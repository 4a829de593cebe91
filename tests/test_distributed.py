"""Real multi-PROCESS decode: 2 CPU processes, jax.distributed, DCN-style
collectives between them (round-1 gap: collectives were only ever tested
inside one process's virtual mesh)."""

import os
import socket
import subprocess
import sys

import pytest

_CHILD = r"""
import os, sys
import numpy as np

import jax
import jax.numpy as jnp

from rtlsdr_ft8d_jax.parallel.distributed import (initialize,
                                                  make_global_grid_mesh,
                                                  shard_channels, local_rows)

pid = int(sys.argv[1])
coord = sys.argv[2]
initialize(coord, 2, pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8, len(jax.devices())   # 2 procs x 4 cpus

mesh = make_global_grid_mesh()
assert mesh.shape == {"host": 2, "chip": 4}
# 'host' must be the slowest-varying axis: row p = process p's devices
for p in range(2):
    assert all(d.process_index == p for d in mesh.devices[p]), mesh.devices

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.parallel.dense import decode_window_dense
from rtlsdr_ft8d_jax.protocol.unpack import unpack77

# each process synthesizes ITS OWN 4 channels with process-specific texts
msgs = [f"CQ K{pid}JT FN2{b}" for b in range(4)]
local = np.stack([
    np.stack([c.real, c.imag]) for c in
    (synthesize_message(m, f0_hz=300 + 100 * b, noise_sigma=0.05,
                        rng=np.random.default_rng(10 * pid + b))
     for b, m in enumerate(msgs))
])  # (4, 2, 48000)
i_g, q_g = shard_channels(mesh, local[:, 0].astype(np.float32),
                          local[:, 1].astype(np.float32))
assert i_g.shape == (8, 48000)

out = decode_window_dense(i_g, q_g, mesh, global_budget=600)

packed, rows = local_rows(out["packed"])
ok, _ = local_rows(out["ok"])
texts = set()
for r in range(packed.shape[0]):
    for k in np.nonzero(ok[r])[0]:
        texts.add(unpack77(np.unpackbits(packed[r, k])[:77]))
missing = [m for m in msgs if m not in texts]
assert not missing, (pid, missing, texts)

# sequence-parallel halo across PROCESS boundaries: the 750x decimator's
# overlap-save ppermute must carry state from the last device of proc 0
# to the first device of proc 1
from rtlsdr_ft8d_jax.parallel.halo import TIME_AXIS, decimate_time_sharded
from rtlsdr_ft8d_jax.ops.decimate import HISTORY, polyphase_decimate
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

tmesh = Mesh(np.asarray(jax.devices()), (TIME_AXIS,))
n_dev = len(jax.devices())
n = n_dev * 8 * 750
rng = np.random.default_rng(77)
x = rng.standard_normal(n).astype(np.float32)
y = rng.standard_normal(n).astype(np.float32)
tsh = NamedSharding(tmesh, P(TIME_AXIS))
per = n // jax.process_count()
lo = pid * per
gx = jax.make_array_from_process_local_data(tsh, x[lo:lo + per])
gy = jax.make_array_from_process_local_data(tsh, y[lo:lo + per])
di, dq = decimate_time_sharded(gx, gy, tmesh)
# reference: full-stream decimation computed locally
pad = np.zeros(HISTORY, np.float32)
ri, _ = polyphase_decimate(jnp.asarray(np.concatenate([pad, x])),
                           jnp.asarray(np.concatenate([pad, y])))
mine = np.concatenate([np.asarray(s.data) for s in sorted(
    di.addressable_shards, key=lambda s: s.index[0].start or 0)])
start = lo // 750
ref_slice = np.asarray(ri)[start:start + mine.shape[0]]
np.testing.assert_allclose(mine, ref_slice, rtol=1e-4, atol=1e-5)
print(f"proc {pid} OK: decoded {sorted(texts)}; halo ok", flush=True)
"""


def test_two_process_dense_decode(tmp_path):
    """Launch 2 coordinated JAX processes; each shards its local channels
    into a global ('host','chip') mesh, decode_window_dense runs with a
    cross-process all-gather, and each process decodes its own channels."""
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))),
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_NUM_CPU_DEVICES": "4",
    })
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), coord],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("2-process decode timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "proc 0 OK" in outs[0]
    assert "proc 1 OK" in outs[1]
