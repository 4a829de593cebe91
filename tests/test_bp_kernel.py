"""The Triton-route BP kernel (ops/ldpc_pallas.py) against the XLA
sum-product loop: in interpret mode here, compiled for the card in the
`chip` tests (run by chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtlsdr_ft8d_jax.ops.ldpc import bp_decode, bp_decode_xla
from rtlsdr_ft8d_jax.ops.ldpc_pallas import bp_decode_pallas
from rtlsdr_ft8d_jax.protocol.crc import add_crc
from rtlsdr_ft8d_jax.protocol.encode import ldpc_encode


def _llrs(n, seed=7):
    """Codewords at three noise levels, plus pure-noise rows."""
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(n):
        if t % 4 == 3:
            rows.append(rng.normal(0, 2.0, 174).astype(np.float32))
            continue
        cw = ldpc_encode(add_crc(rng.integers(0, 2, 77).astype(np.uint8)))
        scale = [4.0, 1.2, 0.7][t % 3]
        rows.append((2.0 * cw.astype(np.float32) - 1.0) * scale
                    + rng.normal(0, 1.0, 174).astype(np.float32))
    return np.stack(rows) * 2.0


@pytest.mark.parametrize("posterior", [False, True])
@pytest.mark.parametrize("n", [1, 37, 256])
def test_kernel_interpret_matches_xla(n, posterior):
    llr = jnp.asarray(_llrs(n))
    want = bp_decode_xla(llr, 20, posterior)
    got = bp_decode_pallas(llr, 20, posterior, interpret=True)
    assert [g.shape for g in got] == [w.shape for w in want]
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), np.asarray(g))


@pytest.mark.chip
@pytest.mark.parametrize("posterior", [False, True])
@pytest.mark.parametrize("n", [1, 37, 1024])
def test_kernel_compiled_matches_xla(n, posterior):
    """Compiled for the GPU, against the XLA loop on the CPU device."""
    llr = _llrs(n)
    got = jax.device_get(bp_decode_pallas(jnp.asarray(llr), 20, posterior))
    want = jax.device_get(bp_decode_xla(
        jax.device_put(llr, jax.devices("cpu")[0]), 20, posterior))
    assert np.array_equal(want[0], got[0])
    assert np.array_equal(want[1], got[1])
    if posterior:
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-3)


@pytest.mark.chip
def test_gpu_graph_lowers_the_kernel():
    x = jnp.zeros((8, 174), jnp.float32)
    text = jax.jit(lambda v: bp_decode(v)).lower(x).as_text()
    assert "bp_decode_triton" in text


def test_kernel_lowers_for_cuda_inside_shard_map():
    """The sharded dense path runs the kernel inside shard_map, where its
    outputs must carry the input's mesh variance; lowering for CUDA here
    runs every Triton lowering rule without a card."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("ch",))
    fn = shard_map(lambda x: bp_decode(x, 20, True), mesh=mesh,
                   in_specs=P("ch"), out_specs=P("ch"))
    text = jax.jit(fn).trace(jax.ShapeDtypeStruct((32, 174), jnp.float32)) \
        .lower(lowering_platforms=("cuda",)).as_text()
    assert "bp_decode_triton" in text
