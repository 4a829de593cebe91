"""Multi-device tests on the virtual 8-device CPU mesh: channel sharding,
sequence-parallel halo exchange, and the driver's dryrun entry."""

import jax
import jax.numpy as jnp
import numpy as np

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.ops.decimate import HISTORY, R, polyphase_decimate
from rtlsdr_ft8d_jax.parallel.halo import (decimate_batch_time_sharded,
                                           decimate_time_sharded,
                                           make_time_mesh)
from rtlsdr_ft8d_jax.parallel.sharding import (decode_window_sharded,
                                               make_mesh)


def test_channel_sharded_decode():
    mesh = make_mesh(8)
    msgs = ["CQ K1JT FN20", "K1ABC W9XYZ EN37"]
    chans = [synthesize_message(msgs[b % 2], f0_hz=300 + 50 * b,
                                noise_sigma=0.1,
                                rng=np.random.default_rng(b))
             for b in range(8)]
    batch = np.stack(chans)
    i_s = np.real(batch).astype(np.float32)
    q_s = np.imag(batch).astype(np.float32)
    out = decode_window_sharded(i_s, q_s, mesh)
    out = jax.device_get(out)
    assert out["packed"].shape == (8, 50, 12)
    # every channel decoded something
    assert (np.asarray(out["n_ok"]) > 0).all()


def test_time_sharded_decimation_matches_single_device():
    mesh = make_time_mesh(8)
    m = 8 * 32                      # outputs; per-device span = 32*750
    n = m * R
    rng = np.random.default_rng(4)
    i_x = rng.standard_normal(n).astype(np.float32)
    q_x = rng.standard_normal(n).astype(np.float32)
    got_i, got_q = decimate_time_sharded(jnp.asarray(i_x), jnp.asarray(q_x),
                                         mesh)
    pad_i = np.concatenate([np.zeros(HISTORY, np.float32), i_x])
    pad_q = np.concatenate([np.zeros(HISTORY, np.float32), q_x])
    ref_i, ref_q = polyphase_decimate(jnp.asarray(pad_i), jnp.asarray(pad_q))
    np.testing.assert_allclose(np.asarray(got_i), np.asarray(ref_i),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_q), np.asarray(ref_q),
                               rtol=1e-4, atol=1e-5)


def test_batch_time_sharded_decimation():
    mesh = make_time_mesh(8)
    m = 8 * 16
    n = m * R
    rng = np.random.default_rng(7)
    i_x = rng.standard_normal((3, n)).astype(np.float32)
    q_x = rng.standard_normal((3, n)).astype(np.float32)
    got_i, _ = decimate_batch_time_sharded(jnp.asarray(i_x),
                                           jnp.asarray(q_x), mesh)
    pad_i = np.concatenate([np.zeros((3, HISTORY), np.float32), i_x], axis=1)
    pad_q = np.concatenate([np.zeros((3, HISTORY), np.float32), q_x], axis=1)
    ref_i, _ = polyphase_decimate(jnp.asarray(pad_i), jnp.asarray(pad_q))
    np.testing.assert_allclose(np.asarray(got_i), np.asarray(ref_i),
                               rtol=1e-4, atol=1e-5)


def test_dryrun_multichip():
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(8)


def test_entry_compiles():
    from __graft_entry__ import entry
    fn, args = entry()
    out = fn(*args)
    jax.block_until_ready(out)
    assert out["packed"].shape == (8, 50, 12)


def test_time_sharded_channelization_matches_single_device():
    from rtlsdr_ft8d_jax.ops.channelize import WB_HISTORY, channelize
    from rtlsdr_ft8d_jax.parallel.halo import channelize_time_sharded

    mesh = make_time_mesh(8)
    m = 8 * 64          # 48000 samples/device >= the 47250-sample halo
    n = m * R
    rng = np.random.default_rng(21)
    i_x = rng.standard_normal(n).astype(np.float32)
    q_x = rng.standard_normal(n).astype(np.float32)
    got_i, got_q = channelize_time_sharded(jnp.asarray(i_x),
                                           jnp.asarray(q_x), mesh)
    pad_i = np.concatenate([np.zeros(WB_HISTORY, np.float32), i_x])
    pad_q = np.concatenate([np.zeros(WB_HISTORY, np.float32), q_x])
    ref_i, ref_q = channelize(jnp.asarray(pad_i), jnp.asarray(pad_q))
    np.testing.assert_allclose(np.asarray(got_i), np.asarray(ref_i),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_q), np.asarray(ref_q),
                               rtol=1e-4, atol=1e-5)


def test_time_sharded_channelization_odd_frames_per_device():
    """8-way sharding with an ODD per-device frame count: the odd
    channels' (-1)^m rotation must use the global frame offset."""
    from rtlsdr_ft8d_jax.ops.channelize import WB_HISTORY, channelize
    from rtlsdr_ft8d_jax.parallel.halo import channelize_time_sharded

    mesh = make_time_mesh(8)
    per_dev = 65                       # odd; 65*750=48750 >= 47250 halo
    n = 8 * per_dev * R
    rng = np.random.default_rng(23)
    i_x = rng.standard_normal(n).astype(np.float32)
    q_x = rng.standard_normal(n).astype(np.float32)
    got_i, got_q = channelize_time_sharded(jnp.asarray(i_x),
                                           jnp.asarray(q_x), mesh)
    pad_i = np.concatenate([np.zeros(WB_HISTORY, np.float32), i_x])
    pad_q = np.concatenate([np.zeros(WB_HISTORY, np.float32), q_x])
    ref_i, ref_q = channelize(jnp.asarray(pad_i), jnp.asarray(pad_q))
    np.testing.assert_allclose(np.asarray(got_i), np.asarray(ref_i),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_q), np.asarray(ref_q),
                               rtol=1e-4, atol=1e-5)


def test_sharded_budget_osd_matches_single_device():
    """budget + osd under GSPMD sharding must produce the same survivors
    as the single-device graph (collectives inserted by XLA for the
    global top-k and flat gathers)."""
    import jax

    from rtlsdr_ft8d_jax.host.synth import synthesize_message
    from rtlsdr_ft8d_jax.parallel.sharding import (decode_window_sharded,
                                                   make_mesh)
    from rtlsdr_ft8d_jax.pipeline import decode_window_device

    chans = [synthesize_message(f"CQ K{b}AA FN0{b}", f0_hz=300 + 120 * b,
                                amplitude=0.1, noise_sigma=0.1,
                                rng=np.random.default_rng(b))
             for b in range(8)]
    batch = np.stack(chans)
    i_s = np.real(batch).astype(np.float32)
    q_s = np.imag(batch).astype(np.float32)
    mesh = make_mesh(8)
    out_s = jax.device_get(decode_window_sharded(
        i_s, q_s, mesh, budget=128, osd_cands=2))
    out_1 = jax.device_get(decode_window_device(
        jnp.asarray(i_s), jnp.asarray(q_s), budget=128, osd_cands=2))
    np.testing.assert_array_equal(np.asarray(out_s["packed"]),
                                  np.asarray(out_1["packed"]))
    np.testing.assert_array_equal(np.asarray(out_s["ok"]),
                                  np.asarray(out_1["ok"]))
