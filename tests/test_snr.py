"""SNR estimator: monotone with injected noise, roughly calibrated."""

import numpy as np

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.pipeline import decode_window


def _snr_of(sigma, seed=3):
    iq = synthesize_message("CQ K1JT FN20", f0_hz=700.0, amplitude=0.5,
                            noise_sigma=sigma,
                            rng=np.random.default_rng(seed))
    decodes = decode_window(iq)
    d = [d for d in decodes if d.text == "CQ K1JT FN20"]
    assert d, f"no decode at sigma={sigma}"
    return d[0].snr_db


def test_snr_monotone_in_noise():
    s_clean = _snr_of(0.05)
    s_mid = _snr_of(0.5)
    s_noisy = _snr_of(1.5)
    assert s_clean > s_mid > s_noisy


def test_snr_rough_calibration():
    """amp 0.5 vs sigma 0.5 complex noise ≈ -1.9 dB in 2500 Hz; the
    cell-quantized estimator should land within ~6 dB of truth."""
    true_snr = 10 * np.log10((0.5 ** 2) / (2 * 0.5 ** 2) * (3200 / 2500))
    est = _snr_of(0.5)
    assert abs(est - true_snr) < 6.0, (est, true_snr)


def test_estimate_snr_flat_matches_grid():
    """estimate_snr_flat (the OSD path's flat selection) must agree with
    the rectangular estimate for the same candidates."""
    import jax.numpy as jnp

    from rtlsdr_ft8d_jax.host.synth import synthesize_message
    from rtlsdr_ft8d_jax.ops.llr import estimate_snr, estimate_snr_flat
    from rtlsdr_ft8d_jax.ops.sync import find_sync
    from rtlsdr_ft8d_jax.ops.waterfall import waterfall

    chans = [synthesize_message("CQ K1JT FN20", f0_hz=300 + 200 * b,
                                amplitude=0.3, noise_sigma=0.1,
                                rng=np.random.default_rng(b))
             for b in range(4)]
    batch = np.stack(chans)
    i_s = jnp.asarray(np.real(batch).astype(np.float32))
    q_s = jnp.asarray(np.imag(batch).astype(np.float32))
    wf = waterfall(i_s, q_s)
    cand = find_sync(wf, 8)
    grid = np.asarray(estimate_snr(wf, cand))            # (4, 8)
    B, K = grid.shape
    chan = jnp.repeat(jnp.arange(B, dtype=jnp.int32), K)
    flat_cand = {k: cand[k].reshape(-1) for k in
                 ("time_sub", "freq_sub", "time_offset", "freq_offset")}
    flat = np.asarray(estimate_snr_flat(wf, flat_cand, chan)).reshape(B, K)
    np.testing.assert_allclose(flat, grid, atol=1e-4)
