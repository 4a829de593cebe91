"""Polyphase decimator: parity vs scipy, streaming state carry, full chain."""

import numpy as np
from scipy.signal import upfirdn

from rtlsdr_ft8d_jax.ops.decimate import (HISTORY, R, StreamingDecimator,
                                          TAPS, filter_taps, fs4_shift,
                                          polyphase_decimate)
from rtlsdr_ft8d_jax.pipeline import decode_window
from rtlsdr_ft8d_jax.protocol.constants import CAPTURE_RATE, DOWNSAMPLING

import jax.numpy as jnp


def scipy_reference(x, m):
    """Same filter/alignment computed via scipy.upfirdn (full conv)."""
    h = filter_taps()[::-1]  # our out[m] = sum_u h_rev[u] x[m*750+u]
    # full correlation: y[m] = sum_u h_rev[u] * x[m*750 + u]
    full = np.correlate(x, h[::-1], mode="full")  # == convolve(x, h_rev[::-1])
    # y[m] corresponds to full[m*750 + TAPS - 1]
    return full[TAPS - 1:TAPS - 1 + m * R:R][:m]


def test_polyphase_matches_direct_convolution():
    rng = np.random.default_rng(0)
    m = 64
    n = HISTORY + m * R
    x = rng.standard_normal(n).astype(np.float32)
    zeros = np.zeros_like(x)
    i_out, _ = polyphase_decimate(jnp.asarray(x), jnp.asarray(zeros))
    i_out = np.asarray(i_out)
    h_rev = filter_taps()[::-1].astype(np.float64)
    expect = np.array([np.dot(h_rev, x[mm * R: mm * R + TAPS])
                       for mm in range(m)])
    np.testing.assert_allclose(i_out, expect, rtol=2e-4, atol=2e-6)


def test_matches_scipy_upfirdn():
    rng = np.random.default_rng(1)
    m = 32
    x = rng.standard_normal(HISTORY + m * R).astype(np.float32)
    got, _ = polyphase_decimate(jnp.asarray(x), jnp.asarray(np.zeros_like(x)))
    h = filter_taps().astype(np.float64)
    y = upfirdn(h, x.astype(np.float64), up=1, down=R)
    # upfirdn: y[k] = sum_j h[j] x[k*750 - j]; our out[m] ends at
    # m*750 + 5999, i.e. out[m] = y[m + (TAPS-1)//750] up to alignment:
    # find best-matching offset once and assert exact agreement
    errs = [np.abs(np.asarray(got)[:m - 8] - y[off:off + m - 8]).max()
            for off in range(0, 12)]
    assert min(errs) < 1e-3, errs


def test_streaming_matches_oneshot():
    rng = np.random.default_rng(2)
    m = 96
    x_i = rng.standard_normal(m * R).astype(np.float32)
    x_q = rng.standard_normal(m * R).astype(np.float32)
    # one shot with zero-padded history
    pad_i = np.concatenate([np.zeros(HISTORY, np.float32), x_i])
    pad_q = np.concatenate([np.zeros(HISTORY, np.float32), x_q])
    ref_i, ref_q = polyphase_decimate(jnp.asarray(pad_i), jnp.asarray(pad_q))
    # streamed in uneven chunks
    dec = StreamingDecimator()
    outs_i, outs_q = [], []
    pos = 0
    for chunk in (31, 17, 5, 43):
        c = chunk * R
        oi, oq = dec.process(x_i[pos:pos + c], x_q[pos:pos + c])
        outs_i.append(oi); outs_q.append(oq)
        pos += c
    got_i = np.concatenate(outs_i)
    got_q = np.concatenate(outs_q)
    np.testing.assert_allclose(got_i, np.asarray(ref_i), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_q, np.asarray(ref_q), rtol=1e-4, atol=1e-5)


def test_fs4_shift_moves_tone():
    """A tone at fs/4 + 1000 Hz must land at 1000 Hz after the shift."""
    n = 48000
    t = np.arange(n) / CAPTURE_RATE
    f = CAPTURE_RATE / 4 + 1000.0
    i_s = np.cos(2 * np.pi * f * t).astype(np.float32)
    q_s = np.sin(2 * np.pi * f * t).astype(np.float32)
    si, sq = fs4_shift(jnp.asarray(i_s), jnp.asarray(q_s), sign=-1)
    x = np.asarray(si) + 1j * np.asarray(sq)
    spec = np.abs(np.fft.fft(x))
    peak = np.argmax(spec)
    freq = peak * CAPTURE_RATE / n
    assert abs(freq - 1000.0) < CAPTURE_RATE / n + 1


def test_full_chain_decode():
    """2.4 Msps synthetic capture -> fs/4 shift -> decimate -> decode."""
    # Build the full-rate signal by upsampling model: synthesize FT8 at
    # 3200 sps, then place it at +fs/4 via zero-stuffing? Instead synthesize
    # directly at 2.4 Msps: tone frequencies fs/4 + f0 + (tone-3.5)*6.25.
    from rtlsdr_ft8d_jax.protocol.constants import (BLOCK_SIZE,
                                                    TONE_SPACING_HZ)
    from rtlsdr_ft8d_jax.protocol.encode import encode
    from rtlsdr_ft8d_jax.protocol.pack import pack77

    tones = encode(pack77("CQ K1JT FN20"))
    f0 = 500.0
    sps_full = BLOCK_SIZE * DOWNSAMPLING          # samples/symbol at 2.4M
    n = 15 * CAPTURE_RATE
    phi = 0.0
    x = np.zeros(n, dtype=np.complex64)
    idx = 0
    rng = np.random.default_rng(3)
    for tone in tones:
        f = CAPTURE_RATE / 4 + f0 + (float(tone) - 3.5) * TONE_SPACING_HZ
        dphi = 2 * np.pi * f / CAPTURE_RATE
        ph = phi + dphi * np.arange(sps_full)
        x[idx:idx + sps_full] = 0.5 * np.exp(1j * ph)
        phi = (phi + dphi * sps_full) % (2 * np.pi)
        idx += sps_full
    x += (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)

    si, sq = fs4_shift(jnp.asarray(np.real(x)), jnp.asarray(np.imag(x)),
                       sign=-1)
    dec = StreamingDecimator()
    oi, oq = dec.process(np.asarray(si), np.asarray(sq))
    assert oi.shape[0] == 48000
    decodes = decode_window((oi, oq))
    texts = {d.text for d in decodes}
    assert "CQ K1JT FN20" in texts
    d = [d for d in decodes if d.text == "CQ K1JT FN20"][0]
    assert abs(d.freq_hz - (f0 - 3.5 * TONE_SPACING_HZ)) < 7


def test_streaming_host_matches_device():
    """StreamingDecimatorHost (numpy, zero device traffic — the daemon's
    --ingest host) must match the device GEMM streaming path
    chunk-for-chunk."""
    from rtlsdr_ft8d_jax.ops.decimate import StreamingDecimatorHost

    rng = np.random.default_rng(9)
    m = 96
    x_i = rng.standard_normal(m * R).astype(np.float32)
    x_q = rng.standard_normal(m * R).astype(np.float32)
    dev = StreamingDecimator()
    host = StreamingDecimatorHost()
    pos = 0
    for chunk in (31, 17, 5, 43):
        c = chunk * R
        di, dq = dev.process(x_i[pos:pos + c], x_q[pos:pos + c])
        hi, hq = host.process(x_i[pos:pos + c], x_q[pos:pos + c])
        np.testing.assert_allclose(hi, di, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(hq, dq, rtol=1e-4, atol=1e-5)
        pos += c
