"""PFB channelizer: tone placement, odd-channel centering, wideband decode,
ghost dedup, streaming state carry."""

import numpy as np
import jax.numpy as jnp

from rtlsdr_ft8d_jax.ops.channelize import (CHANNEL_STEP_HZ, NUM_CHANNELS,
                                            StreamingChannelizer, WB_HISTORY,
                                            channel_center_hz, channelize,
                                            dedup_wideband)
from rtlsdr_ft8d_jax.ops.decimate import R
from rtlsdr_ft8d_jax.pipeline import decode_window
from rtlsdr_ft8d_jax.protocol.constants import (BLOCK_SIZE, CAPTURE_RATE,
                                                DOWNSAMPLING,
                                                TONE_SPACING_HZ)
from rtlsdr_ft8d_jax.protocol.encode import encode
from rtlsdr_ft8d_jax.protocol.pack import pack77


def _tone(freq_hz, n, amp=1.0):
    t = np.arange(n) / CAPTURE_RATE
    return (amp * np.exp(2j * np.pi * freq_hz * t)).astype(np.complex64)


def _channelize_np(x):
    i_ch, q_ch = channelize(jnp.asarray(np.real(x)), jnp.asarray(np.imag(x)))
    return np.asarray(i_ch), np.asarray(q_ch)


def test_tone_lands_in_even_channel():
    m = 3200
    n = WB_HISTORY + m * R
    # 16.3 kHz -> channel 10 (center 16 kHz) at +300 and, by the designed
    # 2x overlap, channel 11 (17.6 kHz) at -1300
    i_ch, q_ch = _channelize_np(_tone(16300.0, n))
    power = (i_ch ** 2 + q_ch ** 2).mean(axis=1)
    assert power[10] > 0.9 and power[11] > 0.9
    z = i_ch[10] + 1j * q_ch[10]
    f = np.fft.fftfreq(z.shape[0], 1.0 / 3200)
    assert abs(f[int(np.argmax(np.abs(np.fft.fft(z))))] - 300.0) < 5


def test_tone_lands_in_odd_channel_centered():
    m = 3200
    n = WB_HISTORY + m * R
    # 8.5 kHz -> odd channel 5 (center 8 kHz), offset +500
    i_ch, q_ch = _channelize_np(_tone(8500.0, n))
    power = (i_ch ** 2 + q_ch ** 2).mean(axis=1)
    assert power[5] > 0.9
    z = i_ch[5] + 1j * q_ch[5]
    f = np.fft.fftfreq(z.shape[0], 1.0 / 3200)
    assert abs(f[int(np.argmax(np.abs(np.fft.fft(z))))] - 500.0) < 5


def test_stopband_isolation():
    """A strong tone must be >55 dB down two channels away."""
    m = 3200
    n = WB_HISTORY + m * R
    i_ch, q_ch = _channelize_np(_tone(16300.0, n))
    power = (i_ch ** 2 + q_ch ** 2).mean(axis=1)
    assert power[13] / power[10] < 10 ** (-5.5)   # >55 dB
    assert power[7] / power[10] < 10 ** (-5.5)


def test_channel_center_hz():
    assert channel_center_hz(0) == 0
    assert channel_center_hz(10) == 16000
    assert channel_center_hz(NUM_CHANNELS - 1) == -CHANNEL_STEP_HZ


def _wideband_ft8(message, abs_freq_hz, n, amp=0.3):
    tones = encode(pack77(message))
    sps = BLOCK_SIZE * DOWNSAMPLING
    x = np.zeros(n, dtype=np.complex64)
    phi, idx = 0.0, WB_HISTORY
    for tone in tones:
        f = abs_freq_hz + (float(tone) - 3.5) * TONE_SPACING_HZ
        dphi = 2 * np.pi * f / CAPTURE_RATE
        end = min(idx + sps, n)
        ph = phi + dphi * np.arange(end - idx)
        x[idx:end] += amp * np.exp(1j * ph)
        phi = (phi + dphi * sps) % (2 * np.pi)
        idx += sps
    return x


def test_wideband_decode_and_ghost_dedup():
    """Signals in two channels; ghosts elsewhere are removed by dedup."""
    m = 48000
    n = WB_HISTORY + m * R
    rng = np.random.default_rng(0)
    # ch 17 (center 27.2 kHz) offset 500; ch 42 (67.2 kHz) offset 900
    x = (_wideband_ft8("CQ K1JT FN20", 17 * 1600 + 500.0, n)
         + _wideband_ft8("K1ABC W9XYZ EN37", 42 * 1600 + 900.0, n))
    x += 0.002 * (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
    i_ch, q_ch = _channelize_np(x)
    sel = [15, 16, 17, 18, 41, 42, 43]
    res = decode_window((i_ch[sel], q_ch[sel]))
    per_channel = []
    for k, decodes in zip(sel, res):
        for d in decodes:
            d.freq_hz += channel_center_hz(k)
        per_channel.append((k, decodes))
    final = dedup_wideband(per_channel)
    texts = [d.text for d in final]
    assert texts.count("CQ K1JT FN20") == 1
    assert texts.count("K1ABC W9XYZ EN37") == 1
    d = [d for d in final if d.text == "CQ K1JT FN20"][0]
    assert abs(d.freq_hz - (17 * 1600 + 500.0
                            - 3.5 * TONE_SPACING_HZ)) < 7


def test_streaming_channelizer_matches_oneshot():
    m = 64
    x = (np.random.default_rng(1).standard_normal(m * R)
         .astype(np.float32))
    q = np.zeros_like(x)
    ref_i, _ = channelize(
        jnp.asarray(np.concatenate([np.zeros(WB_HISTORY, np.float32), x])),
        jnp.asarray(np.concatenate([np.zeros(WB_HISTORY, np.float32), q])))
    sc = StreamingChannelizer()
    out_i = []
    pos = 0
    for chunk in (24, 40):
        oi, _ = sc.process(x[pos:pos + chunk * R], q[pos:pos + chunk * R])
        out_i.append(oi)
        pos += chunk * R
    got_i = np.concatenate(out_i, axis=1)
    np.testing.assert_allclose(got_i, np.asarray(ref_i), rtol=1e-4,
                               atol=1e-5)


def test_streaming_channelizer_odd_frame_chunks():
    """Chunks with ODD frame counts must keep the odd channels'
    (-1)^m rotation phase-continuous (global frame index, not local)."""
    m = 64
    x = (np.random.default_rng(7).standard_normal(m * R)
         .astype(np.float32))
    q = np.zeros_like(x)
    ref_i, ref_q = channelize(
        jnp.asarray(np.concatenate([np.zeros(WB_HISTORY, np.float32), x])),
        jnp.asarray(np.concatenate([np.zeros(WB_HISTORY, np.float32), q])))
    sc = StreamingChannelizer()
    out_i, out_q = [], []
    pos = 0
    for chunk in (23, 17, 24):                    # odd, odd, even frames
        oi, oq = sc.process(x[pos:pos + chunk * R], q[pos:pos + chunk * R])
        out_i.append(oi)
        out_q.append(oq)
        pos += chunk * R
    np.testing.assert_allclose(np.concatenate(out_i, axis=1),
                               np.asarray(ref_i), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.concatenate(out_q, axis=1),
                               np.asarray(ref_q), rtol=1e-4, atol=1e-5)


def test_int8_streaming_channelizer_matches_float():
    """The int8 ingest path (on-device dequant) must match the float
    path exactly: x/128 in float32 is lossless for int8."""
    from rtlsdr_ft8d_jax.ops.channelize import StreamingChannelizerInt8

    rng = np.random.default_rng(9)
    m = 48
    i8 = rng.integers(-128, 128, m * R).astype(np.int8)
    q8 = rng.integers(-128, 128, m * R).astype(np.int8)
    a = StreamingChannelizerInt8()
    b = StreamingChannelizer()
    for sl in (slice(0, 23 * R), slice(23 * R, 48 * R)):
        ai, aq = a.process(i8[sl], q8[sl])
        bi, bq = b.process(i8[sl].astype(np.float32) / 128.0,
                           q8[sl].astype(np.float32) / 128.0)
        np.testing.assert_array_equal(ai, bi)
        np.testing.assert_array_equal(aq, bq)
