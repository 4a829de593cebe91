"""Polyphase filterbank channelizer: one 2.4 Msps capture -> 1500 channels.

The reference monitors ONE 3.2 kHz FT8 sub-band per dongle
(/root/reference/rtlsdr_ft8d.c:1278 tunes a single dial frequency). The
scale story here is the opposite: keep the WHOLE 2.4 MHz capture and
split it into decodable 3200-sps channels with a polyphase analysis
filterbank, then batch-decode every channel in one graph — this is how
"1000+ concurrent channels" (BASELINE.json config 5) arises from real
hardware rather than 1000 dongles.

Design points:
  * The decoder's waterfall spans 0..1600 Hz of each channel (256 bins at
    6.25 Hz, like the reference, rtlsdr_ft8d.h:51), so channels are placed
    every 1600 Hz (2x-oversampled PFB, K = 1500 channels over 2.4 MHz) —
    consecutive decode bands tile the spectrum with no gaps.
  * The prototype is a SHARP 48000-tap Kaiser lowpass (64 taps/phase,
    transition ~1500..1700 Hz, ~65 dB stopband): after decimation by 750
    nothing outside a channel's own 3200 Hz aliases into its decode band
    above -60 dB. (The reference's CIC+57-tap chain is far leakier.)
  * Math: z[m, p] = sum_r w[r*750+p] x[(m+r)*750+p]  (64 taps per phase),
    y[m, k] = sum_p z[m, p] e^{-2pi i p k / 1500},    (DFT across phases)
    and odd channels (centers at odd multiples of 1600 Hz) get the
    (-1)^m post-rotation required when channel spacing = fs_out/2.
    The (750, 1500) DFT is real matmuls, float32 I/Q, no complex dtypes.
  * Weak residual ghosts (a strong signal's stopband image decoding in an
    otherwise-empty channel after per-channel normalization) are removed by
    cross-channel text dedup keeping the strongest score (dedup_wideband).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol.constants import CAPTURE_RATE
from .decimate import R, design_lowpass

CHANNEL_STEP_HZ = 1600
NUM_CHANNELS = CAPTURE_RATE // CHANNEL_STEP_HZ   # 1500
WB_PHASES = 64
WB_TAPS = WB_PHASES * R                          # 48000
WB_HISTORY = WB_TAPS - R                         # 47250


@functools.cache
def wb_prototype() -> np.ndarray:
    """Sharp channelizer prototype: cutoff 1600 Hz, 64 taps/phase."""
    return design_lowpass(WB_TAPS, 1600.0, beta=7.0)


@functools.cache
def _wb_bank() -> np.ndarray:
    """(750, 64) polyphase bank, time-reversed like the decimator's."""
    h = wb_prototype()[::-1].copy()
    return np.ascontiguousarray(h.reshape(WB_PHASES, R).T).astype(np.float32)


@functools.cache
def _dft_bases():
    p, j = np.meshgrid(np.arange(R), np.arange(R), indexing="ij")
    ang = 2.0 * np.pi * p * j / R
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.cache
def _half_twiddle():
    p = np.arange(R)
    ang = 2.0 * np.pi * p / NUM_CHANNELS          # e^{-j 2pi p / 1500}
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@jax.jit
def channelize(i_full: jax.Array, q_full: jax.Array, frame_offset=0):
    """Split a full-rate stream into 1500 overlapped baseband channels.

    2x-oversampled DFT filterbank (K = 1500 channels, decimation R = 750):
    with y_k[m] = sum_n x[n] e^{-j2pi kn/K} h[mR-n], substituting
    n = uR + p splits the twiddle into e^{-j2pi kp/K} (-1)^{ku}. Even
    channels are a 750-point DFT of the polyphase outputs z; odd channels
    use a SIGN-ALTERNATED bank (the (-1)^u lives inside the 64-tap filter
    sum), a half-bin twiddle e^{-j2pi p/1500}, the same 750-point DFT, and
    a (-1)^m output rotation.

    Args:
      i_full, q_full: (n,) float32 at 2.4 Msps with n = WB_HISTORY + 750*M
        (prepend WB_HISTORY zeros or carried state).

    Returns:
      (i_ch, q_ch): (1500, M) float32 — channel k centered at k*1600 Hz
      (k >= 750 are negative frequencies), each at 3200 sps.

    frame_offset is the GLOBAL index of this call's first output frame
    (int, may be traced). The odd-channel (-1)^m rotation must use the
    global frame index, not the local one, or streams assembled from
    odd-frame-count chunks/shards sign-flip odd channels mid-window.
    """
    bank = jnp.asarray(_wb_bank())                 # (750, 64)
    n = i_full.shape[-1]
    m = (n - WB_HISTORY) // R
    nf = m + WB_PHASES - 1                         # total frames = n // 750

    def phase_partials(x):
        # even/odd banks share every slice-FMA term: z_even = sum over
        # all r, z_odd = sum with (-1)^r signs, so computing the even-r
        # and odd-r partial sums ONCE gives both as pe+po / pe-po —
        # half the polyphase filter work of filtering the banks apart
        fr = x.reshape(nf, R)
        pe = jnp.zeros((m, R), jnp.float32)
        po = jnp.zeros((m, R), jnp.float32)
        for r in range(WB_PHASES):
            t = fr[r:r + m, :] * bank[:, r][None, :]
            if r % 2 == 0:
                pe = pe + t
            else:
                po = po + t
        return pe + po, pe - po

    zi_e, zi_o = phase_partials(i_full)
    zq_e, zq_o = phase_partials(q_full)

    # odd path: multiply by e^{-j2pi p/1500} then (-1)^m on the output;
    # (-1)^r from the bank already accounts for (-1)^{m} parity of u=m+r
    ct, st = map(jnp.asarray, _half_twiddle())
    zi_o, zq_o = zi_o * ct + zq_o * st, zq_o * ct - zi_o * st
    sign_m = jnp.where((jnp.arange(m) + frame_offset) % 2 == 0,
                       1.0, -1.0)[:, None]
    zi_o = zi_o * sign_m
    zq_o = zq_o * sign_m

    cos, sin = map(jnp.asarray, _dft_bases())
    kw = dict(precision=jax.lax.Precision.HIGHEST,
              preferred_element_type=jnp.float32)

    def dft(zi, zq):
        # down-shift DFT: (zi + j zq) · e^{-j ang} -> (m, 750)
        re = jnp.dot(zi, cos, **kw) + jnp.dot(zq, sin, **kw)
        im = jnp.dot(zq, cos, **kw) - jnp.dot(zi, sin, **kw)
        return re.T, im.T                          # (750, m)

    re_e, im_e = dft(zi_e, zq_e)                   # channels 0,2,4,...
    re_o, im_o = dft(zi_o, zq_o)                   # channels 1,3,5,...
    re = jnp.stack([re_e, re_o], axis=1).reshape(NUM_CHANNELS, m)
    im = jnp.stack([im_e, im_o], axis=1).reshape(NUM_CHANNELS, m)
    return re, im


@jax.jit
def channelize_int8(i8: jax.Array, q8: jax.Array, frame_offset=0):
    """int8 ingest variant: raw mixed int8 IQ uploads at 1/4 the
    host->device bandwidth of float32 and dequantizes on device (exact:
    x/128 in float32 is lossless for int8 inputs)."""
    return channelize(i8.astype(jnp.float32) / 128.0,
                      q8.astype(jnp.float32) / 128.0, frame_offset)


class StreamingChannelizerInt8:
    """Overlap-save streaming wrapper over raw int8 IQ (the daemon's
    wideband ingest path: ring pops int8, nothing is widened on host)."""

    def __init__(self):
        self._hist_i = np.zeros(WB_HISTORY, np.int8)
        self._hist_q = np.zeros(WB_HISTORY, np.int8)
        self._frames_out = 0

    def process(self, i8, q8, device=False):
        """device=True returns jax arrays WITHOUT downloading: the full
        (1500, 48000) channel bank is ~576 MB, and the daemon selects,
        pads and decodes it on the device."""
        i8 = np.asarray(i8, np.int8)
        q8 = np.asarray(q8, np.int8)
        assert i8.shape[-1] % R == 0
        i_full = np.concatenate([self._hist_i, i8])
        q_full = np.concatenate([self._hist_q, q8])
        self._hist_i = i_full[-WB_HISTORY:].copy()
        self._hist_q = q_full[-WB_HISTORY:].copy()
        off = self._frames_out % 2
        self._frames_out += i8.shape[-1] // R
        i_ch, q_ch = channelize_int8(jnp.asarray(i_full),
                                     jnp.asarray(q_full), jnp.int32(off))
        if device:
            return i_ch, q_ch
        return np.asarray(i_ch), np.asarray(q_ch)


class StreamingChannelizer:
    """Overlap-save streaming wrapper (WB_HISTORY-sample state carry)."""

    def __init__(self):
        self._hist_i = np.zeros(WB_HISTORY, np.float32)
        self._hist_q = np.zeros(WB_HISTORY, np.float32)
        self._frames_out = 0

    def process(self, i_chunk, q_chunk):
        i_chunk = np.asarray(i_chunk, np.float32)
        q_chunk = np.asarray(q_chunk, np.float32)
        assert i_chunk.shape[-1] % R == 0
        i_full = np.concatenate([self._hist_i, i_chunk])
        q_full = np.concatenate([self._hist_q, q_chunk])
        self._hist_i = i_full[-WB_HISTORY:].copy()
        self._hist_q = q_full[-WB_HISTORY:].copy()
        # global frame parity so odd-frame-count chunks keep the odd
        # channels' (-1)^m rotation continuous across process() calls
        off = self._frames_out % 2
        self._frames_out += i_chunk.shape[-1] // R
        i_ch, q_ch = channelize(jnp.asarray(i_full), jnp.asarray(q_full),
                                jnp.int32(off))
        return np.asarray(i_ch), np.asarray(q_ch)


def channel_center_hz(k: int) -> float:
    """Center frequency of channel k relative to the capture center."""
    f = k * float(CHANNEL_STEP_HZ)
    if f >= CAPTURE_RATE / 2:
        f -= CAPTURE_RATE
    return f


def dedup_wideband(decodes_per_channel):
    """Cross-channel dedup: same text in one window -> keep highest score.

    Removes stopband ghosts (a strong signal's image decoding in an
    otherwise-quiet channel at the same text). Input: iterable of
    (channel_index, [Decode,...]); Decode.freq_hz must already be absolute
    per channel. Returns a flat list sorted by frequency.
    """
    best = {}
    for _k, decodes in decodes_per_channel:
        for d in decodes:
            cur = best.get(d.text)
            if cur is None or d.score > cur.score:
                best[d.text] = d
    return sorted(best.values(), key=lambda d: d.freq_hz)
