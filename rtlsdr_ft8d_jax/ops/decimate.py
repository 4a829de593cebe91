"""Polyphase decimating front-end: 2.4 Msps IQ -> 3200 sps baseband.

Batched replacement for the reference's callback DSP chain
(/root/reference/rtlsdr_ft8d.c:76-202): the fs/4 mixer + CIC(N=2, R=750) +
57-tap compensation FIR becomes ONE properly designed 6000-tap Kaiser
anti-alias lowpass applied as a polyphase matmul, decimating by exactly 750
(the reference's stream path decimates by 751 due to an off-by-one — SURVEY
§3.5 — which this build deliberately does not reproduce).

Design:
  * Polyphase-as-GEMM: input reshaped to (num_out, 750) phase frames; the
    750x8 filter bank contracts as (num_out, 750) @ (750, 8), then 8
    shifted diagonal adds. Each input sample is read exactly once.
  * Streaming overlap-save: a (TAPS-750) sample tail carries between chunks
    (the analogue of the reference's static CIC/FIR state registers,
    rtlsdr_ft8d.c:80-86,112-114).
  * Sequence-parallel: shard the time axis over the mesh; the halo is the
    same overlap-save tail exchanged with jax.lax.ppermute between
    devices (see parallel/halo.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol.constants import CAPTURE_RATE, DOWNSAMPLING

R = DOWNSAMPLING            # 750
PHASES = 8                  # filter length = PHASES * R
TAPS = PHASES * R           # 6000
HISTORY = TAPS - R          # 5250 samples of carry-over state


@functools.cache
def design_lowpass(taps: int, cutoff_hz: float, beta: float = 7.0
                   ) -> np.ndarray:
    """Kaiser-windowed sinc lowpass prototype (unity DC gain)."""
    n = np.arange(taps) - (taps - 1) / 2.0
    c = cutoff_hz / CAPTURE_RATE
    h = np.sinc(2 * c * n) * 2 * c
    h *= np.kaiser(taps, beta)
    h /= h.sum()
    return h.astype(np.float32)


@functools.cache
def filter_taps() -> np.ndarray:
    """Default decimator prototype: cutoff mid-transition at 2400 Hz.

    Transition band 1600..3200 Hz so nothing in the capture's own 0..1600 Hz
    band is distorted; ~65 dB stopband with beta=7 at 6000 taps. (The sharp
    wideband-channelizer prototype lives in ops/channelize.py.)
    """
    return design_lowpass(TAPS, 2400.0)


@functools.cache
def _polyphase_bank() -> np.ndarray:
    """(750, 8) filter bank: bank[p, r] = h[r*750 + p] time-reversed.

    out[m] = sum_k h[k] x[m*750 + (TAPS-1) - k]  (causal conv, aligned so
    chunk processing with HISTORY-sample prefix yields exactly chunk//750
    outputs).
    """
    h = filter_taps()[::-1].copy()          # reversed: dot with input window
    return np.ascontiguousarray(h.reshape(PHASES, R).T).astype(np.float32)


def fs4_mixer_tables(n: int, sign: int = -1):
    """Period-4 cos/sin tables for the fs/4 shift (reference c:116-140).

    sign=-1 shifts the +fs/4 sub-band down to baseband.
    Returns (cos, sin) float32 arrays of length n with
    e^{j*sign*pi/2*t} = cos + j*sin.
    """
    t = np.arange(n) % 4
    cos = np.array([1.0, 0.0, -1.0, 0.0], np.float32)[t]
    sin = np.array([0.0, 1.0, 0.0, -1.0], np.float32)[(t if sign > 0 else
                                                       (-t) % 4)]
    return cos, sin


def fs4_shift(i_s, q_s, sign: int = -1):
    """Apply the zero-multiply fs/4 frequency shift to float I/Q arrays."""
    n = i_s.shape[-1]
    cos, sin = fs4_mixer_tables(n, sign)
    cos, sin = jnp.asarray(cos), jnp.asarray(sin)
    return i_s * cos - q_s * sin, i_s * sin + q_s * cos


@jax.jit
def polyphase_decimate(i_s: jax.Array, q_s: jax.Array):
    """Decimate float32 I/Q by 750.

    Args:
      i_s, q_s: (..., n) with n = HISTORY + 750*M (prepend HISTORY zeros or
        carried state; see StreamingDecimator).

    Returns:
      (..., M) float32 I/Q at 3200 sps.
    """
    bank = jnp.asarray(_polyphase_bank())       # (750, 8)
    n = i_s.shape[-1]
    m = (n - HISTORY) // R
    assert n == HISTORY + m * R, "length must be HISTORY + 750*M"

    def one(x):
        # frames[t] = x[t*750 : (t+1)*750]; out[m]'s 6000-tap window covers
        # frames m..m+7, so out[m] = sum_r y[m + r, r] with
        # y[t, r] = frames[t] . bank[:, r] and bank[p, r] = h_rev[r*750 + p].
        nf = m + PHASES - 1                      # total frames = n // R
        fr = x.reshape(x.shape[:-1] + (nf, R))
        y = jnp.dot(fr, bank, precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)   # (..., nf, 8)
        out = jnp.zeros(x.shape[:-1] + (m,), jnp.float32)
        for r in range(PHASES):
            out = out + jax.lax.dynamic_slice_in_dim(
                y[..., r], r, m, axis=-1)
        return out

    return one(i_s), one(q_s)


class StreamingDecimator:
    """Overlap-save streaming wrapper: carries HISTORY samples across calls.

    Host-side equivalent of the reference's static filter state
    (rtlsdr_ft8d.c:80-86,112-114) — feed arbitrary multiple-of-750 chunks of
    full-rate IQ, receive 3200 sps output with no boundary glitches.
    """

    def __init__(self, batch_shape=()):
        self._hist_i = np.zeros(batch_shape + (HISTORY,), np.float32)
        self._hist_q = np.zeros(batch_shape + (HISTORY,), np.float32)

    def process(self, i_chunk, q_chunk):
        i_chunk = np.asarray(i_chunk, np.float32)
        q_chunk = np.asarray(q_chunk, np.float32)
        assert i_chunk.shape[-1] % R == 0
        i_full = np.concatenate([self._hist_i, i_chunk], axis=-1)
        q_full = np.concatenate([self._hist_q, q_chunk], axis=-1)
        self._hist_i = i_full[..., -HISTORY:].copy()
        self._hist_q = q_full[..., -HISTORY:].copy()
        i_out, q_out = polyphase_decimate(jnp.asarray(i_full),
                                          jnp.asarray(q_full))
        return np.asarray(i_out), np.asarray(q_out)


class StreamingDecimatorHost:
    """Host-side (numpy) twin of StreamingDecimator: same polyphase bank,
    same overlap-save state, no device traffic at all.

    Selected with the daemon's `--ingest host`: the full-rate window then
    never leaves the host and only the 3200 sps baseband (~0.4 MB) is
    uploaded, at the polyphase filter's host cost (what a Raspberry Pi
    spent on the same job in the reference, rtlsdr_ft8d.c:76-202).
    """

    def __init__(self):
        self._hist_i = np.zeros(HISTORY, np.float32)
        self._hist_q = np.zeros(HISTORY, np.float32)

    @staticmethod
    def _one(x_full):
        bank = _polyphase_bank()                    # (750, 8)
        m = (x_full.shape[-1] - HISTORY) // R
        nf = m + PHASES - 1
        fr = x_full.reshape(nf, R)
        y = fr @ bank                               # (nf, 8) f32
        out = np.zeros(m, np.float32)
        for r in range(PHASES):
            out += y[r:r + m, r]
        return out

    def process(self, i_chunk, q_chunk):
        i_chunk = np.asarray(i_chunk, np.float32)
        q_chunk = np.asarray(q_chunk, np.float32)
        assert i_chunk.shape[-1] % R == 0
        i_full = np.concatenate([self._hist_i, i_chunk])
        q_full = np.concatenate([self._hist_q, q_chunk])
        self._hist_i = i_full[-HISTORY:].copy()
        self._hist_q = q_full[-HISTORY:].copy()
        return self._one(i_full), self._one(q_full)

