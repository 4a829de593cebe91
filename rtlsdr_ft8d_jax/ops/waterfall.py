"""Batched waterfall spectrogram (windowed DFT -> quantized uint8).

Batched equivalent of the reference's FFTW loop
(/root/reference/rtlsdr_ft8d.c:1401-1435): 92 symbol blocks x 2 half-symbol
time offsets, 1024-pt complex DFT of sine-windowed IQ, log power in dB,
quantized to uint8 in 0.5 dB steps with the reference's `(int)(2*db + 240)`
truncation: the Costas sync scores and 8-FSK LLRs downstream consume these
values. Float32 rounding still moves a cell that sits on a step boundary by
one step between devices (about 1e-5 of the cells, GPU against CPU), which
is why the GEMMs run at HIGHEST (see _WF_PRECISION).

Design notes:
  * The DFT is computed as real matmuls against cos/sin bases instead of
    an FFT: all 184 frames x B channels batched as (184*B, 1024) @
    (1024, 512) GEMMs, float32 I/Q end to end (matching the reference's
    separate i/q sample buffers, rtlsdr_ft8d.h:96-97).
  * Only bins 0..511 (0..1600 Hz) are ever used downstream, so the basis is
    (1024, 512), halving FLOPs vs a full FFT.

Layout matches the reference waterfall ([block][time_sub][freq_sub][bin],
rtlsdr_ft8d.c:1446 block_stride = 1024) as a (batch, 92, 2, 2, 256) array.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol.constants import (FREQ_OSR, NFFT, NUM_BIN, NUM_BLOCKS,
                                  SUB_BLOCK_SIZE, TIME_OSR)

NUM_FRAMES = NUM_BLOCKS * TIME_OSR  # 184
NUM_FFT_BINS = NUM_BIN * FREQ_OSR   # 512 (0..1600 Hz)

# Sine window ("hann" in the reference, actually sqrt-Hann: sin(pi*i/N),
# rtlsdr_ft8d.c:331-334).
_WINDOW = np.sin(np.pi * np.arange(NFFT) / NFFT).astype(np.float32)

# Frames overlap 4x with a 256-sample stride: frame t covers samples
# [t*256, t*256+1024). Reshaping into NUM_SEGMENTS 256-sample blocks and
# concatenating 4 STATIC slices builds them without a general gather.
NUM_SEGMENTS = NFFT // SUB_BLOCK_SIZE               # 4
NUM_BLOCKS_RAW = NUM_FRAMES + NUM_SEGMENTS - 1      # 187


def _frames(x: jax.Array) -> jax.Array:
    """(..., 48000) samples -> (..., 184, 1024) overlapped windowless frames."""
    bl = x[..., :NUM_BLOCKS_RAW * SUB_BLOCK_SIZE].reshape(
        x.shape[:-1] + (NUM_BLOCKS_RAW, SUB_BLOCK_SIZE))
    return jnp.concatenate(
        [bl[..., j:j + NUM_FRAMES, :] for j in range(NUM_SEGMENTS)], axis=-1)

# DFT bases, window folded in: X_k = sum_n w_n x_n e^{-2pi i nk/N}
#   Re X = I @ C + Q @ S ;  Im X = Q @ C - I @ S
_N, _K = np.meshgrid(np.arange(NFFT), np.arange(NUM_FFT_BINS), indexing="ij")
_ANG = 2.0 * np.pi * _N * _K / NFFT
_COS = (np.cos(_ANG) * _WINDOW[:, None]).astype(np.float32)   # (1024, 512)
_SIN = (np.sin(_ANG) * _WINDOW[:, None]).astype(np.float32)


# Waterfall DFT GEMM precision. At HIGH or DEFAULT a GPU runs these
# float32 GEMMs in TF32 (10-bit mantissa), which moves about 1% of the
# uint8 cells by up to 14 quantization steps; HIGHEST keeps the cells
# within one step of the CPU's on ~1e-5 of them. Module-level so the
# precision ladder (scripts/wf_fast_compare.py) can set a rung.
_WF_PRECISION = jax.lax.Precision.HIGHEST


def _dft_mag2(i_frames, q_frames):
    """|DFT|^2 of windowed frames via real matmuls. (..., 1024) -> (..., 512)."""
    kw = dict(precision=_WF_PRECISION,
              preferred_element_type=jnp.float32)
    C, S = jnp.asarray(_COS), jnp.asarray(_SIN)
    re = jnp.dot(i_frames, C, **kw) + jnp.dot(q_frames, S, **kw)
    im = jnp.dot(q_frames, C, **kw) - jnp.dot(i_frames, S, **kw)
    return re * re + im * im


def waterfall(i_samples: jax.Array, q_samples: jax.Array) -> jax.Array:
    """Compute the quantized waterfall.

    Args:
      i_samples, q_samples: (..., 48000) float32 baseband at 3200 sps.

    Returns:
      (..., NUM_BLOCKS, TIME_OSR, FREQ_OSR, NUM_BIN) uint8 waterfall.
    """
    i_f = _frames(i_samples)                       # (..., 184, 1024)
    q_f = _frames(q_samples)
    mag2 = _dft_mag2(i_f, q_f)                     # (..., 184, 512)
    db = 10.0 * jnp.log10(1e-12 + mag2 * (4.0 / (NFFT * NFFT)))
    scaled = jnp.trunc(2.0 * db + 240.0)
    q = jnp.clip(scaled, 0.0, 255.0).astype(jnp.uint8)
    # split frame axis -> (block, time_sub); fft bin = pos*FREQ_OSR + freq_sub
    shape = q.shape[:-2] + (NUM_BLOCKS, TIME_OSR, NUM_BIN, FREQ_OSR)
    q = q.reshape(shape)
    # -> [block][time_sub][freq_sub][bin]
    return jnp.swapaxes(q, -1, -2)

