"""Noncoherent 8-FSK log-likelihood extraction, vectorized over candidates.

Batched equivalent of ft8_lib's ft8_extract_likelihood/ft8_decode_symbol
as driven by the reference decode loop (/root/reference/rtlsdr_ft8d.c:1476).
For every candidate the 58 data symbols (channel symbols 7..35 and 43..71)
contribute 3 Gray-demapped max-log bit LLRs from the 8 tone magnitudes; the
174-vector is then variance-normalized with the ft8_lib scaling factor
sqrt(24/var). Everything is a batched gather + elementwise max — no loops
over candidates.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol.constants import (FT8_LDPC_N, FT8_ND, GRAY_MAP, NUM_BIN,
                                  NUM_BLOCKS)

# Data symbol channel indices: k + 7 for k<29 else k + 14.
_DATA_SYM = np.array([k + (7 if k < 29 else 14) for k in range(FT8_ND)],
                     dtype=np.int32)
_GRAY = GRAY_MAP.astype(np.int32)

# Bit masks for max-log LLRs: bit b of the 3-bit group, over s2[j] where j is
# the Gray-decoded value. logl[b] = max_{j: bit b of j set} s2[j]
#                                  - max_{j: bit b of j clear} s2[j]
_BIT_SET = np.array([[(j >> (2 - b)) & 1 for j in range(8)]
                     for b in range(3)], dtype=bool)         # (3, 8)


def _llrs_from_mags(s2, valid):
    """Shared max-log bit-LLR + ft8_lib variance normalization.
    s2: (..., 58, 8) quantized tone magnitudes; valid: (..., 58)."""
    batch_shape = s2.shape[:-2]
    set_mask = jnp.asarray(_BIT_SET)                     # (3, 8)
    s2e = s2[..., None, :]                               # (..., 58, 1, 8)
    neg = jnp.float32(-1e30)
    max_set = jnp.max(jnp.where(set_mask, s2e, neg), axis=-1)
    max_clr = jnp.max(jnp.where(set_mask, neg, s2e), axis=-1)
    logl = max_set - max_clr                             # (..., 58, 3)
    logl = jnp.where(valid[..., None], logl, 0.0)
    log174 = logl.reshape(batch_shape + (FT8_LDPC_N,))

    # ft8_lib normalization: scale to variance 24
    s = jnp.sum(log174, axis=-1, keepdims=True)
    s2sum = jnp.sum(log174 * log174, axis=-1, keepdims=True)
    inv_n = 1.0 / FT8_LDPC_N
    var = (s2sum - s * s * inv_n) * inv_n
    norm = jnp.sqrt(24.0 / jnp.maximum(var, 1e-12))
    return log174 * norm


def _flatten_grid(cand: dict):
    """(B, K) candidate grid -> flat (B*K,) dict + channel indices."""
    B, K = cand["time_sub"].shape
    flat = {k: cand[k].reshape(-1) for k in
            ("time_sub", "freq_sub", "time_offset", "freq_offset")}
    chan_idx = jax.lax.broadcasted_iota(
        jnp.int32, (B, K), 0).reshape(-1)
    return flat, chan_idx, B, K


def extract_llrs(wf: jax.Array, cand: dict) -> jax.Array:
    """Extract normalized LLRs for each candidate.

    Routed through the flat path (one reshape each way) so the two
    formulations stay a single implementation.

    Args:
      wf: (B, 92, 2, 2, 256) uint8 waterfall.
      cand: dict of (B, K) int arrays (time_sub/freq_sub/time_offset/
        freq_offset) from find_sync.

    Returns:
      (B, K, 174) float32 normalized LLRs.
    """
    flat, chan_idx, B, K = _flatten_grid(cand)
    return extract_llrs_flat(wf, flat, chan_idx).reshape(B, K, FT8_LDPC_N)


def _tone_mags_flat(wf: jax.Array, cand_flat: dict, chan_idx: jax.Array):
    """Gather the 8 Gray-demapped tone magnitudes per (candidate, symbol)
    for a flat (N,) candidate selection.

    One row gather (each unit is a whole 256-bin row) followed by a
    one-hot dot that selects the 8 tone columns.

    Returns (s2, valid): (N, 58, 8) float32 and (N, 58) bool.
    """
    ts, fs = cand_flat["time_sub"], cand_flat["freq_sub"]
    to, fo = cand_flat["time_offset"], cand_flat["freq_offset"]
    N = ts.shape[0]
    B = wf.shape[0]

    sym = jnp.asarray(_DATA_SYM)                         # (58,)
    blocks = to[:, None] + sym[None, :]                  # (N, 58)
    valid = (blocks >= 0) & (blocks < NUM_BLOCKS)
    blocks_c = jnp.clip(blocks, 0, NUM_BLOCKS - 1)

    wf_rows = wf.reshape(B * NUM_BLOCKS * 4, NUM_BIN)
    rowidx = (chan_idx[:, None] * (NUM_BLOCKS * 4)
              + ((blocks_c * 2 + ts[:, None]) * 2 + fs[:, None]))
    rows = jnp.take(wf_rows, rowidx.reshape(-1), axis=0) \
        .reshape(N, FT8_ND, NUM_BIN).astype(jnp.bfloat16)

    col = jax.lax.broadcasted_iota(jnp.int32, (N, NUM_BIN), 1)
    want = fo[:, None, None] + jnp.asarray(_GRAY)[None, None, :]
    sel = (col[..., None] == want).astype(jnp.bfloat16)  # (N, 256, 8)
    # exact at any precision: bf16 holds the operands (0/1 and ints
    # <= 255) exactly, each output has one nonzero term, f32 accumulate
    s2 = jnp.einsum("nsc,ncj->nsj", rows, sel,
                    precision=jax.lax.Precision.DEFAULT,
                    preferred_element_type=jnp.float32)
    return s2, valid



def extract_llrs_flat(wf: jax.Array, cand_flat: dict,
                      chan_idx: jax.Array) -> jax.Array:
    """LLRs for a FLAT cross-channel candidate selection.

    The global-budget path selects the N best candidates across the whole
    batch; extracting LLRs only for those (instead of all B*K) removes
    the pipeline's hottest gather at production budgets.

    Args:
      wf: (B, 92, 2, 2, 256) uint8 waterfall.
      cand_flat: dict of (N,) int arrays.
      chan_idx: (N,) int32 — which batch row each candidate belongs to.

    Returns: (N, 174) float32 normalized LLRs.
    """
    s2, valid = _tone_mags_flat(wf, cand_flat, chan_idx)
    return _llrs_from_mags(s2, valid)


def estimate_snr_flat(wf: jax.Array, cand_flat: dict,
                      chan_idx: jax.Array) -> jax.Array:
    """Flat-selection variant of estimate_snr: (N,) dB estimates."""
    s2, valid = _tone_mags_flat(wf, cand_flat, chan_idx)
    peak = jnp.max(s2, axis=-1)
    nvalid = jnp.maximum(jnp.sum(valid, axis=-1), 1)
    sig_half_db = jnp.sum(jnp.where(valid, peak, 0.0), axis=-1) / nvalid
    # noise floor: mean of the below-average cells (one-step trimmed mean —
    # robust against strong signals inflating the plain mean in busy bands),
    # corrected by the fixed AWGN distribution-shape offset (the lower-half
    # mean of chi-square(2) log-power cells sits 9.9 half-dB below the full
    # mean; measured on pure-noise waterfalls)
    wf_f = wf.reshape(wf.shape[0], -1).astype(jnp.float32)
    m1 = jnp.mean(wf_f, axis=-1, keepdims=True)
    below = (wf_f <= m1).astype(jnp.float32)
    noise_half_db = jnp.sum(wf_f * below, axis=-1) \
        / jnp.maximum(jnp.sum(below, axis=-1), 1.0) + 9.9
    return 0.5 * (sig_half_db - jnp.take(noise_half_db, chan_idx)) - 26.0


def estimate_snr(wf: jax.Array, cand: dict) -> jax.Array:
    """Per-candidate SNR estimate in dB re 2500 Hz bandwidth.

    The reference reports the sync score as 'snr' and its author flags that
    as wrong (rtlsdr_ft8d.c:1517 "it's not true, score != snr"). Here:
    signal level = mean quantized dB of the candidate's strongest tone per
    symbol; noise level = per-channel mean waterfall cell; converted with
    the standard 6.25 Hz -> 2500 Hz bandwidth factor (-26 dB).

    Returns (B, K) float32 dB.
    """
    flat, chan_idx, B, K = _flatten_grid(cand)
    return estimate_snr_flat(wf, flat, chan_idx).reshape(B, K)
