"""Costas sync-correlation search over the waterfall, fully batched.

Batched replacement for ft8_lib's ft8_find_sync as invoked by the
reference (/root/reference/rtlsdr_ft8d.c:1450, min_score=10, top 120): the
7x7 Costas pattern at symbol offsets 0/36/72 is scored at EVERY candidate
cell (time_sub, freq_sub, time_offset in [-12, 24), freq_offset in
[0, 249)) at once as a sum of statically-shifted views of the waterfall —
no data-dependent control flow, one fused elementwise reduction, followed by
a single jax.lax.top_k.

Scoring (matching kgoba/ft8_lib's neighbor-contrast score): for each of the
21 sync symbols, accumulate the difference between the expected Costas tone
cell and (a) one bin lower, (b) one bin higher, (c) same bin one symbol
earlier, (d) same bin one symbol later — each term gated by the same
boundary conditions as the C loop, final score = C-style truncating division
by the number of accumulated terms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol.constants import (COSTAS_OFFSETS, COSTAS_PATTERN,
                                  K_MAX_CANDIDATES, NUM_BIN, NUM_BLOCKS)

TIME_OFFSET_MIN = -12
TIME_OFFSET_MAX = 24           # exclusive
NUM_TIME_OFFSETS = TIME_OFFSET_MAX - TIME_OFFSET_MIN   # 36
NUM_FREQ_OFFSETS = NUM_BIN - 7                          # 249


def _count_table() -> np.ndarray:
    """Per-time-offset accumulated-term count — data-INDEPENDENT.

    Every gate in the C scoring loop (ft8_find_sync's neighbor-contrast
    score) depends only on (time_offset, m, k): block validity, block > 0,
    block + 1 < NUM_BLOCKS, sm > 0, sm < 7. So the divisor is a (36,)
    constant, computed once here with the exact C conditions.
    """
    cnt = np.zeros(NUM_TIME_OFFSETS, np.int32)
    for ti, to in enumerate(range(TIME_OFFSET_MIN, TIME_OFFSET_MAX)):
        for m in COSTAS_OFFSETS:
            for k in range(7):
                b = to + m + k
                if not (0 <= b < NUM_BLOCKS):
                    continue
                sm = int(COSTAS_PATTERN[k])
                cnt[ti] += (sm > 0) + (sm < 7)
                cnt[ti] += (k > 0) and (b > 0)
                cnt[ti] += (k < 6) and (b + 1 < NUM_BLOCKS)
    return np.maximum(cnt, 1)


_COUNT = _count_table()                                    # (36,)


def sync_scores(wf: jax.Array) -> jax.Array:
    """Score all candidate alignments.

    Args:
      wf: (..., 92, 2, 2, 256) uint8 waterfall.

    Returns:
      (..., 2, 2, NUM_TIME_OFFSETS, NUM_FREQ_OFFSETS) int32 scores, indexed
      [time_sub][freq_sub][time_offset - TIME_OFFSET_MIN][freq_offset].

    The score is a LINEAR function of the waterfall with data-independent
    gating, so instead of accumulating ~80 masked two-gather terms over the
    (36, 249) candidate grid (the shape of the C loop), it is restructured
    into static-slice adds (integer math — bit-identical to the C):

      1. four neighbor-difference planes on the small (92, 256) waterfall:
         DL[b,j] = w[b,j]-w[b,j-1], DH = w[b,j]-w[b,j+1],
         DP = w[b,j]-w[b-1,j] (row 0 zeroed: the C gates on block > 0),
         DN = w[b,j]-w[b+1,j] (last row zeroed: gate block+1 < NUM_BLOCKS);
      2. per-Costas-symbol combination: E_k = DH + DL·[sm>0] + DP·[k>0]
         + DN·[k<6] — only 4 distinct variants since sm=0 only at k=3;
      3. fold the three repetition offsets m ∈ {0,36,72} once per variant:
         M_v[i] = Epad_v[i] + Epad_v[i+36] + Epad_v[i+72] (rows zero-padded,
         which implements the C's block-validity gate);
      4. score[to,fo] = Σ_k M_{v(k)}[to+k, fo+pattern[k]] — 7 static-slice
         adds on the big grid, then the C truncating division by the
         precomputed count.
    """
    w = wf.astype(jnp.int32)                     # (..., 92, 2, 2, 256)
    # reorder to (..., time_sub, freq_sub, block, bin)
    w = jnp.moveaxis(w, -4, -2)                  # (..., 2, 2, 92, 256)
    nb = len(w.shape) - 2                        # batch rank incl. subs

    zrow = jnp.zeros(w.shape[:-2] + (1,) + w.shape[-1:], jnp.int32)
    zbin = jnp.zeros(w.shape[:-1] + (1,), jnp.int32)
    dl = jnp.concatenate([zbin, w[..., :, 1:] - w[..., :, :-1]], axis=-1)
    dh = jnp.concatenate([w[..., :, :-1] - w[..., :, 1:], zbin], axis=-1)
    dp = jnp.concatenate([zrow, w[..., 1:, :] - w[..., :-1, :]], axis=-2)
    dn = jnp.concatenate([w[..., :-1, :] - w[..., 1:, :], zrow], axis=-2)
    s4 = dl + dh + dp + dn
    variants = {"all": s4, "no_dp": s4 - dp,     # k == 0
                "no_dl": s4 - dl,                # k == 3 (sm == 0)
                "no_dn": s4 - dn}                # k == 6

    def fold(e):
        # rows needed: to+m+k for to in [-12,24), k in [0,7), m in {0,36,72}
        # -> padded index (to+12)+k+m in [0, 114)
        ep = jnp.pad(e, [(0, 0)] * nb + [(12, 10), (0, 0)])
        return ep[..., 0:42, :] + ep[..., 36:78, :] + ep[..., 72:114, :]

    folded = {v: fold(e) for v, e in variants.items()}
    score = None
    for k in range(7):
        sm = int(COSTAS_PATTERN[k])
        v = {0: "no_dp", 3: "no_dl", 6: "no_dn"}.get(k, "all")
        term = folded[v][..., k:k + NUM_TIME_OFFSETS,
                         sm:sm + NUM_FREQ_OFFSETS]
        score = term if score is None else score + term

    # C truncating division (toward zero, negative scores possible)
    count = jnp.asarray(_COUNT)[:, None]         # (36, 1) broadcast
    q = jnp.abs(score) // count
    return jnp.sign(score) * q



CHUNK = 16   # freq-offset cells per first-stage chunk (100 Hz of band)
CHUNK_K = 4  # survivors per chunk; >1 signal per 100 Hz chunk is rare


@functools.partial(jax.jit, static_argnames=("num_candidates", "exact"))
def find_sync(wf: jax.Array, num_candidates: int = K_MAX_CANDIDATES,
              exact: bool = False):
    """Top-K candidates by sync score.

    Returns dict of (..., K) arrays: score, time_sub, freq_sub, time_offset,
    freq_offset. Candidates below min_score are NOT filtered here — the
    caller masks on score (matching the reference's `score < K_MIN_SCORE`
    skip at rtlsdr_ft8d.c:1467).

    By default the top-K runs in two stages (top-CHUNK_K per 16-cell freq
    chunk, then global top-K over survivors) instead of a full sort of all
    35,856 cells. Every (ts, fs, to) frequency row is padded
    to a CHUNK multiple so chunks NEVER straddle rows: the two-stage
    selection is exact unless more than CHUNK_K of the true global top-K
    fall in the SAME (time_sub, freq_sub, time_offset, 100 Hz) chunk,
    which requires >CHUNK_K interleaved signals within 100 Hz at identical
    time alignment; `exact=True` forces the full sort.
    """
    scores = sync_scores(wf)
    batch_shape = scores.shape[:-4]
    # pad the freq axis so each (ts, fs, to) row is a whole number of
    # chunks (pads score far below any real cell and are never selected)
    padf = (-NUM_FREQ_OFFSETS) % CHUNK
    width = NUM_FREQ_OFFSETS + padf
    sp = jnp.pad(scores, [(0, 0)] * (len(batch_shape) + 3) + [(0, padf)],
                 constant_values=-(1 << 20))
    flat = sp.reshape(batch_shape + (-1,))
    if exact:
        top, idx = jax.lax.top_k(flat, num_candidates)
    else:
        chunks = flat.reshape(batch_shape + (-1, CHUNK))
        v1, i1 = jax.lax.top_k(chunks, CHUNK_K)          # (..., C, CHUNK_K)
        base = (jnp.arange(chunks.shape[-2]) * CHUNK)[..., :, None]
        gidx = (i1 + base).reshape(batch_shape + (-1,))
        v1 = v1.reshape(batch_shape + (-1,))
        top, sel = jax.lax.top_k(v1, num_candidates)
        idx = jnp.take_along_axis(gidx, sel, axis=-1)
    # unravel [ts][fs][to][fo] (fo over the padded row width)
    fo = idx % width
    rest = idx // width
    to = rest % NUM_TIME_OFFSETS + TIME_OFFSET_MIN
    rest = rest // NUM_TIME_OFFSETS
    fs = rest % 2
    ts = rest // 2
    return {"score": top, "time_sub": ts, "freq_sub": fs,
            "time_offset": to, "freq_offset": fo}
