"""Matched-filter candidate refinement: unquantized tone magnitudes at
fine (dt, df) offsets for BP-failed candidates.

The main pipeline works on the reference's quantized uint8 waterfall at
2x/2x oversampling (0.08 s / 3.125 Hz grid) for bit-parity with
ft8_lib's decode chain (SURVEY §3.4). Signals landing between grid
points lose up to ~1 dB to timing/frequency mismatch and quantization.
This stage re-derives the 79x8 tone magnitudes for a FAILED candidate
directly from the raw baseband samples — per-symbol matched filters
(rectangular window, exact candidate frequency) evaluated on a finer
+-quarter-grid — picks the (dt, df) variant with the highest Costas sync
power, and emits fresh float LLRs for a BP retry + OSD.

All of it is batched dense linear algebra (gathers + two GEMMs onto a
fixed 24-tone cos/sin basis) — GEMM work, float32 I/Q, no complex
dtypes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..protocol.constants import (BLOCK_SIZE, COSTAS_PATTERN, FT8_LDPC_N,
                                  FT8_ND, FT8_NN, GRAY_MAP,
                                  SIGNAL_SAMPLE_RATE, TONE_SPACING_HZ)
from .llr import _BIT_SET, _DATA_SYM

# refinement grids: +-1/4 symbol in time, +-1/4 bin in frequency
# (a finer 5x5 grid measured NO sensitivity gain — the Costas-power
# variant pick saturates at quarter-grid residuals)
_DT_GRID = np.array([-128, 0, 128], dtype=np.int32)          # samples
_DF_GRID = np.array([-TONE_SPACING_HZ / 4, 0.0,
                     TONE_SPACING_HZ / 4], dtype=np.float64)  # Hz

_WINDOW_SAMPLES = FT8_NN * BLOCK_SIZE                        # 40448

# Costas sync symbol indices and their expected tones
_SYNC_SYM = np.concatenate([np.arange(7), 36 + np.arange(7),
                            72 + np.arange(7)]).astype(np.int32)
_SYNC_TONE = np.concatenate([COSTAS_PATTERN] * 3).astype(np.int32)

# Consecutive sync-symbol pairs (6 per Costas block x 3 blocks): the
# phase of z_{i+1}(c_{i+1}) * conj(z_i(c_i)) summed over these pairs is
# the per-symbol residual-CFO rotation (tone spacing x symbol time = 1
# cycle exactly, so the tone bases are already phase-continuous across
# symbols; only the CFO residual rotates).
_SP1 = np.concatenate([b + np.arange(6) for b in (0, 36, 72)]) \
    .astype(np.int32)                                     # first of pair
_SP2 = (_SP1 + 1).astype(np.int32)
_SP1_TONE = np.concatenate([COSTAS_PATTERN[:-1]] * 3).astype(np.int32)
_SP2_TONE = np.concatenate([COSTAS_PATTERN[1:]] * 3).astype(np.int32)

# Adjacent data-symbol pairs within each 29-symbol run (28 + 28); pairs
# never span the middle Costas block.
_PAIR_K = np.array([k for k in range(57) if k != 28], dtype=np.int32)
# Adjacent triples within each run (27 + 27).
_TRIPLE_K = np.array([k for k in range(56) if k not in (27, 28)],
                     dtype=np.int32)


@functools.cache
def _tone_basis():
    """(512, 3*8) cos/sin bases: tone j at j*6.25 + df for each df."""
    u = np.arange(BLOCK_SIZE, dtype=np.float64)
    freqs = []
    for df in _DF_GRID:
        for j in range(8):
            freqs.append(j * TONE_SPACING_HZ + df)
    ang = 2.0 * np.pi * np.outer(u, np.asarray(freqs)) / SIGNAL_SAMPLE_RATE
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def refine_llrs_flat(i_samples: jax.Array, q_samples: jax.Array,
                     cand_flat: dict, chan_idx: jax.Array,
                     return_pair: bool = False):
    """Refined LLRs for a FLAT cross-channel candidate selection.

    Memory and compute scale with the number of refined candidates, NOT
    the channel count — the device graph caps the global selection so a
    1500-channel wideband window refines the same few hundred best
    failures as a 64-channel batch.

    Args:
      i_samples, q_samples: (B, 48000) float32 baseband.
      cand_flat: dict of (N,) int arrays (time_sub/freq_sub/time_offset/
        freq_offset) — the candidates to refine.
      chan_idx: (N,) int32 — each candidate's batch row.

    Returns:
      (llrs, best_score): (N, 174) float32 refined normalized LLRs and
      (N,) float32 best-variant Costas power (linear units). With
      return_pair=True, two more elements: (3rd) PAIR/TRIPLE-COHERENT
      LLRs — adjacent data symbols combined coherently (the residual-CFO
      inter-symbol rotation estimated from the Costas pairs), the
      multi-symbol combining WSJT-X uses for its deepest passes, ~0.5-1
      dB sharper than the noncoherent LLRs on-grid; and (4th)
      BLOCK-COHERENT LLRs — every data symbol scored fully coherently
      against a carrier-phase reference interpolated between the three
      Costas-block anchors (_block_coherent_llrs). Weaker alone than the
      triple flavor but decodes a DIFFERENT subset at the threshold
      (union +2..4/48 at -21.0..-21.5 dB, scripts/coherent_ab.py), so
      the deep ladder runs BP on both.
    """
    ts = cand_flat["time_sub"].astype(jnp.int32)
    fs = cand_flat["freq_sub"].astype(jnp.int32)
    to = cand_flat["time_offset"].astype(jnp.int32)
    fo = cand_flat["freq_offset"].astype(jnp.int32)
    N = ts.shape[0]
    NDT, NDF = len(_DT_GRID), len(_DF_GRID)
    n_in = i_samples.shape[-1]

    # start sample of symbol 0 for each (cand, dt). The +256 bias: the
    # waterfall's 1024-pt sine window is centered half a block after the
    # nominal block start (the reference's systematic -0.08 s DT), so the
    # 512-sample rectangular matched filter starts one half-block later.
    s0 = (to * 2 + ts) * (BLOCK_SIZE // 2) + BLOCK_SIZE // 2    # (N,)
    s0 = s0[:, None] + jnp.asarray(_DT_GRID)[None, :]           # (N, DT)

    # Every window start is a multiple of 128 samples (to*512 + ts*256 +
    # 256 +- 128), so the sample fetch is a ROW GATHER of 128-sample
    # frames instead of a per-sample jnp.take of the same span (124M
    # scalar gathers for N=512). The three dt variants are +0/+1/+2
    # frame shifts of ONE gathered span per candidate.
    FRAME = BLOCK_SIZE // 4                                     # 128
    n_frames = n_in // FRAME
    span_frames = _WINDOW_SAMPLES // FRAME + NDT - 1            # 318
    f0 = to * 4 + ts * 2 + 1              # frame of s0 at dt = -128
    fidx = f0[:, None] + jnp.arange(span_frames)[None, :]       # (N, 318)
    fidx_c = jnp.clip(fidx, 0, n_frames - 1) \
        + chan_idx[:, None] * n_frames
    frames_i = i_samples.reshape(-1, FRAME)                     # (B*375, 128)
    frames_q = q_samples.reshape(-1, FRAME)
    span_i = jnp.take(frames_i, fidx_c.reshape(-1), axis=0) \
        .reshape(N, span_frames, FRAME)
    span_q = jnp.take(frames_q, fidx_c.reshape(-1), axis=0) \
        .reshape(N, span_frames, FRAME)
    win_frames = _WINDOW_SAMPLES // FRAME                       # 316
    xi = jnp.stack([span_i[:, k:k + win_frames]
                    .reshape(N, FT8_NN, BLOCK_SIZE)
                    for k in range(NDT)], axis=1)
    xq = jnp.stack([span_q[:, k:k + win_frames]
                    .reshape(N, FT8_NN, BLOCK_SIZE)
                    for k in range(NDT)], axis=1)

    # downshift by the candidate's center frequency (local per-symbol
    # phase; noncoherent per-symbol energies don't need cross-symbol
    # phase continuity)
    f_c = (fo.astype(jnp.float32) + fs.astype(jnp.float32) / 2.0) \
        * TONE_SPACING_HZ                                       # (N,)
    u = jnp.arange(BLOCK_SIZE, dtype=jnp.float32)
    ph = (2.0 * jnp.pi / SIGNAL_SAMPLE_RATE) \
        * f_c[:, None] * u[None, :]                            # (N, 512)
    c = jnp.cos(ph)[:, None, None, :]
    s = jnp.sin(ph)[:, None, None, :]
    mi = xi * c + xq * s                                       # Re(x e^-jph)
    mq = xq * c - xi * s

    # project every symbol window onto the 24-tone basis (two GEMMs)
    cb, sb = map(jnp.asarray, _tone_basis())                   # (512, 24)
    kw = dict(precision=jax.lax.Precision.HIGHEST,
              preferred_element_type=jnp.float32)
    re = jnp.einsum("ndwu,uf->ndwf", mi, cb, **kw) \
        + jnp.einsum("ndwu,uf->ndwf", mq, sb, **kw)
    im = jnp.einsum("ndwu,uf->ndwf", mq, cb, **kw) \
        - jnp.einsum("ndwu,uf->ndwf", mi, sb, **kw)
    power = (re * re + im * im).reshape(N, NDT, FT8_NN, NDF, 8)

    # per-symbol validity (window fully inside the capture)
    sym_start = s0[..., None] + jnp.arange(FT8_NN)[None, None, :] \
        * BLOCK_SIZE                                           # (N, DT, 79)
    sym_valid = (sym_start >= 0) & (sym_start + BLOCK_SIZE <= n_in)
    power = power * sym_valid[..., None, None].astype(jnp.float32)

    # Costas power per variant -> pick best (dt, df)
    sync_p = power[:, :, jnp.asarray(_SYNC_SYM), :, :]
    sync_p = jnp.take_along_axis(
        sync_p, jnp.asarray(_SYNC_TONE)[None, None, :, None, None],
        axis=-1)[..., 0]                                       # (N,DT,21,DF)
    score = jnp.sum(sync_p, axis=2)                            # (N, DT, DF)
    flat = score.reshape(N, NDT * NDF)
    best = jnp.argmax(flat, axis=-1)                           # (N,)
    best_score = jnp.max(flat, axis=-1)

    # select the winning variant's (79, 8) powers via one-hot einsum
    onehot = jax.nn.one_hot(best, NDT * NDF, dtype=jnp.float32)
    pow_v = power.transpose(0, 1, 3, 2, 4) \
        .reshape(N, NDT * NDF, FT8_NN, 8)
    sel = jnp.einsum("nv,nvwj->nwj", onehot, pow_v, **kw)

    # log-domain max-log bit LLRs over the 58 data symbols; Gray demap:
    # symbol value j was transmitted on tone frequency GRAY_MAP[j]
    s2 = jnp.log(sel[:, jnp.asarray(_DATA_SYM), :]
                 [..., jnp.asarray(GRAY_MAP.astype(np.int32))] + 1e-12)
    set_mask = jnp.asarray(_BIT_SET)                           # (3, 8)
    s2e = s2[..., None, :]
    neg = jnp.float32(-1e30)
    max_set = jnp.max(jnp.where(set_mask, s2e, neg), axis=-1)
    max_clr = jnp.max(jnp.where(set_mask, neg, s2e), axis=-1)
    logl = (max_set - max_clr).reshape(N, FT8_LDPC_N)

    # ft8_lib-style variance normalization to sigma^2 = 24
    def _normalize(ll):
        ssum = jnp.sum(ll, axis=-1, keepdims=True)
        s2sum = jnp.sum(ll * ll, axis=-1, keepdims=True)
        inv_n = 1.0 / FT8_LDPC_N
        var = (s2sum - ssum * ssum * inv_n) * inv_n
        return ll * jnp.sqrt(24.0 / jnp.maximum(var, 1e-12))

    if not return_pair:
        return _normalize(logl), best_score

    # best-variant COMPLEX tone responses for the pair-coherent pass
    re_v = re.reshape(N, NDT, FT8_NN, NDF, 8).transpose(0, 1, 3, 2, 4) \
        .reshape(N, NDT * NDF, FT8_NN, 8)
    im_v = im.reshape(N, NDT, FT8_NN, NDF, 8).transpose(0, 1, 3, 2, 4) \
        .reshape(N, NDT * NDF, FT8_NN, 8)
    zr = jnp.einsum("nv,nvwj->nwj", onehot, re_v, **kw)     # (N, 79, 8)
    zi = jnp.einsum("nv,nvwj->nwj", onehot, im_v, **kw)
    dt_best = best // NDF
    valid_b = jnp.take_along_axis(
        sym_valid, dt_best[:, None, None], axis=1)[:, 0, :]  # (N, 79)
    zr = zr * valid_b[..., None]
    zi = zi * valid_b[..., None]
    cth, sth, theta = _costas_rotation(zr, zi)
    logl_pair = _pair_coherent_llrs(zr, zi, valid_b, cth, sth)
    # symbols without a valid pair partner fall back to the noncoherent
    # estimate (both normalized to the same sigma^2 first)
    def _blend(ll):
        has = jnp.isfinite(ll)
        return jnp.where(has, _normalize(jnp.where(has, ll, 0.0)),
                         _normalize(logl))
    logl_coh = _block_coherent_llrs(zr, zi, valid_b, theta)
    return _normalize(logl), best_score, _blend(logl_pair), \
        _blend(logl_coh)


def _costas_rotation(zr, zi):
    """Per-symbol residual-CFO rotation from the 18 consecutive Costas
    pairs (the same consecutive-gain-product statistic ops/subtract.py
    uses, CFO-immune by construction): the phase of
    sum z_{i+1}(c_{i+1}) conj(z_i(c_i)). Returns (cos, sin) of the
    rotation shaped (N, 1, 1) for broadcasting, and the angle itself."""
    c_sp1 = jnp.asarray(_SP1)
    c_sp2 = jnp.asarray(_SP2)
    z1r = zr[:, c_sp1, jnp.asarray(_SP1_TONE)]              # (N, 18)
    z1i = zi[:, c_sp1, jnp.asarray(_SP1_TONE)]
    z2r = zr[:, c_sp2, jnp.asarray(_SP2_TONE)]
    z2i = zi[:, c_sp2, jnp.asarray(_SP2_TONE)]
    pr = jnp.sum(z2r * z1r + z2i * z1i, axis=1)             # Re(z2 conj z1)
    pi_ = jnp.sum(z2i * z1r - z2r * z1i, axis=1)            # Im(z2 conj z1)
    nrm = jnp.maximum(jnp.sqrt(pr * pr + pi_ * pi_), 1e-12)
    return (pr / nrm)[:, None, None], (pi_ / nrm)[:, None, None], \
        jnp.arctan2(pi_, pr)


def _pair_coherent_llrs(zr, zi, valid, cth, sth):
    """174 bit LLRs from coherent sums over adjacent data symbols.

    FT8's tone spacing times its symbol time is exactly one cycle, so
    the per-symbol matched-filter outputs are phase-continuous across
    symbols up to the residual CFO; its per-symbol rotation is
    estimated from the 18 consecutive Costas pairs (the same
    consecutive-gain-product statistic ops/subtract.py uses, CFO-immune
    by construction). Adjacent TRIPLES then score all 512 joint tone
    hypotheses |z_k(a) + e^{-j.theta} z_{k+1}(b) + e^{-2j.theta}
    z_{k+2}(c)|^2 (the primary flavor — WSJT-X's nsym=3 analogue;
    measured 28/48 decodes at -20.5 dB vs the pair flavor's 15/48 and
    the noncoherent 0/48), with the 64-hypothesis PAIR metric as the
    fallback where a triple doesn't fit the validity window. Per-symbol
    value scores average the (log-domain) metrics each symbol
    participates in. Bits of symbols with no valid estimate return NaN
    (caller blends with the noncoherent LLRs). cth/sth are the
    _costas_rotation cos/sin, shaped (N, 1, 1).
    """
    dsym = jnp.asarray(_DATA_SYM)
    g = jnp.asarray(GRAY_MAP.astype(np.int32))
    # Gray-reorder once: column j = response on the tone of symbol value j
    zd_r = zr[:, dsym, :][..., g]                           # (N, 58, 8)
    zd_i = zi[:, dsym, :][..., g]
    vd = valid[:, dsym]                                     # (N, 58)
    N = zr.shape[0]
    set_mask = jnp.asarray(_BIT_SET)                        # (3, 8)
    neg = jnp.float32(-1e30)

    def bit_llrs(s2, cnt):
        s2e = s2[..., None, :]
        max_set = jnp.max(jnp.where(set_mask, s2e, neg), axis=-1)
        max_clr = jnp.max(jnp.where(set_mask, neg, s2e), axis=-1)
        logl = (max_set - max_clr).reshape(N, FT8_LDPC_N)
        has = jnp.repeat(cnt > 0, 3, axis=-1)               # (N, 174)
        return jnp.where(has, logl, jnp.nan)

    # --- pair estimates (fallback flavor at validity edges) ---
    pk = jnp.asarray(_PAIR_K)
    a_r, a_i = zd_r[:, pk], zd_i[:, pk]                     # (N, 56, 8)
    b_r, b_i = zd_r[:, pk + 1], zd_i[:, pk + 1]
    # rotate the second symbol back by the estimated inter-symbol phase
    b_r2 = b_r * cth + b_i * sth
    b_i2 = b_i * cth - b_r * sth
    sr = a_r[..., :, None] + b_r2[..., None, :]             # (N, 56, 8, 8)
    si = a_i[..., :, None] + b_i2[..., None, :]
    lm = jnp.log(sr * sr + si * si + 1e-12)
    pair_ok = (vd[:, pk] & vd[:, pk + 1]).astype(jnp.float32)
    est = jnp.zeros((N, FT8_ND, 8), jnp.float32)
    cnt = jnp.zeros((N, FT8_ND), jnp.float32)
    est = est.at[:, pk].add(jnp.max(lm, -1) * pair_ok[..., None])
    cnt = cnt.at[:, pk].add(pair_ok)
    est = est.at[:, pk + 1].add(jnp.max(lm, -2) * pair_ok[..., None])
    cnt = cnt.at[:, pk + 1].add(pair_ok)
    llr_pair = bit_llrs(est / jnp.maximum(cnt, 1.0)[..., None], cnt)

    # --- triple estimates (the primary flavor: measured 28/48 vs the
    # pair's 15/48 decodes at -20.5 dB; every data symbol is covered by
    # a triple inside its 29-symbol run) ---
    tk = jnp.asarray(_TRIPLE_K)
    c2r, c2i = cth * cth - sth * sth, 2.0 * sth * cth       # e^{-2j.theta}
    t1r, t1i = zd_r[:, tk], zd_i[:, tk]
    t2r = zd_r[:, tk + 1] * cth + zd_i[:, tk + 1] * sth
    t2i = zd_i[:, tk + 1] * cth - zd_r[:, tk + 1] * sth
    t3r = zd_r[:, tk + 2] * c2r + zd_i[:, tk + 2] * c2i
    t3i = zd_i[:, tk + 2] * c2r - zd_r[:, tk + 2] * c2i
    sr3 = (t1r[..., :, None, None] + t2r[..., None, :, None]
           + t3r[..., None, None, :])                       # (N, 54, 8, 8, 8)
    si3 = (t1i[..., :, None, None] + t2i[..., None, :, None]
           + t3i[..., None, None, :])
    lm3 = jnp.log(sr3 * sr3 + si3 * si3 + 1e-12)
    tri_ok = (vd[:, tk] & vd[:, tk + 1] & vd[:, tk + 2]) \
        .astype(jnp.float32)
    est3 = jnp.zeros((N, FT8_ND, 8), jnp.float32)
    cnt3 = jnp.zeros((N, FT8_ND), jnp.float32)
    for off, red in ((0, (-2, -1)), (1, (-3, -1)), (2, (-3, -2))):
        est3 = est3.at[:, tk + off].add(
            jnp.max(lm3, axis=red) * tri_ok[..., None])
        cnt3 = cnt3.at[:, tk + off].add(tri_ok)
    llr_tri = bit_llrs(est3 / jnp.maximum(cnt3, 1.0)[..., None], cnt3)

    # triple where available, else pair, else NaN (caller blends noncoh)
    return jnp.where(jnp.isfinite(llr_tri), llr_tri, llr_pair)


def _block_coherent_llrs(zr, zi, valid, theta):
    """174 bit LLRs from FULLY-COHERENT per-symbol demodulation.

    Beyond the nsym=3 triple flavor: derotate every symbol's tone
    responses by the Costas-pair residual-CFO estimate (the same
    statistic _pair_coherent_llrs uses), coherently sum each Costas
    block's 7 known-tone responses into an absolute carrier-phase
    anchor (k = 3 / 39 / 75), interpolate the anchor phasors linearly
    in the complex domain across each 29-symbol data run, and score
    each data symbol value as Re(z~_k(a) conj(ref_k)) — the classic
    coherent metric, O(58*8) per candidate vs the triple's 54*512
    joint-hypothesis tensor. (A grid search for the rotation that
    maximizes total coherent Costas power measured WORSE than the
    pair-product estimate — it overfits noise at the depths where the
    flavor matters; see scripts/coherent_ab.py.)

    Alone it trails the triple flavor by ~1 dB of decode count, but it
    errs on DIFFERENT trials, so BP-on-both unions +2..4/48 decodes at
    -21.0..-21.5 dB. Bits of symbols without both neighboring anchors
    (or outside the validity window) return NaN — the caller blends
    those with the noncoherent estimate. theta is the (N,)
    _costas_rotation angle.
    """
    # derotate symbol k by e^{-j k theta}
    k = jnp.arange(FT8_NN, dtype=jnp.float32)
    ck = jnp.cos(theta[:, None] * k[None, :])                 # (N, 79)
    sk = jnp.sin(theta[:, None] * k[None, :])
    ztr = zr * ck[..., None] + zi * sk[..., None]
    zti = zi * ck[..., None] - zr * sk[..., None]

    # Costas anchors: coherent sum of each block's 7 known-tone responses
    ssym = _SYNC_SYM.reshape(3, 7)
    stone = _SYNC_TONE.reshape(3, 7)
    ar, ai, a_ok = [], [], []
    for b in range(3):
        sb = jnp.asarray(ssym[b])
        w = valid[:, sb].astype(jnp.float32)                  # (N, 7)
        ar.append(jnp.sum(ztr[:, sb, jnp.asarray(stone[b])] * w, axis=1))
        ai.append(jnp.sum(zti[:, sb, jnp.asarray(stone[b])] * w, axis=1))
        a_ok.append(jnp.sum(w, axis=1) > 0)
    ar = jnp.stack(ar, axis=1)                                # (N, 3)
    ai = jnp.stack(ai, axis=1)
    a_ok = jnp.stack(a_ok, axis=1)                            # (N, 3)

    # per-data-symbol phase reference: complex interpolation between the
    # two flanking anchors (centers k = 3, 39, 75; every data symbol
    # lies between two of them)
    dsym = np.asarray(_DATA_SYM)
    centers = np.array([3.0, 39.0, 75.0])
    lo = np.where(dsym < 39, 0, 1)
    w = ((dsym - centers[lo]) / 36.0).astype(np.float32)      # (58,)
    lo_j = jnp.asarray(lo)
    w_j = jnp.asarray(w)
    rr = ar[:, lo_j] * (1 - w_j)[None, :] + ar[:, lo_j + 1] * w_j[None, :]
    ri = ai[:, lo_j] * (1 - w_j)[None, :] + ai[:, lo_j + 1] * w_j[None, :]
    nrm = jnp.maximum(jnp.sqrt(rr * rr + ri * ri), 1e-12)
    rr, ri = rr / nrm, ri / nrm                               # (N, 58)

    g = jnp.asarray(GRAY_MAP.astype(np.int32))
    dsym_j = jnp.asarray(dsym)
    zd_r = ztr[:, dsym_j, :][..., g]                          # (N, 58, 8)
    zd_i = zti[:, dsym_j, :][..., g]
    score = zd_r * rr[..., None] + zd_i * ri[..., None]       # Re(z conj ref)

    set_mask = jnp.asarray(_BIT_SET)
    neg = jnp.float32(-1e30)
    s2e = score[..., None, :]
    max_set = jnp.max(jnp.where(set_mask, s2e, neg), axis=-1)
    max_clr = jnp.max(jnp.where(set_mask, neg, s2e), axis=-1)
    N = zr.shape[0]
    logl = (max_set - max_clr).reshape(N, FT8_LDPC_N)
    sym_ok = valid[:, dsym_j] & a_ok[:, lo_j] & a_ok[:, lo_j + 1]
    has = jnp.repeat(sym_ok, 3, axis=-1)                      # (N, 174)
    return jnp.where(has, logl, jnp.nan)


def refine_llrs(i_samples: jax.Array, q_samples: jax.Array, cand_sel: dict):
    """(B, M)-shaped wrapper over refine_llrs_flat."""
    ts = cand_sel["time_sub"]
    B, M = ts.shape
    chan = jnp.repeat(jnp.arange(B, dtype=jnp.int32), M)
    flat = {k: v.reshape(-1) for k, v in cand_sel.items()}
    llrs, score = refine_llrs_flat(i_samples, q_samples, flat, chan)
    return llrs.reshape(B, M, -1), score.reshape(B, M)
