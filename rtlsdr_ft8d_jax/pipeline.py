"""End-to-end FT8 window decode: the batched `ft8_subsystem`.

The reference's per-window pipeline (/root/reference/rtlsdr_ft8d.c:1387-1524)
— waterfall STFT -> Costas sync search -> per-candidate LLR + LDPC + CRC ->
dedup -> spot extraction — rebuilt as ONE jitted batched graph over a
channels axis, with only unpack/dedup on the host (a few survivors per
window). Stages:

  decode_window_device (jit): (B, 48000) complex -> per-candidate hard bits,
    LDPC residual errors, CRC flags, candidate metadata.
  decode_window (host): runs the device graph, unpacks/dedups survivors and
    returns per-channel Decode lists.
"""

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .ops.ldpc import bp_decode, crc_check
from .ops.llr import estimate_snr, extract_llrs
from .ops.sync import find_sync
from .ops.waterfall import waterfall
from .protocol.constants import (FT8_LDPC_K, K_LDPC_ITERS, K_MAX_CANDIDATES,
                                 K_MAX_MESSAGES, K_MIN_SCORE, TONE_SPACING_HZ)
from .protocol.text import CallsignHashTable
from .protocol.unpack import UnpackError, unpack_spot, unpack_spots_batch


@dataclass
class Decode:
    """One decoded message (reference `decoder_results` + full text).

    call/loc/is_cq come from the 77-bit payload FIELDS when the decode was
    produced by the pipeline (protocol/unpack.py:unpack_spot); the text
    heuristics below are only the fallback for hand-constructed instances
    (the reference strtok-parses text, c:1509-1521, which misparses
    'CQ RAEM KO85')."""
    text: str
    freq_hz: float
    time_sec: float
    score: int
    snr_db: float = 0.0
    call_field: str | None = None
    loc_field: str | None = None
    cq_field: bool | None = None

    @property
    def is_cq(self) -> bool:
        if self.cq_field is not None:
            return self.cq_field
        return self.text.startswith("CQ")

    @property
    def call(self) -> str:
        if self.call_field is not None:
            return self.call_field
        parts = self.text.split()
        if self.is_cq:
            # 'CQ CALL GRID' or directed 'CQ DX|nnn|AAAA CALL GRID'
            idx = 1
            if len(parts) > 3 and (parts[1] == "DX" or parts[1].isdigit()
                                   or (parts[1].isalpha()
                                       and len(parts[1]) <= 4)):
                idx = 2
            return parts[idx] if len(parts) > idx else ""
        return parts[0] if parts else ""

    @property
    def loc(self) -> str:
        if self.loc_field is not None:
            return self.loc_field
        if not self.is_cq:
            return ""
        parts = self.text.split()
        return parts[-1] if len(parts) >= 3 and len(parts[-1]) == 4 else ""


def ap_prefix_for_call(call: str) -> np.ndarray | None:
    """(77,) ±1/0 clamp row hypothesizing a message addressed TO `call`
    (the operator's own callsign in the daemon); None if the call has no
    fixed c28 bits. Thin wrapper over ops/ap.py (the AP module)."""
    from .ops.ap import clamp_row_to_call
    return clamp_row_to_call(call)


def deep_rungs(llr_ref, llr_pair, was_failed, score_sel, ap_rows,
               ap_cw_signs, ldpc_iters, llr_coh=None):
    """The deep-decode rung ladder on a FLAT refined candidate selection,
    shared by the single-chip graph and the sharded dense path
    (parallel/dense.py): BP on the noncoherent refined LLRs, BP on the
    pair/triple-coherent LLRs (ops/refine.py — WSJT-X's multi-symbol
    combining, measured 24/32 vs 10/32 decodes at -20 dB), BP on the
    BLOCK-COHERENT LLRs (Costas-anchored fully-coherent demodulation —
    weaker alone but decodes a DIFFERENT subset: union +2..4/48 at
    -21.0..-21.5 dB, scripts/coherent_ab.py), AP clamp hypotheses on
    ALL THREE flavors (the block-coherent clamps union +1..3/48 more,
    scripts/ap_coh_ab.py), and the continuation codeword bank scored
    against the noncoherent and triple flavors (their nulls: max
    0.470/0.372 over 4.1M noise trials vs the 0.58/0.55 gate; the
    block-coherent flavor's bank null is also safe but it added ZERO
    decodes — scripts/bank_coh_null.py — so it is not scored). Every
    acceptance is CRC-14-gated and restricted to candidates that
    genuinely failed the main pass.

    Returns (hard_r, ok_r, post_r, post_c): merged hard bits, accept
    mask, and the BP posteriors of the triple-coherent and the
    block-coherent flavors for host OSD (triple posteriors measured
    strictly better than the noncoherent ones — 19 vs 4 recoveries at
    -20.5 dB; a second OSD attempt on the block-coherent posteriors
    recovers +1..2/48 more at -21..-22 dB, scripts/osd_coh_ab.py).
    post_c is None when llr_coh is None."""
    from .ops.ap import apply_clamp, bank_correlate

    # Every rung's BP is independent of every other rung's, so the whole
    # ladder — plain rungs plus one clamped copy per (AP row, flavor) —
    # runs as ONE batched bp_decode along a leading rung axis: a single
    # 20-iteration loop instead of 3 + 3*len(ap_rows) sequential loops
    # (the per-rung results are bit-identical; only the launch count
    # changes). Acceptance still cascades in the original priority
    # order below. The coherent flavor's AP clamps union +1..3/48
    # decodes at -21.5..-22.5 dB over clamping the first two flavors
    # only (scripts/ap_coh_ab.py).
    rungs = [llr_ref, llr_pair]
    if llr_coh is not None:
        rungs.append(llr_coh)
    ap_bases = (llr_pair, llr_ref) if llr_coh is None \
        else (llr_pair, llr_coh, llr_ref)
    for signs in ap_rows:
        for llr_base in ap_bases:
            rungs.append(apply_clamp(llr_base, signs))
    hard_all, err_all, post_all = bp_decode(
        jnp.stack(rungs, axis=0), ldpc_iters, return_posterior=True)
    ok_all = (err_all == 0) & crc_check(hard_all) & was_failed[None, :]
    post_r = post_all[1]
    post_c = post_all[2] if llr_coh is not None else None

    hard_r = hard_all[0]
    ok_r = ok_all[0]
    for m in range(1, len(rungs)):
        ok_m = ok_all[m] & ~ok_r
        hard_r = jnp.where(ok_m[:, None], hard_all[m], hard_r)
        ok_r = ok_r | ok_m
    if ap_cw_signs is not None:
        for llr_b in (llr_ref, llr_pair):
            hit_r, bits_r = bank_correlate(llr_b, ap_cw_signs, score_sel)
            ok_cw_r = hit_r & was_failed & ~ok_r
            hard_r = jnp.where(ok_cw_r[:, None],
                               bits_r.astype(hard_r.dtype), hard_r)
            ok_r = ok_r | ok_cw_r
    return hard_r, ok_r, post_r, post_c


@functools.partial(jax.jit,
                   static_argnames=("num_candidates", "ldpc_iters", "ap_cq",
                                    "budget", "osd_cands", "sync_exact"))
def decode_window_device(i_samples: jax.Array, q_samples: jax.Array,
                         num_candidates: int = K_MAX_CANDIDATES,
                         ldpc_iters: int = K_LDPC_ITERS,
                         ap_cq: bool = False,
                         budget: int | None = None,
                         osd_cands: int = 0,
                         ap_clamp_signs: jax.Array | None = None,
                         ap_cw_signs: jax.Array | None = None,
                         sync_exact: bool = False):
    """Device-side decode graph (float32 I/Q, no complex dtypes on device —
    mirrors the reference's `ft8_subsystem(iSamples, qSamples, ...)` API,
    rtlsdr_ft8d.c:1387).

    Args:
      i_samples, q_samples: (B, 48000) float32 baseband channels at 3200 sps.

    Returns the compacted survivor dict (see compact_survivors): packed
    12-byte payloads + metadata for <=50 CRC-clean candidates per channel,
    plus osd_* fields when osd_cands > 0.
    """
    # Per-window normalization to -3 dB peak (reference C9 normalizer,
    # rtlsdr_ft8d.c:242-263): decode quality must not depend on capture gain.
    peak = jnp.maximum(
        jnp.max(jnp.abs(i_samples), axis=-1, keepdims=True),
        jnp.max(jnp.abs(q_samples), axis=-1, keepdims=True))
    scale = 0.5 / jnp.maximum(peak, 1e-12)
    i_samples = i_samples * scale
    q_samples = q_samples * scale

    # optimization_barrier between stages: the stage interfaces are small
    # materialized tensors, and the barriers keep XLA from fusing and
    # re-laying-out the whole graph at once, which made compile time grow
    # super-linearly with batch on the accelerator the graph was first
    # built for (whether they still pay on the GPU is ROADMAP D2).
    wf = waterfall(i_samples, q_samples)
    wf = jax.lax.optimization_barrier(wf)
    # sync_exact=True replaces the two-stage chunked top-K with a full
    # sort of all 35,856 cells (exactness escape hatch for pathologically
    # dense bands — see PERF.md (two-stage top-K) for the measured miss
    # behavior; the chunked default is exact up to 4 co-chunk signals).
    cand = find_sync(wf, num_candidates, exact=sync_exact)
    cand = jax.lax.optimization_barrier(cand)
    B, K = cand["score"].shape

    # budget in (None, 0) means unbudgeted (an explicit --budget 0 must not
    # run top_k with k=0 and silently decode nothing)
    if budget and budget < B * K:
        # Global candidate budget (single-chip analogue of the dense
        # path's all-gathered threshold): gather the top-`budget` scoring
        # candidates ACROSS channels into a compact axis, extract LLRs
        # and run BP only for those, scatter back. On a quiet wide band
        # nearly every channel's candidates are noise below the cut, so
        # BOTH the pipeline's hottest gather (tone magnitudes) and the BP
        # loop shrink from B*K to `budget` instances.
        flat_score = cand["score"].reshape(-1)               # (B*K,)
        _, sel = jax.lax.top_k(flat_score, budget)
        chan_idx = sel // K
        cand_flat = {k: cand[k].reshape(-1)[sel] for k in
                     ("time_sub", "freq_sub", "time_offset", "freq_offset")}
        from .ops.llr import extract_llrs_flat
        llrs = extract_llrs_flat(wf, cand_flat, chan_idx)    # (budget, 174)
        llrs = jax.lax.optimization_barrier(llrs)

        def run_bp(llrs_in):
            hard_sel, errors_sel = bp_decode(llrs_in, ldpc_iters)
            hard_f = (jnp.zeros((B * K, hard_sel.shape[-1]), hard_sel.dtype)
                      .at[sel].set(hard_sel).reshape(B, K, -1))
            errors_f = (jnp.full((B * K,), 83, errors_sel.dtype)
                        .at[sel].set(errors_sel).reshape(B, K))
            return hard_f, errors_f
    else:
        llrs = extract_llrs(wf, cand)                        # (B, K, 174)
        llrs = jax.lax.optimization_barrier(llrs)
        run_bp = lambda llrs_in: bp_decode(llrs_in, ldpc_iters)

    hard, errors = run_bp(llrs)
    ok = (errors == 0) & crc_check(hard) & (cand["score"] >= K_MIN_SCORE)

    # A-priori clamp passes (WSJT-X-style AP ladder, half 1 — see
    # ops/ap.py): clamp the known payload bits of an open-ended
    # hypothesized message form (0 in the row = free bit) to
    # high-confidence values and re-run BP; accept only where the full
    # CRC-14 still passes. Hypotheses: the universal "CQ ..." prefix
    # (ap_cq) plus caller-supplied rows — e.g. the operator's own
    # callsign, which recovers replies addressed TO this station ~1 dB
    # deeper. (llrs is either the full (B, K, 174) tensor or the
    # budgeted (budget, 174) selection; the clamp and BP runner handle
    # both shapes.)
    from .ops.ap import apply_clamp, clamp_row_cq
    ap_rows = []
    if ap_cq:
        ap_rows.append(jnp.asarray(clamp_row_cq()))
    if ap_clamp_signs is not None:
        for h in range(ap_clamp_signs.shape[0]):       # static shape
            ap_rows.append(ap_clamp_signs[h])
    for signs in ap_rows:
        hard_ap, errors_ap = run_bp(apply_clamp(llrs, signs))
        ok_ap = (errors_ap == 0) & crc_check(hard_ap) \
            & (cand["score"] >= K_MIN_SCORE) & ~ok
        hard = jnp.where(ok_ap[..., None], hard_ap, hard)
        errors = jnp.where(ok_ap, 0, errors)
        ok = ok | ok_ap

    # AP ladder half 2 — enumeration bank (ops/ap.py): every closed
    # hypothesis (QSO continuations) is a complete codeword; ONE matmul
    # scores all candidates against all hypotheses, and a
    # candidate is accepted through the laddered correlation gate
    # (corr > AP_CW_THRESH, or corr > AP_CW_THRESH_SYNCED with real
    # sync evidence). No BP at all: a batched matched-filter bank.
    if ap_cw_signs is not None:
        from .ops.ap import bank_correlate

        def bank_gate(llrs_in, scores_in):
            hit, bits = bank_correlate(llrs_in, ap_cw_signs, scores_in)
            return (hit & (scores_in >= K_MIN_SCORE),
                    bits.astype(hard.dtype))

        if llrs.ndim == 2:       # budgeted: scatter flat hits back
            score_f = cand["score"].reshape(-1)[sel]
            ok_f = ok.reshape(-1)[sel]
            hit_f, hard_cw = bank_gate(llrs, score_f)
            acc_f = hit_f & ~ok_f
            hard_flat = hard.reshape(B * K, -1)
            hard = hard_flat.at[sel].set(
                jnp.where(acc_f[:, None], hard_cw, hard_flat[sel])) \
                .reshape(B, K, -1)
            errors = errors.reshape(-1).at[sel].set(
                jnp.where(acc_f, 0, errors.reshape(-1)[sel])) \
                .reshape(B, K)
            ok = ok.reshape(-1).at[sel].set(ok_f | acc_f).reshape(B, K)
        else:
            hit, hard_cw = bank_gate(llrs, cand["score"])
            acc = hit & ~ok
            hard = jnp.where(acc[..., None], hard_cw, hard)
            errors = jnp.where(acc, 0, errors)
            ok = ok | acc

    if osd_cands > 0:
        # Deep-decode retry for the best BP-failed candidates: re-derive
        # UNQUANTIZED tone magnitudes from the raw samples on a finer
        # (dt, df) grid (ops/refine.py matched filters), re-run BP on the
        # refined LLRs — successes merge back as full decodes — and ship
        # the refined POSTERIORS of the still-failed ones to the host for
        # ordered-statistics reprocessing (ops/osd.py). The selection is
        # FLAT and globally capped: a 1500-channel wideband window refines
        # the same few hundred best failures as a small batch (refine's
        # gathers would otherwise scale with B to multi-GB tensors).
        from .ops.llr import estimate_snr_flat
        from .ops.refine import refine_llrs_flat

        n_osd = min(B * osd_cands, 1024, B * K)
        failed = (errors > 0) & (cand["score"] >= K_MIN_SCORE)
        flat_rank = jnp.where(failed, cand["score"], -1).reshape(-1)
        _, sel_f = jax.lax.top_k(flat_rank, n_osd)        # best failures
        chan_f = sel_f // K
        cand_sel = {k: cand[k].reshape(-1)[sel_f] for k in
                    ("time_sub", "freq_sub", "time_offset", "freq_offset")}
        llr_ref, _ref_score, llr_pair, llr_coh = refine_llrs_flat(
            i_samples, q_samples, cand_sel, chan_f, return_pair=True)
        was_failed = failed.reshape(-1)[sel_f]
        score_sel = cand["score"].reshape(-1)[sel_f]
        hard_r, ok_r, post_r, post_c = deep_rungs(
            llr_ref, llr_pair, was_failed, score_sel, ap_rows,
            ap_cw_signs, ldpc_iters, llr_coh=llr_coh)
        hard_flat = hard.reshape(B * K, -1)
        hard = hard_flat.at[sel_f].set(
            jnp.where(ok_r[:, None], hard_r, hard_flat[sel_f])) \
            .reshape(B, K, -1)
        err_flat = errors.reshape(-1)
        errors = err_flat.at[sel_f].set(
            jnp.where(ok_r, 0, err_flat[sel_f])).reshape(B, K)
        ok_flat = ok.reshape(-1)
        ok = ok_flat.at[sel_f].set(ok_flat[sel_f] | ok_r).reshape(B, K)

    out = compact_survivors(wf, cand, hard, errors, ok)

    if osd_cands > 0:
        out["osd_post"] = post_r                       # (n_osd, 174)
        out["osd_post_coh"] = post_c                   # (n_osd, 174)
        out["osd_valid"] = was_failed & ~ok_r          # (n_osd,)
        out["osd_chan"] = chan_f.astype(jnp.int32)
        out["osd_score"] = score_sel.astype(jnp.int32)
        out["osd_snr_db"] = estimate_snr_flat(wf, cand_sel, chan_f)
        out["osd_time_sub"] = cand_sel["time_sub"].astype(jnp.uint8)
        out["osd_freq_sub"] = cand_sel["freq_sub"].astype(jnp.uint8)
        out["osd_time_offset"] = cand_sel["time_offset"].astype(jnp.int8)
        out["osd_freq_offset"] = cand_sel["freq_offset"] \
            .astype(jnp.int32)
    return out


def compact_survivors(wf, cand, hard, errors, ok):
    """Device-side survivor compaction: keep at most K_MAX_MESSAGES (50, the
    reference's per-window cap, rtlsdr_ft8d.h:46) CRC-clean candidates per
    channel and bit-pack their 91 message bits into 12 bytes — the host
    only ever sees a few KB per window instead of the full candidate set.
    Shared by the single-chip graph and the dense-band sharded path."""
    order = jnp.argsort(jnp.where(ok, -cand["score"], 1 << 20), axis=-1,
                        stable=True)[..., :K_MAX_MESSAGES]
    take = lambda x: jnp.take_along_axis(x, order, axis=-1)
    hard_k = jnp.take_along_axis(
        hard[..., :FT8_LDPC_K], order[..., None], axis=-2)
    # pack 91 bits -> 12 bytes (5 trailing pad bits)
    pad = jnp.zeros(hard_k.shape[:-1] + (96 - FT8_LDPC_K,), hard_k.dtype)
    bits96 = jnp.concatenate([hard_k, pad], axis=-1)
    weights = jnp.asarray(
        np.array([128, 64, 32, 16, 8, 4, 2, 1], dtype=np.int32))
    packed = jnp.sum(bits96.reshape(bits96.shape[:-1] + (12, 8))
                     .astype(jnp.int32) * weights, axis=-1).astype(jnp.uint8)
    # SNR is only needed for the <=50 kept survivors — estimating it for
    # every candidate re-ran the waterfall tone gather on the full (B, K)
    # set (one of the graph's hottest ops at production budgets)
    cand50 = {k: take(cand[k]) for k in
              ("time_sub", "freq_sub", "time_offset", "freq_offset")}
    snr50 = jnp.round(estimate_snr(wf, cand50) * 2.0).astype(jnp.int32) / 2.0
    return {
        "packed": packed,                                 # (B, 50, 12) uint8
        "n_ok": jnp.sum(ok.astype(jnp.int32), axis=-1),   # (B,)
        "n_above_min": jnp.sum((cand["score"] >= K_MIN_SCORE)
                               .astype(jnp.int32), axis=-1),
        "n_ldpc_ok": jnp.sum((errors == 0).astype(jnp.int32), axis=-1),
        "ok": take(ok),
        "score": take(cand["score"]).astype(jnp.int32),
        "snr_db": snr50,
        "time_sub": cand50["time_sub"].astype(jnp.uint8),
        "freq_sub": cand50["freq_sub"].astype(jnp.uint8),
        "time_offset": cand50["time_offset"].astype(jnp.int8),
        "freq_offset": cand50["freq_offset"].astype(jnp.int32),
    }


def _decode_pass(i_s, q_s, hashes, num_candidates, ldpc_iters,
                 ap_cq=False, budget=None, osd_cands=0,
                 ap_clamp_signs=None, ap_cw_signs=None, sync_exact=False):
    """One device pass + host unpack. Returns (per-channel decode lists,
    per-channel subtraction params, raw out dict).

    `hashes` may be one CallsignHashTable shared by all channels, or a
    list with one table per batch row (multi-band daemon: each band keeps
    its own hashed-callsign context)."""
    out_dev = decode_window_device(
        jnp.asarray(i_s), jnp.asarray(q_s), num_candidates, ldpc_iters,
        ap_cq, budget, osd_cands, ap_clamp_signs, ap_cw_signs,
        sync_exact)
    out = jax.device_get(out_dev)
    results, sub_params = unpack_survivors(out, i_s.shape[0], hashes)
    if osd_cands > 0:
        out["n_osd_recovered"] = _merge_osd_decodes(out, results,
                                                    sub_params, hashes)
    return results, sub_params, out


def _merge_osd_decodes(out, results, sub_params, hashes):
    """Host OSD reprocessing of the BP-failed candidates the device
    shipped (posterior LLRs), merging CRC-clean recoveries into the
    per-channel decode lists."""
    from .ops.osd import osd_batch

    valid = np.asarray(out["osd_valid"])            # (n_osd,)
    n_idx = np.nonzero(valid)[0]
    if n_idx.size == 0:
        return 0
    chan = np.asarray(out["osd_chan"])
    post = np.asarray(out["osd_post"])[n_idx]
    msgs, accept = osd_batch(post)
    # second attempt on the block-coherent posteriors for the
    # rows the triple-flavor attempt rejected (+1..2/48
    # recoveries at -21..-22 dB, scripts/osd_coh_ab.py);
    # incremental host cost tracks the reject count only
    post_c = out.get("osd_post_coh")
    if post_c is not None:
        rej = np.nonzero(~accept)[0]
        if rej.size:
            msgs2, accept2 = osd_batch(
                np.asarray(post_c)[n_idx][rej])
            hit = np.nonzero(accept2)[0]
            msgs[rej[hit]] = msgs2[hit]
            accept[rej[hit]] = True
    per_row = isinstance(hashes, (list, tuple))
    n_recovered = 0
    for j, n in enumerate(n_idx):
        if not accept[j]:
            continue
        b = int(chan[n])
        # false-decode gates beyond the CRC: OSD reprocessing only trusts
        # candidates with real sync evidence (score >= 13; pure-noise
        # candidates cluster at 10-12), and never surfaces raw-typed
        # payloads (a genuine type-5..7 signal surviving only via OSD is
        # vastly less likely than a 14-bit CRC collision)
        if out["osd_score"][n] < 13:
            continue
        row_hashes = hashes[b] if per_row else hashes
        try:
            text, call, loc, is_cq = unpack_spot(msgs[j][:77], row_hashes)
        except UnpackError:
            continue
        if text.startswith("<type"):
            continue
        if any(d.text == text for d in results[b]):
            continue
        freq_hz = (out["osd_freq_offset"][n]
                   + out["osd_freq_sub"][n] / 2.0) * TONE_SPACING_HZ
        time_sec = (out["osd_time_offset"][n]
                    + out["osd_time_sub"][n] / 2.0) * 0.16
        results[b].append(Decode(
            text=text, freq_hz=float(freq_hz), time_sec=float(time_sec),
            score=int(out["osd_score"][n]),
            snr_db=float(np.round(out["osd_snr_db"][n] * 2.0) / 2.0),
            call_field=call, loc_field=loc, cq_field=is_cq))
        sub_params[b].append((msgs[j],
                              int(out["osd_freq_offset"][n]) * 2
                              + int(out["osd_freq_sub"][n]),
                              int(out["osd_time_offset"][n]) * 2
                              + int(out["osd_time_sub"][n])))
        n_recovered += 1
    return n_recovered


def unpack_survivors(out, n_channels, hashes=None):
    """Host side of a decode pass: batched unpack + dedup of the
    device-compacted survivors. ONE native call covers every survivor of
    every channel (hash-table side effects stay sequential in (channel,
    rank) order, identical to a per-message loop). Split out so bench.py
    can time the host cost separately from device dispatch."""
    per_row_hashes = isinstance(hashes, (list, tuple))
    results = [[] for _ in range(n_channels)]
    sub_params = [[] for _ in range(n_channels)]
    ok_mask = np.asarray(out["ok"])
    b_idx, k_idx = np.nonzero(ok_mask)
    if b_idx.size == 0:
        return results, sub_params
    packed = np.asarray(out["packed"])[b_idx, k_idx]       # (N, 12)
    if per_row_hashes:
        # group by channel so each band's adds/lookups hit its own table
        spots = []
        start = 0
        while start < b_idx.size:
            end = start
            while end < b_idx.size and b_idx[end] == b_idx[start]:
                end += 1
            spots.extend(unpack_spots_batch(packed[start:end],
                                            hashes[b_idx[start]]))
            start = end
    else:
        spots = unpack_spots_batch(packed, hashes)
    bits_all = np.unpackbits(packed, axis=1)               # (N, 96)
    freq_off = np.asarray(out["freq_offset"])[b_idx, k_idx]
    freq_sub = np.asarray(out["freq_sub"])[b_idx, k_idx]
    time_off = np.asarray(out["time_offset"])[b_idx, k_idx]
    time_sub = np.asarray(out["time_sub"])[b_idx, k_idx]
    score = np.asarray(out["score"])[b_idx, k_idx]
    snr = np.asarray(out["snr_db"])[b_idx, k_idx]
    seen = [None] * n_channels
    for n in range(b_idx.size):
        spot = spots[n]
        if spot is None:
            continue
        b = int(b_idx[n])
        text, call, loc, is_cq = spot
        if seen[b] is None:
            seen[b] = set()
        if text in seen[b]:
            continue
        seen[b].add(text)
        freq_hz = (freq_off[n] + freq_sub[n] / 2.0) * TONE_SPACING_HZ
        time_sec = (time_off[n] + time_sub[n] / 2.0) * 0.16
        results[b].append(Decode(text=text, freq_hz=float(freq_hz),
                                 time_sec=float(time_sec),
                                 score=int(score[n]),
                                 snr_db=float(snr[n]),
                                 call_field=call, loc_field=loc,
                                 cq_field=is_cq))
        sub_params[b].append((bits_all[n, :91],
                              int(freq_off[n]) * 2 + int(freq_sub[n]),
                              int(time_off[n]) * 2 + int(time_sub[n])))
    return results, sub_params


def decode_window(iq, hashes: CallsignHashTable | None = None,
                  num_candidates: int = K_MAX_CANDIDATES,
                  ldpc_iters: int = K_LDPC_ITERS,
                  return_stats: bool = False,
                  passes: int = 1,
                  ap_cq: bool = False,
                  budget: int | None = None,
                  osd_cands: int = 0,
                  ap_call: str | None = None,
                  ap_texts=None,
                  sync_exact: bool = False):
    """Decode a batch of channels; returns list (per channel) of Decode lists.

    `iq` may be (48000,) or (B, 48000), complex or a (i, q) tuple of float32.
    `hashes`: one CallsignHashTable or a per-channel list (multi-band).
    `passes`: multipass subtraction decoding (WSJT-X-style).
    `ap_cq` / `ap_call`: a-priori clamp hypotheses (universal CQ and/or
      the operator's own callsign — ops/ap.py).
    `ap_texts`: complete hypothesized message texts (QSO continuations)
      scored as a codeword enumeration bank; may also be a
      prebuilt (H, 174) ±1/0 sign array (QsoTracker.codeword_signs).
    `budget`: global candidate budget — LDPC + LLR extraction only for
      the N best-scoring candidates across the whole batch.
    `osd_cands`: per-channel quota for the deep-decode retry (matched-
      filter refinement + BP + OSD; globally capped at 1024 candidates).
    """
    if isinstance(iq, tuple):
        i_s, q_s = (np.asarray(iq[0], np.float32), np.asarray(iq[1],
                                                              np.float32))
    else:
        iq = np.asarray(iq)
        i_s = np.real(iq).astype(np.float32)
        q_s = np.imag(iq).astype(np.float32)
    if i_s.ndim == 1:
        i_s, q_s = i_s[None], q_s[None]
        squeeze = True
    else:
        squeeze = False

    ap_clamp_signs = None
    if ap_call:
        row = ap_prefix_for_call(ap_call)
        if row is not None:
            ap_clamp_signs = jnp.asarray(row[None, :])
    ap_cw_signs = None
    if ap_texts is not None:
        if isinstance(ap_texts, np.ndarray):
            ap_cw_signs = jnp.asarray(ap_texts)
        else:
            from .ops.ap import codeword_signs
            # pad to a power-of-two bucket (>=64) so the jitted graph's
            # shape — and the compile cache — stays stable as the
            # hypothesis set evolves window to window
            bank = codeword_signs(ap_texts)
            if bank is not None:
                h = 64
                while h < bank.shape[0]:
                    h *= 2
                if h > bank.shape[0]:       # pad with inert all-zero rows
                    bank = np.concatenate([bank, np.zeros(
                        (h - bank.shape[0], bank.shape[1]), np.float32)])
                ap_cw_signs = jnp.asarray(bank)
    results, sub_params, out = _decode_pass(i_s, q_s, hashes,
                                            num_candidates, ldpc_iters,
                                            ap_cq, budget, osd_cands,
                                            ap_clamp_signs, ap_cw_signs,
                                            sync_exact)
    outs = [out]                       # per-pass stats, summed at the end

    # Multi-pass: subtract every decoded signal and decode the residual
    # (WSJT-X-style; neither the reference nor ft8_lib has this).
    for _ in range(passes - 1):
        if not any(sub_params):
            break
        from .ops.subtract import subtract_signals
        from .protocol.encode import codeword_to_tones, ldpc_encode
        B = i_s.shape[0]
        MAXM = 16
        tones = np.zeros((B, MAXM, 79), np.int32)
        fbin2 = np.zeros((B, MAXM), np.int32)
        start2 = np.zeros((B, MAXM), np.int32)
        valid = np.zeros((B, MAXM), bool)
        for b, params in enumerate(sub_params):
            for m, (bits91, fb2, st2) in enumerate(params[:MAXM]):
                tones[b, m] = codeword_to_tones(ldpc_encode(bits91))
                fbin2[b, m] = fb2
                start2[b, m] = st2
                valid[b, m] = True
        i_r, q_r = subtract_signals(
            jnp.asarray(np.ascontiguousarray(i_s, np.float32)),
            jnp.asarray(np.ascontiguousarray(q_s, np.float32)),
            jnp.asarray(tones), jnp.asarray(fbin2), jnp.asarray(start2),
            jnp.asarray(valid), MAXM)
        i_s = np.asarray(i_r)
        q_s = np.asarray(q_r)
        res2, sub_params, out2 = _decode_pass(i_s, q_s, hashes,
                                              num_candidates, ldpc_iters,
                                              ap_cq, budget, osd_cands,
                                              ap_clamp_signs, ap_cw_signs,
                                              sync_exact)
        outs.append(out2)
        for b in range(B):
            known = {d.text for d in results[b]}
            new = [d for d in res2[b] if d.text not in known]
            results[b].extend(new)
            # only subtract the NEW signals on the next pass
            sub_params[b] = [p for p, d in zip(sub_params[b], res2[b])
                             if d.text not in known]
    if return_stats:
        from .host.log import WindowStats
        # sum counters over ALL passes so subtraction-pass recoveries are
        # reflected (messages_unique already counts every pass)
        stats = WindowStats(
            channels=i_s.shape[0],
            candidates_scored=len(outs) * i_s.shape[0] * num_candidates,
            candidates_above_min=sum(int(np.sum(o["n_above_min"]))
                                     for o in outs),
            ldpc_converged=sum(int(np.sum(o["n_ldpc_ok"])) for o in outs),
            crc_passed=sum(int(np.sum(o["n_ok"])) for o in outs),
            messages_unique=sum(len(r) for r in results),
            extra=({"osd_recovered": sum(int(o["n_osd_recovered"])
                                         for o in outs)}
                   if "n_osd_recovered" in out else {}),
        )
        return (results[0] if squeeze else results), stats
    return results[0] if squeeze else results
