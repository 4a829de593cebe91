"""Pod-scale dense-band decode: global candidate budgeting via collectives.

BASELINE.json config 5 ("1000+ channels, deep Costas time/freq oversampling
+ max LDPC iterations across N>=2 hosts"): when thousands of channels are
sharded over a ('host','chip') mesh, the per-window LDPC budget should go to
the globally strongest candidates, not a fixed per-channel quota. Inside
shard_map each device scores its channels locally, the per-candidate score
lists are all-gathered over the mesh (between the cards of a host,
then across hosts), and a single global score threshold selects which candidates spend
BP iterations — the distributed analogue of the reference's single-channel
top-120 heap (rtlsdr_ft8d.c:1450).
"""


import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.ldpc import bp_decode, crc_check
from ..ops.llr import extract_llrs
from ..ops.sync import find_sync
from ..ops.waterfall import waterfall
from ..protocol.constants import (K_LDPC_ITERS, K_MAX_CANDIDATES,
                                  K_MIN_SCORE)

CHANNEL_AXIS = "ch"


def make_grid_mesh(hosts: int, chips: int) -> Mesh:
    """('host', 'chip') mesh — channels shard over both axes; collectives
    stay within a host row's cards and cross hosts once."""
    devs = np.asarray(jax.devices()[:hosts * chips]).reshape(hosts, chips)
    return Mesh(devs, ("host", "chip"))


def decode_window_dense(i_samples, q_samples, mesh: Mesh,
                        global_budget: int,
                        num_candidates: int = K_MAX_CANDIDATES,
                        ldpc_iters: int = K_LDPC_ITERS,
                        osd_cands_global: int = 0,
                        ap_clamp_signs=None,
                        ap_cw_signs=None):
    """Decode channels sharded over the mesh with a GLOBAL candidate budget.

    Args:
      i_samples, q_samples: (B, 48000) float32, B divisible by mesh size.
      global_budget: total candidates across all channels that get LDPC
        iterations this window (the rest are masked out).
      osd_cands_global: total deep-decode retries across the mesh (split
        evenly per shard — each shard refines its own best BP failures
        from its LOCAL raw samples, so no sample tensors ever cross the
        interconnect; only the compacted survivors and the ≤osd posterior
        rows do).
      ap_clamp_signs / ap_cw_signs: the AP hypothesis ladder (ops/ap.py)
        — clamp rows and the continuation codeword bank, identical
        semantics to the single-chip graph (pipeline.py). Hypothesis
        tensors are replicated (a few KB).

    Returns the compacted per-channel dict of decode_window_device
    (survivors bit-packed on device — at pod scale the host must never see
    the full (B, K, 91) candidate tensors) plus 'n_selected' (B,) int32 —
    how many of each channel's candidates made the global cut, and the
    osd_* posterior fields (global channel indices) when
    osd_cands_global > 0 — unpack with pipeline.unpack_survivors +
    pipeline._merge_osd_decodes exactly like the single-chip output.
    """
    from ..pipeline import compact_survivors, deep_rungs

    axes = tuple(mesh.axis_names)
    # budget in (None, 0) means unbudgeted, matching the single-chip
    # graph's rule (pipeline.py: "an explicit --budget 0 must not run
    # top_k with k=0") — the threshold then reduces to K_MIN_SCORE
    if not global_budget:
        global_budget = i_samples.shape[0] * num_candidates
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    n_osd_loc = max(osd_cands_global // n_shards, 0)

    def local(i_loc, q_loc):
        wf = waterfall(i_loc, q_loc)
        cand = find_sync(wf, num_candidates)
        scores = cand["score"]                        # (b_loc, K)
        flat = scores.reshape(-1)
        # All-gather every device's candidate scores (small: K ints per
        # channel), then one global threshold = global_budget-th score.
        gathered = flat
        for ax in axes:
            gathered = jax.lax.all_gather(gathered, ax).reshape(-1)
        k = min(global_budget, gathered.shape[0])
        kth = jax.lax.top_k(gathered, k)[0][-1]
        thresh = jnp.maximum(kth, K_MIN_SCORE)
        selected = scores >= thresh                   # (b_loc, K)

        llrs = extract_llrs(wf, cand)
        llrs = jnp.where(selected[..., None], llrs, 0.0)
        hard, errors = bp_decode(llrs, ldpc_iters)
        errors = jnp.where(selected, errors, 83)
        ok = (errors == 0) & crc_check(hard) & selected

        def merge(ok_new, hard_new, ok0, hard0, err0):
            acc = ok_new & ~ok0
            return (ok0 | acc,
                    jnp.where(acc[..., None], hard_new, hard0),
                    jnp.where(acc, 0, err0))

        # AP clamp rows on the budget-selected LLRs (pipeline.py
        # semantics: re-run BP with the hypothesis bits pinned).
        # Unselected rows are zero LLR vectors — BP on them converges
        # nowhere and CRC gates them out; the daemon keeps the clamp-row
        # set to O(1) so the extra BP passes stay a small fraction of
        # the window budget.
        if ap_clamp_signs is not None:
            from ..ops.ap import apply_clamp
            for h in range(ap_clamp_signs.shape[0]):
                hard_a, err_a = bp_decode(
                    apply_clamp(llrs, ap_clamp_signs[h]), ldpc_iters)
                ok_a = (err_a == 0) & crc_check(hard_a) & selected
                ok, hard, errors = merge(ok_a, hard_a, ok, hard, errors)

        # Enumeration bank on the selected LLRs (laddered gate)
        if ap_cw_signs is not None:
            from ..ops.ap import bank_correlate
            hit, bits = bank_correlate(llrs, ap_cw_signs, scores)
            hit = hit & (scores >= K_MIN_SCORE) & selected
            ok, hard, errors = merge(hit, bits.astype(hard.dtype),
                                     ok, hard, errors)

        out_extra = {}
        if n_osd_loc > 0:
            # deep-decode retry per shard: refine the LOCAL best BP
            # failures from the LOCAL raw samples (pipeline.py osd block
            # restructured per shard; chan indices globalized below)
            from ..ops.llr import estimate_snr_flat
            from ..ops.refine import refine_llrs_flat

            b_loc, K = scores.shape
            failed = (errors > 0) & (scores >= K_MIN_SCORE) & selected
            flat_rank = jnp.where(failed, scores, -1).reshape(-1)
            _, sel_f = jax.lax.top_k(flat_rank, min(n_osd_loc, b_loc * K))
            chan_f = sel_f // K
            cand_sel = {kk: cand[kk].reshape(-1)[sel_f] for kk in
                        ("time_sub", "freq_sub", "time_offset",
                         "freq_offset")}
            llr_ref, _s, llr_pair, llr_coh = refine_llrs_flat(
                i_loc, q_loc, cand_sel, chan_f, return_pair=True)
            was_failed = failed.reshape(-1)[sel_f]
            score_sel = scores.reshape(-1)[sel_f]
            ap_rows = ([ap_clamp_signs[h]
                        for h in range(ap_clamp_signs.shape[0])]
                       if ap_clamp_signs is not None else [])
            hard_r, ok_r, post_p, post_c = deep_rungs(
                llr_ref, llr_pair, was_failed, score_sel, ap_rows,
                ap_cw_signs, ldpc_iters, llr_coh=llr_coh)
            hard_flat = hard.reshape(b_loc * K, -1)
            hard = hard_flat.at[sel_f].set(
                jnp.where(ok_r[:, None], hard_r, hard_flat[sel_f])) \
                .reshape(b_loc, K, -1)
            errors = errors.reshape(-1).at[sel_f].set(
                jnp.where(ok_r, 0, errors.reshape(-1)[sel_f])) \
                .reshape(b_loc, K)
            ok = ok.reshape(-1).at[sel_f].set(
                ok.reshape(-1)[sel_f] | ok_r).reshape(b_loc, K)
            # globalize channel indices: shard offset along the mesh
            shard = jnp.int32(0)
            for ax in axes:
                shard = shard * mesh.shape[ax] + jax.lax.axis_index(ax)
            out_extra = {
                "osd_post": post_p,
                "osd_post_coh": post_c,
                "osd_valid": was_failed & ~ok_r,
                "osd_chan": (chan_f + shard * b_loc).astype(jnp.int32),
                "osd_score": score_sel.astype(jnp.int32),
                "osd_snr_db": estimate_snr_flat(wf, cand_sel, chan_f),
                "osd_time_sub": cand_sel["time_sub"].astype(jnp.uint8),
                "osd_freq_sub": cand_sel["freq_sub"].astype(jnp.uint8),
                "osd_time_offset":
                    cand_sel["time_offset"].astype(jnp.int8),
                "osd_freq_offset":
                    cand_sel["freq_offset"].astype(jnp.int32),
            }

        out = compact_survivors(wf, cand, hard, errors, ok)
        out["n_selected"] = jnp.sum(selected.astype(jnp.int32), axis=-1)
        out.update(out_extra)
        return out

    spec = P(axes)   # shard channel axis over all mesh axes
    fn = shard_map(local, mesh=mesh, in_specs=(spec, spec), out_specs=spec)
    return fn(jnp.asarray(i_samples), jnp.asarray(q_samples))
