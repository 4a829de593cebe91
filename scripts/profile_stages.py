"""Per-stage device timing of the budgeted 64-channel decode graph.

Times each pipeline stage as a separate jitted function with DEPTH
pipelined launches ended by jax.block_until_ready (same methodology as
bench.py). Stage totals
slightly exceed the fused graph (barrier/materialization overhead), but
the RATIOS are what steer optimization.

Usage: python3 scripts/profile_stages.py [budget]
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from rtlsdr_ft8d_jax.host.cache import enable_compilation_cache
    enable_compilation_cache()
    from rtlsdr_ft8d_jax.host.synth import synthesize_message
    from rtlsdr_ft8d_jax.ops.ldpc import bp_decode, crc_check
    from rtlsdr_ft8d_jax.ops.llr import extract_llrs_flat
    from rtlsdr_ft8d_jax.ops.sync import find_sync, sync_scores
    from rtlsdr_ft8d_jax.ops.waterfall import waterfall
    from rtlsdr_ft8d_jax.pipeline import decode_window_device

    B = 64
    BUDGET = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    msgs = ["CQ K1JT FN20", "K1ABC W9XYZ EN37", "CQ VA2GKA FN35",
            "W9XYZ K1ABC R-09"]
    rng = np.random.default_rng(5)
    batch = np.stack([
        synthesize_message(msgs[b % 4], f0_hz=100 + 17.5 * b % 1300,
                           noise_sigma=0.3, rng=rng) for b in range(B)])
    i_s = jnp.asarray(np.real(batch).astype(np.float32))
    q_s = jnp.asarray(np.imag(batch).astype(np.float32))

    @jax.jit
    def stage_wf(i_samples, q_samples):
        peak = jnp.maximum(
            jnp.max(jnp.abs(i_samples), axis=-1, keepdims=True),
            jnp.max(jnp.abs(q_samples), axis=-1, keepdims=True))
        scale = 0.5 / jnp.maximum(peak, 1e-12)
        return waterfall(i_samples * scale, q_samples * scale)

    @jax.jit
    def stage_scores(wf):
        return sync_scores(wf)

    @jax.jit
    def stage_sync(wf):
        return find_sync(wf)

    @jax.jit
    def stage_budget_llr(wf, cand):
        flat_score = cand["score"].reshape(-1)
        _, sel = jax.lax.top_k(flat_score, BUDGET)
        chan_idx = sel // 120
        cand_flat = {k: cand[k].reshape(-1)[sel] for k in
                     ("time_sub", "freq_sub", "time_offset", "freq_offset")}
        return extract_llrs_flat(wf, cand_flat, chan_idx)

    @jax.jit
    def stage_bp(llrs):
        hard, err = bp_decode(llrs)
        # include the CRC GEMM in the timed stage (adding the bool keeps
        # it live; err==0 & crc is the pipeline's accept condition)
        return hard, err + (~crc_check(hard)).astype(err.dtype)

    wf = stage_wf(i_s, q_s)
    cand = stage_sync(wf)
    llrs = stage_budget_llr(wf, cand)

    def timeit(name, fn, *args):
        jax.block_until_ready(fn(*args))
        DEPTH, REPS = 64, 5
        ts = []
        for _ in range(REPS):
            t0 = time.time()
            jax.block_until_ready([fn(*args) for _ in range(DEPTH)])
            ts.append((time.time() - t0) / DEPTH)
        med = float(np.median(ts)) * 1e3
        print(f"{name:24s} {med:7.3f} ms")
        return med

    total = 0.0
    total += timeit("waterfall(+norm)", stage_wf, i_s, q_s)
    total += timeit("sync_scores", stage_scores, wf)
    total += timeit("find_sync(scores+topk)", stage_sync, wf)
    total += timeit("budget topk + LLR", stage_budget_llr, wf, cand)
    total += timeit("bp_decode+crc", stage_bp, llrs)
    print(f"{'stage total':24s} {total:7.3f} ms")

    @jax.jit
    def fused(i, q):
        return decode_window_device(i, q, budget=BUDGET)

    timeit("FUSED full graph", fused, i_s, q_s)


if __name__ == "__main__":
    main()
