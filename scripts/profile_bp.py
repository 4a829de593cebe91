"""A/B the two BP implementations on the GPU.

  python3 scripts/profile_bp.py [--sweep]

1. The BP stage alone at N=1024 (the production budget) and N=7680 (64
   channels unbudgeted): the XLA loop of one-hot GEMMs
   (ops/ldpc.bp_decode_xla, at HIGHEST and at DEFAULT precision) against
   the Triton-route kernel (ops/ldpc_pallas.bp_decode_pallas), with the
   kernel's agreement with the HIGHEST loop. --sweep also times the
   kernel over candidate blocks and warp counts.
2. The whole B=64 decode graph, budgeted (1024) and unbudgeted, with each
   BP in turn (kernel, XLA, XLA, kernel), so the stage's gain is read
   end to end.

Times are medians of 5 runs of 32 pipelined calls, each run ended by
jax.block_until_ready. Needs a GPU.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np


def make_llrs(n, rng):
    from rtlsdr_ft8d_jax.protocol.crc import add_crc
    from rtlsdr_ft8d_jax.protocol.encode import ldpc_encode

    rows = []
    for t in range(n // 4):
        payload = rng.integers(0, 2, 77).astype(np.uint8)
        cw = ldpc_encode(add_crc(payload)).astype(np.float32)
        scale = [4.0, 1.2, 0.7, 0.5][t % 4]
        rows.append((2.0 * cw - 1.0) * scale
                    + rng.normal(0, 1.0, 174).astype(np.float32))
    for _ in range(n - len(rows)):
        rows.append(rng.normal(0, 2.0, 174).astype(np.float32))
    return np.stack(rows) * 2.0


def timeit(fn, *args, depth=32, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(depth)]
        jax.block_until_ready(outs)
        ts.append((time.perf_counter() - t0) / depth)
    return float(np.median(ts)) * 1e3


def main():
    import jax
    import jax.numpy as jnp

    import bench

    dev = bench.require_gpu()
    print(f"device: {dev.device_kind}", flush=True)
    from rtlsdr_ft8d_jax.host.cache import enable_compilation_cache
    enable_compilation_cache()
    from rtlsdr_ft8d_jax.ops import ldpc
    from rtlsdr_ft8d_jax.ops.ldpc_pallas import bp_decode_pallas
    from rtlsdr_ft8d_jax.pipeline import decode_window_device

    rng = np.random.default_rng(0)
    highest = ldpc._MM
    default = dict(highest, precision=jax.lax.Precision.DEFAULT)
    for n in (1024, 7680):
        llr = jnp.asarray(make_llrs(n, rng))
        print(f"--- BP stage, N={n}", flush=True)
        ref = jax.device_get(ldpc.bp_decode_xla(llr, 20, True))
        for name, mm in (("XLA HIGHEST", highest), ("XLA DEFAULT", default)):
            ldpc._MM = mm
            jax.clear_caches()
            ms = timeit(lambda x: ldpc.bp_decode_xla(x, 20), llr)
            print(f"  {name:24s} {ms:8.3f} ms", flush=True)
        ldpc._MM = highest
        jax.clear_caches()
        got = jax.device_get(bp_decode_pallas(llr, 20, True))
        ms = timeit(lambda x: bp_decode_pallas(x, 20), llr)
        print(f"  {'Triton kernel':24s} {ms:8.3f} ms   errors agree "
              f"{(ref[1] == got[1]).mean():.4f}, hard rows differ "
              f"{int((ref[0] != got[0]).any(axis=1).sum())}, converged "
              f"{int((ref[1] == 0).sum())}/{int((got[1] == 0).sum())}, max "
              f"|posterior diff| {float(np.abs(ref[2] - got[2]).max()):.3g}",
              flush=True)
        if "--sweep" in sys.argv:
            for block, warps in ((2, 8), (4, 4), (4, 8), (4, 16), (8, 8)):
                ms = timeit(lambda x: bp_decode_pallas(
                    x, 20, block=block, num_warps=warps), llr)
                print(f"    block {block} warps {warps:2d}: {ms:8.3f} ms",
                      flush=True)

    batch = bench.strong_batch()
    i_s = jnp.asarray(np.real(batch).astype(np.float32))
    q_s = jnp.asarray(np.imag(batch).astype(np.float32))
    print("--- B=64 decode graph, ms per 64-channel window", flush=True)
    for mode in ("kernel", "xla", "xla", "kernel"):
        os.environ["FT8D_EXACT"] = "1" if mode == "xla" else "0"
        jax.clear_caches()
        for budget in (bench.BUDGET, None):
            ms = timeit(lambda a, b: decode_window_device(a, b,
                                                          budget=budget),
                        i_s, q_s)
            print(f"  BP {mode:6s} budget={budget}: {ms:8.3f} ms",
                  flush=True)
    os.environ.pop("FT8D_EXACT")


if __name__ == "__main__":
    main()
