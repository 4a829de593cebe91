"""Sub-step timing of the waterfall stage (gather / DFT GEMM / quantize)."""

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
    from rtlsdr_ft8d_jax.ops import waterfall as W

    B = 64
    rng = np.random.default_rng(0)
    i_s = jnp.asarray(rng.standard_normal((B, 48000)).astype(np.float32))
    q_s = jnp.asarray(rng.standard_normal((B, 48000)).astype(np.float32))

    @jax.jit
    def gather(i, q):
        return W._frames(i), W._frames(q)

    @jax.jit
    def gemm(i_f, q_f):
        return W._dft_mag2(i_f, q_f)

    @jax.jit
    def quant(mag2):
        db = 10.0 * jnp.log10(1e-12 + mag2 * (4.0 / (W.NFFT * W.NFFT)))
        scaled = jnp.trunc(2.0 * db + 240.0)
        q = jnp.clip(scaled, 0.0, 255.0).astype(jnp.uint8)
        shape = q.shape[:-2] + (W.NUM_BLOCKS, W.TIME_OSR, W.NUM_BIN,
                                W.FREQ_OSR)
        return jnp.swapaxes(q.reshape(shape), -1, -2)

    i_f, q_f = gather(i_s, q_s)
    mag2 = gemm(i_f, q_f)

    def timeit(name, fn, *args):
        jax.block_until_ready(fn(*args))
        DEPTH, REPS = 64, 5
        ts = []
        for _ in range(REPS):
            t0 = time.time()
            jax.block_until_ready([fn(*args) for _ in range(DEPTH)])
            ts.append((time.time() - t0) / DEPTH)
        print(f"{name:18s} {float(np.median(ts))*1e3:7.3f} ms")

    timeit("frame gather", gather, i_s, q_s)
    timeit("DFT GEMM+mag2", gemm, i_f, q_f)
    timeit("log/quant/layout", quant, mag2)
    timeit("full waterfall", jax.jit(W.waterfall), i_s, q_s)


if __name__ == "__main__":
    main()
