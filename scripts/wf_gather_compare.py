"""A/B the waterfall frame fetch: general gather vs static-slice concat
vs strided conv. Checks exact output equality, then times each full
waterfall variant on the current backend."""

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
    SB, NF = W.SUB_BLOCK_SIZE, W.NUM_FRAMES
    rng = np.random.default_rng(0)
    i_s = jnp.asarray(rng.standard_normal((B, 48000)).astype(np.float32))
    q_s = jnp.asarray(rng.standard_normal((B, 48000)).astype(np.float32))

    # the OLD formulation this script exists to compare against: a general
    # gather of NUM_FRAMES x NFFT duplicated indices (ops/waterfall.py used
    # this until the static-slice concat, W._frames, replaced it)
    frame_idx = (np.arange(NF)[:, None] * SB
                 + np.arange(W.NFFT)[None, :]).astype(np.int32)

    def frames_gather(x):
        return x[..., frame_idx]

    def finish(mag2):
        db = 10.0 * jnp.log10(1e-12 + mag2 * (4.0 / (W.NFFT * W.NFFT)))
        q = jnp.clip(jnp.trunc(2.0 * db + 240.0), 0.0, 255.0) \
            .astype(jnp.uint8)
        shape = q.shape[:-2] + (W.NUM_BLOCKS, W.TIME_OSR, W.NUM_BIN,
                                W.FREQ_OSR)
        return jnp.swapaxes(q.reshape(shape), -1, -2)

    @jax.jit
    def wf_gather(i, q):
        return finish(W._dft_mag2(frames_gather(i), frames_gather(q)))

    @jax.jit
    def wf_concat(i, q):
        return finish(W._dft_mag2(W._frames(i), W._frames(q)))

    @jax.jit
    def wf_conv(i, q):
        # strided conv: (B, 48000) -> (B, 184, 512) per basis, NWC/WIO
        dn = jax.lax.conv_dimension_numbers((B, 48000, 1), (W.NFFT, 1, 512),
                                            ("NWC", "WIO", "NWC"))
        kw = dict(window_strides=(SB,), padding="VALID",
                  dimension_numbers=dn, precision=W._WF_PRECISION,
                  preferred_element_type=jnp.float32)
        C = jnp.asarray(W._COS)[:, None, :]
        S = jnp.asarray(W._SIN)[:, None, :]
        ix, qx = i[..., None], q[..., None]
        re = jax.lax.conv_general_dilated(ix, C, **kw) \
            + jax.lax.conv_general_dilated(qx, S, **kw)
        im = jax.lax.conv_general_dilated(qx, C, **kw) \
            - jax.lax.conv_general_dilated(ix, S, **kw)
        return finish((re * re + im * im)[:, :NF])

    ref = np.asarray(wf_gather(i_s, q_s))
    got_c = np.asarray(wf_concat(i_s, q_s))
    print("concat exact:", bool((ref == got_c).all()))
    try:
        got_v = np.asarray(wf_conv(i_s, q_s))
        d = np.abs(ref.astype(int) - got_v.astype(int))
        print(f"conv: max|d|={d.max()} frac_exact={(d == 0).mean():.6f}")
        conv_ok = True
    except Exception as e:
        print("conv failed:", type(e).__name__, str(e)[:200])
        conv_ok = False

    def timeit(name, fn):
        jax.block_until_ready(fn(i_s, q_s))
        DEPTH, REPS = 64, 5
        ts = []
        for _ in range(REPS):
            t0 = time.time()
            jax.block_until_ready([fn(i_s, q_s) for _ in range(DEPTH)])
            ts.append((time.time() - t0) / DEPTH)
        print(f"{name:12s} {float(np.median(ts))*1e3:7.3f} ms")

    timeit("gather", wf_gather)
    timeit("concat", wf_concat)
    if conv_ok:
        timeit("conv", wf_conv)


if __name__ == "__main__":
    main()
