"""Waterfall precision ladder: decode-set equality of each DFT GEMM
precision against HIGHEST on knife-edge channels, in one process.

  python3 scripts/wf_fast_compare.py [OUT.json]

Decodes a fixed set of knife-edge ladders (8 seeds x 64 channels spanning
-15..-20 dB with mixed message forms, budget 1024) with the waterfall's
GEMMs at HIGHEST, HIGH, DEFAULT and the 3-pass TF32 algorithm preset
(GPU only) in turn, and reports for each rung
the channels whose sorted decode list differs from HIGHEST's, the decodes
it loses and gains, and the waterfall stage's time at B=64 (median of 5
runs of 32 calls, ended by jax.block_until_ready). Run it on the target
device: a GPU may carry DEFAULT and HIGH float32 dots in TF32.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np

SEEDS = 8
B = 64
MSGS = ["CQ K1JT FN20", "K1ABC W9XYZ EN37", "CQ VA2GKA FN35",
        "W9XYZ K1ABC R-09", "CQ TEST K1ABC FN42", "K1ABC W9XYZ RR73"]


def sigma_for_snr(snr_db, amp=0.5):
    return np.sqrt(amp ** 2 / (2 * 10 ** (snr_db / 10) * (2500 / 3200)))


def ladders():
    from rtlsdr_ft8d_jax.host.synth import synthesize_message

    out = []
    for seed in range(SEEDS):
        chans = []
        for b in range(B):
            snr = -15.0 - 5.0 * b / (B - 1)            # -15..-20 dB
            chans.append(synthesize_message(
                MSGS[(b + seed) % len(MSGS)],
                f0_hz=250 + (17.0 * b + 31.0 * seed) % 1100,
                noise_sigma=sigma_for_snr(snr),
                rng=np.random.default_rng(seed * 1000 + b)))
        out.append(np.stack(chans))
    return out


def main():
    import jax
    import jax.numpy as jnp

    from rtlsdr_ft8d_jax.host.cache import enable_compilation_cache
    enable_compilation_cache()
    from rtlsdr_ft8d_jax.ops import waterfall as wf_mod
    from rtlsdr_ft8d_jax.pipeline import decode_window

    print(f"device: {jax.devices()[0].device_kind}", flush=True)
    batches = ladders()
    i_s = jnp.asarray(np.real(batches[0]).astype(np.float32))
    q_s = jnp.asarray(np.imag(batches[0]).astype(np.float32))
    P = jax.lax.Precision
    lists = {}
    A = jax.lax.DotAlgorithmPreset
    for rung in (P.HIGHEST, P.HIGH, P.DEFAULT, A.TF32_TF32_F32_X3):
        wf_mod._WF_PRECISION = rung
        jax.clear_caches()
        wf = jax.jit(wf_mod.waterfall)
        jax.block_until_ready(wf(i_s, q_s))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready([wf(i_s, q_s) for _ in range(32)])
            ts.append((time.perf_counter() - t0) / 32)
        lists[rung.name] = [[sorted(d.text for d in decs)
                             for decs in decode_window(x, budget=1024)]
                            for x in batches]
        n = sum(len(l) for ls in lists[rung.name] for l in ls)
        print(f"{rung.name:16s} waterfall B=64 {np.median(ts) * 1e3:7.3f} ms,"
              f" {n} decodes", flush=True)
    ref = lists["HIGHEST"]
    for name in list(lists)[1:]:
        diff = lost = gained = 0
        for la_s, lb_s in zip(ref, lists[name]):
            for la, lb in zip(la_s, lb_s):
                diff += la != lb
                lost += len(set(la) - set(lb))
                gained += len(set(lb) - set(la))
        print(f"{name:16s} vs HIGHEST: {diff}/{SEEDS * B} channels differ, "
              f"{lost} decodes lost, {gained} gained", flush=True)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(lists, f)


if __name__ == "__main__":
    main()
