"""Does AP-clamping the BLOCK-COHERENT flavor add decodes?

The deep ladder clamps AP hypothesis bits on the LLR flavors
(pipeline.deep_rungs). This measures, on AP-eligible traffic at the
threshold, whether running the same clamps on the block-coherent
flavor unions additional decodes over clamping only the noncoherent
and triple flavors — i.e. whether the third flavor in the AP loop is
worth its extra BP rungs. (It is: wired since the measurement below.)

Usage: JAX_PLATFORMS=cpu python3 scripts/ap_coh_ab.py
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import jax.numpy as jnp
import numpy as np

from scripts.ab_common import decode_mask, prep, sigma_for_snr

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.ops.ap import AP_CLAMP_MAG, clamp_row_cq, \
    clamp_row_to_call
from rtlsdr_ft8d_jax.ops.refine import refine_llrs_flat

MY_CALL = "VA2GKA"
MSGS = ["CQ W9XYZ EN37", f"{MY_CALL} K1ABC -07"]


def _clamped(llr, signs):
    mask = signs != 0.0
    clamp = signs * np.float32(AP_CLAMP_MAG)
    return llr.at[..., :77].set(
        jnp.where(jnp.asarray(mask), jnp.asarray(clamp), llr[..., :77]))


def main():
    rows = [("cq", clamp_row_cq()),
            ("mycall", clamp_row_to_call(MY_CALL))]
    for snr in (-21.0, -21.5, -22.0, -22.5):
        rng = np.random.default_rng(4321)
        T = 48
        seeded = [MSGS[t % 2] for t in range(T)]
        batch = np.stack([
            synthesize_message(
                seeded[t],
                f0_hz=500 + (t % 7) * 11.25 + rng.uniform(-0.7, 0.7),
                noise_sigma=sigma_for_snr(snr), rng=rng)
            for t in range(T)])
        i_n, q_n, best, chan, _scores = prep(batch)
        noncoh, _score, tri, coh = refine_llrs_flat(
            i_n, q_n, best, chan, return_pair=True)
        base = np.zeros(T, bool)
        for llr in (noncoh, tri, coh):
            base |= decode_mask(llr, seeded)
        ap2 = base.copy()
        ap3 = base.copy()
        for _name, signs in rows:
            for llr in (tri, noncoh):
                m = decode_mask(_clamped(llr, signs), seeded)
                ap2 |= m
                ap3 |= m
            ap3 |= decode_mask(_clamped(coh, signs), seeded)
        print(f"SNR {snr:6.1f}: plain-rungs {base.sum():2d}/48  "
              f"+AP(non,tri) {ap2.sum():2d}/48  "
              f"+AP(coh too) {ap3.sum():2d}/48  "
              f"coh-AP-only {(ap3 & ~ap2).sum()}", flush=True)


if __name__ == "__main__":
    main()
