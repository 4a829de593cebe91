"""A/B the block-coherent LLR flavor against the triple-coherent one.

Measures the flavor shipped as ops/refine.py:_block_coherent_llrs:
derotate every symbol's matched-filter output by the Costas-pair CFO
estimate, anchor the absolute carrier phase on the three Costas blocks
(complex-interpolated across each 29-symbol data run), and score each
data symbol COHERENTLY: Re(z~_k(a) conj(ref_k)). O(58*8) per candidate
vs the triple's 54*512 joint-hypothesis tensor.

Usage: JAX_PLATFORMS=cpu python3 scripts/coherent_ab.py
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np

from scripts.ab_common import decode_mask, prep, sigma_for_snr

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.ops.refine import refine_llrs_flat

MSG = "K1ABC W9XYZ EN37"


def main():
    for snr in (-19.5, -20.0, -20.5, -21.0, -21.5):
        rng = np.random.default_rng(1234)
        T = 48
        batch = np.stack([
            synthesize_message(
                MSG,
                f0_hz=500 + (t % 7) * 11.25 + rng.uniform(-0.7, 0.7),
                noise_sigma=sigma_for_snr(snr), rng=rng)
            for t in range(T)])
        i_n, q_n, best, chan, _scores = prep(batch)
        noncoh, _score, tri, coh = refine_llrs_flat(
            i_n, q_n, best, chan, return_pair=True)
        m_non = decode_mask(noncoh, MSG)
        m_tri = decode_mask(tri, MSG)
        m_coh = decode_mask(coh, MSG)
        m_blend = decode_mask((tri + coh) * np.sqrt(0.5), MSG)
        print(f"SNR {snr:6.1f}: noncoh {m_non.sum():2d}/48  "
              f"tri {m_tri.sum():2d}/48  coh {m_coh.sum():2d}/48  "
              f"blend {m_blend.sum():2d}/48  "
              f"union {(m_tri | m_coh).sum():2d}/48  "
              f"union3 {(m_tri | m_coh | m_blend).sum():2d}/48",
              flush=True)


if __name__ == "__main__":
    main()
