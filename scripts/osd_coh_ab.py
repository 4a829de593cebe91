"""Does host OSD on the BLOCK-COHERENT posteriors recover extra decodes?

The device ships the triple-coherent BP posteriors of still-failed
candidates for host OSD. This measures, at the deep threshold, whether
a second OSD attempt on the block-coherent flavor's posteriors recovers
messages the first attempt misses. The BP baseline runs all three
flavors, matching the shipped ladder. (It does: wired since the
measurement below.)

Usage: JAX_PLATFORMS=cpu python3 scripts/osd_coh_ab.py
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np

from scripts.ab_common import prep, sigma_for_snr

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.ops.ldpc import bp_decode, crc_check
from rtlsdr_ft8d_jax.ops.osd import osd_batch
from rtlsdr_ft8d_jax.ops.refine import refine_llrs_flat
from rtlsdr_ft8d_jax.protocol.pack import pack77

MSG = "K1ABC W9XYZ EN37"


def main():
    want = pack77(MSG)
    for snr in (-21.0, -21.5, -22.0):
        rng = np.random.default_rng(97)
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
        # BP on each flavor (the shipped ladder's plain rungs); keep the
        # two coherent flavors' posteriors for OSD
        h_n, err_n = bp_decode(noncoh, 20)
        h_t, err_t, post_t = bp_decode(tri, 20, return_posterior=True)
        h_c, err_c, post_c = bp_decode(coh, 20, return_posterior=True)
        bp_ok = np.zeros(T, bool)
        for h, e in ((h_n, err_n), (h_t, err_t), (h_c, err_c)):
            bp_ok |= np.asarray((e == 0) & crc_check(h))
        failed = ~bp_ok
        idx = np.nonzero(failed)[0]
        m_t = np.zeros(T, bool)
        m_c = np.zeros(T, bool)
        for post, m in ((post_t, m_t), (post_c, m_c)):
            msgs, accept = osd_batch(np.asarray(post)[idx])
            for j, t in enumerate(idx):
                if accept[j] and bytes(msgs[j][:77]) == bytes(want):
                    m[t] = True
        print(f"SNR {snr:6.1f}: bp {bp_ok.sum():2d}/48  "
              f"osd(tri) +{m_t.sum():2d}  osd(coh) +{m_c.sum():2d}  "
              f"osd union +{(m_t | m_c).sum():2d}  "
              f"coh-only +{(m_c & ~m_t).sum()}", flush=True)


if __name__ == "__main__":
    main()
