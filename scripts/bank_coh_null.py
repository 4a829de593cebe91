"""Null + gain measurement for scoring the codeword bank against the
BLOCK-COHERENT LLR flavor.

Three measurements, mirroring the ones that calibrated AP_CW_THRESH /
AP_CW_THRESH_SYNCED for the first two flavors (ops/ap.py):
  1. pure-noise null: max normalized bank correlation of the coherent
     flavor over noise channels (overall and among score>=13 candidates);
  2. wrong-hypothesis-with-signal: real signals whose true message is
     NOT in the bank — max correlation against a bank sharing callsign
     bits;
  3. gain: continuation-message decodes via the bank on the coherent
     flavor that the existing two flavors miss, at -22..-23 dB.

Measured (2026-08-18): nulls safe (noise max 0.458 / 0.330 synced over
1.0M trials; wrong-hypothesis 0.493 — all below the 0.55 gate) but the
gain was ZERO at every depth, so the bank is deliberately NOT scored
against the coherent flavor (pipeline.deep_rungs).

Usage: JAX_PLATFORMS=cpu python3 scripts/bank_coh_null.py
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import numpy as np

from scripts.ab_common import prep, sigma_for_snr

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.ops.ap import codeword_signs, continuation_texts
from rtlsdr_ft8d_jax.ops.refine import refine_llrs_flat

BANK_TEXTS = (continuation_texts("K1ABC", "W9XYZ", grid="EN37")
              + continuation_texts("W9XYZ", "K1ABC"))
BANK = codeword_signs(BANK_TEXTS, h_pad=256)


def _flavors(iq_batch, k_cand=8):
    i_n, q_n, flat, chan, scores = prep(iq_batch, k_cand)
    ref, _score, tri, coh = refine_llrs_flat(
        i_n, q_n, flat, chan, return_pair=True)
    return ref, tri, coh, scores


def _corr(llr):
    num = np.asarray(llr) @ np.asarray(BANK).T
    den = np.maximum(np.abs(np.asarray(llr)).sum(-1, keepdims=True), 1e-9)
    return (num / den).max(-1)


def main():
    # --- 1. pure-noise null ---
    rng = np.random.default_rng(2024)
    mx_all, mx_synced, n_tr = 0.0, 0.0, 0
    for rep in range(4):
        noise = (rng.normal(0, 1.0, (64, 48000))
                 + 1j * rng.normal(0, 1.0, (64, 48000))) \
            .astype(np.complex64)
        _ref, _tri, coh, score = _flavors(noise, k_cand=16)
        c = _corr(coh)
        n_tr += c.size * BANK.shape[0]
        mx_all = max(mx_all, float(c.max()))
        sy = c[score >= 13]
        if sy.size:
            mx_synced = max(mx_synced, float(sy.max()))
    print(f"noise null ({n_tr/1e6:.1f}M trials): max {mx_all:.3f}  "
          f"score>=13 max {mx_synced:.3f}", flush=True)

    # --- 2. wrong-hypothesis-with-signal ---
    # real signals sharing callsign bits with bank rows, whose seeded
    # text is NOT in the bank
    wrong_msgs = ["K1ABC N0XYZ EN37", "N0XYZ K1ABC FN42",
                  "CQ K1ABC FN42"]
    in_bank = set(BANK_TEXTS)
    assert not any(m in in_bank for m in wrong_msgs)
    mx_wrong = 0.0
    for snr in (-10.0, -15.0, -19.0):
        batch = np.stack([
            synthesize_message(wrong_msgs[t % 3], f0_hz=300 + 50 * t,
                               noise_sigma=sigma_for_snr(snr),
                               rng=np.random.default_rng(1000 + t))
            for t in range(24)])
        _ref, _tri, coh, score = _flavors(batch, k_cand=4)
        c = _corr(coh)[score >= 13]
        if c.size:
            mx_wrong = max(mx_wrong, float(c.max()))
    print(f"wrong-hypothesis (signal, not in bank): max {mx_wrong:.3f}",
          flush=True)

    # --- 3. gain on continuation traffic at the bank's depth ---
    from rtlsdr_ft8d_jax.ops.ap import AP_CW_THRESH_SYNCED
    for snr in (-22.0, -22.5, -23.0):
        T = 48
        batch = np.stack([
            synthesize_message("K1ABC W9XYZ RR73",
                               f0_hz=400 + 20 * t + (t % 5) / 5 * 6.25,
                               noise_sigma=sigma_for_snr(snr),
                               rng=np.random.default_rng(7000 + t))
            for t in range(T)])
        ref, tri, coh, score = _flavors(batch, k_cand=1)
        ok = score >= 13
        c_ref, c_tri, c_coh = _corr(ref), _corr(tri), _corr(coh)
        th = AP_CW_THRESH_SYNCED
        two = ((c_ref > th) | (c_tri > th)) & ok
        three = two | ((c_coh > th) & ok)
        print(f"SNR {snr:6.1f}: bank(ref,tri) {two.sum():2d}/{T}  "
              f"+coh {three.sum():2d}/{T}", flush=True)


if __name__ == "__main__":
    main()
