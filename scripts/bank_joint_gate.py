"""Joint two-flavor bank gate: null + gain measurement.

The continuation codeword bank currently accepts when ONE flavor's
normalized correlation clears 0.58 (0.55 with sync evidence). This
measures a candidate additional rung: accept when BOTH the noncoherent
and the triple-coherent flavors pick the SAME hypothesis row and both
clear a lower threshold. The two flavors' noise correlations are
correlated (same candidate, same samples), so the joint null must be
measured, not derived from the marginals.

Measured (2026-08-18): the joint null is comfortably low (noise max
0.378 / 0.349 synced over 6144x251 trials; wrong-hypothesis 0.396), BUT
the gain is ZERO at every depth and threshold tried (0.45/0.48/0.50,
-22.5..-24.0 dB): the two flavors' correlations track each other so
closely on a real signal that "both medium, neither high" essentially
never happens. The joint gate is deliberately NOT wired.

Usage: JAX_PLATFORMS=cpu python3 scripts/bank_joint_gate.py
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
N_REAL = len(BANK_TEXTS)


def _flavors(iq_batch, k_cand=8):
    i_n, q_n, flat, chan, scores = prep(iq_batch, k_cand)
    ref, _score, tri, coh = refine_llrs_flat(
        i_n, q_n, flat, chan, return_pair=True)
    return ref, tri, coh, scores


def _corr_full(llr):
    num = np.asarray(llr) @ np.asarray(BANK).T
    den = np.maximum(np.abs(np.asarray(llr)).sum(-1, keepdims=True), 1e-9)
    return num / den                              # (N, H)


def _joint(c_ref, c_tri):
    """min(corr) of the two flavors at each flavor's OWN argmax row,
    gated on the argmaxes agreeing (real rows only)."""
    a_r = c_ref[:, :N_REAL].argmax(-1)
    a_t = c_tri[:, :N_REAL].argmax(-1)
    same = a_r == a_t
    take = np.take_along_axis
    v = np.minimum(
        take(c_ref, a_r[:, None], -1)[:, 0],
        take(c_tri, a_t[:, None], -1)[:, 0])
    return np.where(same, v, -1.0), a_r


def main():
    # --- joint noise null ---
    rng = np.random.default_rng(555)
    mx, mx_sync, n_tr = -1.0, -1.0, 0
    for rep in range(6):
        noise = (rng.normal(0, 1.0, (64, 48000))
                 + 1j * rng.normal(0, 1.0, (64, 48000))) \
            .astype(np.complex64)
        ref, tri, _coh, score = _flavors(noise, k_cand=16)
        j, _ = _joint(_corr_full(ref), _corr_full(tri))
        n_tr += j.size
        mx = max(mx, float(j.max()))
        sy = j[score >= 13]
        if sy.size:
            mx_sync = max(mx_sync, float(sy.max()))
    print(f"joint noise null ({n_tr} candidates x {N_REAL} rows): "
          f"max {mx:.3f}  score>=13 max {mx_sync:.3f}", flush=True)

    # --- wrong-hypothesis-with-signal null (the binding constraint for
    # the single-flavor gate was 0.52 here) ---
    wrong_msgs = ["K1ABC N0XYZ EN37", "N0XYZ K1ABC FN42",
                  "CQ K1ABC FN42"]
    assert not any(m in set(BANK_TEXTS) for m in wrong_msgs)
    mx_wrong = -1.0
    for snr in (-5.0, -10.0, -15.0, -19.0):
        batch = np.stack([
            synthesize_message(wrong_msgs[t % 3], f0_hz=300 + 50 * t,
                               noise_sigma=sigma_for_snr(snr),
                               rng=np.random.default_rng(3000 + t))
            for t in range(24)])
        ref, tri, _coh, score = _flavors(batch, k_cand=4)
        j, _ = _joint(_corr_full(ref), _corr_full(tri))
        j = j[score >= 13]
        if j.size:
            mx_wrong = max(mx_wrong, float(j.max()))
    print(f"joint wrong-hypothesis max: {mx_wrong:.3f}", flush=True)

    # --- gain on continuation traffic below the single-flavor gate ---
    from rtlsdr_ft8d_jax.ops.ap import AP_CW_THRESH_SYNCED
    for snr in (-22.5, -23.0, -23.5, -24.0):
        T = 48
        batch = np.stack([
            synthesize_message("K1ABC W9XYZ RR73",
                               f0_hz=400 + 20 * t + (t % 5) / 5 * 6.25,
                               noise_sigma=sigma_for_snr(snr),
                               rng=np.random.default_rng(8000 + t))
            for t in range(T)])
        ref, tri, _coh, score = _flavors(batch, k_cand=1)
        ok = score >= 13
        c_ref, c_tri = _corr_full(ref), _corr_full(tri)
        cur = ((c_ref.max(-1) > AP_CW_THRESH_SYNCED)
               | (c_tri.max(-1) > AP_CW_THRESH_SYNCED)) & ok
        j, arow = _joint(c_ref, c_tri)
        want = BANK_TEXTS.index("K1ABC W9XYZ RR73")
        for jt in (0.45, 0.48, 0.50):
            joint = (j > jt) & ok & (arow == want)
            both = cur | joint
            print(f"SNR {snr:6.1f} jt={jt:.2f}: single-gate "
                  f"{cur.sum():2d}/{T}  +joint {both.sum():2d}/{T}",
                  flush=True)


if __name__ == "__main__":
    main()
