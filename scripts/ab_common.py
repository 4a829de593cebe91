"""Shared harness for the deep-ladder A/B measurement scripts
(coherent_ab, ap_coh_ab, osd_coh_ab, bank_coh_null): synthesize ->
normalize -> waterfall -> sync -> per-candidate LLR flavors, and a
decode-mask helper. One copy so a change to the normalization or the
sigma formula cannot silently skew one script's numbers against the
others."""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import jax.numpy as jnp
import numpy as np

from rtlsdr_ft8d_jax.ops.ldpc import bp_decode, crc_check
from rtlsdr_ft8d_jax.ops.sync import find_sync
from rtlsdr_ft8d_jax.ops.waterfall import waterfall
from rtlsdr_ft8d_jax.protocol.unpack import unpack77


def sigma_for_snr(snr_db, amp=0.5):
    """Complex-noise sigma per component for an SNR in 2500 Hz."""
    return np.sqrt(amp ** 2 / (2 * 10 ** (snr_db / 10) * (2500 / 3200)))


def prep(iq_batch, k_cand=1):
    """Normalize a complex batch and pick each channel's top-k_cand sync
    candidates. Returns (i, q, cand_flat, chan_idx, scores_flat)."""
    i_s = np.real(iq_batch).astype(np.float32)
    q_s = np.imag(iq_batch).astype(np.float32)
    peak = np.maximum(np.abs(i_s).max(-1, keepdims=True),
                      np.abs(q_s).max(-1, keepdims=True))
    i_n, q_n = i_s * (0.5 / peak), q_s * (0.5 / peak)
    wf = waterfall(jnp.asarray(i_n), jnp.asarray(q_n))
    cand = find_sync(wf, max(k_cand, 8))
    B = iq_batch.shape[0]
    flat = {k: cand[k][:, :k_cand].reshape(-1) for k in
            ("time_sub", "freq_sub", "time_offset", "freq_offset")}
    chan = jnp.repeat(jnp.arange(B, dtype=jnp.int32), k_cand)
    scores = np.asarray(cand["score"][:, :k_cand]).reshape(-1)
    return jnp.asarray(i_n), jnp.asarray(q_n), flat, chan, scores


def decode_mask(llrs, seeded):
    """BP+CRC decode of (N, 174) LLRs; mask of rows whose unpacked text
    equals the seeded message (str, or one str per row)."""
    hard, err = bp_decode(llrs, 20)
    ok = np.asarray((err == 0) & crc_check(hard))
    out = np.zeros(ok.shape[0], bool)
    per_row = not isinstance(seeded, str)
    for t in range(ok.shape[0]):
        if ok[t]:
            try:
                want = seeded[t] if per_row else seeded
                out[t] = unpack77(np.asarray(hard[t][:77])
                                  .astype(np.uint8)) == want
            except Exception:
                pass
    return out
