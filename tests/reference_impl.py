"""Naive NumPy reference implementation of the decode chain.

Written as a direct transliteration of the *behavior* of the serial C loops
(reference rtlsdr_ft8d.c:1395-1450 + ft8_lib's sync/LLR/BP algorithms) to
cross-check the vectorized kernels: same math, independent structure.
Slow and loopy on purpose — trusted baseline for parity tests.
"""

import numpy as np

from rtlsdr_ft8d_jax.protocol.constants import (COSTAS_PATTERN, FT8_LDPC_M,
                                                FT8_LDPC_N, GRAY_MAP)
from rtlsdr_ft8d_jax.protocol.parity_tables import (LDPC_MN, LDPC_NM,
                                                    LDPC_NUM_ROWS)

NUM_BLOCKS, NUM_BIN, NFFT = 92, 256, 1024


def waterfall_ref(iq):
    """(48000,) complex -> (92, 2, 2, 256) uint8."""
    win = np.sin(np.pi * np.arange(NFFT) / NFFT)
    out = np.zeros((NUM_BLOCKS, 2, 2, NUM_BIN), dtype=np.uint8)
    for blk in range(NUM_BLOCKS):
        for ts in range(2):
            seg = iq[blk * 512 + ts * 256: blk * 512 + ts * 256 + NFFT]
            x = np.fft.fft((seg * win).astype(np.complex64))
            mag2 = np.abs(x) ** 2
            db = 10.0 * np.log10(1e-12 + mag2 * 4.0 / (NFFT * NFFT))
            for fs in range(2):
                for pos in range(NUM_BIN):
                    scaled = int(2 * db[pos * 2 + fs] + 240)
                    out[blk, ts, fs, pos] = min(255, max(0, scaled))
    return out


def sync_score_ref(wf, ts, fs, to, fo):
    """C semantics: truncating integer division."""
    score = 0
    num = 0
    for m in (0, 36, 72):
        for k in range(7):
            block = to + m + k
            if block < 0:
                continue
            if block >= NUM_BLOCKS:
                break
            sm = int(COSTAS_PATTERN[k])
            p8 = wf[block, ts, fs].astype(int)
            v = int(p8[fo + sm])
            if sm > 0:
                score += v - int(p8[fo + sm - 1]); num += 1
            if sm < 7:
                score += v - int(p8[fo + sm + 1]); num += 1
            if k > 0 and block > 0:
                score += v - int(wf[block - 1, ts, fs, fo + sm]); num += 1
            if k < 6 and block + 1 < NUM_BLOCKS:
                score += v - int(wf[block + 1, ts, fs, fo + sm]); num += 1
    if num > 0:
        # C integer division truncates toward zero
        score = -((-score) // num) if score < 0 else score // num
    return score


def extract_llr_ref(wf, ts, fs, to, fo):
    log174 = np.zeros(FT8_LDPC_N, dtype=np.float32)
    for k in range(58):
        sym = k + (7 if k < 29 else 14)
        block = to + sym
        if block < 0 or block >= NUM_BLOCKS:
            continue
        ps = wf[block, ts, fs].astype(np.float32)
        s2 = np.array([ps[fo + GRAY_MAP[j]] for j in range(8)])
        log174[3 * k + 0] = max(s2[4], s2[5], s2[6], s2[7]) - \
            max(s2[0], s2[1], s2[2], s2[3])
        log174[3 * k + 1] = max(s2[2], s2[3], s2[6], s2[7]) - \
            max(s2[0], s2[1], s2[4], s2[5])
        log174[3 * k + 2] = max(s2[1], s2[3], s2[5], s2[7]) - \
            max(s2[0], s2[2], s2[4], s2[6])
    s = log174.sum()
    s2s = (log174 * log174).sum()
    inv_n = 1.0 / FT8_LDPC_N
    var = (s2s - s * s * inv_n) * inv_n
    return log174 * np.sqrt(24.0 / max(var, 1e-12))


def ldpc_check_ref(plain):
    errors = 0
    for m in range(FT8_LDPC_M):
        x = 0
        for j in range(LDPC_NUM_ROWS[m]):
            x ^= int(plain[LDPC_NM[m, j]])
        errors += x
    return errors


def fast_tanh_ref(x):
    """kgoba ft8_lib's rational tanh (decode.c fast_tanh)."""
    x = np.clip(x, -4.97, 4.97)
    x2 = x * x
    return x * (945.0 + x2 * (105.0 + x2)) / (945.0 + x2 * (420.0 + 15.0 * x2))


def fast_atanh_ref(x):
    x2 = x * x
    return x * (945.0 + x2 * (-735.0 + x2 * 64.0)) / (
        945.0 + x2 * (-1050.0 + x2 * 225.0))


def bp_decode_ref(llr, max_iters=20):
    tov = np.zeros((FT8_LDPC_N, 3), dtype=np.float32)
    toc = np.zeros((FT8_LDPC_M, 7), dtype=np.float32)
    best_err = FT8_LDPC_M
    best_plain = np.zeros(FT8_LDPC_N, dtype=np.int8)
    for _ in range(max_iters):
        plain = ((llr + tov.sum(axis=1)) > 0).astype(np.int8)
        if plain.sum() == 0:
            break
        errors = ldpc_check_ref(plain)
        if errors < best_err:
            best_err = errors
            best_plain = plain.copy()
            if errors == 0:
                break
        for m in range(FT8_LDPC_M):
            for j in range(LDPC_NUM_ROWS[m]):
                n = LDPC_NM[m, j]
                t = llr[n]
                for i in range(3):
                    if LDPC_MN[n, i] != m:
                        t += tov[n, i]
                toc[m, j] = fast_tanh_ref(-t / 2)
        for n in range(FT8_LDPC_N):
            for i in range(3):
                m = LDPC_MN[n, i]
                p = 1.0
                for j in range(LDPC_NUM_ROWS[m]):
                    if LDPC_NM[m, j] != n:
                        p *= toc[m, j]
                p = np.clip(p, -0.999999, 0.999999)
                tov[n, i] = -2 * fast_atanh_ref(p)
    return best_plain, best_err
