"""Flat tone-magnitude gather (ops/llr._tone_mags_flat) and the LLRs built
on it, against the loop reference (tests/reference_impl.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rtlsdr_ft8d_jax.ops.llr import _tone_mags_flat, extract_llrs_flat
from rtlsdr_ft8d_jax.protocol.constants import GRAY_MAP, NUM_BLOCKS

from . import reference_impl as ref


def _random_cands(rng, n, b):
    return {
        "time_sub": rng.integers(0, 2, n).astype(np.int32),
        "freq_sub": rng.integers(0, 2, n).astype(np.int32),
        "time_offset": rng.integers(-12, 24, n).astype(np.int32),
        "freq_offset": rng.integers(0, 249, n).astype(np.int32),
    }, rng.integers(0, b, n).astype(np.int32)


def _edge_cands(b):
    # every (to, fo) extreme, including fully/partially out-of-window dts
    cands = [(t, f, ts, fs) for t in (-12, -11, -5, 0, 11, 23)
             for f in (0, 1, 247, 248) for ts in (0, 1) for fs in (0, 1)]
    arr = np.array(cands, np.int32)
    return {"time_offset": arr[:, 0], "freq_offset": arr[:, 1],
            "time_sub": arr[:, 2], "freq_sub": arr[:, 3]}, \
        (np.arange(len(cands)) % b).astype(np.int32)


def _ref_mags(wf, cand, chan):
    n = chan.shape[0]
    s2 = np.zeros((n, 58, 8), np.float32)
    valid = np.zeros((n, 58), bool)
    for c in range(n):
        for k in range(58):
            block = cand["time_offset"][c] + k + (7 if k < 29 else 14)
            if not 0 <= block < NUM_BLOCKS:
                continue
            row = wf[chan[c], block, cand["time_sub"][c], cand["freq_sub"][c]]
            s2[c, k] = row[cand["freq_offset"][c] + GRAY_MAP]
            valid[c, k] = True
    return s2, valid


@pytest.mark.parametrize("maker", ["random", "edges", "unpadded",
                                   "wideband"])
def test_tone_mags_match_reference(maker):
    rng = np.random.default_rng(11)
    b = 1500 if maker == "wideband" else 3
    wf = rng.integers(0, 256, (b, 92, 2, 2, 256), dtype=np.uint8)
    if maker == "edges":
        cand, chan = _edge_cands(b)
    else:
        cand, chan = _random_cands(rng, {"random": 64, "unpadded": 19,
                                         "wideband": 48}[maker], b)
    s2, valid = _tone_mags_flat(jnp.asarray(wf), cand, jnp.asarray(chan))
    s2_r, valid_r = _ref_mags(wf, cand, chan)
    assert np.array_equal(np.asarray(valid), valid_r)
    assert np.array_equal(np.asarray(s2) * valid_r[..., None], s2_r)

    llr = np.asarray(extract_llrs_flat(jnp.asarray(wf), cand,
                                       jnp.asarray(chan)))
    for c in range(0, chan.shape[0], 7):
        expect = ref.extract_llr_ref(
            wf[chan[c]], cand["time_sub"][c], cand["freq_sub"][c],
            cand["time_offset"][c], cand["freq_offset"][c])
        np.testing.assert_allclose(llr[c], expect, rtol=1e-4, atol=1e-4)
