"""Cross-check the vectorized kernels against the naive loop reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.ops.ldpc import bp_decode, crc_check
from rtlsdr_ft8d_jax.ops.llr import extract_llrs
from rtlsdr_ft8d_jax.ops.sync import (NUM_FREQ_OFFSETS, TIME_OFFSET_MIN,
                                      find_sync, sync_scores)
from rtlsdr_ft8d_jax.ops.waterfall import waterfall
from rtlsdr_ft8d_jax.protocol.crc import add_crc
from rtlsdr_ft8d_jax.protocol.encode import ldpc_encode

from . import reference_impl as ref


@pytest.fixture(scope="module")
def iq():
    return np.asarray(synthesize_message(
        "CQ K1JT FN20QI", f0_hz=487.5, noise_sigma=0.3,
        rng=np.random.default_rng(3)))


@pytest.fixture(scope="module")
def wf_pair(iq):
    i_s = jnp.asarray(np.real(iq)[None].astype(np.float32))
    q_s = jnp.asarray(np.imag(iq)[None].astype(np.float32))
    wf_jax = np.asarray(jax.jit(waterfall)(i_s, q_s))[0]
    wf_ref = ref.waterfall_ref(iq)
    return wf_jax, wf_ref


def test_waterfall_matches_reference(wf_pair):
    wf_jax, wf_ref = wf_pair
    # float32 FFT vs float64 reference: allow off-by-one quantization on a
    # tiny fraction of cells, but demand exact match on >99.9%
    diff = np.abs(wf_jax.astype(int) - wf_ref.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() > 0.999


def test_sync_scores_match_reference(wf_pair):
    wf_jax, _ = wf_pair
    scores = np.asarray(sync_scores(jnp.asarray(wf_jax[None])))[0]
    rng = np.random.default_rng(0)
    for _ in range(200):
        ts, fs = rng.integers(0, 2), rng.integers(0, 2)
        to = rng.integers(-12, 24)
        fo = rng.integers(0, NUM_FREQ_OFFSETS)
        expect = ref.sync_score_ref(wf_jax, ts, fs, to, fo)
        got = scores[ts, fs, to - TIME_OFFSET_MIN, fo]
        assert got == expect, (ts, fs, to, fo, got, expect)


def test_llr_matches_reference(wf_pair):
    wf_jax, _ = wf_pair
    cand = find_sync(jnp.asarray(wf_jax[None]))
    llrs = np.asarray(extract_llrs(jnp.asarray(wf_jax[None]), cand))[0]
    for k in range(0, 120, 17):
        ts = int(np.asarray(cand["time_sub"])[0, k])
        fs = int(np.asarray(cand["freq_sub"])[0, k])
        to = int(np.asarray(cand["time_offset"])[0, k])
        fo = int(np.asarray(cand["freq_offset"])[0, k])
        expect = ref.extract_llr_ref(wf_jax, ts, fs, to, fo)
        np.testing.assert_allclose(llrs[k], expect, rtol=1e-4, atol=1e-4)


def test_bp_decode_matches_reference(wf_pair):
    wf_jax, _ = wf_pair
    wf_j = jnp.asarray(wf_jax[None])
    cand = find_sync(wf_j)
    llrs = np.asarray(extract_llrs(wf_j, cand))[0]
    hard, err = bp_decode(jnp.asarray(llrs))
    hard, err = np.asarray(hard), np.asarray(err)
    for k in range(0, 120, 11):
        plain_ref, err_ref = ref.bp_decode_ref(llrs[k])
        assert err[k] == err_ref, (k, err[k], err_ref)
        if err_ref == 0:
            assert np.array_equal(hard[k], plain_ref)


def test_bp_decodes_clean_codeword():
    rng = np.random.default_rng(5)
    msg = rng.integers(0, 2, 91).astype(np.uint8)
    cw = ldpc_encode(msg)
    llr = jnp.asarray((2.0 * cw.astype(np.float32) - 1.0) * 4.0)
    hard, err = bp_decode(llr[None])
    assert int(err[0]) == 0
    assert np.array_equal(np.asarray(hard[0]), cw)


def test_bp_corrects_noisy_codeword():
    rng = np.random.default_rng(6)
    msg = np.zeros(77, dtype=np.uint8)
    msg[::5] = 1
    cw = ldpc_encode(add_crc(msg))
    llr = (2.0 * cw.astype(np.float32) - 1.0) * 2.0
    llr += rng.normal(0, 1.3, size=174).astype(np.float32)
    hard, err = bp_decode(jnp.asarray(llr)[None])
    assert int(err[0]) == 0
    assert np.array_equal(np.asarray(hard[0]), cw)
    assert bool(crc_check(hard)[0])


def test_pallas_bp_matches_sum_product():
    """The Triton-route BP kernel (interpret mode on CPU) must agree with
    the XLA sum-product decoder: identical error counts and identical
    hard decisions on every success, across codewords at several noise
    levels plus pure-noise rows."""
    from rtlsdr_ft8d_jax.ops.ldpc_pallas import bp_decode_pallas
    from rtlsdr_ft8d_jax.protocol.crc import add_crc
    from rtlsdr_ft8d_jax.protocol.encode import ldpc_encode

    rng = np.random.default_rng(7)
    rows = []
    for t in range(40):
        payload = rng.integers(0, 2, 77).astype(np.uint8)
        cw = ldpc_encode(add_crc(payload)).astype(np.float32)
        scale = [4.0, 1.2, 0.7][t % 3]
        rows.append((2.0 * cw - 1.0) * scale
                    + rng.normal(0, 1.0, 174).astype(np.float32))
    for _ in range(24):
        rows.append(rng.normal(0, 2.0, 174).astype(np.float32))
    llr = jnp.asarray(np.stack(rows) * 2.0)

    h1, e1 = bp_decode(llr)
    h2, e2 = bp_decode_pallas(llr, interpret=True)
    h1, e1, h2, e2 = map(np.asarray, (h1, e1, h2, e2))
    assert (e1 == e2).all()
    ok = e1 == 0
    assert ok.sum() >= 14         # at least the strong rows must decode
    assert (h1[ok] == h2[ok]).all()
