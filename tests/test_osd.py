"""Ordered-statistics decoder unit tests (ops/osd.py)."""

import numpy as np

from rtlsdr_ft8d_jax.ops.osd import encode_matrix, osd_batch, osd_decode
from rtlsdr_ft8d_jax.protocol.crc import payload_crc
from rtlsdr_ft8d_jax.protocol.encode import ldpc_encode
from rtlsdr_ft8d_jax.protocol.pack import pack77


def _codeword(text="CQ K1JT FN20"):
    bits91 = np.zeros(91, np.uint8)
    p = pack77(text)
    crc = payload_crc(p)
    bits91[:77] = p
    bits91[77:91] = [(crc >> (13 - i)) & 1 for i in range(14)]
    return bits91, ldpc_encode(bits91)


def test_encode_matrix_matches_ldpc_encode():
    bits91, cw = _codeword()
    assert np.array_equal((encode_matrix() @ bits91) % 2, cw)


def test_osd_exact_and_corrupted():
    bits91, cw = _codeword()
    llr = (2.0 * cw.astype(np.float64) - 1.0) * 5.0
    got, norm = osd_decode(llr)
    assert np.array_equal(got, cw) and norm == 0.0
    # flip 8 least-reliable-looking positions (low |llr|)
    rng = np.random.default_rng(0)
    llr2 = llr + rng.normal(0, 1.2, 174)
    weak = np.argsort(np.abs(llr2))[:8]
    llr2[weak] *= -0.3
    got, norm = osd_decode(llr2)
    assert got is not None and np.array_equal(got[:91], bits91)


def test_osd_beats_bp_on_soft_noise():
    """At an SNR where BP mostly fails, OSD on the BP posterior recovers
    a solid fraction (the complementary-decoder property)."""
    import jax.numpy as jnp

    from rtlsdr_ft8d_jax.ops.ldpc import bp_decode

    bits91, cw = _codeword()
    bp_ok = osd_ok = 0
    trials = 12
    for t in range(trials):
        rng = np.random.default_rng(1000 + t)
        llr = ((2.0 * cw.astype(np.float64) - 1.0) * 2.0
               + rng.normal(0, 1.75, 174))
        hard, err, post = bp_decode(
            jnp.asarray(llr[None].astype(np.float32)), 20,
            return_posterior=True)
        bp_ok += (int(err[0]) == 0
                  and np.array_equal(np.asarray(hard[0])[:91], bits91))
        got, _ = osd_decode(np.asarray(post[0], np.float64))
        osd_ok += got is not None and np.array_equal(got[:91], bits91)
    assert osd_ok > bp_ok, (bp_ok, osd_ok)


def test_osd_batch_rejects_noise_llrs():
    rng = np.random.default_rng(5)
    llrs = rng.normal(0, 2.0, (32, 174))
    msgs, accept = osd_batch(llrs)
    assert accept.sum() == 0


def _mixed_llrs(seed=42, n_noise=17):
    """Decodable + marginal + pure-noise LLR rows, float32 so the native
    (float32 in), numpy and scalar paths all see identical values."""
    rng = np.random.default_rng(seed)
    rows = []
    for text in ("CQ K1JT FN20", "K1ABC W9XYZ EN37", "CQ DX F8ABC JN05"):
        _, cw = _codeword(text)
        signs = 2.0 * cw.astype(np.float64) - 1.0
        for noise in (0.5, 1.5, 1.9, 2.3, 2.8):
            rows.append(signs * 2.0 + rng.normal(0, noise, 174))
    for _ in range(n_noise):
        rows.append(rng.normal(0, 2.0, 174))        # pure noise
    return np.stack(rows).astype(np.float32)


def test_osd_batch_paths_match_scalar():
    """The native C++ path (native/osd.cc) and the vectorized numpy path
    must both produce IDENTICAL accept decisions and messages to the
    per-candidate osd_decode loop, across decodable, marginal and
    pure-noise LLRs."""
    from rtlsdr_ft8d_jax.native import load
    from rtlsdr_ft8d_jax.ops.osd import osd_batch_numpy, osd_batch_scalar

    llrs = _mixed_llrs()
    m_s, a_s = osd_batch_scalar(llrs)
    assert a_s.sum() >= 5                           # corpus is non-trivial
    m_n, a_n = osd_batch_numpy(llrs)
    assert np.array_equal(a_n, a_s)
    assert np.array_equal(m_n[a_n], m_s[a_s])
    if load() is not None:
        m_c, a_c = osd_batch(llrs)                  # native dispatch
        assert np.array_equal(a_c, a_s)
        assert np.array_equal(m_c[a_c], m_s[a_s])


def test_osd_batch_pair_depth_exceeds_depth():
    """pair_depth > depth is routed to the numpy path (the native gate
    requires pair_depth <= depth) and used to IndexError there while the
    scalar oracle handled it — all paths must agree on these args too."""
    from rtlsdr_ft8d_jax.ops.osd import osd_batch_numpy, osd_batch_scalar

    llrs = _mixed_llrs()
    m_s, a_s = osd_batch_scalar(llrs, depth=6, pair_depth=10)
    m_n, a_n = osd_batch_numpy(llrs, depth=6, pair_depth=10)
    assert np.array_equal(a_n, a_s)
    assert np.array_equal(m_n[a_n], m_s[a_s])
    m_d, a_d = osd_batch(llrs, depth=6, pair_depth=10)   # dispatch
    assert np.array_equal(a_d, a_s)
    assert np.array_equal(m_d[a_d], m_s[a_s])


def test_osd_batch_parity_fuzz():
    """Wider randomized parity fuzz native vs numpy vs scalar (the three
    implementations share no code beyond the E matrix)."""
    from rtlsdr_ft8d_jax.ops.osd import osd_batch_numpy, osd_batch_scalar

    for seed in (7, 1234, 999):
        llrs = _mixed_llrs(seed=seed, n_noise=9)
        m_s, a_s = osd_batch_scalar(llrs)
        for impl in (osd_batch, osd_batch_numpy):
            m, a = impl(llrs)
            assert np.array_equal(a, a_s), (impl.__name__, seed)
            assert np.array_equal(m[a], m_s[a_s]), (impl.__name__, seed)


def test_osd_batch_vectorized_speed():
    """The batch path must be >=10x faster than the scalar loop
    (VERDICT r2 #3: production windows ship up to 1024 failures)."""
    import time

    rng = np.random.default_rng(9)
    _, cw = _codeword()
    signs = 2.0 * cw.astype(np.float64) - 1.0
    llrs = np.stack([signs * 2.0 + rng.normal(0, 1.8, 174)
                     for _ in range(64)]).astype(np.float32)
    from rtlsdr_ft8d_jax.ops.osd import osd_batch_scalar
    osd_batch(llrs[:4])                             # warm caches
    t0 = time.perf_counter()
    osd_batch(llrs)
    t_vec = time.perf_counter() - t0
    t0 = time.perf_counter()
    osd_batch_scalar(llrs)
    t_scal = time.perf_counter() - t0
    assert t_scal / t_vec >= 10.0, (t_scal, t_vec)


def test_refined_llrs_decode_offgrid_signal():
    """Matched-filter refinement (ops/refine.py): a clean off-grid signal
    whose candidate comes from the quantized waterfall must BP-decode
    from the refined LLRs."""
    import jax
    import jax.numpy as jnp

    from rtlsdr_ft8d_jax.host.synth import synthesize_message
    from rtlsdr_ft8d_jax.ops.ldpc import bp_decode, crc_check
    from rtlsdr_ft8d_jax.ops.refine import refine_llrs
    from rtlsdr_ft8d_jax.ops.sync import find_sync
    from rtlsdr_ft8d_jax.ops.waterfall import waterfall

    bits91, _ = _codeword("K1ABC W9XYZ EN37")
    sig = synthesize_message("K1ABC W9XYZ EN37", f0_hz=502.7,
                             amplitude=0.2, noise_sigma=0.01,
                             start_sample=97,
                             rng=np.random.default_rng(1))
    i_s = jnp.asarray(np.real(sig)[None].astype(np.float32))
    q_s = jnp.asarray(np.imag(sig)[None].astype(np.float32))
    cand = jax.device_get(find_sync(waterfall(i_s, q_s), 8))
    sel = {k: jnp.asarray(cand[k][:, :2])
           for k in ("time_sub", "freq_sub", "time_offset", "freq_offset")}
    llrs, score = refine_llrs(i_s, q_s, sel)
    hard, err = bp_decode(llrs, 20)
    ok = np.asarray((err == 0) & crc_check(hard))
    assert ok[0, 0]
    assert np.array_equal(np.asarray(hard[0, 0])[:91], bits91)
    assert float(score[0, 0]) > 0.0


def test_decode_pass_osd_recovers():
    """End-to-end through _decode_pass: the OSD reprocessing stage must
    recover a real BP failure (noise_sigma 3.5 at this seed fails BP but
    is OSD-recoverable — the regime the bench's OSD-benefit gate seeds)."""
    from rtlsdr_ft8d_jax.host.synth import synthesize_message
    from rtlsdr_ft8d_jax.pipeline import _decode_pass
    from rtlsdr_ft8d_jax.protocol.constants import K_MAX_CANDIDATES
    from rtlsdr_ft8d_jax.protocol.unpack import CallsignHashTable

    iq = synthesize_message("K1ABC W9XYZ EN37", f0_hz=612.5,
                            noise_sigma=3.5,
                            rng=np.random.default_rng(0))
    i_s = np.real(iq)[None].astype(np.float32)
    q_s = np.imag(iq)[None].astype(np.float32)
    args = (i_s, q_s, CallsignHashTable(), K_MAX_CANDIDATES, 20)
    res_h, _, out_h = _decode_pass(*args, osd_cands=8)
    assert out_h["n_osd_recovered"] >= 1          # OSD did real work
    assert "K1ABC W9XYZ EN37" in {d.text for d in res_h[0]}


def test_merge_retries_block_coherent_posteriors():
    """_merge_osd_decodes must recover a message whose triple-flavor
    posterior is OSD-garbage but whose block-coherent posterior is
    clean (the second-attempt branch added with the coherent ladder)."""
    from rtlsdr_ft8d_jax.pipeline import _merge_osd_decodes
    from rtlsdr_ft8d_jax.protocol.unpack import CallsignHashTable

    bits91, cw = _codeword("K1ABC W9XYZ EN37")
    clean = (2.0 * cw.astype(np.float32) - 1.0) * 4.9
    rng = np.random.default_rng(5)
    garbage = rng.normal(0, 1.0, 174).astype(np.float32)
    out = {
        "osd_valid": np.array([True]),
        "osd_post": garbage[None, :],
        "osd_post_coh": clean[None, :],
        "osd_chan": np.array([0], np.int32),
        "osd_score": np.array([20], np.int32),
        "osd_snr_db": np.array([-20.0], np.float32),
        "osd_time_sub": np.array([0], np.uint8),
        "osd_freq_sub": np.array([0], np.uint8),
        "osd_time_offset": np.array([0], np.int8),
        "osd_freq_offset": np.array([16], np.int32),
    }
    results = [[]]
    sub_params = [[]]
    n = _merge_osd_decodes(out, results, sub_params,
                           CallsignHashTable())
    assert n == 1
    assert results[0][0].text == "K1ABC W9XYZ EN37"
    # without the coherent posteriors the same out dict recovers nothing
    out2 = dict(out)
    del out2["osd_post_coh"]
    assert _merge_osd_decodes(out2, [[]], [[]],
                              CallsignHashTable()) == 0


