"""Dense-band global-budget decode on the 8-device CPU mesh."""

import numpy as np

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.parallel.dense import (decode_window_dense,
                                            make_grid_mesh)
from rtlsdr_ft8d_jax.pipeline import decode_window
from rtlsdr_ft8d_jax.protocol.unpack import unpack77


def _decode_texts(out, b):
    texts = set()
    ok_idx = np.nonzero(np.asarray(out["ok"])[b])[0]
    packed = np.asarray(out["packed"])
    for k in ok_idx:
        bits = np.unpackbits(packed[b, k])
        texts.add(unpack77(bits[:77]))
    return texts


def test_dense_decode_2d_mesh():
    mesh = make_grid_mesh(2, 4)
    msgs = ["CQ K1JT FN20", "K1ABC W9XYZ EN37"]
    chans = [synthesize_message(msgs[b % 2], f0_hz=250 + 60 * b,
                                noise_sigma=0.1,
                                rng=np.random.default_rng(b))
             for b in range(16)]
    batch = np.stack(chans)
    i_s = np.real(batch).astype(np.float32)
    q_s = np.imag(batch).astype(np.float32)
    out = decode_window_dense(i_s, q_s, mesh, global_budget=400)
    for b in range(16):
        assert msgs[b % 2] in _decode_texts(out, b), b
    # budget respected: selected count <= budget
    assert int(np.asarray(out["n_selected"]).sum()) <= 400
    # pod-scale contract: outputs are the COMPACTED survivor form (12-byte
    # packed payloads, <= 50/channel), never full (B, K, 91) tensors
    assert np.asarray(out["packed"]).shape[1:] == (50, 12)
    assert "hard" not in out


def test_dense_budget_zero_means_unbudgeted():
    """global_budget in (None, 0) = unbudgeted, matching the single-chip
    rule — top_k with k=0 used to crash at trace time."""
    mesh = make_grid_mesh(2, 4)
    msgs = ["CQ K1JT FN20", "K1ABC W9XYZ EN37"]
    chans = [synthesize_message(msgs[b % 2], f0_hz=250 + 60 * b,
                                noise_sigma=0.1,
                                rng=np.random.default_rng(b))
             for b in range(8)]
    batch = np.stack(chans)
    out = decode_window_dense(np.real(batch).astype(np.float32),
                              np.imag(batch).astype(np.float32),
                              mesh, global_budget=0)
    for b in range(8):
        assert msgs[b % 2] in _decode_texts(out, b), b


def test_dense_budget_prioritizes_strong_signals():
    """With a tiny global budget, the strong channel wins over the weak."""
    mesh = make_grid_mesh(2, 4)
    strong = synthesize_message("CQ K1JT FN20", f0_hz=400, noise_sigma=0.05,
                                rng=np.random.default_rng(0))
    chans = [strong if b == 3 else
             (0.001 * np.random.default_rng(b).standard_normal(48000)
              + 1j * 0.001 * np.random.default_rng(b + 99)
              .standard_normal(48000)).astype(np.complex64)
             for b in range(8)]
    batch = np.stack(chans)
    out = decode_window_dense(np.real(batch).astype(np.float32),
                              np.imag(batch).astype(np.float32),
                              mesh, global_budget=8)
    assert "CQ K1JT FN20" in _decode_texts(out, 3)
    sel = np.asarray(out["n_selected"])
    # nearly all selections concentrate on the strong channel
    assert sel[3] >= sel.sum() * 0.5


def test_dense_deep_decode_matches_single_chip():
    """The sharded dense path with the FULL deep-decode stack (refine +
    pair-coherent + AP clamps + continuation bank + host OSD merge)
    recovers the same weak decodes as the single-chip graph, with
    correctly globalized osd channel indices."""
    import jax.numpy as jnp

    from rtlsdr_ft8d_jax.ops.ap import codeword_signs, continuation_texts
    from rtlsdr_ft8d_jax.pipeline import (_merge_osd_decodes,
                                          unpack_survivors)

    def sigma(snr, amp=0.5):
        return np.sqrt(amp ** 2 / (2 * 10 ** (snr / 10) * (2500 / 3200)))

    mesh = make_grid_mesh(2, 4)
    msgs = ["CQ K1JT FN20", "K1ABC W9XYZ RR73"]
    chans = []
    deep = set()
    for b in range(16):
        if b % 5 == 2:                      # a weak continuation channel
            m, snr = "K1ABC W9XYZ RR73", -21.5
            deep.add(b)
        else:
            m, snr = "CQ K1JT FN20", -12.0
        chans.append(synthesize_message(
            m, f0_hz=250 + 60 * b, noise_sigma=sigma(snr),
            rng=np.random.default_rng(1000 + b)))
    batch = np.stack(chans)
    # normalize like the single-chip pipeline's C9 stage (the dense path
    # takes pre-normalized baseband)
    i_s = np.real(batch).astype(np.float32)
    q_s = np.imag(batch).astype(np.float32)
    peak = np.maximum(np.abs(i_s).max(-1, keepdims=True),
                      np.abs(q_s).max(-1, keepdims=True))
    i_s, q_s = i_s * (0.5 / peak), q_s * (0.5 / peak)

    bank = codeword_signs(continuation_texts("K1ABC", "W9XYZ"), h_pad=64)
    out = decode_window_dense(i_s, q_s, mesh, global_budget=800,
                              osd_cands_global=64,
                              ap_cw_signs=jnp.asarray(bank))
    import jax
    out = jax.device_get(out)
    res, sub = unpack_survivors(out, 16)
    n_rec = _merge_osd_decodes(out, res, sub, None)
    texts = [{d.text for d in r} for r in res]
    for b in range(16):
        want = "K1ABC W9XYZ RR73" if b in deep else "CQ K1JT FN20"
        assert want in texts[b], (b, texts[b])
    # osd channel indices must be GLOBAL (within range, no cross-shard
    # aliasing): every valid posterior row maps to a real channel
    if np.asarray(out["osd_valid"]).any():
        chan = np.asarray(out["osd_chan"])[np.asarray(out["osd_valid"])]
        assert chan.min() >= 0 and chan.max() < 16
    assert n_rec >= 0
