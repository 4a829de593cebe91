"""Robustness: degenerate inputs must not crash or emit false decodes."""

import numpy as np
import pytest

from rtlsdr_ft8d_jax.pipeline import decode_window
from rtlsdr_ft8d_jax.protocol.pack import pack77
from rtlsdr_ft8d_jax.protocol.unpack import UnpackError, unpack77


def test_all_zero_window():
    decs = decode_window(np.zeros(48000, np.complex64))
    assert decs == []


def test_pure_noise_no_false_decodes():
    rng = np.random.default_rng(0)
    iq = (rng.standard_normal(48000)
          + 1j * rng.standard_normal(48000)).astype(np.complex64)
    assert decode_window(iq) == []


def test_dc_offset_window():
    iq = np.full(48000, 0.3 + 0.3j, np.complex64)
    assert decode_window(iq) == []


@pytest.mark.parametrize("seed", range(8))
def test_pack77_fuzz_never_crashes(seed):
    rng = np.random.default_rng(seed)
    chars = " ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+-./?<>;"
    for _ in range(50):
        n = rng.integers(1, 30)
        text = "".join(rng.choice(list(chars), n))
        bits = pack77(text)
        assert bits.shape == (77,)
        try:
            unpack77(bits)
        except UnpackError:
            pass


def test_unpack_fuzz_never_hangs():
    rng = np.random.default_rng(1)
    for _ in range(200):
        bits = rng.integers(0, 2, 77).astype(np.uint8)
        try:
            out = unpack77(bits)
            assert isinstance(out, str)
        except UnpackError:
            pass


def test_all_features_compose():
    """budget + OSD + AP + multipass together on a mixed batch: every
    decodable signal found, quiet channels clean."""
    import numpy as np

    from rtlsdr_ft8d_jax.host.synth import synthesize_message
    from rtlsdr_ft8d_jax.pipeline import decode_window

    rng = np.random.default_rng(11)
    msgs = {}
    chans = []
    for b in range(16):
        if b % 3 == 0:
            m = f"CQ W{b}AB FN{b:02d}"
            msgs[b] = m
            chans.append(synthesize_message(
                m, f0_hz=350 + 60 * b, noise_sigma=0.1, amplitude=0.08,
                rng=np.random.default_rng(b)))
        else:
            chans.append((0.1 * rng.standard_normal(48000)
                          + 0.1j * rng.standard_normal(48000))
                         .astype(np.complex64))
    res = decode_window(np.stack(chans), budget=256, osd_cands=4,
                        ap_cq=True, passes=2)
    for b, m in msgs.items():
        assert m in {d.text for d in res[b]}, (b, res[b])
    for b in range(16):
        if b not in msgs:
            assert not res[b], (b, res[b])
