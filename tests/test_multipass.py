"""Multi-pass decode: subtraction reveals signals masked by stronger ones."""

import numpy as np

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.pipeline import decode_window


def _scene(rng):
    """Strong signal on top of a 23 dB weaker one at overlapping tones."""
    strong = synthesize_message("CQ K1JT FN20", f0_hz=500.0, amplitude=0.5,
                                noise_sigma=0.0)
    weak = synthesize_message("K1ABC W9XYZ EN37", f0_hz=506.25,
                              amplitude=0.035, noise_sigma=0.0)
    noise = 0.004 * (rng.standard_normal(48000)
                     + 1j * rng.standard_normal(48000))
    return (strong + weak + noise).astype(np.complex64)


def test_second_pass_finds_masked_signal():
    iq = _scene(np.random.default_rng(7))
    one = {d.text for d in decode_window(iq, passes=1)}
    two = {d.text for d in decode_window(iq, passes=2)}
    assert "CQ K1JT FN20" in one
    assert "K1ABC W9XYZ EN37" not in one          # masked in pass 1
    assert "CQ K1JT FN20" in two
    assert "K1ABC W9XYZ EN37" in two              # revealed by subtraction


def test_multipass_no_false_decodes_on_clean():
    iq = synthesize_message("CQ K1JT FN20", f0_hz=700.0, amplitude=0.5,
                            noise_sigma=0.1, rng=np.random.default_rng(9))
    decs = decode_window(iq, passes=3)
    texts = [d.text for d in decs]
    assert texts.count("CQ K1JT FN20") == 1
    assert len(texts) == 1
