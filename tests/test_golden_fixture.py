"""Golden-capture replay regression (the ft8_lib-test-WAV analogue).

tests/fixtures/golden_10sig.iq is a CHECKED-IN capture: ten messages
spanning the grammar (std/directed CQ/RTTY/Field Day/nonstd type-4),
encoded by the NATIVE C++ encoder (not the Python under test) at known
f0/dt/SNR (-10..-18 dB) over AWGN; golden_10sig.txt lists them. The full
decoder must reproduce the list exactly — no misses, no phantoms."""

import os


FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _expected():
    out = []
    with open(os.path.join(FIX, "golden_10sig.txt")) as f:
        for line in f:
            text, f0, start, snr = line.rstrip("\n").split("\t")
            out.append((text, float(f0), int(start), float(snr)))
    return out


def test_golden_capture_decodes_exactly():
    from rtlsdr_ft8d_jax.host.io import read_iq
    from rtlsdr_ft8d_jax.pipeline import decode_window

    i, q = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    res = decode_window((i, q), osd_cands=8, passes=2)
    texts = {d.text for d in res}
    expected = {t for t, *_ in _expected()}
    assert texts == expected, (sorted(expected - texts),
                               sorted(texts - expected))
    # frequency estimates within a tone spacing of truth
    by_text = {d.text: d for d in res}
    for text, f0, start, snr in _expected():
        d = by_text[text]
        # candidate freq is the lowest tone: f0 - 3.5 * 6.25
        assert abs(d.freq_hz - (f0 - 21.875)) < 7.0, (text, d.freq_hz, f0)


def test_golden_capture_single_pass_floor():
    """Even the plain single-pass BP (reference-class config) must find
    the stronger half of the golden list."""
    from rtlsdr_ft8d_jax.host.io import read_iq
    from rtlsdr_ft8d_jax.pipeline import decode_window

    i, q = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    res = decode_window((i, q))
    texts = {d.text for d in res}
    expected = {t for t, *_ in _expected()}
    assert len(texts & expected) >= 6, sorted(texts)
    assert not texts - expected, texts - expected


def test_golden_capture_via_cli_replay(capsys):
    """The `-r file.iq` CLI surface (reference c:859-887) on the fixture."""
    from rtlsdr_ft8d_jax.host.cli import build_parser
    from rtlsdr_ft8d_jax.host.daemon import decode_file

    args = build_parser().parse_args(
        ["-r", os.path.join(FIX, "golden_10sig.iq"), "-f", "20m",
         "--osd", "8", "--multipass", "2"])
    rc = decode_file(args)
    assert rc == 0
    out = capsys.readouterr().out
    for text, *_ in _expected():
        assert text in out, text
