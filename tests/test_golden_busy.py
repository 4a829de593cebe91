"""Busy-band golden fixture: 18 native-encoded signals, six of them weak
(-17..-19 dB) partners 18 Hz from a strong neighbor — the subtraction
multipass regime. The expected column in golden_busy.txt records which
signals the full stack decodes; the suite enforces no regressions and no
phantom decodes."""

import os


FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _load():
    rows = []
    with open(os.path.join(FIX, "golden_busy.txt")) as f:
        for line in f:
            text, f0, start, snr, dec = line.rstrip("\n").split("\t")
            rows.append((text, float(f0), int(start), float(snr),
                         dec == "1"))
    return rows


def test_busy_band_multipass_decodes_expected_set():
    from rtlsdr_ft8d_jax.host.io import read_iq
    from rtlsdr_ft8d_jax.pipeline import decode_window

    i, q = read_iq(os.path.join(FIX, "golden_busy.iq"))
    rows = _load()
    all_texts = {t for t, *_ in rows}
    expected = {t for t, _f, _s, _snr, dec in rows if dec}
    assert len(expected) >= 15          # the fixture's recorded floor

    res = decode_window((i, q), passes=3, osd_cands=8)
    texts = {d.text for d in res}
    missing = expected - texts
    assert not missing, sorted(missing)
    assert not texts - all_texts, texts - all_texts   # no phantoms

    # single-pass must still get the strong population
    res1 = decode_window((i, q))
    texts1 = {d.text for d in res1}
    assert len(texts1 & all_texts) >= 12
    assert not texts1 - all_texts


def test_busy_band_subtraction_recovers_overlapped():
    """At least 3 of the 6 weak overlapped partners (18 Hz from a strong
    signal) must appear ONLY with multipass on."""
    from rtlsdr_ft8d_jax.host.io import read_iq
    from rtlsdr_ft8d_jax.pipeline import decode_window

    i, q = read_iq(os.path.join(FIX, "golden_busy.iq"))
    rows = _load()
    weak = {t for t, _f, _s, snr, _d in rows if snr <= -16}
    res1 = {d.text for d in decode_window((i, q))}
    res3 = {d.text for d in decode_window((i, q), passes=3, osd_cands=8)}
    gained = (res3 & weak) - res1
    assert len(gained) >= 2, (sorted(res1 & weak), sorted(res3 & weak))


def test_busy_band_full_stack_decodes_all_18():
    """With the QSO-continuation bank seeded (as QsoTracker would be
    after hearing the VA2AAA<->PY2CCC exchange in a previous window),
    the full stack decodes EVERY signal in the fixture — including the
    one interference-limited partner the AP-less stack misses — with
    zero phantoms."""
    from rtlsdr_ft8d_jax.host.io import read_iq
    from rtlsdr_ft8d_jax.ops.ap import codeword_signs, continuation_texts
    from rtlsdr_ft8d_jax.pipeline import decode_window

    i, q = read_iq(os.path.join(FIX, "golden_busy.iq"))
    rows = _load()
    all_texts = {t for t, *_ in rows}
    bank = codeword_signs(continuation_texts("VA2AAA", "PY2CCC")
                          + continuation_texts("PY2CCC", "VA2AAA"),
                          h_pad=256)
    res = decode_window((i, q), passes=3, osd_cands=8, ap_texts=bank)
    texts = {d.text for d in res}
    assert texts >= all_texts, sorted(all_texts - texts)
    assert not texts - all_texts, sorted(texts - all_texts)
