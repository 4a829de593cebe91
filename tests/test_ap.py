"""A-priori hypothesis ladder tests (ops/ap.py + pipeline wiring).

The enumeration bank is the deepest rung of the decode-quality ladder
(SURVEY §9.5; VERDICT r2 #1): complete continuation hypotheses scored
as a matched-filter codeword bank.
"""

import numpy as np

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.ops.ap import (QsoTracker, clamp_row_cq,
                                    clamp_row_to_call, codeword_signs,
                                    continuation_texts)
from rtlsdr_ft8d_jax.pipeline import Decode, decode_window

AMP = 0.5


def _sigma(snr_db):
    return np.sqrt(AMP ** 2 / (2 * 10 ** (snr_db / 10) * (2500 / 3200)))


def _chan(text, snr_db, seed, f0=500.0):
    return synthesize_message(text, f0_hz=f0, amplitude=AMP,
                              noise_sigma=_sigma(snr_db),
                              rng=np.random.default_rng(seed))


def texts_of(decodes):
    return {d.text for d in decodes}


def test_clamp_rows_shape_and_content():
    cq = clamp_row_cq()
    assert cq.shape == (77,)
    assert np.all(cq[29:] == 0) and np.all(np.abs(cq[:29]) == 1)
    row = clamp_row_to_call("VA2GKA")
    assert row is not None and row.shape == (77,)
    assert np.all(np.abs(row[:29]) == 1) and np.all(row[29:] == 0)
    assert clamp_row_to_call("PJ4/K1ABC") is None   # hashed: no fixed bits


def test_continuation_texts_cover_the_ladder():
    ts = continuation_texts("K1ABC", "W9XYZ", grid="EN37")
    assert "K1ABC W9XYZ RRR" in ts
    assert "K1ABC W9XYZ RR73" in ts
    assert "K1ABC W9XYZ 73" in ts
    assert "K1ABC W9XYZ EN37" in ts
    assert "K1ABC W9XYZ -10" in ts and "K1ABC W9XYZ R-10" in ts
    assert "K1ABC W9XYZ +05" in ts


def test_codeword_signs_pad_and_skip():
    signs = codeword_signs(["K1ABC W9XYZ RR73", "!!not a message!!"],
                           h_pad=8)
    assert signs.shape == (8, 174)
    assert np.all(np.abs(signs[0]) == 1)       # real hypothesis row
    assert np.all(signs[1:] == 0)              # pad rows never accepted
    assert codeword_signs(["@@@"]) is None


def test_bank_decodes_continuation_3db_below_bp():
    """A QSO continuation at -21 dB: plain BP fails, the enumeration
    bank decodes it (the honest AP column VERDICT r2 asked for)."""
    msg = "K1ABC W9XYZ RR73"
    bank = continuation_texts("K1ABC", "W9XYZ") \
        + continuation_texts("W9XYZ", "K1ABC")
    got_plain = got_bank = 0
    for t in range(4):
        iq = _chan(msg, -21.0, seed=100 + t, f0=400.0 + 60 * t)
        got_plain += msg in texts_of(decode_window(iq))
        got_bank += msg in texts_of(decode_window(iq, ap_texts=bank))
    assert got_plain <= 1          # plain BP is essentially dead here
    assert got_bank >= 3           # the bank is not


def test_bank_budget_mode_scatter_path():
    """The budgeted graph scores the bank on the flat selection and
    scatters accepts back (pipeline.py budget branch)."""
    msg = "K1ABC W9XYZ RR73"
    bank = continuation_texts("K1ABC", "W9XYZ")
    iq = np.stack([_chan(msg, -20.0, seed=7),
                   _chan("CQ K1JT FN20", -10.0, seed=8, f0=900.0)])
    res = decode_window(iq, ap_texts=bank, budget=64)
    assert msg in texts_of(res[0])
    assert "CQ K1JT FN20" in texts_of(res[1])


def test_bank_refined_rung_with_osd():
    """osd_cands > 0 adds the refined-LLR rung; decode lists stay
    correct and noise stays clean."""
    msg = "K1ABC W9XYZ RR73"
    bank = continuation_texts("K1ABC", "W9XYZ")
    iq = _chan(msg, -21.0, seed=101, f0=460.0)
    assert msg in texts_of(decode_window(iq, ap_texts=bank, osd_cands=8))


def test_bank_no_false_decodes_on_noise():
    """Pure noise through a full 8-direction bank + OSD must produce
    ZERO decodes (laddered correlation gate, ops/ap.py)."""
    bank = []
    for a, b in [("K1ABC", "W9XYZ"), ("F8ABC", "JA1XYZ"),
                 ("VK2DEF", "N0GHI"), ("G4JKL", "PY2MNO")]:
        bank += continuation_texts(a, b, "FN42")
        bank += continuation_texts(b, a, "EN37")
    rng = np.random.default_rng(55)
    noise = (rng.normal(0, 1.0, (16, 48000))
             + 1j * rng.normal(0, 1.0, (16, 48000))).astype(np.complex64)
    res = decode_window(noise, ap_texts=bank, osd_cands=8)
    assert sum(len(r) for r in res) == 0


def test_qso_tracker_harvests_and_expires():
    tr = QsoTracker(max_pairs=2, ttl=2, h_max=256)
    tr.observe([Decode(text="K1ABC W9XYZ -07", freq_hz=500.0,
                       time_sec=0.0, score=20,
                       call_field="W9XYZ", loc_field="",
                       cq_field=False)])
    assert ("K1ABC", "W9XYZ") in tr._pairs
    ts = tr.hypothesis_texts()
    assert "K1ABC W9XYZ RR73" in ts and "W9XYZ K1ABC RR73" in ts
    bank = tr.bank()
    assert bank.shape == (256, 174)
    assert np.any(bank != 0)
    # ages out after ttl quiet windows
    tr.observe([])
    tr.observe([])
    tr.observe([])
    assert not tr._pairs
    assert np.all(tr.bank() == 0)                  # shape-stable empty


def test_qso_tracker_ignores_cq_and_hashed():
    tr = QsoTracker()
    tr.observe([
        Decode(text="CQ K1JT FN20", freq_hz=0, time_sec=0, score=20,
               call_field="K1JT", loc_field="FN20", cq_field=True),
        Decode(text="<...> W9XYZ 73", freq_hz=0, time_sec=0, score=20,
               call_field="W9XYZ", loc_field="", cq_field=False),
    ])
    assert not tr._pairs
    # but the CQ caller's grid is remembered for later hypotheses
    assert tr._grids.get("K1JT") == "FN20"


def test_qso_state_two_window_loop():
    """The full QSO-continuation flow: window 1 decodes a strong
    directed message, the tracker hypothesizes the continuations, and
    window 2 decodes the -21 dB reply that plain BP misses."""
    tr = QsoTracker(h_max=256)
    w1 = _chan("K1ABC W9XYZ -07", -10.0, seed=300)
    res1 = decode_window(w1, ap_texts=tr.bank())
    tr.observe(res1)
    assert ("K1ABC", "W9XYZ") in tr._pairs
    reply = "W9XYZ K1ABC R-12"
    w2 = _chan(reply, -21.0, seed=301, f0=700.0)
    assert reply not in texts_of(decode_window(w2))
    assert reply in texts_of(decode_window(w2, ap_texts=tr.bank()))


def test_bank_rejects_wrong_hypothesis_on_real_signal():
    """A real signal whose true message is NOT in the bank must not be
    claimed as a related bank row. This is the binding false-decode
    class (not noise): 'VA2GKA K1ABC -07' shares K1ABC's callsign bits
    with the bank's 'W9XYZ K1ABC ...' rows and correlates up to ~0.52
    at threshold-straddling SNR; the synced gate sits at 0.55 for
    exactly this reason (ops/ap.py calibration comment)."""
    bank_texts = (continuation_texts("K1ABC", "W9XYZ", grid="EN37")
                  + continuation_texts("W9XYZ", "K1ABC"))
    bank_set = {" ".join(t.split()) for t in bank_texts}

    def sigma(snr, amp=0.5):
        return np.sqrt(amp ** 2 / (2 * 10 ** (snr / 10) * (2500 / 3200)))

    msg = "VA2GKA K1ABC -07"
    for snr in (-20.0, -21.0, -21.5):
        chans = [synthesize_message(
            msg, f0_hz=250 + 20 * t, noise_sigma=sigma(snr),
            rng=np.random.default_rng(hash((snr, t, 32)) % (1 << 31)))
            for t in range(24)]
        res = decode_window(np.stack(chans), ap_texts=bank_texts,
                            osd_cands=8)
        wrong = [d.text for decs in res for d in decs
                 if d.text in bank_set]
        assert not wrong, (snr, wrong)
