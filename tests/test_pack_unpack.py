"""pack77/unpack77 grammar tests: golden vector + roundtrip corpus."""

import numpy as np
import pytest

from rtlsdr_ft8d_jax.protocol.constants import GOLDEN_MESSAGE, GOLDEN_PACKED
from rtlsdr_ft8d_jax.protocol.encode import bits_to_bytes, bytes_to_bits
from rtlsdr_ft8d_jax.protocol.pack import pack77, pack_free_text
from rtlsdr_ft8d_jax.protocol.text import CallsignHashTable, hash_callsign
from rtlsdr_ft8d_jax.protocol.unpack import unpack77

ROUNDTRIP = [
    "CQ K1JT FN20",
    "CQ DX W9XYZ EN37",
    "K1ABC W9XYZ EN37",
    "W9XYZ K1ABC -11",
    "K1ABC W9XYZ R-09",
    "W9XYZ K1ABC RRR",
    "K1ABC W9XYZ 73",
    "K1ABC W9XYZ RR73",
    "CQ TEST K1ABC/R FN42",
    "K1ABC/R W9XYZ/R RR73",
    "DE VA2GKA FN35",
    "QRZ K9AN EN50",
    "CQ 021 K1ABC FN42",
    "TNX BOB 73 GL",
    "CQ VA2GKA/P FN35",
    "CQ PJ4/K1ABC",
]


def test_pack77_golden():
    bits = pack77(GOLDEN_MESSAGE)
    assert bits_to_bytes(bits)[:10] == GOLDEN_PACKED


def test_unpack77_golden():
    bits = bytes_to_bits(GOLDEN_PACKED, 77)
    assert unpack77(bits) == "CQ K1JT FN20"


@pytest.mark.parametrize("msg", ROUNDTRIP)
def test_roundtrip(msg):
    bits = pack77(msg)
    assert bits.shape == (77,)
    out = unpack77(bits)
    if "PJ4/" in msg:
        # nonstandard call falls back to free text here (hash-based type 4
        # pack is a possible future addition); must still roundtrip as text
        assert out == msg
    else:
        assert out == msg


def test_free_text_roundtrip():
    bits = pack_free_text("HELLO WORLD.?")
    assert unpack77(bits) == "HELLO WORLD.?"


def test_hash_table():
    t = CallsignHashTable()
    t.add("PJ4/K1ABC")
    h22 = hash_callsign("PJ4/K1ABC", 22)
    assert t.lookup(h22, 22) == "PJ4/K1ABC"
    assert t.lookup(h22 >> 10, 12) == "PJ4/K1ABC"


def test_rtty_roundtrip():
    from rtlsdr_ft8d_jax.protocol.unpack import unpack77 as u
    for msg in ["TU; W9XYZ K1ABC R 579 0013", "K1ABC W9XYZ 559 0007",
                "W9XYZ K1ABC R 599 7999"]:
        assert u(pack77(msg)) == msg


def test_dxpedition_roundtrip():
    from rtlsdr_ft8d_jax.protocol.text import CallsignHashTable
    from rtlsdr_ft8d_jax.protocol.unpack import unpack77 as u
    t = CallsignHashTable()
    t.add("KH1/KH7Z")
    msg = "K1ABC RR73; W9XYZ <KH1/KH7Z> -08"
    assert u(pack77(msg), t) == msg


def test_rtty_does_not_capture_free_text():
    from rtlsdr_ft8d_jax.protocol.unpack import unpack77 as u
    msg = "HELO 579 0013"   # 13 chars, non-call tokens
    assert u(pack77(msg)) == msg   # must stay free text


def test_unpack_spot_structural_fields():
    """Spot call/loc come from the payload fields, not text re-parsing
    (the reference's strtok parse misreads 'CQ RAEM KO85')."""
    from rtlsdr_ft8d_jax.protocol.unpack import unpack_spot

    cases = [
        ("CQ K1JT FN20", "K1JT", "FN20", True),
        ("CQ DX W9XYZ EN37", "W9XYZ", "EN37", True),
        ("CQ 021 K1ABC FN42", "K1ABC", "FN42", True),
        ("CQ TEST K1ABC FN42", "K1ABC", "FN42", True),
        ("K1ABC W9XYZ EN37", "W9XYZ", "EN37", False),
        ("K1ABC W9XYZ R-09", "W9XYZ", "", False),
    ]
    for text, call, loc, is_cq in cases:
        t, c, l, q = unpack_spot(pack77(text))
        assert t == text
        assert c == call, (text, c)
        assert l == loc, (text, l)
        assert q == is_cq, text
    # nonstandard call in a CQ (type 4): 'CQ RAEM' — the text heuristic the
    # reference uses would see a directed-CQ modifier; the c1 field says CQ
    # and the c58 field carries the call
    t, c, l, q = unpack_spot(pack77("CQ RAEM"))
    assert t == "CQ RAEM" and c == "RAEM" and q is True
