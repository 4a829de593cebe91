"""Adversarial grammar edges, Python <-> C++ in both directions.

VERDICT r2 weak #6: the 1500-msg fuzz generates grammar-typical strings;
the three real divergences it caught all lived at hostile edges. This
file targets those edge classes directly: 13-char free text at alphabet
boundaries, max-length '/' nonstandard calls, 22-bit hash-collision
lookups, all-token CQ variants, and numeric field boundaries. Every case
asserts the two independent implementations agree on accept-vs-reject,
on every packed BIT, and on the rendered text.
"""

import ctypes

import numpy as np
import pytest

from rtlsdr_ft8d_jax import native
from rtlsdr_ft8d_jax.protocol.pack import PackError, pack77
from rtlsdr_ft8d_jax.protocol.text import CallsignHashTable, hash_callsign
from rtlsdr_ft8d_jax.protocol.unpack import (UnpackError, unpack77,
                                             unpack_spot, unpack_spots_batch)

lib = native.load()
pytestmark = pytest.mark.skipif(lib is None, reason="native lib unavailable")


def _native_pack(msg):
    out = np.zeros(77, np.uint8)
    rc = lib.ft8_pack77(
        msg.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, rc


def _native_unpack(bits):
    arr = np.ascontiguousarray(bits, np.uint8)
    buf = ctypes.create_string_buffer(64)
    rc = lib.ft8_unpack77(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf, 64)
    return buf.value.decode() if rc == 0 else None


def _both_ways(msg):
    """Pack with both impls; if packed, unpack with both. Returns the
    canonical rendering (or None if both reject) after asserting parity
    at every step."""
    try:
        py_bits = pack77(msg)
    except PackError:
        py_bits = None
    c_bits, c_rc = _native_pack(msg)
    if py_bits is None:
        assert c_rc != 0, f"C++ packed what Python refused: {msg!r}"
        return None
    assert c_rc == 0, f"Python packed what C++ refused: {msg!r}"
    assert np.array_equal(py_bits, c_bits), f"bit mismatch: {msg!r}"
    try:
        py_text = unpack77(py_bits)
    except UnpackError:
        py_text = None
    c_text = _native_unpack(py_bits)
    assert py_text == c_text, (msg, py_text, c_text)
    return py_text


def test_free_text_alphabet_boundaries():
    """13-char free text at the base-42 extremes: first/last alphabet
    chars, all-special strings, and the maximum 71-bit payload value."""
    cases = [
        "?" * 13,                  # max base-42 value (overflow edge)
        "0" * 13,
        "Z" * 13,
        "+-./?+-./?+-.",           # specials only
        "A" * 13,
        "?" * 12 + "A",
        "A" + "?" * 12,
        "0123456789+-.",
        "TNX BOB 73 GL",           # the canonical QEX free-text example
        "/" * 13,
        ".............",
    ]
    for msg in cases:
        text = _both_ways(msg)
        assert text is not None, msg
        # free text round-trips up to leading/trailing whitespace
        assert text.strip() == msg.strip().lstrip(), (msg, text)


def test_free_text_normalization_parity():
    """Whitespace / overlong / out-of-alphabet handling must agree even
    when the behavior is reject-or-mangle."""
    for msg in ["  LEADING", "TRAILING   ", "A  B  C", "a lower case",
                "FOURTEEN CHAR X", "*&^%$#@!", "", " ", "\t",
                "EXACTLY13CHAR", "EXACTLY13CHARX"]:
        _both_ways(msg)           # parity assertions inside


def test_nonstd_call_max_length():
    """11-char '/'-bearing nonstandard calls (the i3=4 58-bit limit),
    in every message position."""
    longcalls = ["PJ4/K1ABCDE", "KH1/K1ABCDE", "K1ABCDE/QRP",
                 "ABCDEFGHIJK", "3D2/W9XYZAB", "K1ABC/MM"]
    for nc in longcalls:
        for form in (f"CQ {nc}",
                     f"{nc} K1ABC",
                     f"K1ABC {nc}",
                     f"{nc} K1ABC RR73",
                     f"K1ABC {nc} 73"):
            _both_ways(form)
    # 12 chars exceed the i3=4 58-bit field AND the 11-char hash limit:
    # an unresolvable '<...>' would lose more than free text does, so both
    # impls fall to free text (13-char truncation), identically
    assert _both_ways("CQ ABCDEFGHIJKL") == "CQ ABCDEFGHIJ"


def test_hash_collision_lookup():
    """GGCUO and ORDE share 22-bit hash 4189921 (found by search): the
    LAST learned call must win in both the sequential and the batched
    unpack path, identically."""
    assert hash_callsign("GGCUO", 22) == hash_callsign("ORDE", 22)
    seq = [
        "CQ GGCUO",               # learns GGCUO
        "GGCUO K1ABC RR73",       # refers to it by hash
        "CQ ORDE",                # collides: table now renders ORDE
        "ORDE K1ABC 73",          # same h22, resolves to ORDE
    ]
    rows, bits_list = [], []
    for m in seq:
        bits = pack77(m)
        bits_list.append(bits)
        rows.append(np.packbits(np.concatenate(
            [bits, np.zeros(19, np.uint8)])))
    h_seq = CallsignHashTable()
    expected = [unpack_spot(b, h_seq) for b in bits_list]
    h_batch = CallsignHashTable()
    got = unpack_spots_batch(np.stack(rows), h_batch)
    assert got == expected
    assert h_batch._by22 == h_seq._by22
    # the colliding slot holds the last writer
    assert h_seq._by22[hash_callsign("ORDE", 22)] == "ORDE"


def test_junk_fields_fall_to_free_text():
    """Structured-looking junk must NOT be lossily force-parsed: the c28
    hash fallback requires a valid hashable call and reports require
    digits, so these fall to free text and round-trip exactly. Both were
    live Python<->C++ divergences caught by scripts/fuzz_extended.py
    ('BXUCO /R': bare '/R' stripped-to-empty vs hashed; 'WXM.UO8 9 -D':
    C++ atoi('-D') accepted junk as a +00 report)."""
    from rtlsdr_ft8d_jax.protocol.pack import pack77

    for msg in ["BXUCO /R", "WXM.UO8 9 -D", "K1ABC /P", "/R /R",
                "K1ABC W9X -D", "BXUCO TNX 73"]:
        text = _both_ways(msg)
        bits = pack77(msg)
        i3 = int(bits[74]) * 4 + int(bits[75]) * 2 + int(bits[76])
        assert i3 == 0, (msg, i3)          # free text, not structured
        assert text == msg, (msg, text)    # lossless round-trip


def test_grammar_edge_regressions():
    """Cases from the protocol-layer review: bare report sign, '/P' after
    a directed CQ, bare directed-CQ modifier — parity AND semantics."""
    from rtlsdr_ft8d_jax.protocol.pack import pack77

    # bare '+' third field: used to escape as an uncaught ValueError
    # (PackError subclasses ValueError so `except PackError` missed it)
    text = _both_ways("K1ABC W9XYZ +")
    assert text == "K1ABC W9XYZ +"          # free text, lossless
    # '/P' at tokens[2] after a two-token directed CQ is type 2
    bits = pack77("CQ EU K1ABC/P IO91")
    assert int(bits[74]) * 4 + int(bits[75]) * 2 + int(bits[76]) == 2
    assert _both_ways("CQ EU K1ABC/P IO91") == "CQ EU K1ABC/P IO91"
    # a trailing directed-CQ modifier with no caller: both codecs must
    # agree (free text), not emit divergent structured bits
    assert _both_ways("CQ 123") == "CQ 123"
    assert _both_ways("CQ DX") == "CQ DX"


def test_spot_extracts_nonstd_sender():
    """i3=4 non-CQ: the c58 call in the SENDER slot must be spotted
    (consistent with i3 1/2/3; the reference's CQ-only spot slots are a
    deliberately-unreproduced quirk, SURVEY §8)."""
    from rtlsdr_ft8d_jax.protocol.pack import pack77
    from rtlsdr_ft8d_jax.protocol.unpack import unpack_spot

    bits = pack77("K1ABC PJ4/W9XYZ RRR")    # h1=0: c58 call is sender
    text, call, loc, is_cq = unpack_spot(bits)
    assert call == "PJ4/W9XYZ" and not is_cq
    bits = pack77("PJ4/W9XYZ K1ABC 73")     # h1=1: sender is only hashed
    text, call, loc, is_cq = unpack_spot(bits)
    assert call == "" and not is_cq


def test_cq_token_variants():
    """Every CQ modifier class at its boundary values."""
    for mod in ["000", "999", "001", "A", "ZZ", "ZZZZ", "DX", "POTA",
                "TEST"]:
        _both_ways(f"CQ {mod} K1ABC FN20")
    # 5-letter modifier / out-of-range numeric must agree (reject)
    _both_ways("CQ ABCDE K1ABC FN20")
    _both_ways("CQ 1000 K1ABC FN20")


def test_numeric_field_boundaries():
    """Reports, RTTY serials, Field Day classes at their envelope."""
    for rpt in ["-30", "-31", "+49", "+50", "-50", "+00", "-00"]:
        _both_ways(f"K1ABC W9XYZ {rpt}")
        _both_ways(f"K1ABC W9XYZ R{rpt}")
    for serial in ["0000", "0001", "7999", "8000", "9999"]:
        _both_ways(f"K1ABC W9XYZ 579 {serial}")
    for cls in ["1A", "32F", "16B", "33A", "0A"]:
        _both_ways(f"K1ABC W9XYZ {cls} WI")
    for grid in ["AA00", "RR99", "RR73", "KO85"]:
        _both_ways(f"K1ABC W9XYZ {grid}")
    _both_ways("K1ABC W9XYZ R AA00")
    _both_ways("K1ABC W9XYZ R RR99")


def test_hashed_call_brackets():
    """<bracketed> hashed-call references at max length, DXpedition and
    i3=4 forms."""
    for msg in ["K1ABC RR73; W9XYZ <PJ4/K1ABCDE> -15",
                "K1ABC RR73; W9XYZ <ABCDEFGHIJK> +00",
                "<PJ4/K1ABCDE> W9XYZ",
                "CQ ABCDEFGHIJK"]:
        _both_ways(msg)
