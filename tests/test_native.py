"""Native C++ library parity vs the Python protocol implementation."""

import ctypes

import numpy as np
import pytest

from rtlsdr_ft8d_jax import native
from rtlsdr_ft8d_jax.protocol.constants import (GOLDEN_PACKED, GOLDEN_TONES,
                                                FT8_PAYLOAD_BITS)
from rtlsdr_ft8d_jax.protocol.crc import payload_crc
from rtlsdr_ft8d_jax.protocol.encode import bytes_to_bits, encode
from rtlsdr_ft8d_jax.protocol.pack import pack77
from rtlsdr_ft8d_jax.protocol.text import hash_callsign
from rtlsdr_ft8d_jax.protocol.unpack import unpack77

lib = native.load()
pytestmark = pytest.mark.skipif(lib is None, reason="native lib not built")


def _bits_ptr(bits):
    arr = np.ascontiguousarray(np.asarray(bits, dtype=np.uint8))
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def test_native_crc_matches():
    payload = bytes_to_bits(GOLDEN_PACKED, FT8_PAYLOAD_BITS)
    arr, ptr = _bits_ptr(payload)
    assert lib.ft8_crc14(ptr) == payload_crc(payload)


def test_native_encode_golden():
    payload = bytes_to_bits(GOLDEN_PACKED, FT8_PAYLOAD_BITS)
    arr, ptr = _bits_ptr(payload)
    tones = np.zeros(79, dtype=np.uint8)
    lib.ft8_encode_tones(ptr, tones.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)))
    assert np.array_equal(tones.astype(np.int32), GOLDEN_TONES)


CORPUS = ["CQ K1JT FN20", "K1ABC W9XYZ EN37", "W9XYZ K1ABC R-09",
          "K1ABC W9XYZ RR73", "CQ DX W9XYZ EN37", "CQ 021 K1ABC FN42",
          "TNX BOB 73 GL", "DE VA2GKA FN35", "CQ TEST K1ABC/R FN42",
          "CQ K1JT FN20QI", "TU; W9XYZ K1ABC R 579 0013",
          "K1ABC W9XYZ 559 0007", "K1ABC RR73; W9XYZ <KH1/KH7Z> -08",
          "K1ABC W9XYZ 6A WI", "W9XYZ K1ABC R 17B EMA",
          "K1ABC W9XYZ R 32F DX", "CQ PJ4/K1ABC", "PJ4/K1ABC W9XYZ RR73",
          "W9XYZ PJ4/K1ABC 73", "CQ RAEM"]


@pytest.mark.parametrize("msg", CORPUS)
def test_native_pack_matches_python(msg):
    bits_py = pack77(msg)
    out = np.zeros(77, dtype=np.uint8)
    rc = lib.ft8_pack77(msg.encode(),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    assert rc == 0
    assert np.array_equal(out, bits_py), (
        np.nonzero(out != bits_py), msg)


@pytest.mark.parametrize("msg", CORPUS)
def test_native_unpack_matches_python(msg):
    bits = pack77(msg)
    arr, ptr = _bits_ptr(bits)
    buf = ctypes.create_string_buffer(64)
    rc = lib.ft8_unpack77(ptr, buf, 64)
    assert rc == 0
    assert buf.value.decode() == unpack77(bits)


def test_native_hash22():
    assert lib.ft8_hash22(b"PJ4/K1ABC") == hash_callsign("PJ4/K1ABC", 22)


def test_native_ldpc_check():
    payload = bytes_to_bits(GOLDEN_PACKED, FT8_PAYLOAD_BITS)
    from rtlsdr_ft8d_jax.protocol.crc import add_crc
    from rtlsdr_ft8d_jax.protocol.encode import ldpc_encode
    cw = ldpc_encode(add_crc(payload))
    arr, ptr = _bits_ptr(cw)
    assert lib.ft8_ldpc_check(ptr) == 0
    cw2 = cw.copy(); cw2[5] ^= 1
    arr2, ptr2 = _bits_ptr(cw2)
    assert lib.ft8_ldpc_check(ptr2) == 3   # column weight exactly 3


def test_ipfix_frame_structure():
    spots = (native.Ft8Spot * 2)()
    for i, (call, loc) in enumerate([(b"K1JT", b"FN20"),
                                     (b"VA2GKA", b"FN35")]):
        spots[i].call = call
        spots[i].locator = loc
        spots[i].freq_hz = 14074000 + i
        spots[i].snr_db = -10 + i
        spots[i].epoch = 1700000000
    buf = (ctypes.c_uint8 * 2048)()
    n = lib.ipfix_build_frame(buf, 2048, b"TEST1", b"AA00",
                              b"jax-ft8d-0.1", spots, 2,
                              1700000000, 1, 0xDEADBEEF)
    assert n > 0
    raw = bytes(buf[:n])
    # header: version 0x000A, total length, time, seq, session
    assert raw[0:2] == b"\x00\x0a"
    assert int.from_bytes(raw[2:4], "big") == n
    assert int.from_bytes(raw[4:8], "big") == 1700000000
    assert int.from_bytes(raw[8:12], "big") == 1
    assert int.from_bytes(raw[12:16], "big") == 0xDEADBEEF
    assert n % 4 == 0
    # descriptors present (template set ids 3 and 2, link ids 0x9992/0x9993)
    assert raw[16:18] == b"\x00\x03"
    assert b"\x99\x92" in raw and b"\x99\x93" in raw
    # spot payload contains calls and mode
    assert b"K1JT" in raw and b"VA2GKA" in raw and b"FT8" in raw


def test_ingest_ring_mixer():
    ring = lib.ingest_ring_create(1 << 16)
    # u8 interleaved IQ: constant (I=138, Q=130) -> signed (10, 2)
    n = 8
    iq = np.empty(2 * n, dtype=np.uint8)
    iq[0::2] = 138
    iq[1::2] = 130
    pushed = lib.ingest_ring_push_u8(
        ring, iq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)
    assert pushed == n
    assert lib.ingest_ring_available(ring) == n
    i_out = np.zeros(n, dtype=np.int8)
    q_out = np.zeros(n, dtype=np.int8)
    got = lib.ingest_ring_pop(
        ring, i_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        q_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), n)
    assert got == n
    # fs/4 pattern: (i,q), (q,-i), (-i,-q), (-q,i) with i=10, q=2
    assert i_out[:4].tolist() == [10, 2, -10, -2]
    assert q_out[:4].tolist() == [2, -10, -2, 10]
    lib.ingest_ring_destroy(ring)


def test_native_pack_long_hostile_inputs():
    """Regression: trailing-token accumulation must be bounded (the round-1
    strcat into char fc[32] overflowed on ~60-char inputs)."""
    hostile = [
        "K1JT W9XYZ AAAAAAAAAAAAAA BBBBBBBBBBBBBB CCCCCCCCCCCCCC DDD",
        "CQ ABCD K1ABC/LONGSUFFIX XXXXXXXXXXXXXXXXXXXXXXXXXXXXXXXXXX",
        "A B C D E F G H I J K L M N O P Q R S T U V W X Y Z",
        "",
    ]
    for msg in hostile:
        out = np.zeros(77, dtype=np.uint8)
        rc = lib.ft8_pack77(
            msg.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        assert rc == 0  # falls back to free text; must not crash/corrupt


def test_ring_overrun_counter_and_discard():
    """New round-2 ring APIs: dropped counts producer overruns (the
    daemon's drift-control signal); discard advances tail without
    copying (the UTC-boundary flush)."""
    ring = lib.ingest_ring_create(1 << 10)          # 1024 samples
    try:
        n = 900
        buf = np.zeros(2 * n, dtype=np.uint8)
        p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        assert lib.ingest_ring_push_u8(ring, p, n) == n
        assert lib.ingest_ring_dropped(ring) == 0
        # second push overflows: 1024 - 900 = 124 accepted, 776 dropped
        assert lib.ingest_ring_push_u8(ring, p, n) == 124
        assert lib.ingest_ring_dropped(ring) == 776
        assert lib.ingest_ring_available(ring) == 1024
        # boundary flush
        assert lib.ingest_ring_discard(ring, 1 << 20) == 1024
        assert lib.ingest_ring_available(ring) == 0
        # ring usable again afterwards
        assert lib.ingest_ring_push_u8(ring, p, 10) == 10
        i8 = np.zeros(10, np.int8)
        q8 = np.zeros(10, np.int8)
        got = lib.ingest_ring_pop(
            ring, i8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            q8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), 10)
        assert got == 10
    finally:
        lib.ingest_ring_destroy(ring)
