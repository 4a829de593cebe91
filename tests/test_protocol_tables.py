"""Protocol-table correctness: golden vector + LDPC structure.

The golden vector is the reference's own documented self-test output
(/root/reference/rtlsdr_ft8d.c:919-923).
"""

import numpy as np

from rtlsdr_ft8d_jax.protocol.constants import (
    COSTAS_OFFSETS, COSTAS_PATTERN, FT8_LDPC_K, FT8_LDPC_M, FT8_LDPC_N,
    FT8_PAYLOAD_BITS, GOLDEN_PACKED, GOLDEN_TONES)
from rtlsdr_ft8d_jax.protocol.crc import add_crc, check_crc
from rtlsdr_ft8d_jax.protocol.encode import (bytes_to_bits, encode,
                                             ldpc_encode, tones_to_codeword)
from rtlsdr_ft8d_jax.protocol.generator import generator_matrix
from rtlsdr_ft8d_jax.protocol.parity_tables import (LDPC_MN, LDPC_NM,
                                                    LDPC_NUM_ROWS)


def test_golden_costas():
    for off in COSTAS_OFFSETS:
        assert np.array_equal(GOLDEN_TONES[off:off + 7], COSTAS_PATTERN)


def test_golden_payload_extraction():
    cw = tones_to_codeword(GOLDEN_TONES)
    payload = bytes_to_bits(GOLDEN_PACKED, FT8_PAYLOAD_BITS)
    assert np.array_equal(cw[:FT8_PAYLOAD_BITS], payload)


def test_golden_crc():
    cw = tones_to_codeword(GOLDEN_TONES)
    payload = cw[:FT8_PAYLOAD_BITS]
    assert np.array_equal(add_crc(payload), cw[:FT8_LDPC_K])
    assert check_crc(cw[:FT8_LDPC_K])


def test_golden_full_encode():
    payload = bytes_to_bits(GOLDEN_PACKED, FT8_PAYLOAD_BITS)
    assert np.array_equal(encode(payload), GOLDEN_TONES)


def test_crc_detects_flips():
    payload = bytes_to_bits(GOLDEN_PACKED, FT8_PAYLOAD_BITS)
    msg = add_crc(payload)
    for i in (0, 13, 76, 80, 90):
        bad = msg.copy()
        bad[i] ^= 1
        assert not check_crc(bad)


def test_parity_structure():
    G = generator_matrix()
    assert G.shape == (FT8_LDPC_M, FT8_LDPC_K)
    # column weights exactly 3
    counts = np.zeros(FT8_LDPC_N, dtype=int)
    for m in range(FT8_LDPC_M):
        row = LDPC_NM[m]
        row = row[row >= 0]
        assert len(row) == LDPC_NUM_ROWS[m]
        assert LDPC_NUM_ROWS[m] in (6, 7)
        counts[row] += 1
    assert np.all(counts == 3)
    # Mn is the transpose relation
    for n in range(FT8_LDPC_N):
        for m in LDPC_MN[n]:
            assert n in LDPC_NM[m]


def test_parity_annihilates_codewords():
    G = generator_matrix()
    rng = np.random.default_rng(42)
    for _ in range(16):
        m = rng.integers(0, 2, size=FT8_LDPC_K).astype(np.uint8)
        cw = ldpc_encode(m)
        for row_idx in range(FT8_LDPC_M):
            row = LDPC_NM[row_idx]
            row = row[row >= 0]
            assert int(cw[row].sum()) % 2 == 0
