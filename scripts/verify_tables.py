"""Verify protocol tables against the reference golden vector.

Golden vector (reference rtlsdr_ft8d.c:919-923):
  pack77("CQ K1JT FN20QI") = 00 00 00 20 4d fc dc 8a 14 08
  tones = 3140652...3140652 (79 symbols)

Checks:
  1. Costas symbols in golden tones match COSTAS_PATTERN.
  2. Extract the 174-bit codeword from golden tones (Gray-demap data symbols);
     its first 77 bits must equal the packed payload.
  3. CRC-14 of the payload must equal codeword bits 77..90.
  4. LDPC generator applied to message bits must reproduce parity bits 91..173.
     Reports per-row mismatches to localize any bad generator rows.
"""

import os
import sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import numpy as np

from rtlsdr_ft8d_jax.protocol.constants import (
    COSTAS_OFFSETS, COSTAS_PATTERN, GOLDEN_PACKED, GOLDEN_TONES,
    FT8_PAYLOAD_BITS, FT8_LDPC_K)
from rtlsdr_ft8d_jax.protocol.crc import add_crc
from rtlsdr_ft8d_jax.protocol.encode import (bytes_to_bits, tones_to_codeword,
                                             ldpc_encode)

ok = True

# 1. Costas
for off in COSTAS_OFFSETS:
    got = GOLDEN_TONES[off:off+7]
    if not np.array_equal(got, COSTAS_PATTERN):
        print(f"FAIL costas @ {off}: {got}")
        ok = False
print("costas:", "OK" if ok else "FAIL")

# 2. Codeword extraction vs packed payload
cw = tones_to_codeword(GOLDEN_TONES)
payload = bytes_to_bits(GOLDEN_PACKED, FT8_PAYLOAD_BITS)
if np.array_equal(cw[:FT8_PAYLOAD_BITS], payload):
    print("payload bits: OK")
else:
    bad = np.nonzero(cw[:FT8_PAYLOAD_BITS] != payload)[0]
    print(f"payload bits: FAIL at {bad}")
    ok = False

# 3. CRC
msg = add_crc(payload)
if np.array_equal(msg, cw[:FT8_LDPC_K]):
    print("crc14: OK")
else:
    bad = np.nonzero(msg != cw[:FT8_LDPC_K])[0]
    print(f"crc14: FAIL, mismatched bits {bad}")
    print("  expect:", cw[FT8_PAYLOAD_BITS:FT8_LDPC_K])
    print("  got:   ", msg[FT8_PAYLOAD_BITS:FT8_LDPC_K])
    ok = False

# 4. Generator parity
cw_enc = ldpc_encode(cw[:FT8_LDPC_K])
parity_true = cw[FT8_LDPC_K:]
parity_got = cw_enc[FT8_LDPC_K:]
if np.array_equal(parity_got, parity_true):
    print("generator parity: OK (all 83 bits)")
else:
    bad = np.nonzero(parity_got != parity_true)[0]
    print(f"generator parity: FAIL on rows {bad.tolist()} ({len(bad)}/83)")
    ok = False

print("ALL OK" if ok else "FAILURES PRESENT")
sys.exit(0 if ok else 1)
