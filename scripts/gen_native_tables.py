"""Generate native/ft8_tables.h from the verified Python protocol tables."""

import os
import sys
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import numpy as np

from rtlsdr_ft8d_jax.protocol.constants import COSTAS_PATTERN, GRAY_MAP
from rtlsdr_ft8d_jax.protocol.generator import generator_matrix
from rtlsdr_ft8d_jax.protocol.parity_tables import LDPC_NM, LDPC_NUM_ROWS
from rtlsdr_ft8d_jax.protocol.text import ARRL_SECTIONS

G = generator_matrix()

with open(os.path.join(_ROOT, "native/ft8_tables.h"), "w") as f:
    f.write("// GENERATED by scripts/gen_native_tables.py — do not edit.\n")
    f.write("// Tables verified against the reference golden vector\n")
    f.write("// (/root/reference/rtlsdr_ft8d.c:919-923); see SURVEY.md.\n")
    f.write("#pragma once\n#include <cstdint>\n\n")
    f.write("static const uint8_t kCostas[7] = {"
            + ", ".join(map(str, COSTAS_PATTERN)) + "};\n")
    f.write("static const uint8_t kGrayMap[8] = {"
            + ", ".join(map(str, GRAY_MAP)) + "};\n\n")
    # generator rows as 12-byte MSB-first bit strings (91 bits + 5 pad)
    f.write("static const uint8_t kGenerator[83][12] = {\n")
    for row in G:
        padded = np.concatenate([row, np.zeros(5, np.uint8)])
        bytes_ = np.packbits(padded)
        f.write("  {" + ", ".join(f"0x{b:02x}" for b in bytes_) + "},\n")
    f.write("};\n\n")
    f.write("static const int16_t kLdpcNm[83][7] = {\n")
    for row in LDPC_NM:
        f.write("  {" + ", ".join(f"{v:3d}" for v in row) + "},\n")
    f.write("};\n")
    f.write("static const uint8_t kLdpcNumRows[83] = {"
            + ", ".join(map(str, LDPC_NUM_ROWS)) + "};\n\n")
    f.write(f"static const int kNumSections = {len(ARRL_SECTIONS)};\n")
    f.write("static const char* const kArrlSections[] = {\n  "
            + ", ".join(f'"{s}"' for s in ARRL_SECTIONS) + "};\n")

print("wrote native/ft8_tables.h")
