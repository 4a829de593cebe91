"""Extended Python<->C++ codec fuzz (one-off confidence run).

Same generators and parity rules as tests/test_fuzz_parity.py, scaled up
(default 50,000 grammar messages + 200,000 random payload unpacks) for
idle-CPU soak runs; the in-suite test stays at 1,500 to keep suite time
bounded. Usage: python3 scripts/fuzz_extended.py [n_msgs] [n_payloads]
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import numpy as np


def main():
    n_msgs = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    n_payloads = int(sys.argv[2]) if len(sys.argv) > 2 else 200_000

    from test_fuzz_parity import (_native_pack, _native_unpack, lib,
                                  random_message)

    from rtlsdr_ft8d_jax.protocol.pack import PackError, pack77
    from rtlsdr_ft8d_jax.protocol.unpack import UnpackError, unpack77

    assert lib is not None, "native lib required (make -C native)"
    rng = np.random.default_rng(777)
    mismatches = []
    n_checked = 0
    for i in range(n_msgs):
        msg = random_message(rng)
        try:
            py_bits = pack77(msg)
        except PackError:
            py_bits = None
        c_bits, c_rc = _native_pack(msg)
        if py_bits is None:
            if c_rc == 0:
                mismatches.append(("pack-refusal", msg))
            continue
        if c_rc != 0 or not np.array_equal(py_bits, c_bits):
            mismatches.append(("pack", msg))
            continue
        try:
            py_text = unpack77(py_bits)
        except UnpackError:
            py_text = None
        c_text = _native_unpack(py_bits)
        if py_text != c_text:
            mismatches.append(("unpack", msg, py_text, c_text))
        n_checked += 1
        if (i + 1) % 5000 == 0:
            print(f"{i + 1}/{n_msgs} grammar msgs, {n_checked} checked, "
                  f"{len(mismatches)} mismatches", flush=True)

    for i in range(n_payloads):
        bits = rng.integers(0, 2, 77).astype(np.uint8)
        try:
            py_text = unpack77(bits)
        except UnpackError:
            py_text = None
        c_text = _native_unpack(bits)
        if py_text != c_text:
            mismatches.append(("payload", bits.tolist(), py_text, c_text))
        if (i + 1) % 20000 == 0:
            print(f"{i + 1}/{n_payloads} payloads, "
                  f"{len(mismatches)} mismatches", flush=True)

    # phase 3: spot-field extraction parity (native batched vs sequential
    # Python, shared hash-table side effects) over packable grammar msgs
    from rtlsdr_ft8d_jax.protocol.text import CallsignHashTable
    from rtlsdr_ft8d_jax.protocol.unpack import unpack_spot, \
        unpack_spots_batch

    n_spot = min(n_msgs, 20_000)
    rows, keep = [], []
    for _ in range(n_spot):
        try:
            bits = pack77(random_message(rng))
        except PackError:
            continue
        rows.append(np.packbits(np.concatenate(
            [bits, np.zeros(19, np.uint8)])))
        keep.append(bits)
    h_seq = CallsignHashTable()
    expected = []
    for bits in keep:
        try:
            expected.append(unpack_spot(bits, h_seq))
        except UnpackError:
            expected.append(None)
    h_batch = CallsignHashTable()
    got = unpack_spots_batch(np.stack(rows), h_batch)
    for i, (e, g) in enumerate(zip(expected, got)):
        if e != g:
            mismatches.append(("spot", i, e, g))
    if h_batch._by22 != h_seq._by22:
        mismatches.append(("spot-hashtable",))
    print(f"spot parity over {len(keep)} packable msgs", flush=True)

    print(f"DONE grammar={n_msgs} checked={n_checked} "
          f"payloads={n_payloads} spots={len(keep)} "
          f"mismatches={len(mismatches)}")
    for m in mismatches[:40]:
        print("MISMATCH:", m)
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
