"""Two-stage top-K exactness in its designed failure regime.

find_sync's chunked selection (ops/sync.py: top-CHUNK_K per 16-cell /
100 Hz freq chunk, then global top-K) is exact unless more than CHUNK_K
of the true top-K cells share one (time_sub, freq_sub, time_offset,
100 Hz) chunk. That requires >4 interleaved signals inside 100 Hz at
IDENTICAL time alignment — but an FT8 signal occupies 50 Hz, so more
than ~2 cleanly decodable signals cannot physically coexist in a chunk,
and signals at different alignments land in different chunks. These
tests drive the worst case (5-8 co-chunk, co-aligned signals) and pin
the measured behavior: decode lists IDENTICAL to exact=True (measured
48/48 dense trials; worst observed divergence is one dropped redundant
candidate cell per window with no decode impact). PERF.md records the
measurement; `sync_exact=True` (decode_window / decode_window_device)
is the full-sort escape hatch.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.ops.sync import find_sync
from rtlsdr_ft8d_jax.ops.waterfall import waterfall
from rtlsdr_ft8d_jax.pipeline import decode_window
from rtlsdr_ft8d_jax.protocol.constants import K_MIN_SCORE

CALLS = ["K1ABC", "W9XYZ", "N0CAL", "VE3XY", "G4ABC", "JA1DE", "VK2GH",
         "PY2JK"]


def _dense_band(n_sig, seed, span_hz=96.0):
    """n_sig co-aligned signals packed inside one 100 Hz chunk span."""
    base = 500.0 + 100.0 * seed % 800
    iq = np.zeros(48000, np.complex64)
    msgs = []
    for s in range(n_sig):
        m = f"CQ {CALLS[s]} FN{20 + s:02d}"
        msgs.append(m)
        iq += synthesize_message(m, f0_hz=base + span_hz / n_sig * s,
                                 amplitude=0.5, noise_sigma=0.0,
                                 rng=np.random.default_rng(seed * 100 + s))
    rng = np.random.default_rng(seed + 999)
    iq += 0.08 * (rng.standard_normal(48000)
                  + 1j * rng.standard_normal(48000)).astype(np.complex64)
    return iq, msgs


def _cells(cand):
    return {(int(cand["time_sub"][0, k]), int(cand["freq_sub"][0, k]),
             int(cand["time_offset"][0, k]), int(cand["freq_offset"][0, k]))
            for k in range(cand["score"].shape[-1])
            if int(cand["score"][0, k]) >= K_MIN_SCORE}


@pytest.mark.parametrize("n_sig", [5, 6, 8])
def test_dense_cochunk_decode_parity(n_sig):
    """Decode lists must match exact=True even past the chunk capacity."""
    for seed in range(3):
        iq, _msgs = _dense_band(n_sig, seed)
        two = {d.text for d in decode_window(iq[None])[0]}
        ex = {d.text for d in decode_window(iq[None], sync_exact=True)[0]}
        assert two == ex, (n_sig, seed, two, ex)


def test_dense_cochunk_candidate_miss_bounded():
    """Candidate-cell divergence vs the full sort stays marginal (the
    dropped cells are redundant sub-offset duplicates of kept signals)."""
    missed = 0
    trials = 6
    for seed in range(trials):
        iq, _ = _dense_band(6, seed)
        i_s = jnp.asarray(np.real(iq)[None].astype(np.float32))
        q_s = jnp.asarray(np.imag(iq)[None].astype(np.float32))
        peak = float(max(np.abs(np.real(iq)).max(),
                         np.abs(np.imag(iq)).max()))
        wf = waterfall(i_s * (0.5 / peak), q_s * (0.5 / peak))
        s2 = _cells(find_sync(wf, 120))
        sx = _cells(find_sync(wf, 120, exact=True))
        assert s2 <= sx | s2   # sanity
        missed += len(sx - s2)
    assert missed <= 2 * trials, f"missed {missed} cells in {trials} trials"


def test_separated_signals_exact_equivalence():
    """Signals in distinct chunks: candidate sets identical to exact."""
    iq = np.zeros(48000, np.complex64)
    for s in range(6):
        iq += synthesize_message(f"CQ {CALLS[s]} FN{30 + s:02d}",
                                 f0_hz=300.0 + 150.0 * s, amplitude=0.5,
                                 noise_sigma=0.0,
                                 rng=np.random.default_rng(s))
    i_s = jnp.asarray(np.real(iq)[None].astype(np.float32))
    q_s = jnp.asarray(np.imag(iq)[None].astype(np.float32))
    peak = float(max(np.abs(np.real(iq)).max(), np.abs(np.imag(iq)).max()))
    wf = waterfall(i_s * (0.5 / peak), q_s * (0.5 / peak))
    assert _cells(find_sync(wf, 120)) == _cells(find_sync(wf, 120,
                                                          exact=True))
