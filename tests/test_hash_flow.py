"""Hashed-callsign flow through the full decode path + reporter send."""

import socket

import numpy as np

from rtlsdr_ft8d_jax.host.reporter import PskReporter
from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.pipeline import Decode, decode_window
from rtlsdr_ft8d_jax.protocol.text import CallsignHashTable


def test_nonstandard_call_resolves_via_hash_table():
    """Type-4 message carries the full call; a later type-1 hash reference
    resolves through the shared table."""
    hashes = CallsignHashTable()
    iq1 = synthesize_message("CQ PJ4/K1ABC", f0_hz=400.0, noise_sigma=0.05,
                             rng=np.random.default_rng(0))
    d1 = decode_window(iq1, hashes=hashes)
    assert "CQ PJ4/K1ABC" in {d.text for d in d1}
    # the full call is now in the hash table
    from rtlsdr_ft8d_jax.protocol.text import hash_callsign
    assert hashes.lookup(hash_callsign("PJ4/K1ABC", 22), 22) == "PJ4/K1ABC"


def test_reporter_sends_udp_frame():
    """PskReporter.report() emits a parseable frame to a local UDP sink."""
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    sink.settimeout(5)
    port = sink.getsockname()[1]

    rep = PskReporter("T1ST", "AA00", enabled=True, host="127.0.0.1",
                      port=port)
    decodes = [Decode(text="CQ K1JT FN20", freq_hz=1312.0, time_sec=0.0,
                      score=25, snr_db=-7.0)]
    frame = rep.report(decodes, dial_freq_hz=14_074_000,
                       epoch=1_700_000_000)
    assert frame is not None
    data, _ = sink.recvfrom(4096)
    sink.close()
    assert data == frame
    assert data[0:2] == b"\x00\x0a"
    assert int.from_bytes(data[2:4], "big") == len(data)
    assert b"K1JT" in data and b"FN20" in data and b"FT8" in data
    assert rep.sequence == 2


def test_reporter_disabled_by_default():
    rep = PskReporter("T1ST", "AA00")
    d = [Decode(text="CQ K1JT FN20", freq_hz=1000.0, time_sec=0.0,
                score=20)]
    assert rep.report(d, 14_074_000) is None


def test_reporter_skips_non_cq():
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    port = sink.getsockname()[1]
    rep = PskReporter("T1ST", "AA00", enabled=True, host="127.0.0.1",
                      port=port)
    d = [Decode(text="K1ABC W9XYZ 73", freq_hz=900.0, time_sec=0.0,
                score=15)]
    assert rep.report(d, 14_074_000) is None
    sink.close()
