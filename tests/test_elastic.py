"""Elastic mesh recovery (parallel/elastic.py): an 8-device dense decode
continues after devices die — no process restart (SURVEY §5
failure-detection; the reference exits on any device error,
rtlsdr_ft8d.c:1224-1290)."""

import numpy as np
import pytest

import jax

from rtlsdr_ft8d_jax.host.synth import synthesize_message
from rtlsdr_ft8d_jax.parallel import elastic
from rtlsdr_ft8d_jax.parallel.elastic import ElasticDecoder, device_heartbeat
from rtlsdr_ft8d_jax.protocol.unpack import unpack77

MSGS = ["CQ K1JT FN20", "K1ABC W9XYZ EN37"]


def _texts(out, b):
    texts = set()
    for k in np.nonzero(np.asarray(out["ok"])[b])[0]:
        bits = np.unpackbits(np.asarray(out["packed"])[b, k])
        texts.add(unpack77(bits[:77]))
    return texts


def _batch(n=16):
    chans = [synthesize_message(MSGS[b % 2], f0_hz=250 + 60 * b,
                                noise_sigma=0.1,
                                rng=np.random.default_rng(b))
             for b in range(n)]
    batch = np.stack(chans)
    return (np.real(batch).astype(np.float32),
            np.imag(batch).astype(np.float32))


def _injectable_heartbeat(dead):
    return lambda d, timeout=0.0: d not in dead


def test_heartbeat_live_devices():
    for d in jax.devices():
        assert device_heartbeat(d)


def test_decode_continues_after_half_mesh_dies():
    """The VERDICT r2 acceptance scenario: 8-device dense decode, 4
    devices die between windows, the next window decodes every channel
    on the surviving 4-device mesh."""
    dead = set()
    dec = ElasticDecoder(heartbeat=_injectable_heartbeat(dead))
    assert dec.mesh.devices.size == 8
    i_s, q_s = _batch(16)
    out, mesh = dec.decode_window(i_s, q_s, 400)
    assert mesh.devices.size == 8
    for b in range(16):
        assert MSGS[b % 2] in _texts(out, b), b

    dead.update(jax.devices()[4:])           # half the pod goes away
    out, mesh = dec.decode_window(i_s, q_s, 400)
    assert mesh.devices.size == 4
    assert dec.windows_recovered == 1
    for b in range(16):
        assert MSGS[b % 2] in _texts(out, b), b


def test_non_power_of_two_survivors_and_padding():
    """8 -> 5 survivors uses a 4-device mesh; a channel count that does
    not divide the mesh is zero-padded and outputs trimmed back to B."""
    dead = set(jax.devices()[5:])
    dec = ElasticDecoder(heartbeat=_injectable_heartbeat(dead))
    assert dec.mesh.devices.size == 4
    i_s, q_s = _batch(6)                      # 6 % 4 != 0 -> pad 2
    out, mesh = dec.decode_window(i_s, q_s, 400)
    assert np.asarray(out["packed"]).shape[0] == 6
    assert np.asarray(out["n_ok"]).shape == (6,)
    for b in range(6):
        assert MSGS[b % 2] in _texts(out, b), b


def test_midwindow_failure_shrinks_and_retries(monkeypatch):
    """A collective failure DURING a window (not caught by the pre-window
    heartbeat) triggers re-probe + one in-place retry on the shrunk
    mesh; the window's channels still decode."""
    dead = set()
    real = elastic.decode_window_dense
    state = {"fired": False}

    def flaky(i_s, q_s, mesh, budget, **kw):
        if not state["fired"]:
            state["fired"] = True
            dead.update(jax.devices()[6:])   # 2 devices die mid-window
            raise RuntimeError("simulated collective failure")
        return real(i_s, q_s, mesh, budget, **kw)

    monkeypatch.setattr(elastic, "decode_window_dense", flaky)
    dec = ElasticDecoder(heartbeat=_injectable_heartbeat(dead))
    i_s, q_s = _batch(8)
    out, mesh = dec.decode_window(i_s, q_s, 400)
    assert state["fired"]
    assert mesh.devices.size == 4            # 6 survivors -> pow2 mesh
    assert dec.windows_recovered == 1
    for b in range(8):
        assert MSGS[b % 2] in _texts(out, b), b


def test_failure_with_no_device_loss_is_a_real_error(monkeypatch):
    """If the decode fails but every device heartbeats, the error is NOT
    swallowed (a genuine bug must surface, not retry forever)."""
    def boom(*a, **kw):
        raise RuntimeError("genuine graph bug")

    monkeypatch.setattr(elastic, "decode_window_dense", boom)
    dec = ElasticDecoder(heartbeat=_injectable_heartbeat(set()))
    i_s, q_s = _batch(8)
    with pytest.raises(RuntimeError, match="genuine graph bug"):
        dec.decode_window(i_s, q_s, 400)


def test_all_devices_dead_raises():
    dead = set(jax.devices())
    dec = ElasticDecoder(heartbeat=_injectable_heartbeat(set()))
    dec.dead = set()
    dec.heartbeat = _injectable_heartbeat(dead)
    i_s, q_s = _batch(8)
    with pytest.raises(RuntimeError, match="no devices left"):
        dec.decode_window(i_s, q_s, 400)


def test_daemon_elastic_wideband_path():
    """The daemon's --elastic wideband decode (host/daemon.py:
    _decode_elastic) runs the full deep stack over the elastic mesh and
    returns unpacked per-channel decodes + mesh observability stats."""
    from types import SimpleNamespace

    from rtlsdr_ft8d_jax.host.daemon import WindowProcessor
    from rtlsdr_ft8d_jax.host.synth import synthesize_message
    from rtlsdr_ft8d_jax.ops.ap import QsoTracker

    B = 8
    msgs = ["CQ K1JT FN20", "K1ABC W9XYZ EN37"]
    chans = [synthesize_message(msgs[b % 2], f0_hz=300 + 50 * b,
                                noise_sigma=0.1,
                                rng=np.random.default_rng(b))
             for b in range(B)]
    iq = np.stack(chans)
    i_b = np.real(iq).astype(np.float32)
    q_b = np.imag(iq).astype(np.float32)

    self = SimpleNamespace(
        args=SimpleNamespace(elastic=True, ap=True, osd=4,
                             callsign="VA2GKA"),
        hashes=None, qso=QsoTracker(), _elastic=None)
    results, stats = WindowProcessor._decode_elastic(self, i_b, q_b,
                                                     budget=400)
    for b in range(B):
        assert msgs[b % 2] in {d.text for d in results[b]}, b
    assert stats.extra["mesh_devices"] >= 1
    assert stats.crc_passed >= B
