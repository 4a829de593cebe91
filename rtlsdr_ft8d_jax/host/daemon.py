"""Daemon main loop: 15-s UTC-aligned capture -> device decode -> report.

Replaces the reference's thread/condvar/double-buffer architecture
(/root/reference/rtlsdr_ft8d.c:1322-1354 + decoder() at c:221-285) with an
explicit ingest queue: the source pushes full-rate u8 IQ into the native
SPSC ring (which applies the int8 fs/4 mixer), the window loop drains
exactly 15 s of samples at each UTC boundary, decimates on the device with
overlap-save state carry, and decodes the *previous* window while the next
one captures — the same capture/decode overlap as the reference's double
buffer, without the by-timing data race (SURVEY.md §5).
"""

import ctypes
import signal
import sys
import time
from datetime import datetime, timezone

import numpy as np

from ..ops.decimate import R, StreamingDecimator
from ..pipeline import decode_window
from ..protocol.constants import (CAPTURE_RATE, SIGNAL_LENGTH_S,
                                  SIGNAL_SAMPLE_RATE)
from ..protocol.text import CallsignHashTable
from .cli import atofs, parse_frequency
from .io import read_any, timestamped_name, write_iq
from .reporter import PskReporter, print_spots

WINDOW = SIGNAL_LENGTH_S * SIGNAL_SAMPLE_RATE
FULLRATE_WINDOW = SIGNAL_LENGTH_S * CAPTURE_RATE

# Injectable clock (tests drive the live loop with a simulated clock whose
# sleep() also produces samples — see tests/test_host.py).
_now = time.time
_sleep = time.sleep


def seconds_to_next_window(now=None) -> float:
    """Time until the next 15-s UTC boundary (reference c:1339-1347)."""
    now = now if now is not None else _now()
    return (15.0 - (now % 15.0)) % 15.0


def decode_file(args) -> int:
    """`-r file` mode: decode a recorded capture and exit (c:859-887)."""
    path = args.readfile
    i_s, q_s, dial = read_any(path)
    dial_freq = int(dial) if dial else (
        parse_frequency(args.frequency[0], 0)[0] if args.frequency else 0)
    if i_s.shape[0] < WINDOW:
        i_s = np.pad(i_s, (0, WINDOW - i_s.shape[0]))
        q_s = np.pad(q_s, (0, WINDOW - q_s.shape[0]))
    hashes = CallsignHashTable()
    # batch ALL 15-s windows of the capture as channels: one device call
    # decodes the whole file (the reference replays one window at a time)
    n_windows = max(1, -(-i_s.shape[0] // WINDOW))
    pad = n_windows * WINDOW - i_s.shape[0]
    if pad:
        i_s = np.pad(i_s, (0, pad))
        q_s = np.pad(q_s, (0, pad))
    batches = (i_s.reshape(n_windows, WINDOW), q_s.reshape(n_windows, WINDOW))
    # replay must use the live path's squelch config: honor --budget, and
    # apply the same >=512-channel auto-budget rule as the wideband daemon
    # (process_wideband below) so a recorded capture replays with exactly
    # the production semantics
    budget = getattr(args, "budget", None)
    if budget is None and n_windows >= 512:
        budget = 4096
    results = decode_window(batches, hashes=hashes,
                            passes=getattr(args, "multipass", 1),
                            ap_cq=getattr(args, "ap", False),
                            budget=budget,
                            osd_cands=getattr(args, "osd", 0),
                            ap_call=(args.callsign if getattr(
                                args, "ap", False) else None))
    total = 0
    when = datetime.now(timezone.utc)
    for w, decodes in enumerate(results):
        if n_windows > 1:
            print(f"-- window {w} (t={w * 15}s)")
        print_spots(decodes, when, dial_freq)
        total += len(decodes)
    return 0 if total > 0 else 1


def _make_decimator(args):
    """Narrow-band decimator per --ingest: 'device' = polyphase GEMM on
    the accelerator (default), 'host' = the same bank in numpy (no
    full-rate upload)."""
    if getattr(args, "ingest", "device") == "host":
        from ..ops.decimate import StreamingDecimatorHost
        return StreamingDecimatorHost()
    return StreamingDecimator()


class WindowProcessor:
    """Drains the ingest ring, decimates (or channelizes), decodes,
    reports one window."""

    def __init__(self, args, dial_freq_hz):
        self.args = args
        self.dial_freq = dial_freq_hz
        self.hashes = CallsignHashTable()
        # QSO-state continuation AP (ops/ap.py): with --ap, track active
        # call pairs across windows and hypothesize their next
        # transmissions as a codeword enumeration bank
        if getattr(args, "ap", False):
            from ..ops.ap import QsoTracker
            self.qso = QsoTracker()
        else:
            self.qso = None
        self.decimator = _make_decimator(args)
        self.wideband = getattr(args, "wideband", False)
        if self.wideband:
            from ..ops.channelize import StreamingChannelizerInt8
            self.channelizer = StreamingChannelizerInt8()
            from ..ops.channelize import NUM_CHANNELS
            sel = getattr(args, "wideband_channels", None)
            if sel:
                try:
                    chans = [int(c) for c in sel.split(",") if c.strip()]
                except ValueError:
                    raise SystemExit(
                        f"--wideband-channels must be a comma-separated "
                        f"list of integers, got {sel!r}")
                bad = [c for c in chans if not 0 <= c < NUM_CHANNELS]
                if bad or not chans:
                    raise SystemExit(
                        f"--wideband-channels out of range 0.."
                        f"{NUM_CHANNELS - 1}: {bad or sel!r}")
                self.wb_channels = chans
            else:
                self.wb_channels = list(range(NUM_CHANNELS))
        self.reporter = PskReporter(
            args.callsign, args.locator,
            enabled=args.report and not args.noreport,
            host=args.psk_host or "report.pskreporter.info",
            port=args.psk_port)
        self.windows_done = 0

    def reset_streams(self):
        """Drop overlap-save filter state after a resync gap (the carried
        history no longer abuts the next window's samples)."""
        self.decimator = _make_decimator(self.args)
        if self.wideband:
            from ..ops.channelize import StreamingChannelizerInt8
            self.channelizer = StreamingChannelizerInt8()

    def process_fullrate(self, i8: np.ndarray, q8: np.ndarray):
        """One 15-s window of mixed int8 baseband at 2.4 Msps."""
        n = (i8.shape[0] // R) * R
        if self.wideband:
            # int8 straight through: the channelizer dequantizes on device
            return self.process_wideband(i8[:n], q8[:n])
        i_bb, q_bb = self.decimator.process(
            i8[:n].astype(np.float32) / 128.0,
            q8[:n].astype(np.float32) / 128.0)
        return self.process_baseband(i_bb, q_bb)

    def process_wideband(self, i8: np.ndarray, q8: np.ndarray):
        """Channelize the whole capture (raw int8 IQ in, 4x less
        host->device bandwidth); decode every selected channel."""
        from ..ops.channelize import channel_center_hz
        # full-band default: a global candidate budget (~2.7/channel plus
        # headroom) — BP and LLRs for 4096 candidates instead of 180,000,
        # identical decode lists on quiet-to-normal bands (the bench's
        # wideband gate); explicit --budget wins
        budget = getattr(self.args, "budget", None)
        if budget is None and len(self.wb_channels) >= 512:
            budget = 4096
        # channel bank stays ON DEVICE: selection, padding and the decode
        # consume it in place instead of a host round trip of the full
        # (1500, 48000) bank (~576 MB each way)
        import jax.numpy as jnp
        i_ch, q_ch = self.channelizer.process(i8, q8, device=True)
        sel = np.asarray(self.wb_channels, np.int32)
        i_b = i_ch[sel]
        q_b = q_ch[sel]
        if i_b.shape[1] < WINDOW:
            pad = WINDOW - i_b.shape[1]
            i_b = jnp.pad(i_b, ((0, 0), (0, pad)))
            q_b = jnp.pad(q_b, ((0, 0), (0, pad)))
        i_b, q_b = i_b[:, :WINDOW], q_b[:, :WINDOW]
        epoch = int(_now()) - SIGNAL_LENGTH_S + 1
        when = datetime.fromtimestamp(epoch, timezone.utc)
        t0 = time.time()
        if getattr(self.args, "elastic", False):
            results, stats = self._decode_elastic(i_b, q_b, budget)
        else:
            results, stats = decode_window(
                (i_b, q_b), hashes=self.hashes, return_stats=True,
                passes=getattr(self.args, "multipass", 1),
                ap_cq=getattr(self.args, "ap", False),
                budget=budget,
                osd_cands=getattr(self.args, "osd", 0),
                ap_call=(self.args.callsign if getattr(
                    self.args, "ap", False) else None),
                ap_texts=(self.qso.bank() if self.qso else None))
        if getattr(self.args, "stats", False):
            from .log import logger
            stats.epoch = epoch
            stats.decode_ms = (time.time() - t0) * 1000.0
            logger.info(stats.to_json())
        per_channel = []
        for k, decodes in zip(sel, results):
            for d in decodes:
                d.freq_hz += channel_center_hz(k)
            per_channel.append((k, decodes))
        from ..ops.channelize import dedup_wideband
        all_decodes = dedup_wideband(per_channel)
        if self.qso:
            self.qso.observe(all_decodes)
        print_spots(all_decodes, when, self.dial_freq)
        self.reporter.report(all_decodes, self.dial_freq, epoch)
        self.windows_done += 1
        return all_decodes

    def _decode_elastic(self, i_b, q_b, budget):
        """Wideband decode through ElasticDecoder (--elastic): the local
        device mesh shrinks when chips die and the band keeps decoding
        (SURVEY §5 failure-detection; parallel/elastic.py). Runs the
        same deep stack as the single-graph path (clamp rows, the QSO
        continuation bank, per-shard refine/OSD); multipass subtraction
        is not available on this path."""
        import jax.numpy as jnp

        from ..ops.ap import clamp_row_cq
        from ..pipeline import (_merge_osd_decodes, ap_prefix_for_call,
                                unpack_survivors)
        from ..protocol.constants import K_MAX_CANDIDATES
        from .log import WindowStats

        if getattr(self, "_elastic", None) is None:
            from ..parallel.elastic import ElasticDecoder
            self._elastic = ElasticDecoder()
        B = i_b.shape[0]
        # per-channel -3 dB normalization (pipeline C9 stage; the dense
        # graph takes pre-normalized baseband)
        peak = np.maximum(np.abs(i_b).max(-1, keepdims=True),
                          np.abs(q_b).max(-1, keepdims=True))
        scale = (0.5 / np.maximum(peak, 1e-12)).astype(np.float32)
        rows = []
        if getattr(self.args, "ap", False):
            rows.append(clamp_row_cq())
            r = ap_prefix_for_call(self.args.callsign)
            if r is not None:
                rows.append(r)
        clamp = jnp.asarray(np.stack(rows)) if rows else None
        bank = jnp.asarray(self.qso.bank()) if self.qso else None
        osd = getattr(self.args, "osd", 0)
        out, _mesh = self._elastic.decode_window(
            i_b * scale, q_b * scale,
            global_budget=(budget or B * K_MAX_CANDIDATES),
            osd_cands_global=(min(B * osd, 1024) if osd else 0),
            ap_clamp_signs=clamp, ap_cw_signs=bank)
        results, sub = unpack_survivors(out, B, self.hashes)
        extra = {"windows_recovered": self._elastic.windows_recovered,
                 "mesh_devices": int(self._elastic.mesh.devices.size)}
        if osd:
            extra["osd_recovered"] = _merge_osd_decodes(
                out, results, sub, self.hashes)
        stats = WindowStats(
            channels=B,
            candidates_scored=B * K_MAX_CANDIDATES,
            candidates_above_min=int(np.sum(out["n_above_min"])),
            ldpc_converged=int(np.sum(out["n_ldpc_ok"])),
            crc_passed=int(np.sum(out["n_ok"])),
            messages_unique=sum(len(r) for r in results),
            extra=extra)
        return results, stats

    def decimate_fullrate(self, i8: np.ndarray, q8: np.ndarray):
        """Full-rate int8 -> padded 48000-sample baseband (no decode)."""
        n = (i8.shape[0] // R) * R
        i_bb, q_bb = self.decimator.process(
            i8[:n].astype(np.float32) / 128.0,
            q8[:n].astype(np.float32) / 128.0)
        if i_bb.shape[0] < WINDOW:
            i_bb = np.pad(i_bb, (0, WINDOW - i_bb.shape[0]))
            q_bb = np.pad(q_bb, (0, WINDOW - q_bb.shape[0]))
        return i_bb[:WINDOW], q_bb[:WINDOW]

    def emit(self, decodes, epoch, stats=None, decode_ms=0.0,
             i_bb=None, q_bb=None):
        """Print/report/save one window's results."""
        when = datetime.fromtimestamp(epoch, timezone.utc)
        if stats is not None and getattr(self.args, "stats", False):
            from .log import logger
            stats.epoch = epoch
            stats.decode_ms = decode_ms
            logger.info(stats.to_json())
        print_spots(decodes, when, self.dial_freq)
        if self.args.writefile and i_bb is not None:
            write_iq(timestamped_name(self.args.writefile, when), i_bb, q_bb)
        if getattr(self.args, "save_c2", None) and i_bb is not None:
            from .io import write_c2
            write_c2(self.args.save_c2, i_bb, q_bb, self.dial_freq)
        self.reporter.report(decodes, self.dial_freq, epoch)
        self.windows_done += 1
        return decodes

    def process_baseband(self, i_bb: np.ndarray, q_bb: np.ndarray):
        if i_bb.shape[0] < WINDOW:
            i_bb = np.pad(i_bb, (0, WINDOW - i_bb.shape[0]))
            q_bb = np.pad(q_bb, (0, WINDOW - q_bb.shape[0]))
        i_bb, q_bb = i_bb[:WINDOW], q_bb[:WINDOW]
        epoch = int(_now()) - SIGNAL_LENGTH_S + 1
        t0 = time.time()
        decodes, stats = decode_window(
            (i_bb, q_bb), hashes=self.hashes, return_stats=True,
            passes=getattr(self.args, "multipass", 1),
            ap_cq=getattr(self.args, "ap", False),
            osd_cands=getattr(self.args, "osd", 0),
            ap_call=(self.args.callsign if getattr(
                self.args, "ap", False) else None),
            ap_texts=(self.qso.bank() if self.qso else None))
        if self.qso:
            self.qso.observe(decodes)
        return self.emit(decodes, epoch, stats, (time.time() - t0) * 1000.0,
                         i_bb, q_bb)


def run_daemon(args) -> int:
    """Live mode: RTL-SDR (or synthetic) -> ring -> windows (c:1202-1377).

    With multiple -f arguments, one device per band (device indices counting
    up from -i) feeds one ring each; all bands decode as ONE batched window
    on the device — the multi-channel scaling axis the single-core reference
    cannot have.
    """
    from .. import native
    from .sources import RtlSdrSource, SourceError, SyntheticSource

    bands = [parse_frequency(f, args.directsampling)
             for f in args.frequency]
    procs = [WindowProcessor(args, dial) for dial, _ in bands]
    # multiband shares ONE QsoTracker: QSO hypotheses are per-station,
    # not per-band, and the batched multiband decode feeds every band's
    # decodes through the same bank (per-proc trackers would be dead
    # state on procs[1:])
    for p in procs[1:]:
        p.qso = procs[0].qso
    if getattr(args, "elastic", False) and getattr(args, "multipass", 1) > 1:
        print("warning: --multipass is not available on the --elastic "
              "path; running single-pass", file=sys.stderr)

    lib = native.load()
    if lib is None:
        print("native ingest library unavailable", file=sys.stderr)
        return 1
    rings = [lib.ingest_ring_create(1 << 26) for _ in bands]

    synthetic = getattr(args, "synthetic", False)
    sources = []
    try:
        for bi, (dial_freq, ds) in enumerate(bands):
            if synthetic:
                sources.append(SyntheticSource())
            else:
                sources.append(RtlSdrSource(
                    device_index=args.device + bi, dial_freq_hz=dial_freq,
                    gain=args.gain, autogain=args.autogain, ppm=args.ppm,
                    direct_sampling=ds, offset=args.offset,
                    upconverter=int(atofs(args.upconverter))))
    except SourceError as e:
        print(f"source error: {e}", file=sys.stderr)
        for r in rings:
            lib.ingest_ring_destroy(r)
        return 1

    def push_fn(ring):
        def push(u8):
            lib.ingest_ring_push_u8(
                ring, u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                u8.shape[0] // 2)
        return push

    if not synthetic:
        for src, ring in zip(sources, rings):
            src.start(push_fn(ring))

    stop = False

    # POSIX teardown parity (reference installs 6 handlers, c:1203-1208):
    # a SIGTERM (systemd stop) / SIGHUP must cancel the USB async read and
    # close the device, not just KeyboardInterrupt.
    def _graceful(signum, frame):
        nonlocal stop
        stop = True

    installed = {}
    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
        try:
            installed[sig] = signal.signal(sig, _graceful)
        except (ValueError, OSError):
            pass                      # non-main thread / unsupported

    def align_to_boundary():
        """Sleep to the next 15-s UTC boundary, then flush everything the
        sources captured before it (the reference resets iqIndex at each
        boundary, c:1349-1352). Window 0 then starts AT the boundary.
        Sleeps in 0.1-s slices checking `stop` (like the main wait loop)
        so SIGTERM during alignment doesn't stall up to a full 15 s —
        PEP 475 makes one monolithic time.sleep resume after the handler."""
        deadline = _now() + seconds_to_next_window()
        while not stop and _now() < deadline:
            _sleep(min(0.1, max(deadline - _now(), 0.0)))
        for ring in rings:
            lib.ingest_ring_discard(ring, lib.ingest_ring_available(ring))

    def resync(reason):
        print(f"{reason}, resyncing to next UTC boundary", file=sys.stderr)
        align_to_boundary()
        for proc in procs:
            proc.reset_streams()

    try:
        i8 = np.zeros(FULLRATE_WINDOW, dtype=np.int8)
        q8 = np.zeros(FULLRATE_WINDOW, dtype=np.int8)
        multiband = len(bands) > 1 and not getattr(args, "wideband", False)
        pace = synthetic and getattr(args, "synthetic_pace", False)
        if not synthetic or pace:
            align_to_boundary()
        dropped_seen = [0] * len(rings)
        consecutive_short = 0
        while not stop:
            if pace and not stop:
                # soak realism: one window per real 15-s UTC boundary
                # (plain --synthetic free-runs for fast integration tests)
                deadline = _now() + seconds_to_next_window()
                while not stop and _now() < deadline:
                    _sleep(min(0.1, max(deadline - _now(), 0.0)))
            basebands = []
            short = None
            for src, ring, proc in zip(sources, rings, procs):
                if synthetic:
                    push_fn(ring)(src.read(FULLRATE_WINDOW))
                else:
                    # after a boundary flush the ring needs a full 15 s to
                    # fill; allow 2 s of slack beyond that before declaring
                    # the window short
                    deadline = _now() + SIGNAL_LENGTH_S + 2.0
                    while (lib.ingest_ring_available(ring) < FULLRATE_WINDOW
                           and _now() < deadline and not stop):
                        _sleep(0.1)
                got = lib.ingest_ring_pop(
                    ring, i8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    q8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    FULLRATE_WINDOW)
                if got < FULLRATE_WINDOW:
                    short = got
                    break
                if multiband:
                    basebands.append(proc.decimate_fullrate(i8, q8))
                else:
                    proc.process_fullrate(i8, q8)
            if stop:
                break
            if short is not None:
                # missed deadline — discard the partial window and realign
                # (the reference skips partial buffers, c:235-237; decoding
                # them would leave every later window offset by the deficit)
                consecutive_short += 1
                if consecutive_short >= 2:
                    # pump looks dead, not just late: reopen the device(s)
                    # (the reference exits on any device error; SURVEY §5
                    # asks the new build to recover instead)
                    for src in sources:
                        if hasattr(src, "restart"):
                            try:
                                src.restart()
                                print("device restarted", file=sys.stderr)
                            except Exception as e:
                                print(f"device restart failed: {e}",
                                      file=sys.stderr)
                    consecutive_short = 0
                resync(f"short window ({short} samples)")
                continue
            consecutive_short = 0
            if multiband:
                # ONE batched device decode across all bands; each band
                # resolves hashed calls against its OWN table
                i_b = np.stack([b[0] for b in basebands])
                q_b = np.stack([b[1] for b in basebands])
                epoch = int(_now()) - SIGNAL_LENGTH_S + 1
                want_stats = getattr(args, "stats", False)
                t0 = time.time()
                rs = decode_window(
                    (i_b, q_b), hashes=[p.hashes for p in procs],
                    return_stats=want_stats,
                    passes=getattr(args, "multipass", 1),
                    ap_cq=getattr(args, "ap", False),
                    osd_cands=getattr(args, "osd", 0),
                    ap_call=(args.callsign if getattr(
                        args, "ap", False) else None),
                    ap_texts=(procs[0].qso.bank()
                              if procs[0].qso else None))
                results, mb_stats = rs if want_stats else (rs, None)
                decode_ms = (time.time() - t0) * 1000.0
                for bi, (proc, decodes, bb) in enumerate(
                        zip(procs, results, basebands)):
                    if procs[0].qso:
                        procs[0].qso.observe(decodes)
                    # the batched decode yields ONE WindowStats across
                    # all bands; log it once (first band's emit)
                    proc.emit(decodes, epoch,
                              mb_stats if bi == 0 else None,
                              decode_ms, i_bb=bb[0], q_bb=bb[1])
            if args.maxloop and procs[0].windows_done >= args.maxloop:
                stop = True
            if not stop and not synthetic:
                # drift control: a ring overrun means samples were lost and
                # every later window would be permanently offset
                over = False
                for bi, ring in enumerate(rings):
                    d = lib.ingest_ring_dropped(ring)
                    if d != dropped_seen[bi]:
                        dropped_seen[bi] = d
                        over = True
                if over:
                    resync("ring overrun (samples dropped)")
    except KeyboardInterrupt:
        pass
    finally:
        for sig, old in installed.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        if not synthetic:
            for src in sources:
                try:
                    src.stop()
                except SourceError as e:    # wedged pump: leak, keep going
                    print(f"source stop: {e}", file=sys.stderr)
        for r in rings:
            lib.ingest_ring_destroy(r)
    return 0
