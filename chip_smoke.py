"""Smoke run of the decode chain on one NVIDIA GPU.

    python3 chip_smoke.py              # one card: phases a-h below
    python3 chip_smoke.py --gpus 4     # four cards: the sharded paths only

Phases of the one-card run, in order:
  a. refuse to run unless JAX's first device is a GPU;
  b. print the card's name and power limit (nvidia-smi);
  c. build native/ from the tracked sources; FT8D_REQUIRE_NATIVE=1 so
     host OSD and unpack never fall back to Python silently;
  d. decode both golden fixtures with the deep stack: exact lists;
  e. the daemon through cli.main, in this process: the single-band
     synthetic run (2 windows) and the 1500-channel wideband run;
  f. every device stage on the GPU against the same stage on the CPU
     device (the plain XLA reference), at B=64 and B=1500;
  g. the bench's decode-quality gates (bench.py);
  h. the tests marked `chip`, in this process.

With --gpus 4 it runs only the multi-device paths, each against the
same work on one card: the --elastic wideband daemon decode, the dense
decode on a (1, 4) ('host', 'chip') mesh, and the time-sharded
decimator.

Every phase raises on failure; the process then exits non-zero and never
prints the last line. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Everything runs in one process: a second JAX process on the card would
fail for want of memory.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DAEMON_ARGS = ["-f", "20m", "-c", "T1ST", "-l", "AA00", "--synthetic"]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def require_gpu(devices):
    """Phase a: the run needs a GPU as JAX's first device."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's first device is {dev.platform!r}"
                           f" ({dev.device_kind})")
    return dev


def result_line(devices) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def phase_card():
    """Phase b: the card's name and power limit, one line per card, as
    nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(out.stdout.strip(), flush=True)


def phase_native():
    subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                   check=True, capture_output=True, timeout=300)
    os.environ["FT8D_REQUIRE_NATIVE"] = "1"
    from rtlsdr_ft8d_jax import native
    check(native.load() is not None, "native library did not load")
    log("c", "native library built and loaded")


def golden_lists():
    """Phase d: both checked-in fixtures, deep stack, exact lists."""
    from rtlsdr_ft8d_jax.host.io import read_iq
    from rtlsdr_ft8d_jax.pipeline import decode_window

    fix = os.path.join(ROOT, "tests", "fixtures")
    for name, kw in (("golden_10sig", dict(osd_cands=8, passes=2)),
                     ("golden_busy", dict(osd_cands=8, passes=3))):
        listed, expected = set(), set()
        with open(os.path.join(fix, f"{name}.txt")) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                listed.add(parts[0])
                if len(parts) < 5 or parts[4] == "1":
                    expected.add(parts[0])
        i, q = read_iq(os.path.join(fix, f"{name}.iq"))
        t0 = time.time()
        texts = {d.text for d in decode_window((i, q), **kw)}
        missing, phantoms = expected - texts, texts - listed
        log("d", f"{name}: {len(texts & expected)}/{len(expected)} "
                 f"expected, missing={sorted(missing)}, "
                 f"phantoms={sorted(phantoms)} ({time.time() - t0:.1f} s)")
        check(not missing and not phantoms, f"{name}: decode list differs")


def cli_spots(argv):
    """Run the CLI entry point in this process; return the printed spots
    as (frequency Hz, text)."""
    from rtlsdr_ft8d_jax.host import cli, daemon

    spots = []
    print_spots = daemon.print_spots

    def record(decodes, when, dial_freq_hz=0, out=None):
        spots.extend((int(d.freq_hz) + dial_freq_hz, d.text)
                     for d in decodes)
        print_spots(decodes, when, dial_freq_hz, out)

    daemon.print_spots = record
    try:
        rc = cli.main(argv)
    finally:
        daemon.print_spots = print_spots
    check(rc == 0, f"cli.main({argv}) returned {rc}")
    return spots


def phase_daemon():
    """Phase e: the daemon's two main paths through the CLI entry point."""
    t0 = time.time()
    spots = cli_spots(DAEMON_ARGS + ["-n", "2"])
    log("e", f"single band, 2 windows: {spots} ({time.time() - t0:.1f} s)")
    hits = [f for f, text in spots if text == "CQ K1JT FN20"]
    check(len(hits) == 2 and all(abs(f - 14074478) <= 7 for f in hits),
          "single band: expected CQ K1JT FN20 at ~14074478 Hz per window")
    t0 = time.time()
    spots = cli_spots(DAEMON_ARGS + ["--wideband", "-n", "1"])
    log("e", f"wideband, 1500 channels: {spots} ({time.time() - t0:.1f} s)")
    check([t for _f, t in spots] == ["CQ K1JT FN20"],
          "wideband: expected exactly one spot, CQ K1JT FN20")


def both(fn, *args):
    """[result on the GPU, result on the CPU device] of jit(fn)(*args)."""
    import jax

    jf = jax.jit(fn)
    return [jax.device_get(jf(*jax.device_put(args, d)))
            for d in (jax.devices()[0], jax.devices("cpu")[0])]


def compare_stages(label, i_np, q_np, n_flat):
    """Phase f at one batch size: each stage on the GPU against the same
    stage on the CPU device, fed identical inputs."""
    import jax
    import numpy as np

    from rtlsdr_ft8d_jax.ops.ldpc import bp_decode
    from rtlsdr_ft8d_jax.ops.llr import _llrs_from_mags, _tone_mags_flat
    from rtlsdr_ft8d_jax.ops.sync import find_sync, sync_scores
    from rtlsdr_ft8d_jax.ops.waterfall import waterfall

    wf_g, wf_c = both(waterfall, i_np, q_np)
    d = np.abs(wf_g.astype(np.int32) - wf_c.astype(np.int32))
    frac = float((d > 0).mean())
    log("f", f"{label} waterfall: {int((d > 0).sum())} of {d.size} cells "
             f"differ ({frac:.2e}), max {int(d.max())} step")
    check(d.max() <= 1 and frac <= 1e-4, f"{label} waterfall out of bounds")

    s_g, s_c = both(sync_scores, wf_g)
    log("f", f"{label} sync scores bit-exact: {np.array_equal(s_g, s_c)}")
    check(np.array_equal(s_g, s_c), f"{label} sync scores differ")

    cand = jax.device_get(find_sync(jax.device_put(wf_g, jax.devices()[0])))
    k = cand["score"].shape[1]
    sel = np.argsort(-cand["score"].reshape(-1), kind="stable")[:n_flat]
    flat = {key: cand[key].reshape(-1)[sel].astype(np.int32) for key in
            ("time_sub", "freq_sub", "time_offset", "freq_offset")}
    chan = (sel // k).astype(np.int32)
    (s2_g, v_g), (s2_c, v_c) = both(_tone_mags_flat, wf_g, flat, chan)
    log("f", f"{label} LLR tone magnitudes (N={n_flat}) bit-exact: "
             f"{np.array_equal(s2_g, s2_c) and np.array_equal(v_g, v_c)}")
    check(np.array_equal(s2_g, s2_c) and np.array_equal(v_g, v_c),
          f"{label} LLR s2 differs")

    llr = both(_llrs_from_mags, s2_c, v_c)[1]
    (h_g, e_g, p_g), (h_c, e_c, p_c) = both(
        lambda x: bp_decode(x, 20, return_posterior=True), llr)
    rows = int((h_g != h_c).any(axis=1).sum())
    dpost = float(np.abs(p_g - p_c).max())
    conv = e_c == 0
    log("f", f"{label} BP (N={n_flat}): hard decisions differ on {rows} "
             f"rows, errors differ on {int((e_g != e_c).sum())}, "
             f"{int(conv.sum())} converged, max |posterior diff| {dpost:.3g}")
    check(rows == 0 and np.array_equal(e_g, e_c),
          f"{label} BP decisions differ")
    check(dpost <= 1e-3, f"{label} BP posterior out of tolerance")


def compare_front_ends():
    """Phase f, ingest: decimator and channelizer, GPU vs CPU, HIGHEST."""
    import numpy as np

    from rtlsdr_ft8d_jax.ops.channelize import WB_HISTORY, channelize
    from rtlsdr_ft8d_jax.ops.decimate import HISTORY, R, polyphase_decimate

    rng = np.random.default_rng(0)

    for name, fn, hist, m in (("decimator", polyphase_decimate, HISTORY,
                               48000),
                              ("channelizer", channelize, WB_HISTORY, 4800)):
        n = hist + R * m
        x = (rng.integers(-127, 128, (2, n)) / 128.0).astype(np.float32)
        (gi, gq), (ci, cq) = both(fn, x[0], x[1])
        err = max(float(np.abs(gi - ci).max()), float(np.abs(gq - cq).max()))
        scale = max(float(np.abs(ci).max()), float(np.abs(cq).max()))
        log("f", f"{name} {gi.shape}: max |GPU - CPU| {err:.3g} "
                 f"(output peak {scale:.3g})")
        check(err <= 1e-4 * scale, f"{name} out of tolerance")


def phase_stages():
    import bench

    batch = bench.strong_batch()
    compare_stages("B=64", batch.real.astype("float32"),
                   batch.imag.astype("float32"), 64 * 120)
    wi, wq, _ = bench.wideband_band()
    compare_stages("B=1500", wi, wq, bench.WB_BUDGET)
    compare_front_ends()


def phase_gates():
    """Phase g: the bench's decode-quality floors on the card."""
    import jax
    import jax.numpy as jnp

    import bench
    from rtlsdr_ft8d_jax.pipeline import decode_window_device
    from rtlsdr_ft8d_jax.protocol.text import CallsignHashTable

    batch = bench.strong_batch()
    for budget in (None, bench.BUDGET):
        n_ok = bench.strong_ok(batch, budget=budget)
        log("g", f"strong, budget={budget}: {n_ok}/{bench.B}")
        check(n_ok == bench.B, "strong gate failed")
    rungs = bench.ladder_rungs()
    log("g", f"ladder: {rungs} (strong {sum(rungs[:5])}/40, "
             f"weak {sum(rungs[5:])}/24)")
    err = bench.ladder_gate(rungs)
    check(err is None, err)
    bi, bq, weak_chans, osd_chans = bench.busy_band()
    out = jax.device_get(decode_window_device(
        jnp.asarray(bi), jnp.asarray(bq), osd_cands=bench.OSD_CANDS))
    _spots, rec, weak, osd_only = bench.osd_counts(
        out, weak_chans, osd_chans, CallsignHashTable())
    log("g", f"OSD: recovered {rec}, OSD-only {osd_only}/5, weak "
             f"{weak}/16 (one launch)")
    err = bench.osd_gate(rec, 1, weak, osd_only)
    check(err is None, err)
    wi, wq, seeded = bench.wideband_band()
    out = jax.device_get(decode_window_device(
        jnp.asarray(wi), jnp.asarray(wq), budget=bench.WB_BUDGET))
    n_ok = bench.wideband_ok(out, seeded)
    log("g", f"wideband: {n_ok}/{len(seeded)}")
    check(n_ok == len(seeded), "wideband gate failed")


def phase_chip_tests():
    import pytest

    os.environ["FT8D_CHIP_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    log("h", f"pytest -m chip exit code {int(rc)}")
    check(int(rc) == 0, "chip tests failed")


def phase_four_cards(devices, wideband=("--wideband", "-n", "1")):
    """--gpus 4: the multi-device paths against one card."""
    import jax.numpy as jnp
    import numpy as np

    import bench
    from rtlsdr_ft8d_jax.parallel.dense import (decode_window_dense,
                                                make_grid_mesh)
    from rtlsdr_ft8d_jax.parallel.halo import (decimate_time_sharded,
                                               make_time_mesh)
    from rtlsdr_ft8d_jax.ops.decimate import HISTORY, polyphase_decimate
    from rtlsdr_ft8d_jax.pipeline import unpack_survivors

    check(len(devices) >= 4, f"--gpus 4 needs 4 GPUs, found {len(devices)}")

    # 1. --elastic wideband daemon decode (1500 channels) vs one card
    lists = {}
    for extra in ([], ["--elastic"]):
        t0 = time.time()
        lists[bool(extra)] = sorted(cli_spots(DAEMON_ARGS + list(wideband)
                                              + extra))
        log("4", f"wideband daemon {' '.join(extra) or '(one card)'}: "
                 f"{lists[bool(extra)]} ({time.time() - t0:.1f} s)")
    check(lists[True] == lists[False] and lists[True],
          "elastic wideband decode differs from one card")

    # 2. dense decode on a (1, 4) ('host', 'chip') mesh vs one card
    batch = bench.strong_batch()
    i_s, q_s = batch.real.astype(np.float32), batch.imag.astype(np.float32)
    texts = {}
    for n in (1, 4):
        mesh = make_grid_mesh(1, n)
        out = decode_window_dense(i_s, q_s, mesh, global_budget=bench.BUDGET)
        out = {k: np.asarray(v) for k, v in out.items()}
        res, _ = unpack_survivors(out, bench.B)
        texts[n] = [sorted(d.text for d in r) for r in res]
    same = texts[1] == texts[4]
    ok4 = sum(1 for b, t in enumerate(texts[4]) if bench.MSGS[b % 4] in t)
    log("4", f"dense (1,4) mesh: {ok4}/{bench.B} decoded, lists equal to "
             f"(1,1): {same}")
    check(same and ok4 == bench.B, "dense mesh decode differs from one card")

    # 3. time-sharded decimator vs one card
    rng = np.random.default_rng(2)
    n = 4 * 12 * 750 * 10
    x = (rng.integers(-127, 128, (2, n)) / 128.0).astype(np.float32)
    di, dq = decimate_time_sharded(jnp.asarray(x[0]), jnp.asarray(x[1]),
                                   make_time_mesh(4))
    pad = np.zeros(HISTORY, np.float32)
    ri, rq = polyphase_decimate(jnp.asarray(np.concatenate([pad, x[0]])),
                                jnp.asarray(np.concatenate([pad, x[1]])))
    err = max(float(np.abs(np.asarray(di) - np.asarray(ri)).max()),
              float(np.abs(np.asarray(dq) - np.asarray(rq)).max()))
    log("4", f"time-sharded decimator on 4 devices: max |diff| vs one "
             f"card {err:.3g}")
    check(err <= 1e-5, "time-sharded decimator differs from one card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gpus", type=int, choices=(1, 4), default=1)
    opts = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices)
    log("a", f"JAX {jax.__version__}: {len(devices)} x "
             f"{devices[0].device_kind}")
    sys.path.insert(0, ROOT)
    from rtlsdr_ft8d_jax.host.cache import enable_compilation_cache
    log("a", f"compile cache: {enable_compilation_cache()}")
    phase_card()
    phase_native()
    t0 = time.time()
    if opts.gpus == 4:
        phase_four_cards(devices)
    else:
        for fn in (golden_lists, phase_daemon, phase_stages, phase_gates,
                   phase_chip_tests):
            fn()
            log("-", f"{fn.__name__} done at {time.time() - t0:.0f} s")
    print(result_line(devices[:opts.gpus]), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"FAILED: {e}", flush=True)
        sys.exit(1)
