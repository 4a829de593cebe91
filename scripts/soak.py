"""Long-run daemon soak: RSS, window cadence, resync accounting.

The reference is an unattended daemon (/root/reference/README.md:44);
its longest validated run in this repo so far was test-length. This
harness runs the real daemon loop (`host/cli.py --synthetic --stats`)
for N wall-clock 15-s windows, samples the process RSS every few
seconds, parses the per-window JSON stats records from stderr, and
writes a one-line JSON summary covering:

  - windows completed vs requested, resync count (must be 0)
  - RSS at start / end / max, and a least-squares slope (KB/window) —
    a leak shows as a positive slope over hundreds of windows
  - decode_ms median/p95 and window-cadence jitter

Usage:
  python3 scripts/soak.py [--windows 480] [--wideband] [--out SOAK.json]

480 windows = 2 h of real-cadence operation. Runs on whatever backend
is configured (the GPU by default, the CPU with JAX_PLATFORMS=cpu).
"""

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def rss_kb(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=480)
    ap.add_argument("--wideband", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    cmd = [sys.executable, "-m", "rtlsdr_ft8d_jax.host.cli",
           "-f", "20m", "-c", "T1ST", "-l", "AA00",
           "--synthetic", "--synthetic-pace", "--stats",
           "-n", str(args.windows)]
    if args.wideband:
        cmd += ["--wideband", "--wideband-channels", "0,1,2,3"]

    t_start = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)

    samples = []                    # (t, rss_kb)
    stats = []                      # per-window dicts
    resyncs = []
    window_walls = []               # arrival wall-times of stats records

    import threading

    def pump_stderr():
        for line in proc.stderr:
            line = line.strip()
            if "resyncing" in line:
                resyncs.append(line)
            # stats records are logger lines: "... I jax_ft8d: {...}"
            brace = line.find('{"window_stats"')
            if brace >= 0:
                try:
                    rec = json.loads(line[brace:])
                except ValueError:
                    continue
                stats.append(rec["window_stats"])
                window_walls.append(time.time())

    th = threading.Thread(target=pump_stderr, daemon=True)
    th.start()

    while proc.poll() is None:
        r = rss_kb(proc.pid)
        if r is not None:
            samples.append((time.time() - t_start, r))
        time.sleep(5.0)
    th.join(timeout=10)
    rc = proc.returncode

    # RSS slope per window via least squares over the post-warmup tail
    # (first 5 windows pay one-time compiles / cache loads).
    import numpy as np
    slope_kb_per_win = None
    if len(samples) > 10:
        t = np.array([s[0] for s in samples])
        r = np.array([s[1] for s in samples], float)
        cut = t > 90.0
        if cut.sum() > 5:
            t, r = t[cut], r[cut]
            a = np.polyfit(t, r, 1)[0]          # KB/s
            slope_kb_per_win = round(float(a) * 15.0, 2)

    dms = sorted(s.get("decode_ms", 0.0) for s in stats)
    gaps = np.diff(window_walls) if len(window_walls) > 2 else []
    summary = {
        "soak_windows_requested": args.windows,
        "soak_windows_completed": len(stats),
        "wideband": args.wideband,
        "wall_s": round(time.time() - t_start, 1),
        "rc": rc,
        "resyncs": len(resyncs),
        "resync_lines": resyncs[:5],
        "rss_start_kb": samples[0][1] if samples else None,
        "rss_end_kb": samples[-1][1] if samples else None,
        "rss_max_kb": max(s[1] for s in samples) if samples else None,
        "rss_slope_kb_per_window": slope_kb_per_win,
        "decode_ms_median": round(dms[len(dms) // 2], 1) if dms else None,
        "decode_ms_p95": (round(dms[int(len(dms) * 0.95)], 1)
                          if dms else None),
        "cadence_median_s": (round(float(np.median(gaps)), 2)
                             if len(gaps) else None),
        "cadence_max_s": round(float(np.max(gaps)), 2) if len(gaps) else None,
        "spots_total": sum(s.get("messages_unique", 0) for s in stats),
    }
    line = json.dumps(summary)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
