"""Command-line interface — superset of the reference CLI.

Honors every option of the reference's usage text
(/root/reference/rtlsdr_ft8d.c:975-1006): -f (frequency or band string with
the same 16-entry band plan, HF bands auto-enable direct sampling mode 2),
-c, -l, -g, -a, -o, -p, -u, -d, -n, -i, -x, -t, -w, -r, --help, --version.
Extensions: repeated -f args (multi-band batch decode), --report (the
reference ships with reporting hard-disabled, c:366 — here it is opt-in),
--save-c2, --host/--port for the uplink.
"""

import argparse
import sys

VERSION = "0.2.0"

# Band plan table (reference rtlsdr_ft8d.c:1047-1102).
# name -> (dial freq Hz, auto direct-sampling mode)
BAND_PLAN = {
    "160m": (1_840_000, 2),
    "80m": (3_573_000, 2),
    "60m": (5_357_000, 2),
    "40m": (7_074_000, 2),
    "30m": (10_136_000, 2),
    "20m": (14_074_000, 2),
    "17m": (18_100_000, 2),
    "15m": (21_074_000, 2),
    "12m": (24_915_000, 2),
    "10m": (28_074_000, 2),
    "6m": (50_313_000, 0),
    "4m": (70_100_000, 0),
    "2m": (144_174_000, 0),
    "1m25": (222_065_000, 0),
    "70cm": (432_065_000, 0),
    "23cm": (1_296_174_000, 0),
}


def atofs(s: str) -> float:
    """Suffix parser like the reference's atofs (c:688-713): k/M/G."""
    s = s.strip()
    mult = 1.0
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1e3, "m": 1e6, "g": 1e9}[s[-1].lower()]
        s = s[:-1]
    try:
        return float(s) * mult
    except ValueError:
        raise SystemExit(f"bad frequency/number: {s!r}\n --help for usage...")


def parse_frequency(value: str, direct_sampling: int):
    """Returns (dial_freq_hz, direct_sampling)."""
    key = value.lower()
    if key in BAND_PLAN:
        freq, auto_ds = BAND_PLAN[key]
        if not direct_sampling and auto_ds:
            direct_sampling = auto_ds
        return freq, direct_sampling
    return int(atofs(value)), direct_sampling


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jax_ft8d",
        description="Batched JAX FT8 daemon with the capabilities of "
                    "rtlsdr_ft8d (batched decode of many channels per "
                    "15-s window)",
    )
    p.add_argument("-f", "--frequency", action="append", default=[],
                   help="dial frequency [(k,M,G) Hz] or band string; "
                        "repeatable for multi-channel operation. Bands: "
                        + " ".join(BAND_PLAN))
    p.add_argument("-c", "--callsign", default="", help="your callsign")
    p.add_argument("-l", "--locator", default="", help="your locator grid")
    p.add_argument("-g", "--gain", type=int, default=29,
                   help="gain [0-49] (default: 29)")
    p.add_argument("-a", "--autogain", action="store_true",
                   help="auto gain (off by default)")
    p.add_argument("-o", "--offset", type=int, default=0,
                   help="frequency offset (default: 0)")
    p.add_argument("-p", "--ppm", type=int, default=0,
                   help="crystal correction factor (ppm)")
    p.add_argument("-u", "--upconverter", type=str, default="0",
                   help="upconverter frequency (default: 0)")
    p.add_argument("-d", "--directsampling", type=int, default=0,
                   choices=[0, 1, 2], help="direct sampling mode")
    p.add_argument("-n", "--maxloop", type=int, default=0,
                   help="max 15-s windows (default: 0 = infinite)")
    p.add_argument("-i", "--device", type=int, default=0,
                   help="device index")
    p.add_argument("-x", "--noreport", action="store_true",
                   help="do not report spots (reporting is also off unless "
                        "--report is given, matching the reference default)")
    p.add_argument("--report", action="store_true",
                   help="enable the PSKreporter uplink")
    p.add_argument("-t", "--selftest", action="store_true",
                   help="decoder self-test (generate a signal & decode)")
    p.add_argument("-w", "--writefile", metavar="PREFIX",
                   help="write received windows to timestamped .iq files")
    p.add_argument("-r", "--readfile", metavar="FILE",
                   help="read .iq/.c2/.wav capture, decode and exit")
    p.add_argument("--save-c2", metavar="FILE", help="also save .c2 format")
    p.add_argument("--wideband", action="store_true",
                   help="decode ALL 1500 channels (1600 Hz spacing) of the 2.4 MHz "
                        "capture via the polyphase filterbank channelizer "
                        "instead of just the dial sub-band")
    p.add_argument("--wideband-channels", type=str, default=None,
                   help="comma-separated channel indices to decode in "
                        "--wideband mode (default: all 1500)")
    p.add_argument("--ingest", choices=("device", "host"),
                   default="device",
                   help="narrow-band decimation placement: 'device' = "
                        "polyphase GEMM on the accelerator (default), "
                        "'host' = same bank in numpy (no full-rate upload)")
    p.add_argument("--osd", type=int, default=0, metavar="M",
                   help="ordered-statistics decoding of the M best "
                        "BP-failed candidates per channel (~1 dB deeper; "
                        "host-side, WSJT-X-class; default 0 = off)")
    p.add_argument("--ap", action="store_true",
                   help="a-priori CQ decoding: a second LDPC pass with the "
                        "known 'CQ' prefix bits clamped recovers CQ calls "
                        "~1 dB deeper (WSJT-X-style)")
    p.add_argument("--budget", type=int, default=None, metavar="N",
                   help="global candidate budget: run LDPC only on the N "
                        "best-scoring candidates ACROSS all channels (big "
                        "win on quiet wide bands; default: no budget)")
    p.add_argument("--multipass", type=int, default=1, metavar="N",
                   help="decode passes with signal subtraction between "
                        "passes (WSJT-X-style; default 1 = single pass)")
    p.add_argument("--synthetic", action="store_true",
                   help="run the daemon loop from a synthetic full-rate "
                        "source (no hardware needed; for integration tests)")
    p.add_argument("--synthetic-pace", action="store_true",
                   help="with --synthetic: pace windows to real 15-s UTC "
                        "boundaries (soak realism) instead of free-running")
    p.add_argument("--stats", action="store_true",
                   help="emit per-window JSON stats records to stderr")
    p.add_argument("--compile-cache", metavar="DIR", nargs="?",
                   const="", default="",
                   help="persistent XLA compile cache directory (FFTW-"
                        "wisdom analogue). ON by default (default dir); "
                        "--no-compile-cache disables. Without it every "
                        "daemon start pays full window-1 compiles; where "
                        "JAX_COMPILATION_CACHE_DIR is set, that directory "
                        "is used instead")
    p.add_argument("--no-compile-cache", dest="compile_cache",
                   action="store_const", const=None,
                   help="disable the persistent XLA compile cache")
    p.add_argument("--psk-host", default=None, help="PSKreporter host")
    p.add_argument("--psk-port", type=int, default=4739)
    p.add_argument("--elastic", action="store_true",
                   help="wideband mode: decode over an elastic device "
                        "mesh that shrinks (and keeps decoding) when "
                        "chips die instead of exiting like the reference")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host mode: JAX distributed coordinator "
                        "address (run one process per host; host 0's "
                        "address)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host mode: total number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host mode: this process's rank (0-based)")
    p.add_argument("--version", action="version",
                   version=f"jax_ft8d v{VERSION}")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from .log import setup_logging
    setup_logging()

    if args.compile_cache is not None:
        from .cache import enable_compilation_cache
        enable_compilation_cache(args.compile_cache or None)

    if args.coordinator or args.num_processes:
        from ..parallel.distributed import initialize
        initialize(args.coordinator, args.num_processes, args.process_id)

    if args.selftest:
        from .selftest import run_selftest
        return 0 if run_selftest() else 1

    if args.readfile:
        from .daemon import decode_file
        return decode_file(args)

    if not args.frequency:
        print("Please specify a dial frequency.\n --help for usage...",
              file=sys.stderr)
        return 1
    if not args.callsign:
        print("Please specify your callsign.\n --help for usage...",
              file=sys.stderr)
        return 1
    if not args.locator:
        print("Please specify your locator.\n --help for usage...",
              file=sys.stderr)
        return 1

    from .daemon import run_daemon
    return run_daemon(args)


if __name__ == "__main__":
    sys.exit(main())
