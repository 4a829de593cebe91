"""Logging + per-window metrics.

The reference has a compile-time LOG macro to stderr and nothing else
(C20, /root/reference/rtlsdr_ft8d.h:68-74; SURVEY.md §5 calls out the
missing observability). Here: standard leveled logging plus structured
per-window counters (decode counts, candidate stats, stage timings) that
the daemon emits as single-line JSON records for scraping.
"""

import json
import logging
import sys
import time
from dataclasses import asdict, dataclass, field

logger = logging.getLogger("jax_ft8d")


def setup_logging(level=logging.INFO, stream=None):
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s"))
    logger.handlers[:] = [handler]
    logger.setLevel(level)
    # don't propagate to the root handler: embedding scripts that called
    # logging.basicConfig would otherwise see every scrape-oriented
    # single-line JSON record twice
    logger.propagate = False
    return logger


@dataclass
class WindowStats:
    """Structured per-window decode metrics."""
    epoch: int = 0
    channels: int = 0
    candidates_scored: int = 0
    candidates_above_min: int = 0
    ldpc_converged: int = 0
    crc_passed: int = 0
    messages_unique: int = 0
    decode_ms: float = 0.0
    extra: dict = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps({"window_stats": asdict(self)}, sort_keys=True)


class StageTimer:
    """Context-manager timer for host-side stage accounting."""

    def __init__(self):
        self.timings = {}

    class _Ctx:
        def __init__(self, parent, name):
            self.parent, self.name = parent, name

        def __enter__(self):
            self.t0 = time.perf_counter()   # monotonic: immune to NTP steps
            return self

        def __exit__(self, *exc):
            self.parent.timings[self.name] = \
                self.parent.timings.get(self.name, 0.0) \
                + (time.perf_counter() - self.t0) * 1000.0

    def stage(self, name):
        return self._Ctx(self, name)
