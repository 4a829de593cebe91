import os
import sys

import pytest

# Tests run on a deterministic virtual 8-device CPU mesh. chip_smoke.py
# runs the `chip`-marked tests inside its own process on the GPU and sets
# FT8D_CHIP_TESTS=1 there, so the platform is left alone.
ON_CHIP = os.environ.get("FT8D_CHIP_TESTS") == "1"
if not ON_CHIP:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_CHIP:
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Persistent compilation cache for the CPU test graphs: the suite's wall
# time is dominated by recompiling the same decode graphs every run.
from rtlsdr_ft8d_jax.host.cache import (DEFAULT_DIR,  # noqa: E402
                                        enable_compilation_cache)

if not ON_CHIP:
    enable_compilation_cache(os.path.join(DEFAULT_DIR, "cputest"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU; skipped elsewhere, run on the card "
                   "by chip_smoke.py")


def pytest_sessionstart(session):
    if not ON_CHIP:
        devs = jax.devices()
        assert devs[0].platform == "cpu" and len(devs) == 8, devs


@pytest.fixture(autouse=True)
def _chip_tests_need_a_gpu(request):
    if (request.node.get_closest_marker("chip")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU (chip_smoke.py runs it on the card)")
