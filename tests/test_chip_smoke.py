"""chip_smoke.py's guards, which run here without a card: it refuses a
non-GPU device, and a passing run ends with the contract's JSON line."""

import json
from types import SimpleNamespace

import jax
import pytest

import chip_smoke


def test_refuses_the_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_result_line():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert json.loads(chip_smoke.result_line([dev] * 4))["device"][
        "count"] == 4
