"""The port's observability utilities (``iterseg_tpu_torch.utils``): the
phase timers of the JAX package, and ``device_trace`` on ``torch.profiler``
in place of ``jax.profiler``."""
import json
import os

import pytest
import torch

from iterseg_tpu_torch import utils


def test_stopwatch_and_phase_timer():
    sw = utils.Stopwatch()
    for _ in range(2):
        with sw.phase("a"):
            sum(range(1000))
    with sw.phase("b"):
        pass
    assert set(sw.times) == {"a", "b"} and sw.times["a"] > 0
    report = sw.report()
    assert report.startswith("total ") and "  a " in report
    profile = {}
    for _ in range(2):
        with utils.phase_timer(profile, "step"):
            pass
    assert list(profile) == ["step"] and profile["step"] >= 0
    with utils.phase_timer(None, "ignored"):
        pass
    with pytest.raises(ValueError):
        with utils.phase_timer(profile, "raises"):
            raise ValueError
    assert "raises" in profile  # timed on the way out, too


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with utils.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path / "trace")
    assert name.startswith("trace-") and name.endswith(".json")
    trace = json.loads((tmp_path / "trace" / name).read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())
    assert not hasattr(utils, "enable_compilation_cache")


def test_device_trace_needs_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        with utils.device_trace(str(tmp_path)):
            pass
