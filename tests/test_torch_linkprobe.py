"""The port's link probe (``engine/linkprobe``) and the ``device_flood=True``
rule it feeds, as ``tests/test_linkprobe.py`` holds JAX's: no link on the
CPU, a cache per process, and ``True`` resolving both ways under a
monkeypatched probe, in both pipelines. On the CPU ``True`` is ``"xla"``,
as JAX resolves it off the TPU."""
import pytest
import torch

from iterseg_tpu_torch.engine import device_pipeline as tdp
from iterseg_tpu_torch.engine import linkprobe

PIPELINES = ["AffinityPipeline", "DoGPipeline"]


@pytest.fixture(autouse=True)
def _fresh_probe_cache():
    linkprobe.reset_cache()
    yield
    linkprobe.reset_cache()


def _mock_link(monkeypatch, mbps):
    monkeypatch.setattr(linkprobe, "measure_link_mbps",
                        lambda device=None, n_runs=3: mbps)


def test_no_link_on_the_cpu():
    assert linkprobe.measure_link_mbps("cpu") is None
    if not torch.cuda.is_available():
        assert linkprobe.measure_link_mbps() is None


def test_cached():
    dev = torch.device("cuda", 0)
    linkprobe._cache[dev] = 123.0
    assert linkprobe.measure_link_mbps(dev) == 123.0
    assert linkprobe.measure_link_mbps("cuda:0") == 123.0
    linkprobe.reset_cache()
    assert linkprobe._cache == {}


def test_measured_table_holds_only_the_crossover():
    assert set(linkprobe.MEASURED) == {"device_flood_crossover_mbps"}
    assert linkprobe.MEASURED["device_flood_crossover_mbps"] >= 0.0


@pytest.mark.parametrize("cls_name", PIPELINES)
def test_true_fast_link_is_pallas(monkeypatch, cls_name):
    _mock_link(monkeypatch, linkprobe.MEASURED[
        "device_flood_crossover_mbps"] + 1.0)
    cls = getattr(tdp, cls_name)
    assert cls.normalize_device_flood(True, "cuda") == "pallas"


@pytest.mark.parametrize("cls_name", PIPELINES)
def test_true_at_the_crossover_is_pallas(monkeypatch, cls_name):
    _mock_link(monkeypatch, linkprobe.MEASURED["device_flood_crossover_mbps"])
    cls = getattr(tdp, cls_name)
    assert cls.normalize_device_flood(True, "cuda") == "pallas"


@pytest.mark.parametrize("cls_name", PIPELINES)
def test_true_slow_or_no_link_is_host(monkeypatch, cls_name):
    cls = getattr(tdp, cls_name)
    _mock_link(monkeypatch, None)
    assert cls.normalize_device_flood(True, "cuda") is False
    crossover = linkprobe.MEASURED["device_flood_crossover_mbps"]
    if crossover > 0:
        _mock_link(monkeypatch, crossover / 2)
        assert cls.normalize_device_flood(True, "cuda") is False


@pytest.mark.parametrize("cls_name", PIPELINES)
def test_explicit_values_always_force(monkeypatch, cls_name):
    _mock_link(monkeypatch, None)
    cls = getattr(tdp, cls_name)
    for mode in ("pallas", "xla", "exact"):
        assert cls.normalize_device_flood(mode, "cuda") == mode
        assert cls.normalize_device_flood(mode, "cpu") == mode
    assert cls.normalize_device_flood(None) is False
    assert cls.normalize_device_flood(False, "cuda") is False
    with pytest.raises(ValueError, match="unknown device_flood"):
        cls.normalize_device_flood("cuda")


@pytest.mark.parametrize("cls_name", PIPELINES)
def test_true_on_the_cpu_is_xla(monkeypatch, cls_name):
    _mock_link(monkeypatch, 1e9)  # the CPU never asks the probe
    cls = getattr(tdp, cls_name)
    assert cls.normalize_device_flood(True, "cpu") == "xla"
    if cls_name == "DoGPipeline":
        pipe = cls(device_flood=True, device=torch.device("cpu"))
    else:
        pipe = cls(None, device_flood=True, device=torch.device("cpu"))
    assert pipe.device_flood == "xla"
