"""``BENCHMARK.json`` keeps to its contract, and every file a cell names
is found by name."""
import json
import os
import re

import pytest

from conftest import PORTBENCH

ROOT = os.path.dirname(PORTBENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert len(spec["command"]) <= 32 and all(map(_one_line,
                                                  spec["command"]))
    assert 1 <= spec["run_seconds"] <= 51
    assert isinstance(spec["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    # a full check of 24 cells fits its time
    rs = spec["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    spec = _spec()
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"])
        assert _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _one_line(w["why"])
    cells = [w["name"] for w in spec["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) \
        == len(cells)
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(
        1, len(cells) // 4)
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= set(cells)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and _one_line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in _spec()["workloads"]])
def test_cell_files_found_by_name(cell):
    from harness import bench

    spec, work, cfg, mix, limits = bench.load_cell(cell)
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    assert conf["file"].startswith("portbench/")
    assert cfg["name"] == conf["name"] and cfg["reduced"] == conf["reduced"]
    assert os.path.exists(os.path.join(PORTBENCH, "drivers",
                                       mix["driver"] + ".py"))
    assert limits and all(v >= 0 for v in limits.values())
    e2e = bench.metric_names(spec, cell, traced=False)
    per_layer = bench.metric_names(spec, cell, traced=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer
    for m in e2e + per_layer:
        assert callable(bench.reader(m["name"]))
        moves = m.get("moves")
        assert moves is None or moves in {x["name"] for x in e2e}


@pytest.mark.parametrize("cell", [w["name"] for w in _spec()["workloads"]])
def test_every_key_of_a_cell_is_read(cell, cpu_context):
    """Building the cell's driver reads every key of its configuration
    and mix (else it raises naming the key)."""
    from harness import bench

    bench.make_driver(cpu_context(cell)[0])


@pytest.mark.parametrize("where", ["config", "config.segment", "mix"])
def test_a_key_that_nothing_reads_is_refused(where, cpu_context):
    from harness import bench

    ctx, _ = cpu_context("unet.stack")
    part = {"config": ctx.cfg, "config.segment": dict.__getitem__(
        ctx.cfg, "segment"), "mix": ctx.mix}[where]
    part["colour"] = "blue"
    with pytest.raises(ValueError, match="colour"):
        bench.make_driver(ctx)


@pytest.mark.parametrize("cell", ["unet.stack", "dog.volume"])
def test_the_entry_gets_what_the_configuration_states(cell, cpu_context,
                                                      monkeypatch):
    """``flood`` reaches the entry as ``device_flood`` (a cell of another
    flood times that flood), ``dtype`` as ``compute_dtype``."""
    from harness import bench
    from iterseg_tpu_torch.engine import segmentation as seg

    seen = {}
    name = {"unet.stack": "affinity_unet_watershed",
            "dog.volume": "dog_blob_watershed"}[cell]
    monkeypatch.setattr(seg, name, lambda *a, **kw: seen.update(kw))
    ctx, _ = cpu_context(cell)
    dict.__getitem__(ctx.cfg, "segment")["flood"] = "pallas"
    d = bench.make_driver(ctx)
    d.entry(d.inputs[0])
    assert seen["device_flood"] == "pallas"
    if cell == "unet.stack":
        assert seen["compute_dtype"] == "float32"


def test_widths_other_than_the_checkpoints_are_refused(cpu_context):
    from harness import bench

    ctx, _ = cpu_context("unet.train")
    dict.__setitem__(ctx.cfg, "encoder_channels", [32, 64, 128, 256, 512])
    with pytest.raises(ValueError, match="encoder_channels"):
        bench.make_driver(ctx)
