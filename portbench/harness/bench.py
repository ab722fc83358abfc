"""One run of one cell: set-up, measured window, optional traced tail,
the comparison with the plain reference, one JSON line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), the driver the mix names
(``drivers/<driver>.py``, a class ``Driver``), its limits
(``limits/<cell>.json``) and each metric's reader (``metrics/<metric>.py``,
a function ``read(run)`` that returns a number or None). A driver reads
every key of its configuration and mix when it is built; a cell with a
key that nothing read is refused before it runs.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys

from .keys import Keys, refuse_unread

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PORTBENCH)
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "iterseg_tpu")
# configuration keys that describe the cell; ``load_cell`` holds them to
# BENCHMARK.json
DESCRIPTIVE = ("name", "source", "reduced")


def set_cache_dirs():
    """Every build and kernel cache of the program at a fixed place inside
    the checkout, so only a checkout's first run builds."""
    build = os.path.join(CHECKOUT, "build")
    os.environ["ITERSEG_TORCH_BUILD_DIR"] = os.path.join(
        build, "iterseg_tpu_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name):
    """``(spec, workload, config, mix, limits)`` of the cell ``name``."""
    spec = _json(os.path.join(CHECKOUT, "BENCHMARK.json"))
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    cfg = _json(os.path.join(CHECKOUT, conf["file"]))
    for key in ("name", "reduced"):
        if cfg[key] != conf[key]:
            raise ValueError(f"{conf['file']}: {key} is not BENCHMARK.json's")
    if not cfg["source"].startswith(conf["source"]):
        raise ValueError(f"{conf['file']}: source is not BENCHMARK.json's")
    mix = _json(os.path.join(PORTBENCH, "traffic", work["traffic"] + ".json"))
    limits = _json(os.path.join(PORTBENCH, "limits", name + ".json"))
    return spec, work, cfg, mix, limits


def driver(name):
    """The class ``Driver`` of ``drivers/<name>.py``."""
    if not os.path.exists(os.path.join(PORTBENCH, "drivers", name + ".py")):
        raise ValueError(f"no driver {name!r}")
    return importlib.import_module("drivers." + name).Driver


def free(device):
    """Drop what the program left on ``device``."""
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def metric_names(spec, workload, traced):
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones (listed for it, or unlisted and moving a metric it reports)."""
    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if workload in m.get(
        "workloads", []) or ("workloads" not in m and m["moves"] in reported)]


def reader(name):
    path = os.path.join(PORTBENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Context:
    """What a driver needs: the cell's configuration and mix (as ``Keys``),
    the seed, and ``cards``, the devices the cell may use (the first is
    where the harness and the reference run)."""

    def __init__(self, workload, cfg, mix, seed, cards):
        self.workload, self.seed = workload, int(seed)
        self.cfg, self.mix = Keys(cfg), Keys(mix)
        self.cfg.skip(*DESCRIPTIVE)
        self.cards = list(cards)
        self.device, self.chips = self.cards[0], len(self.cards)
        self.checkout = CHECKOUT


def make_driver(ctx):
    """The mix's driver, built; refuses keys that it did not read."""
    d = driver(ctx.mix["driver"])(ctx)
    refuse_unread(config=ctx.cfg, mix=ctx.mix)
    return d


def run_cell(ctx, seconds, traced, peak_memory=None):
    """Set-up, window, traced tail, comparison. Returns ``(run, checks)``:
    ``run`` is the record the metric readers read."""
    d = make_driver(ctx)
    d.warm()
    run = d.window(seconds)
    if traced:
        run["trace"] = d.tail()
    run["memory_peak_bytes"] = peak_memory() if peak_memory else 0
    run.update(cfg=ctx.cfg, mix=ctx.mix, chips=ctx.chips)
    d.release()
    return run, d.check()


def judge(checks, limits, failed):
    """``(correct, compared)``: every number within its limit and no call
    failed; ``compared`` holds each number beside its limit."""
    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in checks.items()}
    correct = failed == 0 and all(v["value"] <= v["limit"]
                                  for v in compared.values())
    return correct, compared


def _parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's "
                                "benchmark once and print one JSON line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0):
    args = _parse(argv)
    spec, work, cfg, mix, limits = load_cell(args.workload)
    import torch

    chips = int(work["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA card(s); {seen} "
              "visible", file=sys.stderr)
        return 3
    set_cache_dirs()
    cards = [torch.device("cuda", i) for i in range(chips)]
    ctx = Context(args.workload, cfg, mix, args.seed, cards)

    def peak():
        return max(torch.cuda.max_memory_allocated(d) for d in cards)

    run, checks = run_cell(ctx, args.seconds, bool(args.trace), peak)
    run["setup_s"] = run["t_start"] - t0
    bad = forbidden_modules()
    if bad:
        print("portbench: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    metrics = {}
    for m in metric_names(spec, args.workload, bool(args.trace)):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    calls = run.get("calls")
    failed = sum(1 for c in calls if not c[3]) if calls else 0
    attempted = len(calls) if calls else run["steps"]
    correct, compared = judge(checks, limits, failed)
    if calls:
        secs = sorted(c[1] - c[0] for c in calls)
        print("calls %d, seconds min %.4f median %.4f max %.4f"
              % (len(secs), secs[0], secs[len(secs) // 2], secs[-1]),
              file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if args.trace:
        tr = run.get("trace") or {"busy_s": 0.0, "window_s": 0.0,
                                  "device_ops": [], "idle_gaps": []}
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = compared
    sys.stdout.flush()
    for k, v in compared.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
