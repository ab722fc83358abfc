"""The per-layer readers of the program's spans and counters
(``harness/spans.py`` and the six ``metrics/*.segment.py`` it serves):
None on an untraced run and for a program that keeps no spans, a number
on a tiny cell traced on the CPU."""
import contextlib
import io

import pytest
import torch

READERS = ("entry_s.segment", "dispatch_s.segment", "device_wait_s.segment",
           "host_half_s.segment", "host_flood_s.segment",
           "builds_per_call.segment")
CELLS = ("unet.stack", "dog.volume", "unet.stack.4card")


def _read(run):
    from harness import bench

    return {name: bench.reader(name)(run) for name in READERS}


def _driver(cpu_context, cell):
    from harness import bench

    d = bench.make_driver(cpu_context(cell)[0])
    with contextlib.redirect_stdout(io.StringIO()):
        d.warm()
    return d


def _tail(d, calls=2):
    """The driver's traced tail on the CPU: each call inside the harness's
    span, under a profile of the host alone."""
    from iterseg_tpu_torch import utils

    utils.clear_spans()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with contextlib.redirect_stdout(io.StringIO()), \
            torch.profiler.profile(activities=acts):
        for k in range(calls):
            with torch.profiler.record_function("portbench.call"):
                d.entry(d.inputs[k % len(d.inputs)])
    return {"kind": "segment", "trace": None}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_tiny_cell_reads_a_number(cell, cpu_context):
    d = _driver(cpu_context, cell)
    got = _read(_tail(d))
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    assert got["dispatch_s.segment"] > 0 and got["host_half_s.segment"] > 0
    # frames of (10, 64, 96) with (10, 64, 64) chunks: 2 chunked-forward
    # programs a 2-frame stack, one checkpoint, replica and pipeline
    if cell == "dog.volume":
        assert got["builds_per_call.segment"] == 1.0
    else:
        assert got["builds_per_call.segment"] == 5.0


def test_untraced_and_spanless_runs_read_none(cpu_context, monkeypatch):
    from iterseg_tpu_torch import utils

    d = _driver(cpu_context, "unet.stack")
    utils.clear_spans()
    with contextlib.redirect_stdout(io.StringIO()):
        run = d.window(0.0)
    assert set(_read(run).values()) == {None}
    run = _tail(d, calls=1)
    assert None not in _read(run).values()
    monkeypatch.delattr(utils, "spans")  # a program that keeps no spans
    assert set(_read(run).values()) == {None}
    assert set(_read({"kind": "train"}).values()) == {None}
