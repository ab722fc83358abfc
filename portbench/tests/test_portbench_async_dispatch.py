"""The reader ``async_dispatch_share.segment`` on a recorded tail: None
where no frame counted ``async_dispatch`` (the CPU's frames take no
stream) and without spans; 100 when every frame counted it, and the
counted share when one did not."""
import contextlib
import io

import pytest
import torch


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


@pytest.mark.parametrize("cell", ["unet.stack", "unet.stack.4card"])
def test_async_dispatch_share_reads_the_frames_counted(cell, cpu_context,
                                                       monkeypatch):
    from harness import bench
    from iterseg_tpu_torch import utils

    share = bench.reader("async_dispatch_share.segment")
    d = _driver(cpu_context, cell)
    run = _tail(d)
    assert share(run) is None
    items = utils.spans()
    frames = [s for s in items if s["kind"] == "span"
              and s["name"] == "frame"]
    counted = [dict(kind="counter", name="async_dispatch", value=1,
                    call=f["call"], frame=f["frame"], card=f["card"],
                    parent=f["id"], thread=f["thread"], time_ns=f["start_ns"])
               for f in frames]
    monkeypatch.setattr(utils, "spans", lambda: items + counted)
    assert len(frames) >= 2 and share(run) == 100.0
    monkeypatch.setattr(utils, "spans", lambda: items + counted[1:])
    assert share(run) == 100.0 * (len(frames) - 1) / len(frames)
    utils.clear_spans()
    monkeypatch.setattr(utils, "spans", lambda: [])
    with contextlib.redirect_stdout(io.StringIO()):
        assert share(d.window(0.0)) is None
