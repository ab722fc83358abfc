"""The port's spans and counters (``iterseg_tpu_torch.utils``) on the
public path, on the CPU at (10, 64, 64).

- With no profiler running nothing is recorded, and the pipelines' profile
  dicts hold the keys they held before the spans.
- Under ``torch.profiler`` a call of either segmenter records its ``call``,
  ``frame`` and leaf spans, all with the call's id, the frame's index and
  card and a recorded parent; every top-level op on the main thread under
  the caller's span is a leaf span, and the leaf spans do not overlap.
- The build counters of a call; ``train_unet(profile=)``'s per-step lists
  are its spans; the exact mode's worker-thread flood carries the call.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu_torch import utils
from iterseg_tpu_torch.engine import device_pipeline as tdp
from iterseg_tpu_torch.engine.predict import load_unet
from iterseg_tpu_torch.engine.segmentation import (affinity_unet_watershed,
                                                   dog_blob_watershed)
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
SHAPE = (10, 64, 64)
KW = dict(chunk_size=(10, 64, 64), margin=(1, 16, 16), debug=True,
          devices=[CPU])
AFFINITY_KEYS = {"device_program", "download_mask_cands", "bytes_mask",
                 "gather_dispatch", "bytes_gather", "host_spacing",
                 "host_mask_filter", "gather_affinities", "flood"}
DOG_KEYS = {"device_program", "download", "bytes_mask", "gather_dispatch",
            "bytes_gather", "host_blobs", "gather_distance", "flood"}
HOST_HALF = {"affinity": {"device_wait", "download_mask_cands",
                          "gather_dispatch", "host_spacing",
                          "host_mask_filter", "gather_affinities", "flood"},
             "dog": {"device_wait", "download", "gather_dispatch",
                     "host_blobs", "gather_distance", "flood"}}


def blob_stack(n_frames, seed=0):
    r = np.random.default_rng(seed)
    frames = []
    for _ in range(n_frames):
        vol = np.zeros(SHAPE, np.float32)
        pts = np.stack([r.integers(1, s - 1, size=20) for s in SHAPE], 1)
        vol[tuple(pts.T)] = 1.0
        vol = ndi.gaussian_filter(vol, (1, 3, 3))
        frames.append((vol / vol.max() * 60000).astype(np.uint16))
    return np.stack(frames)


@pytest.fixture(scope="module")
def stack():
    return blob_stack(2)


@pytest.fixture(scope="module")
def model():
    return load_unet(None)


def entry(kind, data, **kw):
    if kind == "affinity":
        return affinity_unet_watershed(None, data, None, "trace", None,
                                       **KW, **kw)
    return dog_blob_watershed(None, data, None, "trace", None, **KW, **kw)


def profiled(fn):
    """Run ``fn`` under a CPU profile inside the caller's span, as the
    benchmark's tail does; returns the profiler and the recorded spans."""
    utils.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.call"):
            fn()
    return prof, utils.spans()


def named(items, name):
    return [s for s in items if s["kind"] == "span" and s["name"] == name]


def test_no_profiler_records_nothing_and_keeps_the_keys(model, stack):
    utils.clear_spans()
    prof = {}
    tdp.AffinityPipeline(model, (10, 64, 64), (1, 16, 16),
                         device=CPU).segment(stack[0], profile=prof)
    assert set(prof) == AFFINITY_KEYS
    prof = {}
    tdp.DoGPipeline(device=CPU).segment(stack[0], profile=prof,
                                        normalize=True)
    assert set(prof) == DOG_KEYS
    prof = {}
    out = np.zeros(stack.shape, np.int32)
    list(tdp.DoGPipeline(device=CPU).segment_stack(stack, out, profile=prof))
    assert set(prof) == DOG_KEYS  # device_program now on stack frames too
    entry("dog", stack)
    entry("affinity", stack[0])
    assert utils.spans() == []
    with utils.phase_timer(None, "nothing") as s:
        pass
    assert s.seconds == 0.0 and utils.spans() == []


@pytest.mark.parametrize("kind,frames", [("affinity", 2), ("affinity", 0),
                                         ("dog", 0), ("dog", 2)])
def test_a_profiled_call_records_its_spans(kind, frames, stack):
    data = stack if frames else stack[0]
    prof, items = profiled(lambda: entry(kind, data))
    (call,) = named(items, "call")
    ids = {s["id"] for s in items if s["kind"] == "span"}
    assert all(s["call"] == call["id"] for s in items)
    assert all(s["parent"] in ids for s in items if s is not call)
    fr = named(items, "frame")
    assert sorted(s["frame"] for s in fr) == list(range(max(frames, 1)))
    assert {s["card"] for s in fr} == {"cpu"}
    assert len(named(items, "entry")) == 1
    names = {s["name"] for s in items if s["kind"] == "span"}
    assert {"dispatch", "restore", "finalize"} | HOST_HALF[kind] <= names
    by_id = {s["id"]: s for s in items if s["kind"] == "span"}
    for s in named(items, "device_wait"):
        assert by_id[s["parent"]]["name"] == "finalize"
        assert s["frame"] is not None and s["card"] == "cpu"
    # the profiler's view: under the caller's span, on the main thread,
    # every top-level op is a leaf span and no two of them overlap
    events = list(prof.events())
    (outer,) = [e for e in events if e.name == "portbench.call"]
    top = sorted((e for e in events if e.thread == outer.thread
                  and e.cpu_parent is outer), key=lambda e: e.time_range.start)
    assert top and all(e.name.startswith(utils.PREFIX) for e in top)
    for a, b in zip(top, top[1:]):
        assert a.time_range.end <= b.time_range.start
    leaves = {e.name[len(utils.PREFIX):] for e in top}
    assert "finalize" not in leaves and "frame" not in leaves
    assert {"entry", "dispatch", "device_wait", "flood"} <= leaves


@pytest.mark.parametrize("frames", [0, 2])
def test_the_calls_replica_is_freed_inside_its_release_span(frames, stack,
                                                             monkeypatch):
    """The U-Net replica a call builds goes inside the call's ``release``
    span (on a card its blocks, marked for the frame streams, record CUDA
    events as they are freed: outside a span they would name the idle
    gap that follows)."""
    import weakref

    from iterseg_tpu_torch.engine import predict

    real, freed_in, refs = predict.UNetModel.module, [], []

    def module(self, device):
        net = real(self, device)
        if not refs:
            refs.append(weakref.ref(
                net, lambda _: freed_in.append(utils._context.get().parent)))
        return net

    monkeypatch.setattr(predict.UNetModel, "module", module)
    _, items = profiled(lambda: entry("affinity",
                                      stack if frames else stack[0]))
    (release,) = named(items, "release")
    (call,) = named(items, "call")
    assert freed_in == [release["id"]] and release["parent"] == call["id"]


@pytest.mark.parametrize("kind,builds", [
    ("affinity", {"checkpoint_reads": 1, "unet_replicas": 1, "pipelines": 1,
                  "feature_programs": 2}),
    ("dog", {"pipelines": 1})])
def test_build_counters_of_a_second_call(kind, builds, stack):
    entry(kind, stack)
    _, items = profiled(lambda: entry(kind, stack))
    got = {}
    for s in items:
        if s["kind"] == "counter" and not s["name"].startswith("bytes_"):
            got[s["name"]] = got.get(s["name"], 0) + s["value"]
    assert got == builds
    moved = [s for s in items if s["kind"] == "counter"
             and s["name"] == "bytes_gather"]
    assert {s["frame"] for s in moved} == {0, 1}
    assert all(s["value"] > 0 for s in moved)


def test_train_profile_lists_are_its_spans():
    from iterseg_tpu_torch.train.train import train_unet

    r = np.random.default_rng(0)
    xs = [r.random((2, 16, 16), dtype=np.float32) for _ in range(3)]
    ys = [(r.random((5, 2, 16, 16)) > 0.5).astype(np.float32)
          for _ in range(3)]
    prof = {}
    _, items = profiled(lambda: train_unet(
        xs[:2], xs[2:], ys[:2], ys[2:], epochs=1, device=CPU, log=False,
        profile=prof))
    seconds = {n: [(s["end_ns"] - s["start_ns"]) / 1e9
                   for s in named(items, n)]
               for n in ("load", "step", "read", "validation")}
    assert prof["load_s"] == seconds["load"] and len(seconds["load"]) == 4
    assert prof["validation_s"] == seconds["validation"]
    assert len(prof["step_s"]) == 2
    assert prof["step_s"][1] == seconds["step"][1] + seconds["read"][1]


def test_exact_worker_flood_carries_the_call(stack, monkeypatch):
    # the early tie probe held at 0, so the speculative host flood runs
    monkeypatch.setattr(tdp, "_tie_probe",
                        lambda mask_packed, aff_pad: torch.tensor(0.0))
    _, items = profiled(lambda: entry("affinity", stack[0],
                                      device_flood="exact"))
    (call,) = named(items, "call")
    worker = [s for s in named(items, "flood")
              if s["thread"] != call["thread"]]
    assert worker and all(s["call"] == call["id"] and s["frame"] == 0
                          for s in worker)
    assert named(items, "flood_certificate")


def test_a_threaded_call_carries_its_id(stack):
    def run():
        dog_blob_watershed(None, stack, None, "trace", None,
                           chunk_size=KW["chunk_size"], margin=KW["margin"],
                           devices=[CPU], threaded=True).result()

    _, items = profiled(run)
    (call,) = named(items, "call")
    frames = named(items, "frame")
    assert len(frames) == 2 and len(named(items, "entry")) == 1
    assert all(f["call"] == call["id"] and f["parent"] == call["id"]
               and f["thread"] != call["thread"] for f in frames)
