"""Frame parallelism in the port on the CPU: a stack's frames round-robin
over a list of devices (``segment_stack(devices=...)`` in both pipelines,
the entry points' ``devices=``, ``SegmentationServer(devices=...)``).

torch has one CPU device, so the lists here name it twice (``[cpu,
cpu]``): the round-robin, the widened lookahead and the per-device guards
run as they do over two cards. Every case holds the labels bit-equal to
``devices=[cpu]``, warm restart included.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu_torch.engine import device_pipeline as tdp
from iterseg_tpu_torch.engine.predict import UNetModel
from iterseg_tpu_torch.engine.segmentation import (affinity_unet_watershed,
                                                   dog_blob_watershed)
from iterseg_tpu_torch.engine.serve import SegmentationServer
from iterseg_tpu_torch.io.zarr_io import open_zarr
from iterseg_tpu_torch.models.convert import params_to_numpy
from iterseg_tpu_torch.models.unet import UNet, UNetSpec
from slab_uploads import slab_by_slab
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
CHUNK, MARGIN = (8, 32, 32), (1, 4, 4)


def blob_stack(n_frames=3, shape=(8, 48, 48), seed=0):
    r = np.random.default_rng(seed)
    frames = []
    for _ in range(n_frames):
        vol = np.zeros(shape, np.float32)
        pts = np.stack([r.integers(1, s - 1, size=24) for s in shape], 1)
        vol[tuple(pts.T)] = 1.0
        vol = ndi.gaussian_filter(vol, (1, 2, 2))
        frames.append((vol / vol.max() * 60000).astype(np.uint16))
    return np.stack(frames)


@pytest.fixture(scope="module")
def stack():
    return blob_stack()


@pytest.fixture(scope="module")
def model():
    return UNetModel(params_to_numpy(UNet(UNetSpec(1, 5)).init_weights(0)))


def pipelines(model):
    return {
        "affinity": lambda: tdp.AffinityPipeline(model, CHUNK, MARGIN,
                                                 device=CPU),
        "dog": lambda: tdp.DoGPipeline(device=CPU),
    }


@pytest.mark.parametrize("kind", ["affinity", "dog"])
def test_segment_stack_round_robin_equals_one_device(model, stack, kind):
    make = pipelines(model)[kind]
    one = np.zeros(stack.shape, np.int32)
    assert list(make().segment_stack(stack, one, devices=[CPU])) == [0, 1, 2]
    assert one.max() > 0
    two = np.zeros(stack.shape, np.int32)
    assert list(make().segment_stack(stack, two,
                                     devices=[CPU, CPU])) == [0, 1, 2]
    np.testing.assert_array_equal(two, one)
    # warm restart: frame 1 already labelled, the others are redone
    again = two.copy()
    again[0] = 0
    again[2] = 0
    assert list(make().segment_stack(stack, again,
                                     devices=[CPU, CPU, CPU])) == [0, 2]
    np.testing.assert_array_equal(again, one)


def test_lookahead_is_the_device_count():
    """``_drive_stack`` keeps len(devices) frames queued ahead of the one
    it finalises, and round-robins them over the list."""
    events = []
    out = np.zeros((5, 1), np.int32)
    a, b, c = devices = [torch.device("cpu", i) for i in range(3)]

    def dispatch(t, device):
        events.append(("dispatch", t, device))
        return t

    def finalize(t):
        events.append(("finalize", t))
        return t + 1

    done = list(tdp._drive_stack(out, out, True, devices, dispatch,
                                 finalize))
    assert done == [0, 1, 2, 3, 4]
    assert events[:5] == [("dispatch", 0, a), ("dispatch", 1, b),
                          ("dispatch", 2, c), ("dispatch", 3, a),
                          ("finalize", 0)]
    assert [e[2] for e in events if e[0] == "dispatch"] == [a, b, c, a, b]
    np.testing.assert_array_equal(out[:, 0], [1, 2, 3, 4, 5])


@pytest.mark.parametrize("segmenter", ["affinity", "dog"])
def test_entry_points_equal_one_device(tmp_path, stack, segmenter,
                                       monkeypatch):
    """The segmenters with ``devices=[cpu, cpu]`` and a save directory:
    the whole list reaches ``segment_stack``, the stored labels equal one
    device's, and a second run into the same store gives them again."""
    cls = tdp.AffinityPipeline if segmenter == "affinity" else tdp.DoGPipeline
    real, seen = cls.segment_stack, []

    def recorded(self, *args, devices=None, **kw):
        seen.append(devices)
        return real(self, *args, devices=devices, **kw)

    monkeypatch.setattr(cls, "segment_stack", recorded)
    if segmenter == "affinity":
        def run(devices, name):
            return affinity_unet_watershed(
                None, stack, str(tmp_path), name, None, chunk_size=CHUNK,
                margin=MARGIN, devices=devices)
    else:
        def run(devices, name):
            return dog_blob_watershed(None, stack, str(tmp_path), name, None,
                                      devices=devices)
    one = np.asarray(run([CPU], "one"))
    two = np.asarray(run([CPU, CPU], "two"))
    assert seen == [[CPU], [CPU, CPU]]
    assert one.max() > 0
    np.testing.assert_array_equal(two, one)
    np.testing.assert_array_equal(np.asarray(run([CPU, CPU], "two")), one)
    assert seen[-1] == [CPU, CPU]


def test_server_round_robins_a_stack(tmp_path, stack, monkeypatch):
    """``SegmentationServer(devices=[cpu, cpu])`` serves a stack with the
    labels of the one-device server."""
    got, seen = {}, []
    real = tdp.DoGPipeline.segment_stack

    def recorded(self, *args, devices=None, **kw):
        seen.append(devices)
        return real(self, *args, devices=devices, **kw)

    monkeypatch.setattr(tdp.DoGPipeline, "segment_stack", recorded)
    for n in (1, 2):
        server = SegmentationServer("DoG-blob-watershed", chunk_size=CHUNK,
                                    margin=MARGIN, devices=[CPU] * n)
        assert server.devices == [CPU] * n
        got[n] = np.asarray(server.segment_to(
            stack, str(tmp_path / f"s{n}.ome.zarr")))
    assert seen == [[CPU], [CPU, CPU]] and got[1].max() > 0
    np.testing.assert_array_equal(got[2], got[1])
    np.testing.assert_array_equal(
        np.asarray(open_zarr(str(tmp_path / "s2.ome.zarr" / "0"))), got[1])


@pytest.mark.parametrize("normalize", [True, False])
def test_whole_frame_upload_equals_slab_by_slab(model, normalize):
    """The feature program's one upload of the frame gives the features of
    the slab-by-slab uploads bit for bit, with and without ``/ max``."""
    vol = blob_stack(1, (20, 48, 48), seed=4)[0]
    program = tdp.get_feature_program(model, vol.shape, CHUNK, MARGIN,
                                      microbatch=2, normalize=normalize,
                                      device=CPU)
    assert len(set(program.slab_of)) > 1
    got = program(vol, CPU)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdp, "_upload_frame", slab_by_slab(program))
        want = program(vol, CPU)
    assert torch.equal(got, want)


@pytest.mark.parametrize("devices", [[CPU], [torch.device("cpu", 0),
                                            torch.device("cpu", 1)]])
def test_stack_labels_equal_slab_by_slab_uploads(model, stack, devices,
                                                 monkeypatch):
    """The stack path on CPU device lists gives the labels of the
    slab-by-slab uploads, frame for frame, and enters no CUDA stream."""
    def no_stream(*a, **k):
        raise AssertionError("a CUDA stream was entered on the CPU")

    monkeypatch.setattr(torch.cuda, "stream", no_stream)
    monkeypatch.setattr(torch.cuda, "Stream", no_stream)
    pipe = pipelines(model)["affinity"]()
    got = np.zeros(stack.shape, np.int32)
    assert list(pipe.segment_stack(stack, got, devices=devices)) == [0, 1, 2]
    real = tdp.get_feature_program

    def old_uploads(*a, **k):
        program = real(*a, **k)
        monkeypatch.setattr(tdp, "_upload_frame", slab_by_slab(program))
        return program

    monkeypatch.setattr(tdp, "get_feature_program", old_uploads)
    want = np.zeros(stack.shape, np.int32)
    assert list(pipe.segment_stack(stack, want, devices=devices)) == [0, 1, 2]
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)
    assert tdp._frame_streams == {}


def test_drive_stack_signature_and_order_on_its_own_device():
    """``_drive_stack`` takes ``(stack, output_labels, skip_labelled,
    devices, dispatch_one, finalize_one, own_device)`` by position; with
    ``devices=None`` it runs on ``own_device`` one frame ahead: each
    frame's dispatch comes before the previous frame's finalisation, and
    a CPU device gets no stream."""
    import inspect

    assert list(inspect.signature(tdp._drive_stack).parameters) == [
        "stack", "output_labels", "skip_labelled", "devices",
        "dispatch_one", "finalize_one", "own_device"]
    events = []
    out = np.zeros((3, 1), np.int32)

    def dispatch(t, device):
        events.append(("dispatch", t, device))
        return t

    def finalize(t):
        events.append(("finalize", t))
        return t + 1

    done = list(tdp._drive_stack(out, out, True, None, dispatch, finalize,
                                 CPU))
    assert done == [0, 1, 2]
    assert events == [("dispatch", 0, None), ("dispatch", 1, None),
                      ("finalize", 0), ("dispatch", 2, None),
                      ("finalize", 1), ("finalize", 2)]
    assert tdp._card_index(CPU) is None and tdp._card_index(None) is None


@pytest.mark.parametrize("queued", [[True, False, True],
                                    [False, False, True]])
def test_drive_stack_counts_the_dispatches_left_queued(queued, monkeypatch):
    """``async_dispatch`` counts a frame only when its stream still has
    work queued as its dispatch returns (``stream.query()`` False)."""
    import contextlib

    from iterseg_tpu_torch import utils

    class Stream:
        def __init__(self, busy):
            self.busy = busy

        def query(self):
            return not self.busy

    class Streams:
        def __init__(self, cards):
            self.left = iter(queued)

        @contextlib.contextmanager
        def dispatching(self, card):
            yield Stream(next(self.left))

    monkeypatch.setattr(tdp, "_CardStreams", Streams)
    monkeypatch.setattr(tdp, "_frame_stream",
                        lambda stream: contextlib.nullcontext())
    out = np.zeros((3, 1), np.int32)
    utils.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert list(tdp._drive_stack(out, out, True, None, lambda t, d: t,
                                     lambda t: t + 1, CPU)) == [0, 1, 2]
    counted = [s["frame"] for s in utils.spans()
               if s["name"] == "async_dispatch"]
    assert counted == [t for t, q in enumerate(queued) if q]


def zero_slice_cases():
    r = np.random.default_rng(9)
    base = r.integers(0, 4, (6, 7, 8)).astype(np.uint16)
    z_plane, yx_planes = base.copy(), base.copy()
    z_plane[2] = 0
    yx_planes[:, 3] = 0
    yx_planes[:, :, 0] = 0
    signed = r.integers(-3, 4, (6, 7, 8)).astype(np.int16)
    signed[1] = 0
    signed[:, :, 4] = 0
    # z plane 1 sums to zero without being zero, and x plane 4 sums to
    # zero only once z plane 1 has gone
    signed[1, 0, 0], signed[1, 0, 1], signed[1, 0, 4] = 3, -5, 2
    return {"no zero plane": base, "no zero": base + 1,
            "z plane": z_plane, "y and x planes": yx_planes,
            "signed": signed}


@pytest.mark.parametrize("case", sorted(zero_slice_cases()))
def test_prepare_frame_removes_the_zero_slices_it_did(case):
    """The stack path's frame preparation keeps a frame that loses no
    hyperplane as it is, and cuts the others as the zero-slice scan does
    (signed frames whose planes sum to zero included)."""
    from iterseg_tpu_torch.core.volume import remove_sum_zero_slices

    raw = zero_slice_cases()[case]
    want, kept = raw, None
    if raw.min() == 0:
        want, kept = remove_sum_zero_slices(raw, return_kept=True)
        if want.shape == raw.shape:
            kept = None
    vol, got_kept, device_norm = tdp._prepare_frame(raw)
    assert device_norm and vol.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(vol, want)
    assert (got_kept is None) == (kept is None)
    if kept is not None:
        for a, b in zip(got_kept, kept):
            np.testing.assert_array_equal(a, b)
    if case.startswith("no zero"):
        assert vol is raw
