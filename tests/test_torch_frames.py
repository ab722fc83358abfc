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
