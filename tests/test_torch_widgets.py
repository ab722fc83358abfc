"""The port's headless widget twins (``iterseg_tpu_torch.widgets``) against
the JAX package's on the same inputs: loading, reshaping, harvesting ground
truth from ROIs (bit-equal under the same ``np.random.seed``), saving,
combining, matching and assessing."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image as PILImage
from scipy import ndimage as ndi

from iterseg_tpu import widgets as jw
from iterseg_tpu import viewer as jv
from iterseg_tpu_torch import helpers, widgets as tw
from iterseg_tpu_torch.io.zarr_io import zarr_open, zarr_save
from iterseg_tpu_torch.viewer import Image, Labels, Viewer
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture
def blob_image():
    r = np.random.default_rng(1)
    vol = np.zeros((8, 48, 48), np.float32)
    for c in np.stack([r.integers(2, s - 2, size=14) for s in vol.shape], 1):
        vol[tuple(c)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 2, 2))
    return (vol / vol.max()).astype(np.float32)


def write_tiff_frames(path, arr):
    frames = [PILImage.fromarray(z) for z in arr]
    frames[0].save(path, save_all=True, append_images=frames[1:])


class TestLoadData:
    def test_zarr_store_equals_jax(self, tmp_path, blob_image):
        p = str(tmp_path / "img.zarr")
        zarr_save(p, blob_image)
        got = tw._load_data(None, "im", "Image", directory=p,
                            scale=(4, 1, 1)).layers["im"]
        want = jw._load_data(None, "im", "Image", directory=p,
                             scale=(4, 1, 1)).layers["im"]
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.scale, want.scale)
        lazy, _ = tw.read_data(p, None, "individual frames", in_memory=False)
        assert not isinstance(lazy, np.ndarray)
        np.testing.assert_array_equal(np.asarray(lazy), blob_image)

    @pytest.mark.parametrize("data_type", ["individual frames",
                                           "image stacks"])
    def test_directory_of_frames_lazy_and_eager(self, tmp_path, data_type):
        a = np.arange(2 * 8 * 8, dtype=np.uint16).reshape(2, 8, 8)
        b = np.ones((2, 6, 8), np.uint16)  # ragged y
        write_tiff_frames(tmp_path / "a.tif", a)
        write_tiff_frames(tmp_path / "b.tif", b)
        d = str(tmp_path)
        eager, _ = tw.read_data(d, None, data_type, in_memory=True)
        lazy, _ = tw.read_data(d, None, data_type, in_memory=False)
        want, _ = jw.read_data(d, None, data_type, in_memory=True)
        np.testing.assert_array_equal(eager, want)
        np.testing.assert_array_equal(np.asarray(lazy), want)
        v = tw._load_data(None, "stack", "Image", data_type=data_type,
                          directory=d)
        np.testing.assert_array_equal(v.layers["stack"].data, want)

    def test_directory_of_zarr_frames(self, tmp_path, blob_image):
        for i in range(3):
            zarr_save(tmp_path / f"frame_{i}.zarr", blob_image + i)
        v = tw._load_data(None, "stack", "Image", directory=str(tmp_path))
        want = jw._load_data(None, "stack", "Image", directory=str(tmp_path))
        np.testing.assert_array_equal(v.layers["stack"].data,
                                      want.layers["stack"].data)
        assert v.layers["stack"].data.shape == (3,) + blob_image.shape

    def test_split_channels_and_shapes(self, tmp_path):
        arr = np.random.default_rng(0).random((2, 6, 16, 16)).astype(
            np.float32)
        zarr_save(tmp_path / "c.zarr", arr)
        v = tw.load_data(None, "c", "Image", directory=str(tmp_path / "c.zarr"),
                         split_channels=True)
        assert [lay.name for lay in v.layers] == ["c-ch0", "c-ch1"]
        np.testing.assert_array_equal(v.layers["c-ch1"].data, arr[1])
        shapes = np.array([[[0, 0], [0, 5], [5, 5], [5, 0]]], float)
        np.save(tmp_path / "rois.npy", shapes)
        v = tw._load_data(None, "rois", "Shapes",
                          data_file=str(tmp_path / "rois.npy"))
        assert len(v.layers["rois"].data) == 1

    def test_read_data_errors(self, tmp_path):
        with pytest.raises(ValueError, match="directory="):
            tw.read_data(None, "vol.zarr", "individual frames")
        with pytest.raises(ValueError, match=r"\.tif"):
            tw.read_data(None, "vol.npy", "individual frames")
        with pytest.raises(ValueError, match="no .tif"):
            tw.read_data(str(tmp_path), None, "individual frames")


@pytest.mark.parametrize("shapes", [[(4, 8, 8), (4, 6, 8)],
                                    [(2, 4, 8, 8), (2, 4, 8, 5)],
                                    [(3, 5, 5), (3, 5, 5)]])
def test_correct_shape_equals_jax(shapes):
    r = np.random.default_rng(len(shapes[0]))
    imgs = [r.random(s) for s in shapes]
    got, want = tw.correct_shape(imgs), jw.correct_shape(imgs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ndim,n_tiles", [(3, 2), (4, 1), (4, 3)])
def test_ground_truth_from_roi_equals_jax(tmp_path, blob_image, ndim,
                                          n_tiles):
    gt = ndi.label(blob_image > 0.3)[0].astype(np.int32)
    img = blob_image
    if ndim == 4:
        gt, img = np.stack([gt, gt[:, ::-1]]), np.stack([img, img[:, ::-1]])
    rois = [np.array([[0, 4, 4], [0, 4, 20], [0, 20, 20], [0, 20, 4]],
                     float),
            np.array([[0, 10, 30], [0, 10, 41], [0, 30, 41], [0, 30, 30]],
                     float)]
    if ndim == 4:
        rois = [np.concatenate([np.full((4, 1), t), r], 1)
                for t, r in enumerate(rois)]
    outs = {}
    for pkg, mod, vmod in (("t", tw, None), ("j", jw, jv)):
        v = (Viewer if vmod is None else vmod.Viewer)()
        il, gl = v.add_image(img, name="im"), v.add_labels(gt, name="gt")
        sl = v.add_shapes(rois, name="rois")
        np.random.seed(11)
        outs[pkg] = mod._ground_truth_from_ROI(
            v, il, gl, sl, save_dir=str(tmp_path / pkg), name="roi-gt",
            number_of_tiles=n_tiles, padding=2)
        assert [lay.name for lay in v.layers][-2:] == ["roi-gt_img",
                                                      "roi-gt_labels"]
    for got, want in zip(outs["t"], outs["j"]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    im, lab = (np.asarray(x) for x in outs["t"])
    assert lab.shape == (2,) + gt.shape[-3:]
    np.testing.assert_array_equal(lab[0][:, :16, :16],
                                  gt[(0,) * (ndim - 3)][:, 4:20, 4:20])
    for name in ("roi-gt_labels.zarr", "roi-gt_img.zarr"):
        np.testing.assert_array_equal(
            np.asarray(zarr_open(str(tmp_path / "t" / name))),
            np.asarray(zarr_open(str(tmp_path / "j" / name))))
    # the generate_ground_truth alias is the harvester
    import iterseg_tpu_torch as p

    assert p.generate_ground_truth is tw.ground_truth_from_ROI


class TestSaveFrames:
    def test_selected_frames_and_reload(self, tmp_path, blob_image):
        stack = np.stack([blob_image * i for i in range(1, 4)])
        layer = Image(stack, name="im")
        v = Viewer()
        sp = tw.save_frames(v, layer, save_dir=str(tmp_path),
                            save_name="f", frames=(0, 2), load_saved=True)
        assert sp.endswith("f.zarr")
        np.testing.assert_array_equal(np.asarray(zarr_open(sp)),
                                      stack[[0, 2]])
        np.testing.assert_array_equal(np.asarray(v.layers["im_f0-2"].data),
                                      stack[[0, 2]])
        n = len(v.layers)
        tw.load_saved_data(False, v, (0,), layer, sp, None)
        assert len(v.layers) == n

    def test_whole_layer_individually_and_shapes(self, tmp_path, blob_image):
        stack = np.stack([blob_image] * 2).astype(np.int32)
        tw.save_frames(Viewer(), Labels(stack, name="lab"),
                       save_dir=str(tmp_path), save_name="g",
                       save_as_stack=False)
        for f in range(2):
            np.testing.assert_array_equal(
                np.asarray(zarr_open(str(tmp_path / f"g_f{f}.zarr"))),
                stack[f])
        v = Viewer()
        shapes = v.add_shapes([np.arange(8.0).reshape(4, 2)] * 3, name="s")
        sp = tw.save_frames(v, shapes, save_dir=str(tmp_path),
                            save_name="s")
        np.testing.assert_array_equal(np.load(sp), np.stack(shapes.data))
        assert len(tw.read_shapes(sp)) == 3


def test_combine_layers_equals_jax(tmp_path, blob_image):
    stack = np.stack([blob_image, blob_image[::-1]])
    outs = {}
    for pkg, mod, labels_cls in (("t", tw, Labels), ("j", jw, jv.Labels)):
        base = labels_cls((stack > 0.5).astype(np.int32), name="base")
        app = labels_cls((stack > 0.3).astype(np.int32), name="app")
        mod.combine_layers(None, base, app, save_dir=str(tmp_path / pkg),
                           save_prefix="c", save_indivdually=True,
                           number_from=5)
        outs[pkg] = base.data
        assert sorted(os.listdir(tmp_path / pkg)) == [
            f"c_{t}.zarr" for t in range(5, 9)]
    np.testing.assert_array_equal(outs["t"], outs["j"])
    for t in range(5, 9):
        np.testing.assert_array_equal(
            np.asarray(zarr_open(str(tmp_path / "t" / f"c_{t}.zarr"))),
            np.asarray(zarr_open(str(tmp_path / "j" / f"c_{t}.zarr"))))


def test_find_matching_labels(blob_image):
    gt = (blob_image > 0.3).astype(np.int32)
    v = Viewer()
    v.add_labels(np.zeros_like(gt), name="b")
    v.add_labels(gt + 0, name="a")
    v.add_image(gt + 0, name="im")
    assert tw.find_matching_labels(v, gt).name == "a"
    with pytest.raises(ValueError):  # all background: an empty reduction
        tw.find_matching_labels(v, np.zeros_like(gt))


def test_construct_lists_equal_jax():
    for ext in (1, (2, 1, 1)):
        assert tw.construct_channels_list(ext, "mask", "centreness") == \
            jw.construct_channels_list(ext, "mask", "centreness")
    with pytest.raises(TypeError):
        tw.construct_channels_list(1.5, "mask", "centreness")
    args = ([1, 2], "BCELoss", 0.01, 3, (4, 1, 1))
    assert tw.construct_conditions_list(*args) == \
        jw.construct_conditions_list(*args)


def test_assess_segmentation_writes_csvs_and_pdfs(tmp_path, blob_image):
    gt = ndi.label(blob_image > 0.25)[0]
    seg = ndi.label(blob_image > 0.35)[0]
    gt4, seg4 = np.stack([gt, gt[::-1]]), np.stack([seg, seg[::-1]])
    for pkg, mod in (("t", tw), ("j", jw)):
        (scores, ap), _ = mod._assess_segmentation(
            gt4, seg4, chunk_size=(8, 24, 24), margin=(1, 4, 4),
            save_dir=str(tmp_path / pkg), save_prefix="am", name="m0",
            show=False, exclude_chunks_less_than=1)
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) == sorted(
        f"am_m0_{k}" for k in ("scores.csv", "stats.csv", "AP_curve.csv",
                               "VI_plot.pdf", "AP_plot.pdf", "OD_plot.pdf"))
    for f in files:
        if f.endswith(".csv"):
            assert (tmp_path / "t" / f).read_bytes() == (
                tmp_path / "j" / f).read_bytes(), f
    assert len(scores["model_name"]) > 1
    with pytest.raises(AssertionError, match="pick a directory"):
        tw.assess_segmentation(None, gt4, gt4, save_dir=None)


def test_segment_data_dog_equals_direct_call(blob_image):
    v = Viewer()
    layer = v.add_image(blob_image, name="img")
    out = tw.segment_data(v, layer, None, "seg", "DoG-blob-watershed",
                          devices=[CPU])
    from iterseg_tpu_torch.engine.segmentation import dog_blob_watershed

    want = dog_blob_watershed(None, blob_image, None, "x", None, debug=True,
                              devices=[CPU])
    assert v.layers["seg"] is out and out.data.max() > 0
    np.testing.assert_array_equal(out.data, want)


def test_train_from_viewer_end_to_end(tmp_path, blob_image, monkeypatch):
    """Train on stacked layers on the CPU, predict labels with the fresh
    network, write ``<unet>_meta.json``."""
    gt = ndi.label(blob_image > 0.3)[0].astype(np.int32)
    v = Viewer()
    img = v.add_image(np.stack([blob_image]), name="im")
    lab = v.add_labels(np.stack([gt]), name="gt")
    u_path = tw._train_from_viewer(
        v, img, lab, output_dir=str(tmp_path), scale=(4, 1, 1),
        training_name="tfv", epochs=1, n_each=2, validation_prop=0.5,
        chunk_size=(8, 48, 48), margin=(1, 8, 8), train_shape=(8, 32, 32),
        device=CPU)
    assert len(u_path) == 1 and os.path.exists(u_path[0])
    labels_layer = v.layers["tfv_labels"]
    assert np.asarray(labels_layer.data).shape == (1, 8, 48, 48)
    assert labels_layer.metadata["unet"] == u_path[0]
    (meta_file,) = [f for f in os.listdir(tmp_path)
                    if f.endswith("_meta.json")]
    meta = json.load(open(tmp_path / meta_file))
    assert meta["epochs"] == 1 and meta["n_each"] == 2
    assert meta["labels_path"].endswith("tfv_labels-prediction.zarr")


def test_lazy_image_stack_and_dataset_helpers(tmp_path):
    ids = ["210101_120000_1", "210101_120000_2"]
    r = np.random.default_rng(0)
    arrs = {}
    for i in ids:
        for suffix in ("_image", "_labels", "_output", "_GT"):
            a = r.random((3, 8, 8)).astype(np.float32)
            arrs[i + suffix] = a
            helpers.write_tiff(tmp_path / f"{i}{suffix}.tif", a)
    from iterseg_tpu import helpers as jh

    got = helpers.get_dataset(str(tmp_path), GT=True, return_ID=True)
    want = jh.get_dataset(str(tmp_path), GT=True, return_ID=True)
    assert got[-1] == want[-1] == ids
    for g, w in zip(got[:-1], want[:-1]):
        assert isinstance(g, helpers.LazyImageStack)
        assert g.shape == w.shape == (2, 3, 8, 8)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_array_equal(got[0][1], arrs[ids[1] + "_labels"])
    assert helpers.get_ids([f"x/{ids[0]}_image.tif"]) == [ids[0]]
    helpers.check_ids_match([str(tmp_path / f"{ids[0]}_image.tif")],
                            [str(tmp_path / f"{ids[0]}_labels.tif")])
    with pytest.raises(ValueError, match="Irregular ID"):
        helpers.get_ids(["nope.tif"])
