"""The port's training data (augmentation, ``get_train_data``, the chunk
manifest) and its pandas- and PIL-free writers, against the JAX package
and against pandas and PIL themselves. Augmentation and the crops, splits
and manifests are equal under the same ``default_rng`` seed; ids are equal
up to their timestamp."""
import os
import re
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image
from scipy import ndimage as ndi

from conftest import cpu_subprocess_env
from iterseg_tpu.train import augment as jaug
from iterseg_tpu.train import train_io as jio
from iterseg_tpu_torch import helpers
from iterseg_tpu_torch.train import augment as taug
from iterseg_tpu_torch.train import train_io as tio
from torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CHANS = ("z-1", "y-1", "x-1", "mask", "centreness-log")
STAMP = re.compile(r"\d{6}_\d{6}")


def volume(seed):
    r = np.random.default_rng(seed)
    vol = np.zeros((4, 32, 32), np.float32)
    pts = np.stack([r.integers(1, s - 1, size=8) for s in vol.shape], 1)
    vol[tuple(pts.T)] = 1.0
    img = ndi.gaussian_filter(vol, (1, 2, 2))
    img = img / img.max()
    gt, _ = ndi.label(img > 0.3)
    return img, gt


@pytest.mark.parametrize("seed", range(6))
def test_augment_images_bit_equal(seed):
    r = np.random.default_rng(100 + seed)
    img = r.random((2, 16, 16)).astype(np.float32)
    labs = {"a": r.random((5, 2, 16, 16)), "b": r.random((2, 2, 16, 16))}
    gt = r.integers(0, 5, (2, 16, 16))
    want = jaug.augment_images(img, labs, gt, rng=np.random.default_rng(seed))
    got = taug.augment_images(img, labs, gt, rng=np.random.default_rng(seed))
    np.testing.assert_array_equal(got[0], want[0])
    for k in labs:
        np.testing.assert_array_equal(got[1][k], want[1][k])
    np.testing.assert_array_equal(got[2], want[2])


def _frame(path):
    df = pd.read_csv(path)
    return df.map(lambda v: STAMP.sub("T", v) if isinstance(v, str) else v)


def test_get_train_data_matches_jax(tmp_path):
    """Two volumes into one output directory: the second appends to
    ``start_coords.csv`` as the JAX package's pandas concat does."""
    (img0, gt0), (img1, gt1) = volume(0), volume(1)
    kw = dict(name="tr", shape=(2, 16, 16), n_each=3, channels=CHANS,
              validation_prop=0.5, log=False)
    jd, td = tmp_path / "jax", tmp_path / "torch"
    want = jio.get_train_data([img0, img1], [gt0, gt1], str(jd),
                              rng=np.random.default_rng(3), **kw)
    got = tio.get_train_data([img0, img1], [gt0, gt1], str(td),
                             rng=np.random.default_rng(3), device=CPU, **kw)
    assert list(got) == list(want) == ["y"]
    g, w = got["y"], want["y"]
    for key in ("x", "vx", "y", "vy"):
        assert len(g[key]) == len(w[key])
        for a, b in zip(g[key], w[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for key in ("ids", "vids"):
        assert [STAMP.sub("T", i) for i in g[key]] == [
            STAMP.sub("T", i) for i in w[key]]
    assert g["channels"] == w["channels"] and g["name"] == w["name"]
    assert os.path.basename(g["out_dir"]) == "y"
    (jrun,), (trun,) = os.listdir(jd), os.listdir(td)
    jcsv = jd / jrun / "start_coords.csv"
    tcsv = td / trun / "start_coords.csv"
    jf, tf = _frame(jcsv), _frame(tcsv)
    assert list(jf.columns) == list(tf.columns)
    assert list(tf.columns)[:2] == ["Unnamed: 0.1", "Unnamed: 0"]
    pd.testing.assert_frame_equal(tf, jf)
    assert len(tf) == 6
    # the files themselves, up to the timestamps
    assert (STAMP.sub("T", tcsv.read_text())
            == STAMP.sub("T", jcsv.read_text()))
    assert sorted(os.listdir(td / trun / "y")) and len(
        os.listdir(td / trun / "y")) == len(os.listdir(jd / jrun / "y"))


def test_split_with_replacement_matches_jax():
    chunk = {"x": [np.full((1,), i) for i in range(10)],
             "ys": {"k": [np.full((1,), -i) for i in range(10)]},
             "ids": [f"id{i}" for i in range(10)],
             "channels": {"k": ("mask",)}}
    for seed in range(4):
        want = jio.chunk_dict_to_train_dict(
            chunk, 0.4, rng=np.random.default_rng(seed))["k"]
        got = tio.chunk_dict_to_train_dict(
            chunk, 0.4, rng=np.random.default_rng(seed))["k"]
        assert got["vids"] == want["vids"] and got["ids"] == want["ids"]
        assert len(got["vids"]) <= 4


COLUMNS = {"epoch": [0, 0, 1], "loss": [0.1 + 0.2, 1.0, 1e-20],
           "data_id": ["a", "b,c", 'q"uote'], "gap": [1.5, None, 2.0],
           "ints_gap": [1, None, 3], "strs_gap": ["x", None, "z"],
           "inf": [float("inf"), 0.5, -2.0]}


def test_write_csv_is_to_csv(tmp_path):
    p = tmp_path / "a.csv"
    helpers.write_csv(p, COLUMNS)
    df = pd.DataFrame({k: [np.nan if v is None else v for v in vals]
                       for k, vals in COLUMNS.items()})
    df["strs_gap"] = ["x", np.nan, "z"]
    df.to_csv(tmp_path / "b.csv")
    assert p.read_text() == (tmp_path / "b.csv").read_text()


@pytest.mark.parametrize("header", [None, ",Unnamed: 0,x,x.1,x,,y"])
def test_read_csv_types_as_pandas(tmp_path, header):
    p = tmp_path / "a.csv"
    if header is None:
        helpers.write_csv(p, COLUMNS)
    else:
        p.write_text(header + "\n0,1,2,3,4,a,\n1,5,6,7,8,,1.5\n")
    got = helpers.read_csv(p)
    want = pd.read_csv(p, float_precision="round_trip")
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].tolist()
        g = got[c]
        assert [None if (isinstance(v, float) and np.isnan(v)) else v
                for v in w] == g, c
        kinds = {type(v) for v in g if v is not None}
        assert kinds <= {int} or kinds <= {float} or kinds <= {str}, c


def test_start_coords_appends_as_pandas_concat(tmp_path):
    cols = {"z_start": [0, 1], "y_start": [2, 3], "x_start": [4, 5],
            "data_ids": ["p", "q"], "image_no": [0, 0],
            "image_file": ["f(1, 2)", "f(1, 2)"]}
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    for _ in range(3):
        tio._append_start_coords(str(ours), cols)
        df = pd.DataFrame(cols)
        if theirs.exists():
            df = pd.concat([pd.read_csv(theirs), df])
        df.to_csv(theirs)
        assert ours.read_text() == theirs.read_text()


def test_tiff_writer_reads_back_in_pil_and_port(tmp_path):
    r = np.random.default_rng(0)
    arr = r.standard_normal((1, 3, 2, 5, 7)).astype(np.float32)
    arr[0, 0, 0, 0, 0] = np.inf
    p = tmp_path / "v_output.tif"
    helpers.write_tiff(p, arr)
    planes = arr.reshape(-1, 5, 7)
    np.testing.assert_array_equal(helpers.read_tiff(p), planes)
    im = Image.open(p)
    assert im.n_frames == 6
    for i in range(im.n_frames):
        im.seek(i)
        assert im.mode == "F" and im.size == (7, 5)
        np.testing.assert_array_equal(np.array(im), planes[i])
    single = tmp_path / "one.tif"
    helpers.write_tiff(single, planes[0])
    np.testing.assert_array_equal(helpers.read_tiff(single), planes[:1])


def test_read_tiff_refuses_other_layouts(tmp_path):
    p = tmp_path / "u8.tif"
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(p)
    with pytest.raises(ValueError):
        helpers.read_tiff(p)


def test_training_runs_without_pandas_pil_or_tensorstore(tmp_path):
    """The machine with the card has no pandas, PIL or tensorstore: the
    training modules import and a one-epoch ``run_experiment`` runs on the
    CPU with all three blocked (chunk zarrs go through ``io/zarr_mini``)."""
    code = f"""
import os, sys, warnings
sys.modules['pandas'] = None
sys.modules['PIL'] = None
sys.modules['jax'] = None
sys.modules['tensorstore'] = None
import numpy as np, torch
from scipy import ndimage as ndi
torch.set_num_threads(2)
from iterseg_tpu_torch.helpers import read_csv, read_tiff
from iterseg_tpu_torch.train import (augment, experiments, labels, losses,
                                     train, train_io)
r = np.random.default_rng(0)
vol = np.zeros((4, 32, 32), np.float32)
vol[tuple(np.stack([r.integers(1, s - 1, 8) for s in vol.shape]))] = 1.0
img = ndi.gaussian_filter(vol, (1, 2, 2)); img /= img.max()
gt, _ = ndi.label(img > 0.3)
exp = experiments.get_experiment_dict(
    [{CHANS!r}], ["c"], [{{"epochs": 1}}], n_each=3, name="m")
exp["get_train_data"]["shape"] = (2, 16, 16)
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    (path,) = experiments.run_experiment(exp, [img], [gt], {str(tmp_path)!r},
                                         device="cpu")
assert any("tensorstore" in str(w.message) for w in caught)
assert os.path.exists(path)
d = os.path.dirname(path)
loss = read_csv(os.path.join(d, "loss_c.csv"))
assert len(loss["loss"]) >= 1 and all(np.isfinite(loss["loss"]))
tifs = [f for f in os.listdir(d) if f.endswith("_output.tif")]
assert tifs and read_tiff(os.path.join(d, tifs[0])).shape[0] == 5 * 2
assert not [m for m in sys.modules if m.split('.')[0] in
            ('pandas', 'PIL', 'iterseg_tpu', 'tensorstore')
            and sys.modules[m] is not None]
print("ok")
"""
    env = cpu_subprocess_env(ITERSEG_TPU_NO_TENSORSTORE="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
