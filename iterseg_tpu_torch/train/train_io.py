"""Training-data generation pipeline.

The port of ``iterseg_tpu/train/train_io.py``, without pandas: a chunk
dict's ``"df"`` is a dict of columns, and ``start_coords.csv`` is written by
``helpers.write_csv`` in the layout of ``DataFrame.to_csv``, appended to as
the JAX package appends (``pd.concat`` with a re-read file: an
``Unnamed: 0`` column and repeated index values). Chunks are saved through
the port's ``io/zarr_io.py``. ``device`` is where smoothed label channels
are computed (CUDA when None).

Parity with iterseg ``train_io.py``: rejection-sampled random 3D crops with
a minimum-brightness test, target-channel synthesis via the label grammar,
joint augmentation, zarr persistence of every chunk with a
``start_coords.csv`` manifest, and the train/validation split.

Reference quirk preserved by default: the validation indices are sampled
*with replacement* (train_io.py:481), so duplicate draws shrink the actual
validation set; pass ``validation_with_replacement=False`` to
``chunk_dict_to_train_dict`` for a proper split.
"""
from __future__ import annotations

import os
from datetime import datetime
from pathlib import Path

import numpy as np

from ..device import resolve_device
from ..helpers import (LINE, get_files, log_dir_or_None, read_csv, write_csv,
                       write_log)
from ..io.zarr_io import zarr_save, zarr_open
from .augment import augment_images
from .labels import get_training_labels, print_labels_info

__all__ = [
    "get_train_data",
    "get_random_chunks",
    "get_image_chunks",
    "get_labels_chunks",
    "augment_chunks",
    "save_from_chunk_dict",
    "concat_chunk_dicts",
    "chunk_dict_to_train_dict",
    "normalise_data",
    "save_chunk",
    "load_train_data",
    "load_tensor_from_zarr",
]


# one copy of the /max normalisation (parity: train_io.py:505-515),
# re-exported here under the reference's name
from ..core.volume import normalise_data  # noqa: E402


def load_tensor_from_zarr(i, ls):
    """Materialise item i of a list of (zarr-backed or ndarray) chunks."""
    return np.asarray(ls[i])


def get_train_data(
    image_list,
    gt_list,
    out_dir=None,
    name="train-unet",
    shape=(10, 256, 256),
    n_each=100,
    channels=("z-1", "y-1", "x-1", "centreness"),
    scale=(4, 1, 1),
    log=True,
    validation_prop=0.2,
    rng=None,
    *,
    device=None,
    **kwargs,
):
    """Random training chunks from whole GT volumes → per-label-set train
    dicts (parity: train_io.py:22-105). ``device``: where smoothed label
    channels are computed (CUDA unless given)."""
    device = resolve_device(device)
    assert len(image_list) == len(gt_list)
    if out_dir is not None:
        d = datetime.now().strftime("%y%m%d_%H%M%S") + "_" + name
        out_dir = os.path.join(out_dir, d)
        os.makedirs(out_dir, exist_ok=True)
    chunk_dicts = []
    if not isinstance(scale, list):
        scale = [scale] * len(image_list)
    for i in range(len(image_list)):
        chunk_dicts.append(
            get_random_chunks(
                image_list[i],
                gt_list[i],
                out_dir,
                name=name,
                shape=shape,
                n=n_each,
                channels=channels,
                scale=scale[i],
                log=log,
                image_no=i,
                rng=rng,
                device=device,
            )
        )
    chunk_dict = concat_chunk_dicts(chunk_dicts)
    return chunk_dict_to_train_dict(chunk_dict, validation_prop, rng=rng)


def get_random_chunks(
    image_src,
    gt_src,
    out_dir,
    name="unet-training",
    shape=(10, 256, 256),
    n=25,
    min_brightness_prop=0.005,
    channels=("z-1", "y-1", "x-1", "centreness"),
    scale=(4, 1, 1),
    log=True,
    image_no=0,
    rng=None,
    device=None,
):
    """One volume → n augmented chunks + per-chunk zarr persistence
    (parity: train_io.py:109-217)."""
    save_output = out_dir is not None
    d = datetime.now().strftime("%y%m%d_%H%M%S") + "_" + name
    if isinstance(image_src, (str, Path)):
        image = zarr_open(str(image_src))
        im_name = str(image_src)
    else:
        image = image_src
        im_name = f"image_shape-{np.asarray(image_src).shape}_prepared-{d}"
    image = normalise_data(np.array(image, dtype=np.float32))
    if isinstance(gt_src, (str, Path)):
        ground_truth = np.array(zarr_open(str(gt_src)))
        gt_name = str(gt_src)
    else:
        ground_truth = np.array(gt_src)
        gt_name = f"labels_shape-{ground_truth.shape}_prepared-{d}"
    print(LINE)
    s = (
        f"Generating training data from image: {im_name}, "
        f"Ground truth: {gt_name}"
    )
    print(s)
    print("Generating random image chunks...")
    chunk_dict = get_image_chunks(
        image, shape=shape, n=n, min_brightness_prop=min_brightness_prop,
        image_no=image_no, rng=rng,
    )
    chunk_dict["df"]["image_no"] = [image_no] * chunk_dict["n"]
    chunk_dict["df"]["image_file"] = [Path(im_name).stem] * chunk_dict["n"]
    print("Generating training labels...")
    chunk_dict = get_labels_chunks(chunk_dict, ground_truth,
                                   channels=channels, scale=scale,
                                   device=device)
    print("Augmenting data...")
    chunk_dict = augment_chunks(chunk_dict, rng=rng)
    save_dir = None
    if save_output:
        print("Saving for posterity...")
        save_dir = save_from_chunk_dict(chunk_dict, out_dir, name)
        if log:
            write_log(LINE, save_dir)
            write_log(s, save_dir)
        print(LINE)
        s2 = f"Obtained {n} {shape} chunks of training data"
        print(s2)
        if log:
            write_log(LINE, save_dir)
            write_log(s2, save_dir)
        log_dir = log_dir_or_None(log, save_dir)
        print_labels_info(channels, out_dir=log_dir)
        _append_start_coords(os.path.join(save_dir, "start_coords.csv"),
                             chunk_dict["df"])
    return chunk_dict


def _append_start_coords(df_path, columns):
    """Write the chunk manifest, or append to the one there as
    ``pd.concat([pd.read_csv(df_path), df]).to_csv(df_path)`` does: the
    re-read file brings its index as an ``Unnamed: 0`` column (empty on the
    new rows), and the index restarts at 0 for the new rows."""
    n = len(next(iter(columns.values())))
    if not os.path.exists(df_path):
        write_csv(df_path, columns)
        return
    old = read_csv(df_path)
    n_old = len(next(iter(old.values()))) if old else 0
    names = list(old) + [c for c in columns if c not in old]
    merged = {c: list(old.get(c, [None] * n_old))
              + list(columns.get(c, [None] * n)) for c in names}
    write_csv(df_path, merged, index=list(range(n_old)) + list(range(n)))


def get_image_chunks(image, shape=(10, 256, 256), n=25,
                     min_brightness_prop=0.3, image_no=0, rng=None):
    """Rejection-sampled random crops: a crop is kept when
    ``mean/max > min_brightness_prop`` (parity: train_io.py:224-275)."""
    r = np.random if rng is None else rng
    im = np.array(image)
    assert len(im.shape) == len(shape)
    xs, ids, slices = [], [], []
    df = {"z_start": [], "y_start": [], "x_start": []}
    i = 0
    attempts = 0
    max_attempts = max(1000, n * 1000)
    while i < n:
        attempts += 1
        if attempts > max_attempts:
            raise RuntimeError(
                f"could not find {n} bright-enough chunks in {max_attempts} "
                "draws; lower min_brightness_prop or check the data"
            )
        dim_randints = []
        for j, dim in enumerate(shape):
            max_ = im.shape[j] - dim - 1
            if max_ <= 0:
                if dim > im.shape[j]:
                    raise ValueError(
                        f"chunk shape {shape} exceeds image shape "
                        f"{im.shape} on axis {j}"
                    )
                ri = 0  # chunk spans the whole axis
            else:
                ri = int(r.randint(0, max_) if rng is None
                         else r.integers(0, max_))
            dim_randints.append(ri)
        s_ = tuple(
            slice(dim_randints[j], dim_randints[j] + shape[j])
            for j in range(len(shape))
        )
        x = im[s_]
        if x.mean() / x.max() > min_brightness_prop:
            slices.append(s_)
            df["z_start"].append(dim_randints[0])
            df["y_start"].append(dim_randints[1])
            df["x_start"].append(dim_randints[2])
            xs.append(x)
            d = datetime.now().strftime("%y%m%d_%H%M%S")
            ids.append(f"{d}_img-{image_no}_chunk-{i}")
            i += 1
    df["data_ids"] = ids
    return {
        "x": xs,
        "slices": slices,
        "ids": ids,
        "df": df,
        "n": len(xs),
    }


def get_labels_chunks(chunk_dict, ground_truth,
                      channels=("z-1", "y-1", "x-1", "centreness-log"),
                      scale=(4, 1, 1), device=None):
    """Synthesise target channels for the whole volume once, then slice per
    chunk (parity: train_io.py:291-320)."""
    if not isinstance(channels, dict):
        channels = {"y": channels}
    chunk_dict["channels"] = channels
    labels = {
        key: get_training_labels(ground_truth, channels[key], scale,
                                 device=device)
        for key in channels
    }
    chunk_dict["ys"] = {key: [] for key in labels}
    chunk_dict["ground_truth"] = []
    for s_ in chunk_dict["slices"]:
        chunk_dict["ground_truth"].append(ground_truth[s_])
        new_s_ = (slice(None),) + tuple(s_)
        for key in labels:
            chunk_dict["ys"][key].append(labels[key][new_s_])
    return chunk_dict


def augment_chunks(chunk_dict, rng=None):
    """Jointly augment every chunk in place (parity: train_io.py:331-355)."""
    x, ys, labs_keys, gt, n = _read_chunk_dict(chunk_dict)
    for i in range(n):
        labels_dict = {key: ys[key][i] for key in labs_keys}
        image, labels_dict, ground_truth = augment_images(
            x[i], labels_dict, gt[i], rng=rng
        )
        chunk_dict["x"][i] = image
        for key in labs_keys:
            chunk_dict["ys"][key][i] = labels_dict[key]
        chunk_dict["ground_truth"][i] = ground_truth
    return chunk_dict


def _read_chunk_dict(chunk_dict):
    x = chunk_dict["x"]
    ys = chunk_dict["ys"]
    labs_keys = list(ys.keys())
    gt = chunk_dict["ground_truth"]
    n = chunk_dict["n"]
    assert n == len(x) and n == len(gt)
    for key in labs_keys:
        assert len(ys[key]) == n
    return x, ys, labs_keys, gt, n


def save_chunk(out_dir, i, data_list, ID_list, type_suffix):
    """Persist one chunk and swap the in-memory entry for the on-disk array
    (parity: train_io.py:518-526)."""
    path = os.path.join(out_dir, ID_list[i] + type_suffix)
    arr = zarr_save(path, data_list[i])
    data_list[i] = arr


def save_from_chunk_dict(chunk_dict, out_dir, name):
    """Persist images, GT and every label set (parity:
    train_io.py:366-399)."""
    x = chunk_dict["x"]
    ys = chunk_dict["ys"]
    gt = chunk_dict["ground_truth"]
    ids = chunk_dict["ids"]
    chunk_dict["name"] = name
    for i in range(len(x)):
        save_chunk(out_dir, i, x, ids, "_image.zarr")
        save_chunk(out_dir, i, gt, ids, "_GT.zarr")
    labs_paths = {}
    for key in ys.keys():
        path = os.path.join(out_dir, str(key))
        labs_paths[key] = path
        os.makedirs(path, exist_ok=True)
        y = ys[key]
        for j in range(len(y)):
            save_chunk(path, j, y, ids, "_labels.zarr")
    chunk_dict["save_dir"] = out_dir
    chunk_dict["labels_dirs"] = labs_paths
    return out_dir


def concat_chunk_dicts(chunks_dict_list):
    """Merge per-volume chunk dicts (parity: train_io.py:446-465)."""
    full_dict = chunks_dict_list[0]
    for chunk_dict in chunks_dict_list[1:]:
        full_dict["x"] = full_dict["x"] + chunk_dict["x"]
        full_dict["ground_truth"] = (
            list(full_dict["ground_truth"]) + list(chunk_dict["ground_truth"])
        )
        full_dict["ids"] = full_dict["ids"] + chunk_dict["ids"]
        for key in full_dict["ys"].keys():
            full_dict["ys"][key] = (
                full_dict["ys"][key] + chunk_dict["ys"][key]
            )
        full_dict["df"] = {k: full_dict["df"][k] + chunk_dict["df"][k]
                           for k in full_dict["df"]}
        full_dict["n"] = full_dict["n"] + chunk_dict["n"]
    return full_dict


def chunk_dict_to_train_dict(chunk_dict, validation_prop=0.2, rng=None,
                             validation_with_replacement=True):
    """Train/val split per label set (parity: train_io.py:474-498).

    ``validation_with_replacement=True`` replicates the reference's
    ``np.random.randint`` draw (duplicates shrink the val set).
    """
    r = np.random if rng is None else rng
    n = len(chunk_dict["x"])
    no_val = int(np.round(validation_prop * n))
    if validation_with_replacement:
        vx_idx = (r.randint(0, n, size=no_val) if rng is None
                  else r.integers(0, n, size=no_val))
    else:
        vx_idx = (np.random.permutation(n)[:no_val] if rng is None
                  else r.permutation(n)[:no_val])
    vx_idx = set(int(v) for v in vx_idx)
    out = {}
    for key in chunk_dict["ys"].keys():
        train_dict = {
            "x": [x for i, x in enumerate(chunk_dict["x"])
                  if i not in vx_idx],
            "vx": [x for i, x in enumerate(chunk_dict["x"]) if i in vx_idx],
            "y": [y for i, y in enumerate(chunk_dict["ys"][key])
                  if i not in vx_idx],
            "vy": [y for i, y in enumerate(chunk_dict["ys"][key])
                   if i in vx_idx],
            "ids": [ID for i, ID in enumerate(chunk_dict["ids"])
                    if i not in vx_idx],
            "vids": [ID for i, ID in enumerate(chunk_dict["ids"])
                     if i in vx_idx],
            "out_dir": chunk_dict.get("labels_dirs", {}).get(key),
            "name": key,
            "channels": chunk_dict["channels"][key],
        }
        print(f"generated train dict for {key}")
        out[key] = train_dict
    return out


def load_train_data(
    data_dir,
    id_regex=r"\d{6}_\d{6}_\d{1,3}",
    x_regex=r"\d{6}_\d{6}_\d{1,3}_image.tif",
    y_regex=r"\d{6}_\d{6}_\d{1,3}_labels.tif",
):
    """Load saved train data by naming convention (parity:
    train_io.py:544-613)."""
    import re as _re

    from ..helpers import _read_any

    x_paths, y_paths = get_files(data_dir, x_regex=x_regex, y_regex=y_regex)
    id_pattern = _re.compile(id_regex)
    ids = []
    x_paths.sort()
    y_paths.sort()
    for i in range(len(x_paths)):
        xid = id_pattern.search(Path(x_paths[i]).stem)[0]
        yid = id_pattern.search(Path(y_paths[i]).stem)[0]
        assert xid == yid, "There is a mismatch in image and label IDs"
        ids.append(xid)
    xs, ys = [], []
    for xp, yp in zip(x_paths, y_paths):
        xs.append(normalise_data(_read_any(xp)))
        ys.append(_read_any(yp))
    print(LINE)
    print(f"Loaded {len(xs)} sets of training data")
    return xs, ys, ids
