"""Training-target synthesis from ground-truth instance labels.

The port of ``iterseg_tpu/train/labels.py``: numpy and scipy, except
``smooth``, which runs the port's own ``ops.filters.gaussian`` on the
resolved device (CUDA unless the caller passes ``device``).

Channel-grammar parity with iterseg ``labels.py:23-68``:

- ``'z-n' / 'y-n' / 'x-n'`` — nth short-range affinities along an axis
- ``'centreness'`` / ``'centreness-log'`` — per-object inverse-distance
  score
- ``'centroid-gauss'`` — per-z-slice Gaussian-smoothed centroid points
- ``'offsets-{z,y,x}'`` — normalised axial centre offsets
- ``'mask'`` — semantic foreground
- ``'-smooth'`` suffix — per-z-plane Gaussian smoothing of the channel

Per-object computations (``get_centreness``, ``get_centre_offsets``) are the
reference's hot loops (regionprops with per-voxel Python loops,
``labels.py:143-275``); here they are vectorised per object over bounding
boxes, ~two orders of magnitude faster on host, with identical outputs
(verified against literal oracles in the tests).
"""
from __future__ import annotations

import re
import warnings

import numpy as np
import torch
from scipy import ndimage as ndi

from ..device import resolve_device
from ..ops.filters import gaussian

__all__ = [
    "get_training_labels",
    "is_binary_channel",
    "nth_affinity",
    "get_affinities",
    "get_centreness",
    "get_centre_offsets",
    "get_semantic_labels",
    "get_gauss_centroids",
    "smooth",
    "print_labels_info",
]


def get_training_labels(l, channels=("z-1", "y-1", "x-1", "centreness"),
                        scale=(4, 1, 1), device=None):
    """Stack the requested target channels (parity: labels.py:23-68).
    ``device`` is where the ``-smooth`` and ``centroid-gauss`` channels
    are smoothed (CUDA when None); the other channels are host numpy."""
    labels = []
    get_offsets = any(chan.startswith("offsets-") for chan in channels)
    if get_offsets:
        offsets = get_centre_offsets(l, scale)
    for chan in channels:
        axis = None
        if chan.startswith("z"):
            axis = 0
        elif chan.startswith("y"):
            axis = 1
        elif chan.startswith("x"):
            axis = 2
        n = re.search(r"\d+", chan)
        if n is not None and axis is not None:
            lab = nth_affinity(l, int(n[0]), axis)
        elif chan == "centreness" or chan == "centreness-smooth":
            lab = get_centreness(l, scale=scale)
        elif chan.startswith("centreness-log"):
            lab = get_centreness(l, scale=scale, log=True)
        elif chan == "centroid-gauss":
            lab = get_gauss_centroids(l, device=device)
        elif chan.startswith("offsets-"):
            lab = offsets[_offset_channel(chan)]
        elif chan.startswith("mask"):
            lab = get_semantic_labels(l)
        else:
            m = (
                f"Unrecognised channel type: {chan} \n"
                "Please enter str of form <axis>-<n> for nth affinity "
                "(e.g., z-1), \ncentreness for centreness score (option of "
                "-log for log of centreness),\n"
                "or offset-<axis> (e.g., offset-z) for axis offsets"
            )
            raise ValueError(m)
        if chan.endswith("-smooth"):
            lab = smooth(lab, device=device)
        labels.append(lab)
    return np.stack(labels, axis=0)



def is_binary_channel(chan):
    """True for channels that are {0,1} by construction under this
    grammar: nth-affinity channels (``z-1`` etc.) and ``mask*``, unless
    ``-smooth``ed, which makes any channel continuous. ``centreness*``,
    ``centroid-gauss`` and ``offsets-*`` are continuous."""
    if chan.endswith("-smooth"):
        return False
    if chan.startswith("mask"):
        return True
    return (chan[:1] in ("z", "y", "x")
            and not chan.startswith("offsets-")
            and re.search(r"\d+", chan) is not None)

def _offset_channel(chan):
    if chan.endswith("z"):
        return 0
    if chan.endswith("y"):
        return 1
    if chan.endswith("x"):
        return 2
    raise ValueError(f"Incompatible offset axis name: {chan}")


# ---------------------------------------------------------------------------
# Affinities
# ---------------------------------------------------------------------------


def nth_affinity(labels, n, axis):
    """nth-shift affinities: 1.0 where the label changes across a shift of
    ``n`` along ``axis`` (parity: labels.py:87-109, incl. the reflect-pad
    boundary convention)."""
    labels = np.asarray(labels)
    labs_pad = np.pad(labels, n, mode="reflect")
    ndim = labels.ndim
    sh = labels.shape[axis]
    sl0 = [slice(None)] * ndim
    sl0[axis] = slice(0, sh)
    sln = [slice(None)] * ndim
    sln[axis] = slice(n, n + sh)
    diff = labs_pad[tuple(sl0)] - labs_pad[tuple(sln)]
    # crop the pad on all other axes
    crop = [slice(n, -n)] * ndim
    crop[axis] = slice(None)
    diff = diff[tuple(crop)]
    return np.where(diff != 0, 1.0, 0.0).astype(np.float64)


def get_affinities(image):
    """np.diff-based variant (parity: labels.py:113-136; unused by the
    grammar but part of the public surface)."""
    padded = np.pad(image, 1, mode="reflect")
    affinities = []
    for i in range(len(image.shape)):
        a = np.diff(padded, axis=i)
        a = np.where(a != 0, 1.0, 0.0).astype(np.float32)
        s_ = [slice(1, -1)] * len(image.shape)
        s_[i] = slice(None, -1)
        affinities.append(a[tuple(s_)])
    return np.stack(affinities)


# ---------------------------------------------------------------------------
# Centreness
# ---------------------------------------------------------------------------


def _iter_objects(labels):
    """Yield (label_value, slice, mask) per object, in label order
    (regionprops ordering)."""
    labels = np.asarray(labels)
    objects = ndi.find_objects(labels)
    for i, slc in enumerate(objects):
        if slc is None:
            continue
        lab = i + 1
        yield lab, slc, labels[slc] == lab


def get_centreness(labels, scale=(4, 1, 1), log=False, power=False):
    """Per-voxel inverse scaled distance-to-centroid score per object
    (parity: labels.py:143-205, vectorised).

    For each object: distances d of member voxels to the centroid (mean of
    coordinates) under ``scale``; with ``log``, d>0 → ln d; shift by |min|;
    normalise by max; score = 1 − normalised. Object scores are *added*
    into the output over the object's bounding box, and NaNs (single-voxel
    objects) map to 0 — both reference behaviours.
    """
    scale = np.asarray(scale, dtype=np.float64)
    new = np.zeros(np.asarray(labels).shape, dtype=np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for lab, slc, mask in _iter_objects(labels):
            coords = np.argwhere(mask)
            c = coords.mean(axis=0)
            d = np.linalg.norm((c - coords) * scale, axis=1)
            if log:
                d = np.where(np.abs(d) > 0, np.log(np.where(d > 0, d, 1.0)),
                             d)
                d = d + np.abs(d.min())
            if power:
                d = 2.0**d
            norm = d / d.max()
            values = 1 - norm
            out = np.zeros(mask.shape, dtype=np.float32)
            out[tuple(coords.T)] = values
            new[slc] += out
    return np.nan_to_num(new)


def inverse_dist_score(mask, centroid, scale, log, power):
    """Single-object score (parity shim for labels.py:178-205)."""
    coords = np.argwhere(np.asarray(mask) > 0)
    d = np.linalg.norm((np.asarray(centroid) - coords) * np.asarray(scale),
                       axis=1)
    if log:
        d = np.where(np.abs(d) > 0, np.log(np.where(d > 0, d, 1.0)), d)
        d = d + np.abs(d.min())
    if power:
        d = 2.0**d
    values = 1 - d / d.max()
    return tuple(coords.T.tolist()), values


# ---------------------------------------------------------------------------
# Centre offsets
# ---------------------------------------------------------------------------


def get_centre_offsets(labels, scale):
    """3-channel normalised axial offsets to object centres, background 0.5
    (parity: labels.py:212-275, vectorised)."""
    labels = np.asarray(labels)
    scale = np.asarray(scale, dtype=np.float64)
    m = labels > 0
    m3 = np.stack([m, m, m], axis=0)
    new = np.where(m3, 0.0, 0.5).astype(np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for lab, slc, mask in _iter_objects(labels):
            coords = np.argwhere(mask)
            c = coords.mean(axis=0)
            diffs = (c - coords) * scale  # (n, 3)
            out = np.zeros((3,) + mask.shape, dtype=np.float64)
            for a in range(3):
                d = diffs[:, a]
                dmax, dmin = d.max(), d.min()
                norm = np.where(
                    d > 0, d / dmax, np.where(d < 0, -(d / dmin), 0.0)
                )
                vals = (norm + 1.0) / 2.0
                out[(np.full(len(coords), a),) + tuple(coords.T)] = vals
            s_ = (slice(None),) + slc
            new[s_] += out
    return np.nan_to_num(new)


# ---------------------------------------------------------------------------
# Semantic labels / centroids / smoothing
# ---------------------------------------------------------------------------


def get_semantic_labels(labels, exclude_label_one=False):
    """Foreground mask.

    Deviation (fix): the reference masks ``labels > 1`` (labels.py:284),
    silently excluding object ID 1 from every training mask; the default
    here is ``labels > 0``. Pass ``exclude_label_one=True`` for bug-level
    parity.
    """
    thresh = 1 if exclude_label_one else 0
    return np.where(np.asarray(labels) > thresh, 1.0, 0.0)


def get_gauss_centroids(labels, sigma=1, z=0, device=None):
    """Per-z-plane Gaussian of rounded object centroids, normalised to
    [0, 1] (parity: labels.py:293-309)."""
    labels = np.asarray(labels)
    cents = []
    for lab, slc, mask in _iter_objects(labels):
        coords = np.argwhere(mask)
        c = coords.mean(axis=0) + np.array([s.start for s in slc])
        cents.append(c)
    centroid_image = np.zeros(labels.shape, dtype=float)
    if cents:
        idx = tuple(np.round(np.stack(cents).T).astype(int))
        centroid_image[idx] = 1.0
    out = smooth(centroid_image, z=z, sigma=sigma, device=device)
    out = out - out.min()
    out = out / out.max()
    return out


def smooth(image, z=0, sigma=1, device=None):
    """Per-z-plane 2D Gaussian smoothing on ``device`` (CUDA when None)
    (parity: labels.py:312-321)."""
    image = np.asarray(image, dtype=np.float32)
    sig = [float(sigma)] * image.ndim
    sig[z] = 0.0
    t = torch.from_numpy(image.copy()).to(resolve_device(device))
    return gaussian(t, tuple(sig)).cpu().numpy()


def print_labels_info(channels, out_dir=None, log_name="log.txt"):
    """Human-readable channel summary (parity: labels.py:328-374)."""
    from ..helpers import write_log, LINE

    def _chan_name(chan):
        affinity_match = re.search(r"[xyz]-\d*", chan)
        if affinity_match is not None:
            return f"{affinity_match[0]} affinities"
        return {
            "centreness": "centreness score",
            "centreness-log": "log centreness score",
            "centroid-gauss": "gaussian centroids",
            "mask": "object mask",
        }.get(chan, f"{chan[-1]}-axis centre offsets"
              if chan.startswith("offsets") else "Unknown channel type")

    def _emit(s):
        print(s)
        if out_dir is not None:
            write_log(s, out_dir, log_name)

    print(LINE)
    if isinstance(channels, (list, tuple)):
        _emit(f"Training labels have {len(channels)} output channels: ")
        for i, chan in enumerate(channels):
            _emit(f"Channel {i}: {_chan_name(chan)}")
    if isinstance(channels, dict):
        _emit(f"{len(channels)} sets of training labels were generated:")
        for key, chans in channels.items():
            _emit(f"Training labels entitled {key} has {len(chans)} output "
                  "channels:")
            for i, chan in enumerate(chans):
                _emit(f"Channel {i}: {_chan_name(chan)}")
