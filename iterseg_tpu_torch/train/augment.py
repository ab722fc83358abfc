"""Random intensity + geometric augmentation.

Distribution-level parity with iterseg ``augment.py`` (bit parity is
impossible across RNGs — SURVEY.md §7.3): with probability 0.9 an intensity
transform (truncated-normal scale/shift, 30% chance of one of
gaussian/localvar/poisson/speckle noise, else clip to [0,1]) plus, with
probability 0.2 each, a mirror and/or a y↔x transpose of the last two axes,
applied identically to image, every label set and the ground truth.

Host-side numpy (training-data generation is offline); a seeded
``numpy.random.Generator`` may be injected for reproducible pipelines.
"""
from __future__ import annotations

from itertools import permutations

import numpy as np

__all__ = [
    "augment_images",
    "augment_intensity",
    "augment_order",
    "continuous_choice",
    "random_noise",
]


def _rng(rng=None):
    return np.random if rng is None else rng


def continuous_choice(min_, max_, sigma, loc=0.0, size=1, rng=None):
    """Rejection-sampled truncated normal (parity: augment.py:170-185)."""
    r = _rng(rng)
    while True:
        out = r.normal(loc=loc, scale=sigma, size=size)
        val = out if size == 1 else out.mean()
        if min_ <= val <= max_:
            return out


def random_noise(image, mode="gaussian", var=0.01, rng=None):
    """skimage.util.random_noise-equivalent noise injection, clipped to
    [0, 1] (the modes the reference samples, augment.py:57-65)."""
    r = _rng(rng)
    image = np.asarray(image, dtype=np.float64)
    if mode == "gaussian":
        out = image + r.normal(0, var**0.5, image.shape)
    elif mode == "speckle":
        out = image + image * r.normal(0, var**0.5, image.shape)
    elif mode == "localvar":
        # per-pixel variance from a local intensity estimate
        local_var = np.clip(image, 1e-4, None) * var
        out = image + r.normal(0, 1.0, image.shape) * np.sqrt(local_var)
    elif mode == "poisson":
        vals = 2 ** np.ceil(np.log2(max(len(np.unique(image)), 2)))
        out = r.poisson(np.clip(image, 0, None) * vals) / float(vals)
    else:
        raise ValueError(f"unknown noise mode {mode}")
    return np.clip(out, 0.0, 1.0)


def augment_intensity(
    image,
    min_shift=-0.1,
    max_shift=0.1,
    min_scale=0.8,
    max_scale=1.2,
    shift_sigma=0.02,
    scale_sigma=0.05,
    noise_prob=0.3,
    verbose=False,
    rng=None,
):
    """Intensity scale/shift + optional noise (parity: augment.py:35-72)."""
    r = _rng(rng)
    image = np.asarray(image)
    out = image.copy() / image.max()
    scale = continuous_choice(min_scale, max_scale, scale_sigma, loc=1.0,
                              rng=rng)
    shift = continuous_choice(min_shift, max_shift, shift_sigma, rng=rng)
    out = (out * scale) + shift
    add_noise = r.binomial(1, noise_prob)
    if add_noise:
        options = ["gaussian", "localvar", "poisson", "speckle", "gaussian",
                   "speckle"]
        mode = options[int(r.randint(len(options)) if rng is None
                           else r.integers(len(options)))]
        kwargs = {}
        if mode in ("gaussian", "speckle"):
            kwargs["var"] = 0.001
        if verbose:
            print(f"adding {mode} noise")
        out = random_noise(out, mode=mode, rng=rng, **kwargs)
    else:
        out = np.clip(out, 0.0, 1.0)
    return out


def augment_order(images, mirror_prob=0.2, transpose_prob=0.2,
                  used_axes=(-2, -1), verbose=False, rng=None):
    """Random mirror/transpose of the trailing axes, applied to every array
    identically (parity: augment.py:75-118)."""
    r = _rng(rng)
    out = [np.array(img) for img in images]
    mirror = r.binomial(1, mirror_prob)
    if mirror:
        i = int(r.randint(0, len(used_axes)) if rng is None
                else r.integers(0, len(used_axes)))
        axis = used_axes[i]
        if verbose:
            print("mirroring along ", axis)
        out = [np.flip(img, axis=axis) for img in out]
    transpose = r.binomial(1, transpose_prob)
    if transpose:
        ps = [p for p in permutations(used_axes) if p != tuple(used_axes)]
        idx = int(r.randint(0, len(ps)) if rng is None
                  else r.integers(0, len(ps)))
        p = ps[idx]
        new_out = []
        for image in out:
            axes = list(range(image.ndim))
            for i, ax in enumerate(used_axes):
                na = p[i]
                if na < 0:
                    na = len(axes) + na
                axes[ax] = na
            if verbose:
                print("transposing to: ", axes)
            new_out.append(np.transpose(image, axes))
        out = new_out
    return out


def augment_images(image, labels, ground_truth=None, augment_prob=0.9,
                   rng=None):
    """Jointly augment image + label dict/array (+ optional GT)
    (parity: augment.py:8-32)."""
    r = _rng(rng)
    augment = r.binomial(1, augment_prob)
    if augment:
        image = augment_intensity(image, rng=rng)
    imgs = [image]
    if isinstance(labels, dict):
        for key in labels.keys():
            imgs.append(labels[key])
    else:
        imgs.append(labels)
    if ground_truth is not None:
        imgs.append(ground_truth)
    if augment:
        imgs = augment_order(imgs, rng=rng)
    result = [imgs[0]]
    if isinstance(labels, dict):
        keys = list(labels.keys())
        labs = {key: imgs[i + 1] for i, key in enumerate(keys)}
    else:
        labs = imgs[1]
    result.append(labs)
    if ground_truth is not None:
        result.append(imgs[-1])
    return tuple(result)
