"""Checkpoints into the torch U-Net: the function that carries weights across.

The JAX package keeps its parameters as a flat dict whose keys are already
torch ``state_dict`` names (``iterseg_tpu/models/convert.py``), and every
array has the torch layout: conv weights OIDHW, the grouped transpose-conv
weights ``(C, 1, kz, ky, kx)`` — exactly ``nn.ConvTranspose3d(C, C, k,
stride=k, groups=C).weight`` — and BatchNorm running stats per channel. So
``params_from_numpy`` is a 1:1 ``load_state_dict`` with a strict key check;
``num_batches_tracked`` is synthesised, as torch expects it.

A Swin UNETR state dict (MONAI's names, ``models/swin_unetr.py``) is told
from a U-Net's by its keys (``swin_unetr.is_swin_unetr``):
``infer_spec_from_params`` then gives a ``SwinUNETRSpec`` and
``params_from_numpy`` builds a ``SwinUNETR``, loaded as strictly.

Formats: ``.npz`` (native), ``.pt``/``.pth`` (torch state dicts) and orbax
checkpoint directories, read and written by the port's own
``io/orbax_ckpt.py`` (no orbax, tensorstore or JAX needed).
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from ..io.orbax_ckpt import read_orbax, write_orbax
from . import swin_unetr
from .unet import UNet, UNetSpec

__all__ = [
    "params_from_numpy",
    "params_to_numpy",
    "load_checkpoint",
    "save_checkpoint",
    "load_checkpoint_orbax",
    "save_checkpoint_orbax",
    "infer_spec_from_params",
]

_SKIP_SUFFIXES = ("num_batches_tracked",)


def infer_spec_from_params(params):
    """Recover the spec from parameter shapes: a ``SwinUNETRSpec`` for a
    Swin UNETR state dict, else the UNetSpec (forks + channel counts)."""
    if swin_unetr.is_swin_unetr(params):
        return swin_unetr.spec_from_params(params)
    in_channels = params["c0.conv0.weight"].shape[1]
    forks = []
    i = 0
    while f"c8_{i}.conv1.weight" in params:
        forks.append(params[f"c8_{i}.conv1.weight"].shape[0])
        i += 1
    out = tuple(forks) if len(forks) > 1 else forks[0]
    return UNetSpec(in_channels=in_channels, out_channels=out)


def params_from_numpy(params: Mapping[str, np.ndarray], spec=None):
    """A CPU ``UNet`` (a ``SwinUNETR`` for a ``SwinUNETRSpec``) in eval
    mode holding ``params`` (flat numpy arrays under state-dict keys).
    Raises on missing or unexpected keys."""
    spec = spec if spec is not None else infer_spec_from_params(params)
    swin = isinstance(spec, swin_unetr.SwinUNETRSpec)
    net = swin_unetr.SwinUNETR(spec) if swin else UNet(spec)
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
          for k, v in params.items() if not k.endswith(_SKIP_SUFFIXES)}
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(0, dtype=torch.int64))
    net.load_state_dict(sd, strict=True)
    if swin:
        net.check_index()
    return net.eval()


def params_to_numpy(net) -> Dict[str, np.ndarray]:
    """The flat numpy parameter dict of ``net`` (inverse of
    ``params_from_numpy``)."""
    return {k: v.detach().cpu().float().numpy().copy()
            for k, v in net.state_dict().items()
            if not k.endswith(_SKIP_SUFFIXES)}


def load_checkpoint(path) -> Dict[str, np.ndarray]:
    """Flat numpy params from ``.npz``, ``.pt``/``.pth`` or an orbax
    directory."""
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: np.asarray(data[k]) for k in data.files}
    if path.endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.detach().cpu().float().numpy()
                for k, v in sd.items() if not k.endswith(_SKIP_SUFFIXES)}
    if os.path.isdir(path):
        return load_checkpoint_orbax(path)
    raise ValueError(f"unknown checkpoint format: {path}")


def save_checkpoint_orbax(params: Mapping[str, np.ndarray], path) -> str:
    """Save flat params as an orbax checkpoint directory (the layout orbax
    writes with ``use_ocdbt=False``); returns its absolute path."""
    return write_orbax({k: np.asarray(v) for k, v in params.items()}, path)


def load_checkpoint_orbax(path) -> Dict[str, np.ndarray]:
    """Flat numpy params from an orbax checkpoint directory (OCDBT or
    plain). A directory without orbax's ``_METADATA`` raises
    ``ValueError``."""
    return read_orbax(path)


def save_checkpoint(params: Mapping[str, np.ndarray], path) -> str:
    """Save flat params as ``.npz`` (or a torch state dict for ``.pt``)."""
    path = str(path)
    if path.endswith((".pt", ".pth")):
        torch.save(params_from_numpy(params).state_dict(), path)
        return path
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return path
