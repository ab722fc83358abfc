"""Chunked U-Net inference.

The port of ``iterseg_tpu/engine/predict.py``: ``UNetModel`` (a loaded
network and its compute dtype), ``load_unet``, ``predict_volume`` and the
microbatch heuristic ``_pick_batch_size``. ``predict_volume`` runs the same
chunked-forward program as the device pipeline
(``device_pipeline.get_feature_program``), so the generic and the fast path
give bit-identical features, hence labels.
"""
from __future__ import annotations

import itertools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.chunks import make_chunks, chunk_slices, process_chunks  # noqa: F401 (API parity re-exports)
from ..device import resolve_device
from ..models.convert import (infer_spec_from_params, load_checkpoint,
                              params_from_numpy)
from ..models.unet import UNetSpec
from ..utils import count

__all__ = [
    "DEFAULT_UNET_PATH",
    "UNetModel",
    "load_unet",
    "predict_volume",
    "predict_chunk_feature_map",
    "get_device",
    "make_chunks",
    "process_chunks",
]

# The JAX package's bundled checkpoint, read in place as a data file.
DEFAULT_UNET_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "iterseg_tpu",
    "data", "default_unet.npz"
)

# activation budget of a CPU forward (the JAX package's constant): the CPU
# has no device memory to query
_CPU_BUDGET = 8 << 30
_MICROBATCH_CAP = 8


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[str(dtype)]


class UNetModel:
    """A loaded network: flat numpy params, their spec (a ``UNetSpec``, or a
    ``SwinUNETRSpec`` for a Swin UNETR checkpoint), the compute dtype, and
    one ``nn.Module`` copy per device."""

    def __init__(self, params, spec=None, compute_dtype=torch.float32):
        self._params = params
        self.spec = spec if spec is not None else infer_spec_from_params(
            params)
        self.compute_dtype = _as_dtype(compute_dtype)
        self._nets = {}

    @property
    def params(self):
        """The flat numpy parameter dict. Assign a new dict to swap weights
        (the per-device module copies are rebuilt)."""
        return self._params

    @params.setter
    def params(self, new_params):
        self._params = new_params
        self._nets = {}

    @property
    def out_channels(self) -> int:
        return self.spec.total_out

    @property
    def chunk_multiples(self):
        """What each chunk axis must be a multiple of (the chunk grid rounds
        its chunks to them)."""
        return self.spec.chunk_multiples

    def activation_bytes(self, chunk) -> int:
        """Activation bytes a chunk of this shape takes in a forward (the
        microbatch budget's unit)."""
        return self.spec.activation_bytes(chunk)

    def module(self, device) -> torch.nn.Module:
        """The network on ``device`` in the compute dtype (eval mode). On
        CUDA its tensors are marked as used by the current stream, which
        may not be the stream that built them (a stack's frames each run on
        their own): the caching allocator then reuses their memory, once
        the network is dropped, only after that stream's work is done."""
        device = torch.device(device)
        key = (str(device), self.compute_dtype)
        if key not in self._nets:
            count("unet_replicas")
            net = params_from_numpy(self._params, self.spec)
            self._nets[key] = net.to(device=device, dtype=self.compute_dtype)
        net = self._nets[key]
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            for t in itertools.chain(net.parameters(), net.buffers()):
                t.record_stream(stream)
        return net

    def __call__(self, x, device=None):
        """NCZYX in, NCZYX float32 tensor out, on ``device``."""
        from ..device import f32_numerics

        dev = resolve_device(device)
        x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        with torch.no_grad(), f32_numerics():
            return self.module(dev)(x.to(self.compute_dtype)).float()


def load_unet(u_state_fn=None, compute_dtype=torch.float32) -> UNetModel:
    """Load a U-Net checkpoint (``.npz``, ``.pt`` or an orbax directory), or
    a Swin UNETR one (a MONAI state dict, told by its keys); ``None`` reads
    the bundled ``iterseg_tpu/data/default_unet.npz``."""
    if u_state_fn is None:
        u_state_fn = DEFAULT_UNET_PATH
        if not os.path.exists(u_state_fn):
            raise FileNotFoundError(
                "No default U-Net checkpoint found at "
                f"{os.path.abspath(u_state_fn)}. Pass an explicit .npz/.pt "
                "path.")
    count("checkpoint_reads")
    return UNetModel(load_checkpoint(str(u_state_fn)),
                     compute_dtype=compute_dtype)


def get_device() -> torch.device:
    """The device the engine runs on by default (parity shim for
    ``predict.py:130-135``): ``resolve_device(None)``, CUDA, raising when
    no card is visible."""
    return resolve_device(None)


def _memory_budget(device) -> int:
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return total // 4
    return _CPU_BUDGET


def _pick_batch_size(n_chunks: int, chunk_shape, out_channels: int,
                     device=None, bytes_per_item=None) -> int:
    """Microbatch size: minimise ``padded_forwards × (1 + 0.7/B)`` (the last
    microbatch is padded to B; ties go to the larger B) under an activation
    budget — a quarter of the card's memory on CUDA, 8 GiB on the CPU — and
    a fixed cap of 8. ``bytes_per_item``: a chunk's activation bytes (the
    model's ``activation_bytes``; by default the U-Net's). The fast and the
    generic path both resolve through this one function, so the forward
    (and its numerics) is the same."""
    if bytes_per_item is None:
        bytes_per_item = UNetSpec().activation_bytes(chunk_shape)
    b_mem = max(1, _memory_budget(device) // max(bytes_per_item, 1))
    b_max = int(min(b_mem, n_chunks, _MICROBATCH_CAP))
    best, best_cost = 1, float("inf")
    for b in range(1, b_max + 1):
        padded = -(-n_chunks // b) * b
        cost = padded * (1.0 + 0.7 / b)
        if cost < best_cost or (cost == best_cost and b > best):
            best, best_cost = b, cost
    return best


def predict_volume(
    model: UNetModel,
    volume: np.ndarray,
    chunk_size: Tuple[int, int, int] = (10, 256, 256),
    margin: Tuple[int, int, int] = (1, 64, 64),
    output_volume: Optional[np.ndarray] = None,
    batch_size: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Run the U-Net over a zyx volume through the overlapping chunk grid;
    returns the (C, z, y, x) float32 feature volume (written into
    ``output_volume`` when given). ``batch_size`` overrides the microbatch
    of the one chunked-forward program (the default resolves it as the
    device pipeline does)."""
    from .device_pipeline import get_feature_program

    dev = resolve_device(device)
    volume = np.asarray(volume, dtype=np.float32)
    if volume.ndim > 3:
        if int(np.prod(volume.shape[:-3])) != 1:
            raise ValueError(
                f"predict_volume expects a zyx volume (or singleton "
                f"leading axes), got shape {volume.shape}")
        volume = volume.reshape(volume.shape[-3:])
    program = get_feature_program(model, volume.shape, chunk_size, margin,
                                  microbatch=batch_size, device=dev)
    out = program(volume, device=dev).cpu().numpy()
    if output_volume is not None:
        output_volume[...] = out
        return output_volume
    return out


def predict_chunk_feature_map(input_volume, sl, unet=False,
                              default_only_mask=False, **kwargs):
    """Per-chunk forward for the generic ``process_chunks`` driver (parity:
    iterseg ``predict.py:100-126``): ``sl`` is a chunk's (frame, z, y, x)
    slice; returns the (1, C, z, y, x) numpy features of ``unet`` (an
    ``UNetModel``, or any callable of an NCZYX batch) on that chunk
    (``process_chunks`` drops the leading axis), and with
    ``default_only_mask`` its entry 3 along the first axis, as JAX does.
    ``device`` in ``kwargs`` names where an ``UNetModel`` runs (CUDA
    unless given)."""
    assert unet is not False, "Please ensure a unet is loaded and supplied"
    sl = sl[1:]
    x = np.asarray(input_volume[sl], dtype=np.float32)[None, None]
    if isinstance(unet, UNetModel):
        predicted = unet(x, device=kwargs.get("device")).cpu().numpy()
    else:
        predicted = np.asarray(unet(x))
    if default_only_mask:
        predicted = predicted[3, ...]
    return predicted
