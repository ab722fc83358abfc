"""Device selection and the numerics context of the f32 path.

Every entry point of the port runs on CUDA unless the caller names another
device: ``resolve_device(None)`` is ``cuda`` and raises when no card is
visible, so a missing GPU is an error and never a silent CPU run. The CPU
is used only when asked for (``torch.device("cpu")``), as the tests do.

``f32_numerics()`` pins the settings the f32 forward depends on: TF32 off
for cuDNN convolutions and matmuls (torch enables it for cuDNN by default,
which keeps ~3 decimal digits and breaks the 5e-4 forward bound against the
JAX reference), deterministic cuDNN algorithms, and no autotuning (the
autotuner may choose different algorithms for the fast and the generic path,
which would break their bit-identity).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "f32_numerics"]


def resolve_device(device=None) -> torch.device:
    """The device a port entry point runs on: ``device`` if given, else
    CUDA. Raises ``RuntimeError`` when CUDA is needed but unavailable."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "iterseg_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device=torch.device('cpu') to run on the CPU"
        )
    return device


@contextlib.contextmanager
def f32_numerics():
    """TF32 off, deterministic cuDNN, no benchmark autotuning; restores the
    previous settings on exit."""
    saved = (
        torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.deterministic,
        torch.backends.cudnn.benchmark,
    )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved
