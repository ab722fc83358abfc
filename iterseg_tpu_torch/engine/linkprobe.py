"""Host-to-device link bandwidth probe and the flood crossover it is held
against.

The port of ``iterseg_tpu/engine/linkprobe.py``, for the one decision that
depends on the link: ``device_flood=True`` resolves to the CUDA flood
(``"pallas"``) when the measured link rate is at least
``MEASURED["device_flood_crossover_mbps"]``, else to the exact host flood.
The microbatch size does not depend on the link in the port
(``predict._pick_batch_size``), and no constant measured on a TPU carries
over.

**The crossover**, derived from ``chip_smoke.py``'s ``floods`` phase on its
(33, 512, 512) uint16 volume (NVIDIA H100 80GB HBM3, 700.00 W). Per
pipeline, ``W* = extra bytes / seconds saved``: the extra bytes are what
the ``"pallas"`` path moves over the link beyond the default path (the mask
bits and seeds up and the labels down, less the masked gather: its
indices up and its values down; the DoG pipeline's default path also
downloads the mask bits, which its ``"pallas"`` path keeps on the card),
counted by the pipelines' ``bytes_*`` profile keys, and the seconds saved
are the default
path's ``flood`` + ``gather_*`` less the ``"pallas"`` path's
``device_flood``. Below ``W*`` the extra transfer costs more than the flood
it saves. ``W* = 0`` when the ``"pallas"`` path moves no more bytes, and
infinite when it saves no time. The constant is the largest ``W*`` of the
two pipelines over two calls, rounded up to a whole MB/s:

- affinity: 14,779,546 extra bytes (1,176,882 up, 17,301,504 labels down,
  less the 3,698,840-byte gather), 0.12769 s and 0.11019 s saved, W*
  110.38 and 127.91 MB/s;
- DoG: 14,458,026 extra bytes (24,668 up, 18,493,720 labels down, less
  the 2,904,504-byte gather and the 1,155,858 bytes of mask bits), 0.18332
  s and 0.18190 s saved, W* 75.21 and 75.80 MB/s.

The seconds saved are single host-clock runs (the affinity host flood took
0.108 s in one call and 0.085 s in the other). The card's link measured
27,500 and 27,146 MB/s, so ``True`` is ``"pallas"`` on it. What decides the crossover is the label download, not the mask: the
masks of that volume hold only 2-3% of the grid.

The probe uploads 2 MiB from pinned host memory three times, each fenced by
reading one element back, and reports the median MB/s (MiB/s, as JAX's).
It runs once per device and process, at first use, only on CUDA; on the
CPU there is no link and it returns ``None`` (the pipelines resolve
``True`` to ``"xla"`` there without asking). Tests monkeypatch
:func:`measure_link_mbps`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["MEASURED", "measure_link_mbps", "reset_cache"]

MEASURED = {
    # device_flood=True -> "pallas" at or above this, the host flood below
    "device_flood_crossover_mbps": 128.0,
}

_PROBE_BYTES = 2 * 2 ** 20
_cache: dict = {}  # device -> MB/s, or None where there is no link


def reset_cache():
    _cache.clear()


def measure_link_mbps(device=None, n_runs=3):
    """The median host-to-device rate in MB/s of ``device`` (default: the
    current CUDA device), or ``None`` on the CPU, without CUDA, or when the
    probe fails. Cached per device for the process."""
    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else None
    else:
        device = torch.device(device)
    if device is None or device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device in _cache:
        return _cache[device]
    try:
        buf = torch.full((_PROBE_BYTES,), 7, dtype=torch.uint8,
                         pin_memory=True)
        int(buf.to(device)[:1].item())  # warm: context, allocator
        times = []
        for i in range(n_runs):
            buf[0] = i
            t0 = time.perf_counter()
            x = buf.to(device, non_blocking=True)
            int(x[:1].item())  # fence: the upload's bytes are read back
            times.append(time.perf_counter() - t0)
        mbps = _PROBE_BYTES / float(np.median(times)) / 2 ** 20
        _cache[device] = float(mbps)
    except Exception:
        _cache[device] = None
    return _cache[device]
