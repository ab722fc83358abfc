"""Time the port's orbax checkpoint load on this machine.

    python -m iterseg_tpu_torch.io.orbax_timing DIR [--npz PATH] [--reps N]

``DIR`` is an orbax checkpoint directory, for instance the default U-Net as
the JAX package saves it (``iterseg_tpu.models.convert.
save_checkpoint_orbax``: OCDBT, one zstd frame a parameter, 34 MB). Prints
one JSON line: the card's name and power limit (``nvidia-smi``, when there
is one), the decoder library's build seconds, the seconds of each
``models.convert.load_checkpoint(DIR)`` and of each load of ``--npz``
(default: the bundled ``default_unet.npz``), both read back bit-equal, and
the zstd decoder's rate over every zstd chunk of ``DIR`` (decoded MB a
second, the chunks already in memory).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

from ..engine.predict import DEFAULT_UNET_PATH
from ..models.convert import load_checkpoint
from ..native import zstd
from .ocdbt import OcdbtReader

_ZSTD_MAGIC = bytes.fromhex("28b52ffd")


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _frames(path):
    """Every value of the checkpoint that is a zstd frame: its chunks."""
    with open(os.path.join(path, "_METADATA")) as f:
        ocdbt = json.load(f).get("use_ocdbt", True)
    if ocdbt:
        store = OcdbtReader(path)
        values = [store.read(k) for k in store.list()]
    else:
        values = []
        for d, _, names in os.walk(path):
            for name in names:
                with open(os.path.join(d, name), "rb") as f:
                    values.append(f.read())
    return [v for v in values if v[:4] == _ZSTD_MAGIC]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dir")
    p.add_argument("--npz", default=DEFAULT_UNET_PATH)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    zstd.get_lib()
    build_s = time.perf_counter() - t0
    ref = load_checkpoint(args.npz)
    seconds = {"orbax": [], "npz": []}
    for _ in range(args.reps):
        for name, path in (("orbax", args.dir), ("npz", args.npz)):
            t0 = time.perf_counter()
            got = load_checkpoint(path)
            seconds[name].append(time.perf_counter() - t0)
            if set(got) != set(ref) or any(
                    got[k].tobytes() != ref[k].tobytes() for k in ref):
                raise SystemExit(f"{path} does not read as {args.npz}")
    frames = _frames(args.dir)
    t0 = time.perf_counter()
    decoded = sum(zstd.decompress(frame).size for frame in frames)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "card": _card(), "dir": args.dir, "npz": args.npz,
        "arrays": len(ref), "zstd_build_s": build_s, "load_s": seconds,
        "chunks": len(frames),
        "compressed_bytes": sum(len(f) for f in frames),
        "decoded_bytes": decoded, "decode_s": dt,
        "decode_mb_per_s": decoded / dt / 1e6 if dt else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
