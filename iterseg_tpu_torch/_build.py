"""Where the port's compiled libraries go, and how one is built safely.

Libraries are built at first use into ``<checkout>/build/iterseg_tpu_torch``
(``build/`` is git-ignored), or into ``$ITERSEG_TORCH_BUILD_DIR`` when set —
never beside the sources, and never under ``iterseg_tpu/``. A build writes to
a private temporary name and is renamed into place, so concurrent processes
(the test workers) never load a half-written library.
"""
from __future__ import annotations

import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))


def build_dir() -> str:
    d = os.environ.get("ITERSEG_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "iterseg_tpu_torch"
    )
    os.makedirs(d, exist_ok=True)
    return d


def build_library(src: str, stem: str, cmd_prefix) -> str:
    """Compile ``src`` into a shared library named after ``stem`` and the
    hash of the source and command, unless it is already built; returns the
    library's path. ``cmd_prefix`` is the compiler command without the
    source and output arguments. Raises ``CalledProcessError`` or
    ``FileNotFoundError`` when the compiler fails or is missing."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + repr(cmd_prefix).encode())
    lib = os.path.join(build_dir(), f"{stem}-{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(list(cmd_prefix) + [src, "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib
