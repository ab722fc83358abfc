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
import re
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))


def build_dir() -> str:
    d = os.environ.get("ITERSEG_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "iterseg_tpu_torch"
    )
    os.makedirs(d, exist_ok=True)
    return d


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(src: str):
    """``src`` and every header it includes with ``#include "..."``,
    directly or through another header, resolved beside the including file
    (as the compiler resolves them); each once, ``src`` first. A name not
    found there (a header on the compiler's own path) is left out."""
    files, todo = [], [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in files or not os.path.exists(path):
            continue
        files.append(path)
        with open(path, "rb") as f:
            text = f.read()
        here = os.path.dirname(path)
        todo += [os.path.abspath(os.path.join(here, name.decode()))
                 for name in _LOCAL_INCLUDE.findall(text)]
    return files


def digest(src: str, cmd_prefix) -> str:
    """Hash of the command, ``src`` and the local headers it includes: an
    edit to any of them names a new library, so it is rebuilt."""
    h = hashlib.sha256(repr(cmd_prefix).encode())
    for path in source_files(src):
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build_library(src: str, stem: str, cmd_prefix) -> str:
    """Compile ``src`` into a shared library named after ``stem`` and the
    ``digest`` of the command, the source and its local headers, unless it
    is already built; returns the library's path. ``cmd_prefix`` is the
    compiler command without the source and output arguments. Raises
    ``CalledProcessError`` or ``FileNotFoundError`` when the compiler fails
    or is missing."""
    name = f"{stem}-{digest(src, cmd_prefix)[:12]}.so"
    lib = os.path.join(build_dir(), name)
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
