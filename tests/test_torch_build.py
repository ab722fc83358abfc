"""The port's build cache: a library is named by a digest of the compiler
command, the source and every local header the source includes, so an
edit to a shared header (``csrc/flood_schedule.cuh``) rebuilds every
library that includes it. No compiler is needed: a stand-in writes the
output file."""
import os
import sys

from iterseg_tpu_torch import _build

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "iterseg_tpu_torch", "csrc")


def write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_digest_covers_included_headers(tmp_path):
    (tmp_path / "sub").mkdir()
    src, hdr, nested = (str(tmp_path / "k.cu"), str(tmp_path / "a.cuh"),
                        str(tmp_path / "sub" / "b.cuh"))
    write(src, '#include "a.cuh"\n#include <cuda_runtime.h>\nint f();\n')
    write(hdr, '#pragma once\n#include "sub/b.cuh"\n#include "a.cuh"\n')
    write(nested, "// v1\n")
    assert _build.source_files(src) == [src, hdr, nested]
    before = _build.digest(src, ["nvcc", "-O3"])
    assert _build.digest(src, ["nvcc", "-O3"]) == before
    write(nested, "// v2\n")
    after = _build.digest(src, ["nvcc", "-O3"])
    assert after != before
    assert _build.digest(src, ["nvcc", "-O2"]) != after


def test_both_floods_hash_the_schedule_header():
    header = os.path.join(CSRC, "flood_schedule.cuh")
    for name in ("affinity_flood.cu", "image_flood.cu"):
        files = _build.source_files(os.path.join(CSRC, name))
        assert files == [os.path.join(CSRC, name), header]


def test_header_edit_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setenv("ITERSEG_TORCH_BUILD_DIR", str(tmp_path / "build"))
    fake = str(tmp_path / "cc.py")  # writes the file named after -o
    write(fake, "import sys\nopen(sys.argv[sys.argv.index('-o') + 1], 'w')"
                ".write('lib')\n")
    src, hdr = str(tmp_path / "k.cu"), str(tmp_path / "s.cuh")
    write(src, '#include "s.cuh"\n')
    write(hdr, "// v1\n")
    cmd = [sys.executable, fake]
    first = _build.build_library(src, "k", cmd)
    assert os.path.exists(first)
    assert _build.build_library(src, "k", cmd) == first
    write(hdr, "// v2\n")
    second = _build.build_library(src, "k", cmd)
    assert second != first and os.path.exists(second)


def test_package_data_ships_every_local_include():
    """An installed port builds its kernels only if every file a ``.cu``
    includes by a local ``#include "..."`` ships as package data."""
    import fnmatch
    import re
    import tomllib

    root = os.path.dirname(os.path.dirname(CSRC))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "iterseg_tpu_torch"]
    included = set()
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as f:
            for inc in re.findall(r'#include\s+"([^"]+)"', f.read()):
                included.add("csrc/" + inc)
    assert "csrc/flood_schedule.cuh" in included
    for path in sorted(included | {"csrc/" + n for n in os.listdir(CSRC)}):
        assert any(fnmatch.fnmatch(path, g) for g in globs), path
