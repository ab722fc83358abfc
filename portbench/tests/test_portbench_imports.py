"""No module the harness or the reference loads is JAX or the JAX package
(compared by whole top-level names), and the reference loads nothing of
the program."""
import ast
import glob
import os
import subprocess
import sys

from conftest import PORTBENCH

ROOT = os.path.dirname(PORTBENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "iterseg_tpu"}

_HARNESS = """
import sys, glob, os
sys.path[:0] = [{pb!r}, {root!r}]
import torch
from harness import bench, trace, frames, compare, keys
import drivers.segment, drivers.train
import controls
for f in sorted(glob.glob(os.path.join({pb!r}, "metrics", "*.py"))):
    bench.reader(os.path.basename(f)[:-3])
spec, cfg, mix, limits = None, None, None, None
sys.path.insert(0, os.path.join({pb!r}, "tests"))
from conftest import tiny
for cell in ("dog.volume", "unet.stack"):
    spec, cfg, mix, limits = tiny(cell)
    ctx = bench.Context(cell, cfg, mix, 3, [torch.device("cpu")])
    bench.run_cell(ctx, 0.1, False)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REFERENCE = """
import sys
sys.path[:0] = [{pb!r}, {root!r}]
import reference.unet, reference.segment, reference.train, reference.flood
import reference.filters
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code.format(
        pb=PORTBENCH, root=ROOT)], capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split("\n")[-2].split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _top_level(_HARNESS)
    assert "iterseg_tpu_torch" in mods  # the program did run
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level(_REFERENCE)
    assert not mods & (FORBIDDEN | {"iterseg_tpu_torch", "harness"})


def test_no_source_imports_a_forbidden_name():
    for path in glob.glob(os.path.join(PORTBENCH, "**", "*.py"),
                          recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & FORBIDDEN, path
            if os.sep + "reference" + os.sep in path:
                assert "iterseg_tpu_torch" not in tops, path
