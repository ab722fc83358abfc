"""The port stands alone: it imports without JAX, no module of it (nor
chip_smoke.py) imports ``iterseg_tpu``, orbax or zstandard, and its entry
points need CUDA unless the caller names another device."""
import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import cpu_subprocess_env

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "iterseg_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))


def test_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import iterseg_tpu_torch as p\n"
        "assert callable(p.affinity_unet_watershed)\n"
        "assert 'affinity-unet-watershed' in p.segmenters\n"
        "assert callable(p.dog_blob_watershed)\n"
        "assert 'DoG-blob-watershed' in p.segmenters\n"
        "assert p.segmenters['DoG-blob-watershed'] is p.dog_blob_watershed\n"
        "for name in ('unet_mask', 'otsu_mask', 'blob_watershed', "
        "'DoGPipeline', 'train_unet', 'run_experiment', "
        "'get_experiment_dict'):\n"
        "    assert callable(getattr(p, name)), name\n"
        f"for name in {JAX_ALL!r}:\n"
        "    assert getattr(p, name) is not None, name\n"
        "assert p.generate_ground_truth is p.ground_truth_from_ROI\n"
        "from iterseg_tpu_torch.cli import main\n"
        "from iterseg_tpu_torch.engine.serve import SegmentationServer\n"
        "from iterseg_tpu_torch.eval.metrics import get_accuracy_metrics\n"
        "bad = [m for m in sys.modules if m == 'iterseg_tpu' or "
        "m.startswith('iterseg_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=cpu_subprocess_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
    assert len(MODULES) > 20


# the JAX package's __all__ (iterseg_tpu/__init__.py), which the port exports
JAX_ALL = [
    "train_from_viewer", "segment_data", "combine_layers",
    "generate_ground_truth", "assess_segmentation", "compare_segmentations",
    "load_data", "save_frames", "ground_truth_from_ROI", "segmenters",
    "affinity_unet_watershed", "dog_blob_watershed", "unet_mask",
    "otsu_mask", "blob_watershed", "load_unet", "predict_volume",
    "UNetModel", "train_unet", "run_experiment", "get_experiment_dict",
    "Viewer",
]


def test_exports_cover_the_jax_all():
    import iterseg_tpu
    import iterseg_tpu_torch

    assert sorted(iterseg_tpu.__all__) == sorted(JAX_ALL)
    assert set(JAX_ALL) <= set(iterseg_tpu_torch.__all__)


IMPORT = re.compile(r"^\s*(from|import)\s+(iterseg_tpu|jax)\b(?!_torch)",
                    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_imports(path):
    src = (ROOT / path).read_text()
    assert not IMPORT.findall(src), path


CHECKPOINT_LIBS = re.compile(
    r"^\s*(from|import)\s+(orbax|zstandard|tensorstore)\b", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_checkpoint_library_imports(path):
    """Orbax checkpoints go through the port's own reader and writer: no
    module imports orbax or zstandard, and tensorstore only in
    ``io/zarr_io.py``, whose volumes fall back to ``io/zarr_mini.py``
    without it."""
    found = {m[1] for m in CHECKPOINT_LIBS.findall((ROOT / path).read_text())}
    allowed = ({"tensorstore"} if path == "iterseg_tpu_torch/io/zarr_io.py"
               else set())
    assert found <= allowed, (path, found)


OFF_CARD = {"pandas", "PIL", "matplotlib", "seaborn", "napari", "magicgui"}


def module_level_imports(src):
    """The top-level packages a module imports when it is imported: every
    import outside a function body (``try`` and ``if`` blocks and class
    bodies included)."""
    found = set()

    def visit(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.Import):
                found.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and not node.level:
                found.add(node.module.split(".")[0])
            for field in ("body", "orelse", "finalbody", "handlers"):
                visit(getattr(node, field, []))

    visit(ast.parse(src).body)
    return found


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_no_module_level_pandas_or_pil(path):
    """The machine with the card has no pandas, PIL, matplotlib, seaborn,
    napari or magicgui: the port imports them only inside a function that
    is off the paths it drives on the card."""
    src = (ROOT / path).read_text()
    assert not module_level_imports(src) & OFF_CARD, path
    assert module_level_imports("try:\n    import napari\nexcept "
                                "ImportError:\n    pass\n") == {"napari"}


def test_default_device_needs_cuda(tmp_path):
    from iterseg_tpu_torch.device import resolve_device
    from iterseg_tpu_torch.engine.segmentation import (
        affinity_unet_watershed, dog_blob_watershed)
    from iterseg_tpu_torch.train.experiments import (get_experiment_dict,
                                                     run_experiment)
    from iterseg_tpu_torch.train.labels import smooth
    from iterseg_tpu_torch.train.train import train_unet
    from iterseg_tpu_torch.train.train_io import get_train_data

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        affinity_unet_watershed(None, np.ones((10, 32, 32), np.uint16),
                                debug=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        dog_blob_watershed(None, np.ones((10, 32, 32), np.uint16),
                           debug=True)
    x = [np.ones((2, 16, 16), np.float32)]
    y = [np.ones((5, 2, 16, 16), np.float32)]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_unet(x, [], y, [], epochs=1)
    exp = get_experiment_dict([("mask",)], ["c"], n_each=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiment(exp, x, [np.ones((2, 16, 16), int)], str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        get_train_data(x, [np.ones((2, 16, 16), int)], None, n_each=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        smooth(np.ones((2, 8, 8)))
    assert not list(tmp_path.iterdir())
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           env=cpu_subprocess_env(), capture_output=True,
                           text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
