"""The port stands alone: it imports without JAX, no module of it (nor
chip_smoke.py) imports ``iterseg_tpu``, and its entry points need CUDA
unless the caller names another device."""
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


IMPORT = re.compile(r"^\s*(from|import)\s+(iterseg_tpu|jax)\b(?!_torch)",
                    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_imports(path):
    src = (ROOT / path).read_text()
    assert not IMPORT.findall(src), path


MODULE_LEVEL_IMPORT = re.compile(r"^(from|import)\s+(pandas|PIL)\b",
                                 re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_no_module_level_pandas_or_pil(path):
    """The machine with the card has neither: the port may import them
    only inside a function that is off the paths it drives."""
    src = (ROOT / path).read_text()
    assert not MODULE_LEVEL_IMPORT.findall(src), path


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
