"""The port's GUI factory layer (``iterseg_tpu_torch.gui``) and napari
manifest: the option dicts and annotations are the JAX package's, the
factories wrap the port's headless twins (``HeadlessFactory`` without
magicgui), and every manifest command resolves into the port."""
import importlib
import inspect
import os
import subprocess
import sys
import types

import pytest
import yaml

from conftest import cpu_subprocess_env
from iterseg_tpu import gui as jgui
from iterseg_tpu_torch import gui, widgets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDGET_NAMES = sorted(jgui.WIDGET_OPTIONS)


def test_option_and_annotation_dicts_equal_jax():
    assert gui.WIDGET_OPTIONS == jgui.WIDGET_OPTIONS
    assert gui.WIDGET_ANNOTATIONS == jgui.WIDGET_ANNOTATIONS
    assert len(WIDGET_NAMES) == 8


@pytest.mark.parametrize("name", WIDGET_NAMES)
def test_factory_wraps_the_port_twin(name):
    """Every option and annotation key names a parameter of the port's
    twin, and the module-level factory (the same object on each lookup)
    wraps that twin."""
    params = inspect.signature(getattr(widgets, name)).parameters
    for key in list(gui.WIDGET_OPTIONS[name]) + list(
            gui.WIDGET_ANNOTATIONS[name]):
        assert key == "call_button" or key in params, (name, key)
    factory = getattr(gui, name)
    assert factory is getattr(gui, name)
    fn = getattr(factory, "func", None) or factory._function
    assert fn.__wrapped__ is getattr(widgets, name)


def test_headless_factory_call_surface():
    if gui._magic_factory() is not None:
        pytest.skip("magicgui installed: factories are MagicFactory")
    factory = gui.compare_segmentations
    assert isinstance(factory, gui.HeadlessFactory)
    assert factory.keywords == gui.WIDGET_OPTIONS["compare_segmentations"]
    widget = factory()
    assert callable(widget)
    assert widget.__wrapped__ is widgets.compare_segmentations
    assert "magicgui not installed" in repr(factory)
    with pytest.raises(AttributeError):
        gui.not_a_widget


def test_factory_uses_magicgui_when_present(monkeypatch):
    calls = []

    def fake_magic_factory(fn, **options):
        calls.append((fn, options))
        return types.SimpleNamespace(func=fn, keywords=options)

    monkeypatch.setattr(gui, "_magic_factory", lambda: fake_magic_factory)
    factory = gui.get_factory("train_from_viewer")
    (fn, options), = calls
    assert options == gui.WIDGET_OPTIONS["train_from_viewer"]
    assert fn.__wrapped__ is widgets.train_from_viewer
    assert factory.func is fn


def test_annotations_with_stub_napari(monkeypatch):
    napari = types.ModuleType("napari")
    napari.viewer = types.SimpleNamespace(Viewer=type("Viewer", (), {}))
    napari.Viewer = napari.viewer.Viewer
    napari.layers = types.SimpleNamespace(
        Image=type("Image", (), {}), Labels=type("Labels", (), {}),
        Shapes=type("Shapes", (), {}), Layer=type("Layer", (), {}))
    monkeypatch.setitem(sys.modules, "napari", napari)
    sig = inspect.signature(gui._annotated_twin("ground_truth_from_ROI"))
    assert sig.parameters["napari_viewer"].annotation is napari.Viewer
    assert sig.parameters["shapes_layer"].annotation is napari.layers.Shapes
    assert sig.parameters["name"].annotation in (str, "str")


def load_manifest():
    with open(os.path.join(os.path.dirname(gui.__file__), "napari.yaml")) as f:
        return yaml.safe_load(f)


def test_manifest_commands_resolve_into_the_port():
    m = load_manifest()
    with open(os.path.join(ROOT, "iterseg_tpu", "napari.yaml")) as f:
        jm = yaml.safe_load(f)
    assert m["name"] == "iterseg-tpu-torch"
    contributions = m["contributions"]
    suffix = {c["id"].split(".", 1)[1]: c["python_name"]
              for c in contributions["commands"]}
    j_suffix = {c["id"].split(".", 1)[1]: c["python_name"]
                for c in jm["contributions"]["commands"]}
    assert sorted(suffix) == sorted(j_suffix)
    for c in contributions["commands"]:
        assert c["id"].startswith("iterseg-tpu-torch.")
        mod_name, attr = c["python_name"].split(":")
        assert mod_name.startswith("iterseg_tpu_torch.")
        assert callable(getattr(importlib.import_module(mod_name), attr))
    widget_cmds = [w["command"] for w in contributions["widgets"]]
    assert len(widget_cmds) == 7  # combine_layers has no manifest widget
    for cmd in widget_cmds:
        mod_name, attr = suffix[cmd.split(".", 1)[1]].split(":")
        assert mod_name == "iterseg_tpu_torch.gui"
        assert getattr(gui, attr).func.__wrapped__ is getattr(widgets, attr)
    (reader,) = contributions["readers"]
    get_reader = getattr(importlib.import_module(
        suffix["load_ome_zarr"].split(":")[0]), "get_napari_reader")
    assert reader["command"] == "iterseg-tpu-torch.load_ome_zarr"
    assert get_reader("/nonexistent/file.tiff") is None


def test_gui_imports_no_gui_package():
    """Importing the GUI layer imports neither magicgui nor napari; a
    factory lookup asks for magicgui then."""
    code = """
import sys
import iterseg_tpu_torch.gui as gui, iterseg_tpu_torch.viewer as v
assert 'magicgui' not in sys.modules and 'napari' not in sys.modules
sys.modules['magicgui'] = None
assert isinstance(gui.load_data, gui.HeadlessFactory)
assert not v.is_image_layer(object())
print('ok')
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=cpu_subprocess_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
