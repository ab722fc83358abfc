"""Headless viewer/layer model.

The port's copy of ``iterseg_tpu/viewer.py``. The reference is a napari
plugin; the port runs on headless GPU hosts, so it ships a minimal
layer/viewer data model with the napari attribute surface the engine touches
(``.data``, ``.scale``, ``.translate``, ``.metadata``,
``add_image``/``add_labels``/...).  When napari is importable, real napari
objects pass through untouched and all ``isinstance``-style checks accept
both; napari is imported on the first such check, never with this module.
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "Layer",
    "Image",
    "Labels",
    "Shapes",
    "Points",
    "Viewer",
    "is_image_layer",
    "is_labels_layer",
    "is_shapes_layer",
    "is_points_layer",
    "as_layer_types",
]

@functools.cache
def _napari_module():
    """The napari package, or None where it is not installed."""
    try:
        import napari
    except ImportError:
        return None
    return napari


class Layer:
    _kind = "layer"

    def __init__(self, data, name="layer", scale=None, translate=None,
                 metadata=None):
        self.data = data
        self.name = name
        ndim = getattr(data, "ndim", None)
        if ndim is None and isinstance(data, (list, tuple)) and len(data):
            ndim = np.asarray(data[0]).ndim
        ndim = ndim or 3
        self.scale = np.asarray(
            scale if scale is not None else np.ones(ndim)
        )
        self.translate = np.asarray(
            translate if translate is not None else np.zeros(ndim)
        )
        self.metadata = dict(metadata or {})

    @property
    def ndim(self):
        return getattr(self.data, "ndim", len(self.scale))

    def __repr__(self):
        shape = getattr(self.data, "shape", None)
        return f"<{type(self).__name__} {self.name!r} shape={shape}>"


class Image(Layer):
    _kind = "image"


class Labels(Layer):
    _kind = "labels"


class Shapes(Layer):
    _kind = "shapes"


class Points(Layer):
    _kind = "points"


def _is_kind(layer, kind, napari_name):
    if isinstance(layer, Layer):
        return layer._kind == kind
    napari = _napari_module()
    if napari is not None:
        return isinstance(layer, getattr(napari.layers, napari_name))
    return False


def is_image_layer(layer):
    return _is_kind(layer, "image", "Image")


def is_labels_layer(layer):
    return _is_kind(layer, "labels", "Labels")


def is_shapes_layer(layer):
    return _is_kind(layer, "shapes", "Shapes")


def is_points_layer(layer):
    return _is_kind(layer, "points", "Points")


class _LayerList(list):
    def __getitem__(self, key):
        if isinstance(key, str):
            for l in self:
                if l.name == key:
                    return l
            raise KeyError(key)
        return super().__getitem__(key)

    def __delitem__(self, key):
        if isinstance(key, str):
            for i, l in enumerate(self):
                if l.name == key:
                    return super().__delitem__(i)
            raise KeyError(key)
        return super().__delitem__(key)


class Viewer:
    """Headless stand-in for ``napari.Viewer`` (records layers)."""

    def __init__(self):
        self.layers = _LayerList()
        self.dims = type("dims", (), {"current_step": (0, 0, 0, 0)})()

    def _add(self, cls, data, name=None, scale=None, translate=None,
             metadata=None, **kwargs):
        layer = cls(data, name=name or cls.__name__.lower(), scale=scale,
                    translate=translate, metadata=metadata)
        self.layers.append(layer)
        return layer

    def add_image(self, data, **kwargs):
        return self._add(Image, data, **kwargs)

    def add_labels(self, data, **kwargs):
        return self._add(Labels, data, **kwargs)

    def add_shapes(self, data, **kwargs):
        return self._add(Shapes, data, **kwargs)

    def add_points(self, data, **kwargs):
        return self._add(Points, data, **kwargs)


def as_layer_types():
    """(Image, Labels, Shapes, Points) — napari types when available."""
    napari = _napari_module()
    if napari is not None:
        return (napari.layers.Image, napari.layers.Labels,
                napari.layers.Shapes, napari.layers.Points)
    return (Image, Labels, Shapes, Points)
