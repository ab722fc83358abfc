"""The port's DoGPipeline and dog_blob_watershed against the JAX package, on
the CPU, at (10, 48, 48) and (12, 48, 48).

- ``DoGPipeline().segment``: bit-equal to JAX's run op by op
  (``jax.disable_jit``); against jitted JAX the agreement is recorded.
- Given JAX's device outputs, ``_finalize`` is bit-equal to JAX's.
- The fast path equals the host path (``use_device_pipeline=False``), and
  the overflow, no-native and non-convergence paths stay exact (the last
  in the affinity pipeline too).
- ``device_flood="pallas"`` keeps the default run's support and id set, at
  agreement > 0.9, also on a wide-X volume where JAX's Pallas kernel would
  reroute (the port never does). ``"xla"`` is bit-equal to JAX's ``"xla"``
  given the same device outputs; ``"exact"`` is bit-equal to the default
  flood on its tie-density, unresolved and sqrt-collision paths.
- Entry point: 3D and 4D, integer wire, ``save_dir`` loaded by JAX's
  ``load_ome_zarr``, warm restart; the registry; the trio with the JSON
  configs in ``examples/config_files``.
"""
import pathlib
import warnings

import jax
import numpy as np
import pytest
import torch

from iterseg_tpu.engine import device_pipeline as jdp
from iterseg_tpu.io.zarr_io import load_ome_zarr
from iterseg_tpu_torch import native
from iterseg_tpu_torch.core.volume import prepare_volume
from iterseg_tpu_torch.engine import device_pipeline as tdp
from iterseg_tpu_torch.engine import segmentation as tseg
from iterseg_tpu_torch.ops import image_flood_kernel as ifk

from test_device_pipeline import blob_volume
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
    "config_files"


def host_path(vol, **kw):
    out = np.zeros(tuple(s + 2 for s in vol.shape), np.int32)
    tseg.dog_blob_watershed_for_chunks(vol, out, None, None, 1, 1.5, 0.02,
                                       use_device_pipeline=False,
                                       devices=[CPU], **kw)
    return out


@pytest.fixture(scope="module")
def vol():
    return blob_volume(shape=(10, 48, 48), n=14, seed=21)


@pytest.fixture(scope="module")
def labels(vol):
    return tdp.DoGPipeline(device=CPU).segment(vol)


def test_segment_equals_jax(vol, labels, record_property):
    with jax.disable_jit():
        want = np.asarray(jdp.DoGPipeline().segment(vol))
    assert labels.shape == want.shape == tuple(s + 2 for s in vol.shape)
    assert labels.max() > 5
    np.testing.assert_array_equal(labels, want)
    jitted = np.asarray(jdp.DoGPipeline().segment(vol))
    sel = jitted > 0
    record_property("agreement_vs_jit", float((labels[sel] ==
                                               jitted[sel]).mean()))


def test_finalize_equals_jax():
    v = blob_volume(shape=(12, 48, 48), n=16, seed=31)
    jpipe = jdp.DoGPipeline()
    outs = jpipe._device_outputs(v)
    want = np.asarray(jpipe._finalize(v.shape, outs))
    got = tdp.DoGPipeline(device=CPU)._finalize(
        v.shape, tuple(torch.from_numpy(np.array(o)) for o in outs))
    assert want.max() > 5
    np.testing.assert_array_equal(got, want)


def test_fast_path_equals_host_path(vol, labels):
    np.testing.assert_array_equal(labels, host_path(vol))
    out = np.full(labels.shape, -1, np.int32)
    tseg.dog_blob_watershed_for_chunks(vol, out, None, None, 1, 1.5, 0.02,
                                       devices=[CPU])
    np.testing.assert_array_equal(out, labels)


def test_integer_wire_equals_float_path(vol):
    u16 = np.round(vol * 65535.0).astype(np.uint16)
    want = tdp.DoGPipeline(device=CPU).segment(
        prepare_volume(u16.astype(np.float32)))
    got = tdp.DoGPipeline(device=CPU).segment(u16, normalize=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host_path(u16, device_normalize=True),
                                  want)


def test_pallas_flood_keeps_support_and_ids(vol, labels, record_property):
    tdp.reset_flood_fallbacks()
    before = ifk.launches()
    prof = {}
    got = tdp.DoGPipeline(device_flood="pallas", device=CPU).segment(
        vol, profile=prof)
    assert ifk.launches() == before  # CPU tensors take the plain version
    assert tdp.flood_fallbacks() == 0
    assert "device_flood" in prof and prof["flood_launches"] > 1
    assert "flood" not in prof and "gather_distance" not in prof
    np.testing.assert_array_equal(got > 0, labels > 0)
    assert set(np.unique(got)) == set(np.unique(labels))
    sel = labels > 0
    agreement = float((got[sel] == labels[sel]).mean())
    record_property("agreement", agreement)
    assert agreement > 0.9


def test_wide_x_runs_the_image_flood_without_reroute(monkeypatch):
    """JAX reroutes a padded X of ~510 or more to its XLA recurrence with a
    RuntimeWarning (``pallas_flood.fits_vmem``); the CUDA kernel tiles x,
    so the port runs it at every width."""
    r = np.random.default_rng(42)
    shape = (6, 16, 640)
    v = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(2, s - 2, size=12) for s in shape], 1)
    v[tuple(pts.T)] = 1.0
    from scipy import ndimage as ndi

    v = ndi.gaussian_filter(v, (1, 2, 2))
    v /= v.max()
    calls = []
    real = ifk.image_flood

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(ifk, "image_flood", counted)
    host = tdp.DoGPipeline(device=CPU).segment(v)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dev = tdp.DoGPipeline(device_flood="pallas", device=CPU).segment(v)
    assert calls == [(8, 18, 642)]
    np.testing.assert_array_equal(dev > 0, host > 0)
    assert set(np.unique(dev)) == set(np.unique(host))


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["affinity", "dog"])
def test_non_convergence_takes_the_exact_host_flood(vol, labels, kind, mode,
                                                    monkeypatch):
    """A device flood cut short by the one step cap (the CUDA kernels'
    plain versions on the CPU, and the torch recurrences) counts one
    fallback and hands over to the exact host flood: the default labels,
    in both pipelines."""
    if kind == "dog":
        def make(**kw):
            return tdp.DoGPipeline(device=CPU, **kw)
        want = labels
    else:
        from iterseg_tpu_torch.engine.predict import load_unet

        model = load_unet(None)

        def make(**kw):
            return tdp.AffinityPipeline(model, (10, 48, 48), (1, 8, 8),
                                        device=CPU, **kw)
        want = make().segment(vol)
        assert want.max() > 1
    monkeypatch.setattr(tdp, "_FLOOD_MAX_STEPS", 2)
    tdp.reset_flood_fallbacks()
    prof = {}
    got = make(device_flood=mode).segment(vol, profile=prof)
    assert tdp.flood_fallbacks() == 1 and prof["flood_fallback"]
    np.testing.assert_array_equal(got, want)
    tdp.reset_flood_fallbacks()


def test_candidate_overflow_exact(vol, labels):
    tiny = tdp.DoGPipeline(cand_capacity=8, device=CPU)
    np.testing.assert_array_equal(tiny.segment(vol), labels)


def test_no_native_fallback_exact(vol, labels, monkeypatch):
    monkeypatch.setenv("ITERSEG_TORCH_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    np.testing.assert_array_equal(tdp.DoGPipeline(device=CPU).segment(vol),
                                  labels)


def test_heap_past_the_bucket_key_bound(vol, labels, monkeypatch):
    monkeypatch.setattr(native, "BUCKET_FLOOD_MAX_KEY", 1)
    np.testing.assert_array_equal(tdp.DoGPipeline(device=CPU).segment(vol),
                                  labels)


def test_stack_integer_wire_and_warm_restart(tmp_path):
    frames = [np.round(blob_volume(shape=(10, 48, 48), n=12, seed=s)
                       * 65535.0).astype(np.uint16) for s in (61, 62)]
    stack = np.stack(frames)
    out = tseg.dog_blob_watershed(None, stack, str(tmp_path), "s4",
                                  devices=[CPU])
    (data, meta, kind), = load_ome_zarr(tmp_path / "s4.ome.zarr")
    assert kind == "labels"
    data = np.asarray(data)
    np.testing.assert_array_equal(data, np.asarray(out))
    for t, f in enumerate(frames):
        ref = tdp.DoGPipeline(device=CPU).segment(
            prepare_volume(f.astype(np.float32)))
        np.testing.assert_array_equal(data[t], ref[1:-1, 1:-1, 1:-1])
    pipe = tdp.DoGPipeline(device=CPU)
    before = data.copy()
    assert list(pipe.segment_stack(stack, data)) == []
    np.testing.assert_array_equal(data, before)


def test_entry_point_3d_and_registry(vol, labels, tmp_path):
    assert tseg.segmenters["DoG-blob-watershed"] is tseg.dog_blob_watershed
    got = tseg.segmenters["DoG-blob-watershed"](
        None, vol, None, "d3", None, debug=True, devices=[CPU],
        flood_telemetry=True)
    np.testing.assert_array_equal(got, labels[1:-1, 1:-1, 1:-1])
    cfg = CONFIGS / "dog-blob-watershed-config.json"
    pal = tseg.dog_blob_watershed(None, vol, None, "d3", str(cfg),
                                  debug=True, devices=[CPU],
                                  device_flood="pallas")
    np.testing.assert_array_equal(pal > 0, got > 0)


def test_prep_config_honours_falsy_values(tmp_path):
    cfg = tmp_path / "dog.json"
    cfg.write_text('{"threshold": 0, "min_sigma": null, '
                   '"device_flood": "pallas"}')
    prep = tseg.dog_blob_watershed_prep_config(None, str(cfg), None)
    assert prep["threshold"] == 0 and prep["min_sigma"] == 1
    assert prep["device_flood"] == "pallas" and prep["max_sigma"] == 1.5


@pytest.mark.parametrize("name", ["otsu_mask", "blob_watershed", "unet_mask"])
def test_trio_runs_with_example_configs(name):
    cfg = {"otsu_mask": "otsu-mask-config.json",
           "blob_watershed": "blob-watershed-config.json",
           "unet_mask": "unet-mask-config.json"}[name]
    v = blob_volume(shape=(8, 32, 32), n=8, seed=5)
    kw = {"chunk_size": (8, 32, 32), "margin": (1, 4, 4)} if \
        name == "unet_mask" else {}
    out = getattr(tseg, name)(None, v, None, name, str(CONFIGS / cfg),
                              debug=True, devices=[CPU], **kw)
    out = np.asarray(out)
    assert out.shape == v.shape and out.max() >= 1


def test_unsupported_modes_raise():
    """Only an unknown mode still raises; every flood mode builds, and
    several devices round-robin a stack's frames with the labels of one
    device."""
    want = {True: "xla", "xla": "xla", "exact": "exact", "pallas": "pallas",
            False: False}
    for mode, resolved in want.items():
        assert tdp.DoGPipeline(device_flood=mode,
                               device=CPU).device_flood == resolved
    with pytest.raises(ValueError):
        tdp.DoGPipeline(device_flood="cuda", device=CPU)
    stack = np.stack([blob_volume(shape=(10, 32, 32), n=6, seed=s)
                      for s in (1, 2)])
    one = tseg.dog_blob_watershed(None, stack, debug=True, devices=[CPU])
    two = tseg.dog_blob_watershed(None, stack, debug=True,
                                  devices=[CPU, CPU])
    assert np.asarray(one).max() > 0
    np.testing.assert_array_equal(np.asarray(two), np.asarray(one))


def test_xla_finalize_equals_jax():
    """``"xla"`` is JAX's hop-tie recurrence on ``-sqrt(d²)``: bit-equal to
    JAX's ``"xla"`` given the same device outputs."""
    v = blob_volume(shape=(12, 48, 48), n=16, seed=31)
    jpipe = jdp.DoGPipeline(device_flood="xla")
    outs = jpipe._device_outputs(v)
    want = np.asarray(jpipe._finalize(v.shape, outs))
    prof = {}
    got = tdp.DoGPipeline(device_flood="xla", device=CPU)._finalize(
        v.shape, tuple(torch.from_numpy(np.array(o)) for o in outs),
        profile=prof)
    assert want.max() > 5 and prof["flood_iters"] % 8 == 0
    np.testing.assert_array_equal(got, want)
    host = tdp.DoGPipeline(device=CPU)._finalize(
        v.shape, tuple(torch.from_numpy(np.array(o)) for o in outs))
    np.testing.assert_array_equal(got > 0, host > 0)


@pytest.mark.parametrize("patch,path", [
    ({}, "fallback:tie-density"),
    ({"TIE_PROBE_DEFAULT": 1.0}, "certified"),
    ({"TIE_PROBE_DEFAULT": 1.0, "BUCKET_FLOOD_MAX_KEY": 1},
     "fallback:sqrt-collision"),
], ids=["tie_density", "certified", "sqrt_collision"])
def test_exact_equals_default(vol, labels, monkeypatch, patch, path):
    """``"exact"`` is bit-equal to the default host flood on each of its
    DoG paths: the in-program tie probe (EDT landscapes are tie-heavy), the
    certificate with the probe off (it certifies this volume), and the
    ``-d²`` key past the collision bound (the bound lowered; the host flood
    then takes the heap, which is exact there too)."""
    from iterseg_tpu_torch.ops import flood_exact as tfe

    for name, value in patch.items():
        monkeypatch.setattr(native if name.startswith("BUCKET") else tfe,
                            name, value)
    prof = {}
    out = np.full(labels.shape, -1, np.int32)
    got = tdp.DoGPipeline(device_flood="exact", device=CPU).segment(
        vol, out=out, profile=prof)
    np.testing.assert_array_equal(got, labels)
    np.testing.assert_array_equal(out, labels)
    assert prof["flood_exact_path"] == path
    assert prof["flood_tie_frac_scope"] == "filtered"
    fallback = path.startswith("fallback")
    assert ("flood" in prof) is ("gather_distance" in prof) is fallback
    assert ("download_labels" in prof) is (not fallback)
    assert ("flood_uncertain_frac" in prof) is (path != "fallback:tie-density")


def test_exact_stack_and_registry(tmp_path):
    """The stack path and the segmenter honour ``"exact"`` per frame, and a
    JSON config carries it."""
    stack = np.stack([blob_volume(shape=(10, 40, 40), n=10, seed=s)
                      for s in (55, 56)])
    ref = np.zeros((2,) + stack.shape[1:], np.int32)
    got = np.zeros_like(ref)
    list(tdp.DoGPipeline(device=CPU).segment_stack(stack, ref,
                                                   skip_labelled=False))
    list(tdp.DoGPipeline(device_flood="exact", device=CPU).segment_stack(
        stack, got, skip_labelled=False))
    np.testing.assert_array_equal(got, ref)
    cfg = tmp_path / "dog.json"
    cfg.write_text('{"device_flood": "exact"}')
    out = tseg.dog_blob_watershed(None, stack[0], None, "x", str(cfg),
                                  debug=True, devices=[CPU])
    np.testing.assert_array_equal(np.asarray(out), ref[0])
