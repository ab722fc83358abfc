"""The port's AffinityPipeline and affinity_unet_watershed against the JAX
package, on the CPU, at (10, 96, 96) with chunk (10, 64, 64) and margin
(1, 16, 16): two chunks in y and two in x, so the y/x reassembly runs.

- Features: within the 5e-4 forward bound of JAX ``predict_volume``.
- Fast path (``AffinityPipeline.segment``) == generic path
  (``predict_volume`` + ``segment_output_image``), bit for bit.
- Given JAX's device outputs, ``_finalize`` labels are bit-equal to JAX's.
- ``device_flood="pallas"`` keeps the default run's label support and ids;
  ``"xla"`` is bit-equal to JAX's ``"xla"``, with telemetry counts equal to
  JAX's; ``"exact"`` is bit-equal to the default flood on every path
  (certified, repaired, both tie-probe exits, unresolved with and without
  the speculative host flood, the repair-doom exit) and through ``out=``.
- Entry point: 3D volume and 4D stack with ``save_dir``, warm restart.
End-to-end labels built from the two frameworks' forwards are reported as
an agreement fraction, not asserted equal.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from iterseg_tpu.core.volume import prepare_volume
from iterseg_tpu.engine import device_pipeline as jdp
from iterseg_tpu.engine.predict import _pick_batch_size as jax_pick
from iterseg_tpu.engine.predict import load_unet as jax_load_unet
from iterseg_tpu.engine.predict import predict_volume as jax_predict
from iterseg_tpu.io.zarr_io import load_ome_zarr
from iterseg_tpu.ops import watershed as jw
from iterseg_tpu_torch.core.chunks import make_chunks
from iterseg_tpu_torch.engine import device_pipeline as tdp
from iterseg_tpu_torch.engine.predict import _pick_batch_size, load_unet
from iterseg_tpu_torch.engine.predict import predict_volume
from iterseg_tpu_torch.engine.segmentation import (
    affinity_unet_watershed,
    affinity_watershed_prep_config,
)
from iterseg_tpu_torch.ops import flood_kernel as fk
from iterseg_tpu_torch.ops import watershed as tw
import test_flood_exact
from torch_threads import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
CHUNK, MARGIN = (10, 64, 64), (1, 16, 16)
SHAPE = (10, 96, 96)


def blob_stack(n_frames=1, seed=0):
    r = np.random.default_rng(seed)
    frames = []
    for _ in range(n_frames):
        vol = np.zeros(SHAPE, np.float32)
        pts = np.stack([r.integers(1, s - 1, size=30) for s in SHAPE], 1)
        vol[tuple(pts.T)] = 1.0
        vol = ndi.gaussian_filter(vol, (1, 3, 3))
        frames.append((vol / vol.max() * 60000).astype(np.uint16))
    return np.stack(frames)


@pytest.fixture(scope="module")
def vol_u16():
    return blob_stack()[0]


@pytest.fixture(scope="module")
def vol_f32(vol_u16):
    return prepare_volume(vol_u16)


@pytest.fixture(scope="module")
def model():
    return load_unet(None)


@pytest.fixture(scope="module")
def jax_feats(vol_f32):
    return np.array(jax_predict(jax_load_unet(None), vol_f32, CHUNK,
                                MARGIN))


@pytest.fixture(scope="module")
def feats(model, vol_f32):
    return predict_volume(model, vol_f32, CHUNK, MARGIN, device=CPU)


@pytest.fixture(scope="module")
def fast_labels(model, vol_f32):
    pipe = tdp.AffinityPipeline(model, CHUNK, MARGIN, device=CPU)
    return pipe.segment(vol_f32).copy()


def test_features_within_forward_bound(feats, jax_feats, record_property):
    starts, _ = make_chunks(SHAPE, CHUNK, MARGIN)
    assert len({s[1] for s in starts}) == 2
    assert len({s[2] for s in starts}) == 2
    assert feats.shape == jax_feats.shape == (5,) + SHAPE
    resid = float(np.abs(feats - jax_feats).max())
    record_property("max_abs", resid)
    assert resid <= 5e-4


def test_fast_equals_generic(fast_labels, feats, jax_feats, record_property):
    generic, _, _ = tw.segment_output_image(feats, (0, 1, 2), 4, 3,
                                            device=CPU)
    np.testing.assert_array_equal(fast_labels, generic)
    assert fast_labels.max() > 5
    jax_labels, _, _ = jw.segment_output_image(jax_feats, (0, 1, 2), 4, 3)
    sel = jax_labels > 0
    agreement = float((fast_labels[sel] == jax_labels[sel]).mean())
    record_property("agreement_vs_jax", agreement)
    assert agreement >= 0.95


@pytest.fixture(scope="module")
def jax_outs(vol_f32):
    pipe = jdp.AffinityPipeline(jax_load_unet(None), CHUNK, MARGIN)
    return pipe, pipe._device_outputs(vol_f32)


def to_torch(outs):
    return tuple(torch.from_numpy(np.array(o)) for o in outs)


def test_finalize_equals_jax(jax_outs):
    jpipe, outs = jax_outs
    want = np.array(jpipe._finalize(SHAPE, outs))
    pipe = tdp.AffinityPipeline(load_unet(None), CHUNK, MARGIN, device=CPU)
    got = pipe._finalize(SHAPE, to_torch(outs))
    assert want.max() > 5
    np.testing.assert_array_equal(got, want)


def test_cand_program_equals_jax(jax_feats):
    aff, cent, otsu = jw._prep_feature_maps(
        jnp.asarray(jax_feats[:3]), jnp.asarray(jax_feats[4]),
        jnp.asarray(jax_feats[3]))
    jpipe = jdp.AffinityPipeline(None, CHUNK, MARGIN)
    want = [np.array(o) for o in jpipe._cand_program(SHAPE)(
        cent, jnp.asarray(jax_feats[3]), otsu)]
    pipe = tdp.AffinityPipeline(None, CHUNK, MARGIN, device=CPU)
    got = [o.numpy() for o in pipe._cand_program(SHAPE)(
        torch.from_numpy(np.array(cent)), torch.from_numpy(jax_feats[3]),
        torch.tensor(float(otsu)))]
    n = int(want[2])
    assert int(got[2]) == n > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][:n], want[1][:n])
    # the port's own prep: the affinities are exact; the Otsu threshold
    # inherits the Gaussian's <= 2 ulp difference from XLA's FMA
    # contraction (test_torch_ops) through the histogram range
    t_aff, _, t_otsu = tw._prep_feature_maps(
        torch.from_numpy(jax_feats[:3]), torch.from_numpy(jax_feats[4]),
        torch.from_numpy(jax_feats[3]))
    assert abs(t_otsu.item() - float(otsu)) <= 2.4e-7
    np.testing.assert_array_equal(t_aff.numpy(), np.array(aff))


@pytest.mark.parametrize("t", [np.float64(0.3) + 1e-12, 0.3, np.float32(0.3),
                               np.float64(0.5)])
def test_absolute_threshold_rule(t):
    """The device compare must agree with the host's ``f32_array > t``
    (float64 for NumPy f64 scalars, float32 otherwise)."""
    pipe = tdp.AffinityPipeline(None, absolute_thresh=t, device=CPU)
    thr = pipe._threshold(torch.tensor(0.0))
    v = np.float32(float(t)) + np.arange(-8, 9, dtype=np.float32) * np.float32(
        2 ** -25)
    v = v.astype(np.float32)
    np.testing.assert_array_equal((torch.from_numpy(v) > thr).numpy(),
                                  v > t)


def test_pack_mask_bits_and_flood_prep():
    m = np.random.default_rng(0).random((5, 7, 9)) > 0.5
    bits = tdp._pack_mask_bits(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(bits, np.packbits(m.ravel()))
    np.testing.assert_array_equal(
        bits, np.asarray(jdp._pack_mask_bits(jnp.asarray(m))))
    coords = torch.tensor([[1, 2, 3], [4, 6, 8], [0, 0, 0]])
    labs = torch.tensor([5, 7, 0], dtype=torch.int32)
    mask, seeds = tdp._flood_prep(torch.from_numpy(bits), coords, labs,
                                  m.shape)
    np.testing.assert_array_equal(mask.numpy(), m)
    assert seeds[1, 2, 3] == 5 and seeds[4, 6, 8] == 7
    assert int(seeds.sum()) == 12


def test_pallas_flood_keeps_support_and_ids(model, vol_f32, fast_labels,
                                            record_property):
    pipe = tdp.AffinityPipeline(model, CHUNK, MARGIN, device_flood="pallas",
                                device=CPU)
    tdp.reset_flood_fallbacks()
    before = fk.launches()
    prof = {}
    got = pipe.segment(vol_f32, profile=prof)
    assert fk.launches() == before  # CPU tensors take the plain version
    assert tdp.flood_fallbacks() == 0
    assert "device_flood" in prof and "flood" not in prof
    np.testing.assert_array_equal(got > 0, fast_labels > 0)
    assert set(np.unique(got)) == set(np.unique(fast_labels))
    sel = fast_labels > 0
    agreement = float((got[sel] == fast_labels[sel]).mean())
    record_property("agreement", agreement)
    assert agreement >= 0.9


def test_entry_point_3d_stack_save_and_warm_restart(tmp_path, vol_u16,
                                                    fast_labels, monkeypatch):
    kw = dict(chunk_size=CHUNK, margin=MARGIN, devices=[CPU])
    labels = affinity_unet_watershed(None, vol_u16, str(tmp_path), "v3",
                                     None, **kw)
    np.testing.assert_array_equal(np.asarray(labels), fast_labels)
    (data, meta, kind), = load_ome_zarr(tmp_path / "v3.ome.zarr")
    assert kind == "labels"
    np.testing.assert_array_equal(np.asarray(data), fast_labels)

    stack = np.stack([vol_u16, vol_u16[:, ::-1].copy()])
    out = affinity_unet_watershed(None, stack, str(tmp_path), "v4", None,
                                  **kw)
    (data, _, _), = load_ome_zarr(tmp_path / "v4.ome.zarr")
    data = np.asarray(data)
    np.testing.assert_array_equal(data, np.asarray(out))
    np.testing.assert_array_equal(data[0], fast_labels)
    assert data[1].max() > 5

    calls = []
    real = tdp.AffinityPipeline._device_outputs

    def counted(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(tdp.AffinityPipeline, "_device_outputs", counted)
    again = affinity_unet_watershed(None, stack, str(tmp_path), "v4", None,
                                    **kw)
    assert calls == []  # every frame already labelled: warm restart
    np.testing.assert_array_equal(np.asarray(again), data)


def test_json_config_sources(tmp_path, vol_u16):
    from iterseg_tpu_torch.engine.predict import DEFAULT_UNET_PATH

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"unet": "default", "device_flood": "pallas"}))
    prep = affinity_watershed_prep_config(vol_u16, str(cfg), None)
    assert prep["device_flood"] == "pallas"
    assert prep["output_volume"].shape == (5,) + SHAPE
    cfg.write_text(json.dumps({"unet": "labels layer"}))
    layer = type("L", (), {"metadata": {"unet": DEFAULT_UNET_PATH}})()
    prep = affinity_watershed_prep_config(vol_u16, str(cfg), layer)
    assert prep["unet"].out_channels == 5 and prep["device_flood"] is False
    with pytest.raises(AssertionError, match="no file"):
        affinity_watershed_prep_config(vol_u16, str(tmp_path / "x.npz"),
                                       None)


def test_unsupported_modes_raise(model, vol_u16, fast_labels):
    """Nothing raises any more: every flood mode builds, several devices
    round-robin a stack's frames with the labels of one device, and
    ``flood_telemetry`` runs on a volume and on a stack (JAX drops it on a
    stack; the port keeps it)."""
    want = {True: "xla", "xla": "xla", "exact": "exact", "pallas": "pallas",
            False: False, None: False}
    for mode, resolved in want.items():
        pipe = tdp.AffinityPipeline(model, device_flood=mode, device=CPU)
        assert pipe.device_flood == resolved and pipe.speculative_flood
    assert tdp.AffinityPipeline(model, flood_telemetry=True,
                                device=CPU).flood_telemetry
    two = np.asarray(affinity_unet_watershed(
        None, np.stack([vol_u16, vol_u16]), chunk_size=CHUNK, margin=MARGIN,
        debug=True, devices=[CPU, CPU]))
    np.testing.assert_array_equal(two[0], fast_labels)
    np.testing.assert_array_equal(two[1], fast_labels)
    kw = dict(chunk_size=CHUNK, margin=MARGIN, debug=True, devices=[CPU],
              flood_telemetry=True)
    got = affinity_unet_watershed(None, vol_u16, **kw)
    np.testing.assert_array_equal(np.asarray(got), fast_labels)
    stack = np.stack([vol_u16, vol_u16])
    got = np.asarray(affinity_unet_watershed(None, stack, device_flood="xla",
                                             **kw))
    xla = tdp.AffinityPipeline(model, CHUNK, MARGIN, device_flood="xla",
                               device=CPU).segment(prepare_volume(vol_u16))
    np.testing.assert_array_equal(got[0], xla)
    np.testing.assert_array_equal(got[1], xla)


def test_telemetry_on_a_stack_reports_the_bound(model, vol_u16):
    pipe = tdp.AffinityPipeline(model, CHUNK, MARGIN, device_flood="xla",
                                flood_telemetry=True, device=CPU)
    out = np.zeros((1,) + SHAPE, np.int32)
    prof = {}
    assert list(pipe.segment_stack(vol_u16[None], out, profile=prof)) == [0]
    assert prof["flood_certificate_converged"] is True
    assert 0.0 <= prof["flood_disagreement_bound"] <= 1.0
    assert prof["flood_mask_voxels"] > 0 and "flood_telemetry" in prof


def test_xla_finalize_equals_jax(jax_outs, fast_labels):
    """``"xla"`` is JAX's recurrence: bit-equal to JAX's ``"xla"`` given
    the same device outputs, with the default run's support and ids."""
    _, outs = jax_outs
    want = np.array(jdp.AffinityPipeline(None, CHUNK, MARGIN,
                                         device_flood="xla")._finalize(
        SHAPE, outs))
    prof = {}
    got = tdp.AffinityPipeline(None, CHUNK, MARGIN, device_flood="xla",
                               device=CPU)._finalize(SHAPE, to_torch(outs),
                                                     profile=prof)
    np.testing.assert_array_equal(got, want)
    assert prof["flood_iters"] % 8 == 0 and "flood" not in prof
    host = tdp.AffinityPipeline(None, CHUNK, MARGIN, device=CPU)._finalize(
        SHAPE, to_torch(outs))
    np.testing.assert_array_equal(got > 0, host > 0)
    assert set(np.unique(got)) == set(np.unique(host))


EXACT = test_flood_exact.TestPipelineExactFlood()


def exact_outs(kind):
    """``TestPipelineExactFlood``'s prod-like fixtures (seed 5 certifies,
    seed 8 repairs, seed 0 stays unresolved), its quantised variant (the
    early tie probe trips) and its chaotic plateau (phase C's uncertainty
    passes the repair-doom band)."""
    if kind == "plateau":
        return EXACT._plateau_outs()
    shape, outs = EXACT._outs(seed={"certified": 5, "repaired": 8,
                                    "unresolved": 0, "quantised": 6}[kind])
    if kind == "quantised":
        r = np.random.default_rng(6)
        aff_q = (r.integers(0, 3, size=outs[0].shape) / 2.0).astype(
            np.float32)
        outs = (jnp.asarray(aff_q),) + tuple(outs[1:])
    return shape, outs


def test_xla_telemetry_equals_jax():
    shape, outs = exact_outs("certified")
    jprof, prof = {}, {}
    want = np.array(jdp.AffinityPipeline(
        None, cand_capacity=256, device_flood="xla",
        flood_telemetry=True)._finalize(shape, outs, profile=jprof))
    got = tdp.AffinityPipeline(None, cand_capacity=256, device_flood="xla",
                               flood_telemetry=True, device=CPU)._finalize(
        shape, to_torch(outs), profile=prof)
    np.testing.assert_array_equal(got, want)
    for key in ("flood_uncertain_frac", "flood_mismatch_certain_frac",
                "flood_disagreement_bound", "flood_mask_voxels",
                "flood_certificate_converged"):
        assert prof[key] == jprof[key], key
    host = tdp.AffinityPipeline(None, cand_capacity=256, device=CPU)
    n_disagree = int((got != host._finalize(shape, to_torch(outs))).sum())
    assert n_disagree <= prof["flood_disagreement_bound"] * prof[
        "flood_mask_voxels"] + 0.5


@pytest.mark.parametrize("kind,path,speculative", [
    ("certified", "certified", False),
    ("repaired", "repaired", False),
    ("unresolved", "fallback:unresolved", True),
    ("quantised", "fallback:tie-density", False),
    ("plateau", "fallback:unresolved", True),
])
def test_exact_finalize_equals_default(kind, path, speculative):
    shape, outs = exact_outs(kind)
    want = np.array(jdp.AffinityPipeline(None, cand_capacity=256)._finalize(
        shape, outs))
    host = tdp.AffinityPipeline(None, cand_capacity=256, device=CPU)
    np.testing.assert_array_equal(host._finalize(shape, to_torch(outs)), want)
    dev = tdp.AffinityPipeline(None, cand_capacity=256, device_flood="exact",
                               device=CPU)
    prof = {}
    got = dev._finalize(shape, to_torch(outs), profile=prof)
    np.testing.assert_array_equal(got, want)
    assert prof["flood_exact_path"] == path
    assert prof.get("flood_speculative", False) is speculative
    if kind == "quantised":  # the early probe: the certificate never ran
        assert prof["flood_tie_frac_scope"] == "prefilter"
        assert prof["flood_tie_frac"] > 0.02
        assert "flood_uncertain_frac" not in prof and "flood" in prof
    else:
        assert prof["flood_tie_frac_scope"] == "filtered"
        assert prof["flood_tie_frac"] <= 0.02
        assert 0.0 <= prof["flood_uncertain_frac"] <= 1.0
    if speculative:
        assert "flood" in prof and "gather_affinities" in prof
    elif path in ("certified", "repaired"):
        assert "flood" not in prof and "flood_spec_waited" in prof
        assert "device_flood" in prof and "download_labels" in prof
    out = np.full(int(np.prod([s + 2 for s in shape])), -1, np.int32)
    view = dev._finalize(shape, to_torch(outs), out=out)
    np.testing.assert_array_equal(view, want)
    assert (out.reshape([s + 2 for s in shape])[0] == 0).all()


def test_exact_in_program_tie_probe_and_no_speculation(monkeypatch):
    """The in-program probe on the filtered mask routes too (the early
    probe held back by a patch), and without the speculative flood a
    fallback runs the host flood after the certificate."""
    shape, outs = exact_outs("quantised")
    want = np.array(jdp.AffinityPipeline(None, cand_capacity=256)._finalize(
        shape, outs))
    monkeypatch.setattr(tdp, "_tie_probe",
                        lambda mask_packed, aff_pad: torch.tensor(0.0))
    dev = tdp.AffinityPipeline(None, cand_capacity=256, device_flood="exact",
                               device=CPU)
    prof = {}
    np.testing.assert_array_equal(
        dev._finalize(shape, to_torch(outs), profile=prof), want)
    assert prof["flood_exact_path"] == "fallback:tie-density"
    assert prof["flood_tie_frac_scope"] == "filtered"
    assert prof["flood_speculative"] is True
    dev.speculative_flood = False
    shape, outs = exact_outs("unresolved")
    prof = {}
    want = np.array(jdp.AffinityPipeline(None, cand_capacity=256)._finalize(
        shape, outs))
    np.testing.assert_array_equal(
        dev._finalize(shape, to_torch(outs), profile=prof), want)
    assert prof["flood_exact_path"] == "fallback:unresolved"
    assert "flood_speculative" not in prof and "flood" in prof


def test_exact_entry_point_equals_default(vol_u16, fast_labels):
    kw = dict(chunk_size=CHUNK, margin=MARGIN, debug=True, devices=[CPU])
    got = affinity_unet_watershed(None, vol_u16, device_flood="exact", **kw)
    np.testing.assert_array_equal(np.asarray(got), fast_labels)


@pytest.mark.parametrize("n_chunks", [1, 3, 4, 7, 32, 36])
def test_pick_batch_size_matches_jax(n_chunks):
    assert _pick_batch_size(n_chunks, CHUNK, 5, CPU) == jax_pick(
        n_chunks, CHUNK, 5)


@pytest.mark.parametrize("zyx", [SHAPE, (33, 512, 512), (1, 20, 9)])
def test_valid_grid_matches_jax(zyx):
    assert tdp._valid_grid(zyx, (10, 256, 256), (1, 64, 64)) == \
        jdp._valid_grid(zyx, (10, 256, 256), (1, 64, 64))


def test_threaded_worker(vol_u16, fast_labels):
    from iterseg_tpu_torch.engine.segmentation import SegmentationWorker

    worker = affinity_unet_watershed(None, vol_u16, chunk_size=CHUNK,
                                     margin=MARGIN, devices=[CPU],
                                     threaded=True)
    assert isinstance(worker, SegmentationWorker)
    got = worker.result(timeout=300)
    assert worker.done and worker.result() is got
    np.testing.assert_array_equal(got, fast_labels)
