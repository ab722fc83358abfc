"""The port's evaluation (``iterseg_tpu_torch.eval``) against the JAX
package's on the same seeded label pairs: VI, the IoU matching, the stats
and AP columns are bit-equal (``assert_array_equal``) and the three CSV
files are byte-equal to what JAX's pandas writes. The port's columns are
numpy arrays in the frames' order, with the dtypes pandas infers."""
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from scipy import ndimage as ndi

from conftest import cpu_subprocess_env
from iterseg_tpu.eval import metrics as jm
from iterseg_tpu_torch.core.chunks import get_slices_from_chunks
from iterseg_tpu_torch.eval import metrics as tm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def label_pair(shape, seed, dtype, sparse_half=False):
    """Seeded (gt, seg): blobs labelled at two thresholds (so objects split,
    merge and shift), seg ids permuted. ``sparse_half`` empties the right
    half of the GT so its chunks fall under the exclusion threshold."""
    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(0, s, size=int(np.prod(shape) // 700))
                    for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    sigma = (0,) * (len(shape) - 3) + (1, 2, 2)
    vol = ndi.gaussian_filter(vol, sigma)
    vol /= vol.max()
    gt = ndi.label(vol > 0.2)[0]
    seg = ndi.label(vol > 0.3)[0]
    perm = np.concatenate([[0], r.permutation(int(seg.max())) + 1])
    seg = perm[seg]
    if sparse_half:
        gt[..., shape[-1] // 2:] = 0
    return gt.astype(dtype), seg.astype(dtype)


# (shape, dtype, chunk, margin, exclude, sparse_half)
CASES = {
    "3d-int32": ((10, 64, 64), np.int32, (10, 32, 32), (1, 8, 8), 2, False),
    "4d-uint32": ((2, 10, 64, 64), np.uint32, (10, 32, 32), (1, 8, 8), 2,
                  False),
    "4d-int64-sparse": ((2, 10, 64, 64), np.int64, (10, 32, 32), (1, 8, 8),
                        3, True),
    "perfect": ((2, 8, 48, 48), np.int32, (8, 24, 24), (1, 4, 4), 1, False),
    "one-chunk": ((10, 64, 64), np.int32, (10, 64, 64), (1, 8, 8), 2, False),
}


def case_data(name):
    shape, dtype, chunk, margin, exclude, sparse = CASES[name]
    gt, seg = label_pair(shape, len(name), dtype, sparse)
    if name == "perfect":
        seg = gt.copy()
    return gt, seg, get_slices_from_chunks(shape, chunk, margin), exclude


def assert_columns_equal(port, frame):
    """A port column dict against a JAX DataFrame: same names in the same
    order, bit-equal values, the dtype pandas inferred for numbers (an
    empty column has none to infer)."""
    assert list(port) == list(frame.columns)
    for c in frame.columns:
        want = frame[c].to_numpy()
        got = port[c]
        assert got.ndim == 1 and len(got) == len(want), c
        if want.dtype.kind in "if" and len(want):
            assert got.dtype == want.dtype, (c, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=c)
        else:
            assert [str(v) for v in got] == [str(v) for v in want], c


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64])
def test_vi_and_matching_equal_jax(dtype):
    gt, seg = label_pair((10, 48, 48), 3, dtype)
    np.testing.assert_array_equal(tm.variation_of_information(gt, seg),
                                  jm.variation_of_information(gt, seg))
    art_t, art_j = tm._MatchArtifacts(gt, seg), jm._MatchArtifacts(gt, seg)
    for t in jm.THRESHOLDS:
        got = tm.calculate(gt, seg, iou_threshold=t, artifacts=art_t)
        want = jm.calculate(gt, seg, iou_threshold=t, artifacts=art_j)
        assert got.n_true_positives > 0 or t > 0.5
        assert (got.n_true_labels, got.n_pred_labels, got.n_true_positives,
                got.n_false_positives, got.n_false_negatives) == (
            want.n_true_labels, want.n_pred_labels, want.n_true_positives,
            want.n_false_positives, want.n_false_negatives)
        assert vars(got.results) == vars(want.results)
        assert tm.calc_ap(got) == jm.calc_ap(want)
    d_t, d_j = tm.generate_IoU_dict(), jm.generate_IoU_dict()
    tm.generate_IoU_data(gt, seg, d_t)
    jm.generate_IoU_data(gt, seg, d_j)
    assert d_t == d_j


@pytest.mark.parametrize("name", sorted(CASES))
def test_get_accuracy_metrics_equals_jax(name, tmp_path):
    gt, seg, slices, exclude = case_data(name)
    (ts, tap), tstats = tm.get_accuracy_metrics(
        slices, gt, seg, "model-a", "pre", out_path=str(tmp_path / "t"),
        exclude_chunks=exclude)
    (js, jap), jstats = jm.get_accuracy_metrics(
        slices, gt, seg, "model-a", "pre", out_path=str(tmp_path / "j"),
        exclude_chunks=exclude)
    assert_columns_equal(ts, js)
    assert_columns_equal(tstats, jstats)
    if name == "one-chunk":
        assert tap is None and jap is None and list(ts) == ["model_name"]
    else:
        assert_columns_equal(tap, jap)
        n_chunks = len(slices)
        assert 2 <= len(ts["model_name"]) <= n_chunks
        if name.endswith("sparse"):
            assert len(ts["model_name"]) < n_chunks
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    assert len(files) == (2 if name == "one-chunk" else 3)
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == (
            tmp_path / "j" / f).read_bytes(), f
    if name == "perfect":
        # a constant column has zero SEM: scipy's interval is NaN, written
        # as an empty field
        stats_csv = (tmp_path / "t" / "pre_model-a_stats.csv").read_text()
        assert "VI: GT | Output_95pcntCI_2-5pcnt,\n" in stats_csv


@pytest.mark.parametrize("ap", [True, False])
def test_ap_off_and_score_subsets_equal_jax(ap, tmp_path):
    gt, seg, slices, exclude = case_data("4d-uint32")
    kw = dict(VI=ap, AP=ap, ND=True, exclude_chunks=exclude)
    (ts, tap), tstats = tm.get_accuracy_metrics(
        slices, gt, seg, "m", "p", out_path=str(tmp_path / "t"), **kw)
    (js, jap), jstats = jm.get_accuracy_metrics(
        slices, gt, seg, "m", "p", out_path=str(tmp_path / "j"), **kw)
    assert_columns_equal(ts, js)
    assert_columns_equal(tstats, jstats)
    assert (tap is None) == (jap is None) == (not ap)
    for f in os.listdir(tmp_path / "j"):
        assert (tmp_path / "t" / f).read_bytes() == (
            tmp_path / "j" / f).read_bytes(), f


def test_stats_and_ap_scores_from_columns_equal_jax():
    r = np.random.default_rng(5)
    cols = {"a": r.random(7), "b": r.integers(0, 40, 7),
            "c": np.full(7, 0.25)}
    frame = pd.DataFrame(cols)
    assert_columns_equal(tm.single_sample_stats(cols, list(cols), "x"),
                         jm.single_sample_stats(frame, list(cols), "x"))
    counts = {}
    for t in jm.THRESHOLDS:
        for k in ("true_positives", "false_positives", "false_negatives"):
            counts[f"t{t}_{k}"] = r.integers(0, 9, 4)
    counts["t0.9_true_positives"][:] = 0
    counts["t0.9_false_positives"][:] = 0
    counts["t0.9_false_negatives"][:] = 0  # a zero denominator
    assert_columns_equal(tm.generate_ap_scores(counts, "x"),
                         jm.generate_ap_scores(pd.DataFrame(counts), "x"))


def test_affinity_sum_graph_equals_jax():
    img = np.random.default_rng(2).random((6, 20, 50))
    (t_affs, t_res), (j_affs, j_res) = (tm.affinity_sum_graph(img),
                                        jm.affinity_sum_graph(img))
    assert t_affs == j_affs
    # orders past an axis' length give an empty difference: NaN in both
    np.testing.assert_array_equal(t_res, j_res)


def test_get_accuracy_metrics_without_pandas_or_plot_packages(tmp_path):
    """The machine with the card has no pandas, matplotlib, seaborn or PIL:
    the metrics path imports none of them, and ``plot_accuracy_metrics``
    raises ``ImportError`` there."""
    code = f"""
import sys
for m in ('pandas', 'matplotlib', 'seaborn', 'PIL', 'jax'):
    sys.modules[m] = None
import numpy as np, os
from scipy import ndimage as ndi
from iterseg_tpu_torch.core.chunks import get_slices_from_chunks
from iterseg_tpu_torch.eval.metrics import (get_accuracy_metrics,
                                            plot_accuracy_metrics)
from iterseg_tpu_torch.widgets import model_assessment
r = np.random.default_rng(0)
vol = np.zeros((2, 8, 48, 48), np.float32)
vol[tuple(np.stack([r.integers(0, s, 60) for s in vol.shape]))] = 1
vol = ndi.gaussian_filter(vol, (0, 1, 2, 2))
gt = ndi.label(vol > 0.2 * vol.max())[0]
seg = ndi.label(vol > 0.3 * vol.max())[0]
slices = get_slices_from_chunks(gt.shape, (8, 24, 24), (1, 4, 4))
(s, ap), st = model_assessment(gt, seg, "p", "m", slices, {str(tmp_path)!r},
                               True, True, True, 1)
assert len(s["model_name"]) > 1 and ap is not None
assert sorted(os.listdir({str(tmp_path)!r})) == [
    "p_m_AP_curve.csv", "p_m_scores.csv", "p_m_stats.csv"]
try:
    plot_accuracy_metrics((s, ap), "p", {str(tmp_path)!r}, "m", True, True,
                          True, show=False)
except ImportError:
    pass
else:
    raise AssertionError("plotting without matplotlib did not raise")
assert not [m for m in sys.modules if m.split('.')[0] in
            ('pandas', 'matplotlib', 'seaborn', 'PIL', 'iterseg_tpu')
            and sys.modules[m] is not None]
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=cpu_subprocess_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_plots_from_column_dicts(tmp_path):
    """The port's plots take the metrics' column dicts (and the JAX
    frames' CSVs for the comparison figure)."""
    from iterseg_tpu_torch.eval.plots import (VI_plot_compare,
                                              comparison_plots,
                                              experiment_VI_plots)

    gt, seg, slices, exclude = case_data("4d-uint32")
    for i, s in enumerate((seg, gt)):
        data, _ = tm.get_accuracy_metrics(slices, gt, s, f"model-{i}", "cmp",
                                          out_path=str(tmp_path),
                                          exclude_chunks=exclude)
    tm.plot_accuracy_metrics(data, "cmp", str(tmp_path), "model-1", True,
                             True, True, show=False)
    for kind in ("VI", "AP", "OD"):
        assert (tmp_path / f"cmp_model-1_{kind}_plot.pdf").exists()
    assert os.path.exists(comparison_plots(str(tmp_path), "compare",
                                           show=False))
    experiment_VI_plots([data[0], data[0]], ["a", "b"], "VI", "vi",
                        str(tmp_path), cond_ent_over="VI: GT | Output",
                        cond_ent_under="VI: Output | GT", show=False)
    assert (tmp_path / "vi_VI_rainclould_plots.png").exists()
    import matplotlib.pyplot as plt

    f, (ax0, ax1) = plt.subplots(1, 2)
    VI_plot_compare(pd.DataFrame(data[0]), ax0, ax1, "models", ["model-1"])
    assert ax0.get_ylabel() == "models"
    plt.close(f)


def test_loss_plots(tmp_path):
    from iterseg_tpu_torch.eval.plots import (save_channel_loss_plot,
                                              save_loss_plot)
    from iterseg_tpu_torch.helpers import write_csv

    write_csv(tmp_path / "loss_t.csv", {
        "epoch": [0, 0, 1, 1], "batch_num": [0, 1, 0, 1],
        "loss": [1.0, 0.9, 0.5, 0.4], "data_id": list("abcd"),
        **{c: [1.0] * 4 for c in ("z-1", "y-1", "x-1", "mask",
                                  "centreness-log")}})
    write_csv(tmp_path / "validation-loss_t.csv", {
        "epoch": [0, 0, 1], "validation_loss": [1.0, 0.8, 0.6],
        "data_id": list("abc"), "batch_id": [0, 2, 4]})
    save_loss_plot(str(tmp_path / "loss_t.csv"), "BCELoss",
                   v_path=str(tmp_path / "validation-loss_t.csv"), show=False)
    save_channel_loss_plot(str(tmp_path / "loss_t.csv"), show=False)
    assert (tmp_path / "loss_t_loss.png").exists()
    assert (tmp_path / "loss_t_channel-loss.png").exists()
