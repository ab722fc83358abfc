"""Segmentation accuracy metrics: VI, IoU-matched AP, object counts.

The port of ``iterseg_tpu/eval/metrics.py``: the same numpy and scipy core,
with no pandas anywhere. Where the JAX module builds a DataFrame, this one
returns an ordered column dict of 1-D numpy arrays (int64 counts, float64
values, object strings: the dtypes pandas would infer) in the frame's column
order, and writes the CSVs through ``helpers.write_csv`` byte for byte as
``DataFrame.to_csv`` does.

Parity with iterseg ``metrics.py``:

- ``get_accuracy_metrics`` (metrics.py:45-142): per-chunk VI, object-count
  difference and 13-threshold IoU statistics with CSV outputs and 95% t-CIs.
- ``variation_of_information``: conditional entropies H(GT|Out) /
  H(Out|GT) in bits, computed from the label contingency table
  (skimage.metrics.variation_of_information semantics, metrics.py:107).
- ``calculate``: umetrix-equivalent IoU matching (metrics.py:205-227):
  one-to-one Hungarian matching on the IoU matrix restricted to pairs above
  the threshold; returns an object exposing ``n_true_positives``,
  ``n_false_positives``, ``n_false_negatives``, ``n_pred_labels``,
  ``n_true_labels`` and per-image ``results`` (IoU, Jaccard,
  pixel_identity, localization_error).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
from scipy import stats
from scipy.optimize import linear_sum_assignment

from ..helpers import write_csv

__all__ = [
    "variation_of_information",
    "calculate",
    "get_accuracy_metrics",
    "single_sample_stats",
    "calc_ap",
    "generate_IoU_dict",
    "generate_IoU_data",
    "generate_ap_scores",
    "plot_accuracy_metrics",
    "affinity_sum_graph",
    "THRESHOLDS",
]

THRESHOLDS = (0.3, 0.35, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8,
              0.85, 0.9)


def _unique_inverse(flat):
    """``np.unique(flat, return_inverse=True)`` with an O(n) lookup-table
    fast path for non-negative integer labels of bounded range (the
    instance-label case) — identical values/inverse, no O(n log n)
    argsort."""
    if flat.dtype.kind in "iu" and flat.size:
        mn = int(flat.min())
        mx = int(flat.max())
        if mn >= 0 and mx < max(8 * flat.size, 1 << 20):
            # int64 cast: np.bincount rejects uint64 ("safe" cast rule);
            # safe here because 0 <= values <= mx (bounded above).
            idx = flat.astype(np.int64, copy=False)
            present = np.bincount(idx.ravel(), minlength=mx + 1) > 0
            vals = np.flatnonzero(present)
            lut = np.zeros(mx + 1, np.int64)
            lut[vals] = np.arange(vals.size)
            return vals.astype(flat.dtype), lut[idx]
    return np.unique(flat, return_inverse=True)


def _n_unique(arr):
    """``np.unique(arr).size`` with the same O(n) fast path as
    ``_unique_inverse``."""
    flat = np.asarray(arr).ravel()
    if flat.dtype.kind in "iu" and flat.size:
        mn = int(flat.min())
        mx = int(flat.max())
        if mn >= 0 and mx < max(8 * flat.size, 1 << 20):
            return int(np.count_nonzero(np.bincount(
                flat.astype(np.int64, copy=False), minlength=mx + 1)))
    return np.unique(flat).size


class _Pairs:
    """Contingency table of two flattened label volumes, as row-major
    sorted (row, col, count) triples — the dense-key bincount equivalent
    of the previous ``scipy.sparse`` build, bit-identical reductions
    (counts are integer-valued f64, so sums are exact in any order; the
    VI probability sums below keep the same row-major element order as
    CSR axis sums, asserted against a literal sparse reimplementation in
    tests/test_metrics.py)."""

    def __init__(self, a, b):
        a = np.asarray(a).ravel()
        b = np.asarray(b).ravel()
        self.a_vals, self.a_inv = _unique_inverse(a)
        self.b_vals, self.b_inv = _unique_inverse(b)
        a_inv = self.a_inv
        b_inv = self.b_inv
        na = self.a_vals.size
        nb = self.b_vals.size
        key = a_inv * nb + b_inv
        if na * nb <= max(4 * a.size, 1 << 22):
            counts = np.bincount(key, minlength=na * nb)
            nz = np.flatnonzero(counts)
            self.rows, self.cols = np.divmod(nz, nb)
            self.data = counts[nz].astype(np.float64)
        else:
            # degenerate label-count blowup: sort the pair keys instead
            # of materialising the dense na*nb histogram
            skey = np.sort(key)
            edge = np.flatnonzero(np.diff(skey)) + 1
            starts = np.concatenate(([0], edge))
            uniq = skey[starts]
            self.rows, self.cols = np.divmod(uniq, nb)
            self.data = np.diff(
                np.concatenate((starts, [skey.size]))
            ).astype(np.float64)
        self.n = a.size

    def row_sums(self):
        return np.bincount(self.rows, weights=self.data,
                           minlength=self.a_vals.size)

    def col_sums(self):
        return np.bincount(self.cols, weights=self.data,
                           minlength=self.b_vals.size)


def variation_of_information(image0, image1, pairs=None):
    """(H(image0|image1), H(image1|image0)) in bits.

    With GT as image0: element 0 measures under-segmentation, element 1
    over-segmentation (see iterseg ``_dock_widgets.py:731-737``).
    ``pairs`` accepts a precomputed ``_Pairs`` (the per-chunk scoring
    loop shares one with the IoU sweep via ``_MatchArtifacts``).
    """
    if pairs is None:
        pairs = _Pairs(image0, image1)
    # reciprocal-multiply, not true division: scipy.sparse (and skimage's
    # VI built on it) scale by `* (1/n)`, and bit-compat with the prior
    # sparse implementation pins that rounding
    vals = pairs.data * (1.0 / pairs.n)
    # px/py: probability-mass sums per row/col in row-major element
    # order — the same grouping and order as the former CSR axis sums
    px = np.bincount(pairs.rows, weights=vals,
                     minlength=pairs.a_vals.size)
    py = np.bincount(pairs.cols, weights=vals,
                     minlength=pairs.b_vals.size)
    h0g1 = -np.sum(vals * (np.log2(vals) - np.log2(py[pairs.cols])))
    h1g0 = -np.sum(vals * (np.log2(vals) - np.log2(px[pairs.rows])))
    return np.array([h0g1, h1g0])


@dataclass
class MatchResults:
    IoU: float = 0.0
    Jaccard: float = 0.0
    pixel_identity: float = 0.0
    localization_error: float = 0.0


@dataclass
class SegmentationMetrics:
    n_true_labels: int = 0
    n_pred_labels: int = 0
    n_true_positives: int = 0
    n_false_positives: int = 0
    n_false_negatives: int = 0
    results: MatchResults = field(default_factory=MatchResults)


def _centroid_table(vol, vals, inv=None, counts=None):
    """{label id -> centroid tuple} for every value in sorted ``vals``.

    One ``bincount(weights=axis coordinate)`` per axis; exact-integer f64
    sums make the result bit-equal to per-label ``ndi.center_of_mass``
    (asserted in tests/test_metrics.py). ``inv``/``counts`` accept the
    label inverse and per-label voxel counts when the caller already has
    them (``_MatchArtifacts`` reuses the ``_Pairs`` inverse and the
    contingency row sums — integer-valued f64, so identical values).
    """
    if inv is None:
        # vals is sorted-unique over vol
        inv = np.searchsorted(vals, vol.ravel())
    if counts is None:
        counts = np.bincount(inv, minlength=vals.size).astype(np.float64)
    axis_sums = []
    for ax, size in enumerate(vol.shape):
        rs = [1] * vol.ndim
        rs[ax] = size
        # broadcast view of the per-axis coordinate; integer-valued f64
        # weights sum exactly, matching the former int64 // % coordinates
        coord = np.broadcast_to(
            np.arange(size, dtype=np.float64).reshape(rs), vol.shape
        ).ravel()
        axis_sums.append(np.bincount(inv, weights=coord,
                                     minlength=vals.size))
    cents = np.stack(axis_sums, axis=1) / counts[:, None]
    return {int(v): tuple(c) for v, c in zip(vals, cents)}


class _MatchArtifacts:
    """Threshold-independent per-(gt, seg) precomputation.

    ``generate_IoU_data`` sweeps ``calculate`` over 13 thresholds
    (metrics.py:205-227 semantics); the contingency table, the
    foreground IoU pair list, ``pixel_identity`` and per-object
    centroids do not depend on the threshold, so computing them once per
    chunk and filtering per threshold is bit-identical to the per-call
    path (asserted in tests/test_metrics.py) and removes ~13 full-volume
    passes per chunk.
    """

    def __init__(self, gt, seg):
        self.gt = np.asarray(gt)
        self.seg = np.asarray(seg)
        self.pairs = _Pairs(self.gt, self.seg)
        self.a_vals = self.pairs.a_vals
        self.b_vals = self.pairs.b_vals
        a_fg = self.a_vals != 0
        b_fg = self.b_vals != 0
        areas_a = self.pairs.row_sums()
        areas_b = self.pairs.col_sums()
        self._areas_a = areas_a
        self._areas_b = areas_b
        self.n_true = int(a_fg.sum())
        self.n_pred = int(b_fg.sum())
        # IoU per overlapping (gt, seg) pair (foreground only)
        keep = a_fg[self.pairs.rows] & b_fg[self.pairs.cols]
        self.rows = self.pairs.rows[keep]
        self.cols = self.pairs.cols[keep]
        inter = self.pairs.data[keep]
        union = areas_a[self.rows] + areas_b[self.cols] - inter
        self.iou = inter / union
        self._pixel_identity = None
        self._gt_cents = None
        self._seg_cents = None

    @property
    def pixel_identity(self):
        # lazy: a full-volume pass only AP consumers pay for
        if self._pixel_identity is None:
            self._pixel_identity = float(np.mean(self.gt == self.seg))
        return self._pixel_identity

    def centroids(self, gt_labels, seg_labels):
        """Centroids of the given label ids (all labels tabulated once).

        Bit-identical to ``ndi.center_of_mass(np.ones_like(v), v, ids)``:
        a centroid is a mean of integer coordinates, and every partial sum
        is an integer far below 2^53, so the f64 sums are exact regardless
        of summation order — one bincount pass per axis replaces a full
        labeled comprehension per ``calculate`` call (the former hot spot
        of the assess loop).
        """
        if self._gt_cents is None:
            self._gt_cents = _centroid_table(
                self.gt, self.a_vals,
                inv=self.pairs.a_inv, counts=self._areas_a)
            self._seg_cents = _centroid_table(
                self.seg, self.b_vals,
                inv=self.pairs.b_inv, counts=self._areas_b)
        return ([self._gt_cents[lb] for lb in gt_labels],
                [self._seg_cents[lb] for lb in seg_labels])


def calculate(gt, seg, strict=True, iou_threshold=0.5, artifacts=None):
    """umetrix-equivalent IoU matching of instance segmentations.

    One-to-one matching maximising total IoU (Hungarian) over pairs whose
    IoU >= threshold (``strict``); TP = matched pairs, FN = unmatched GT
    objects, FP = unmatched predicted objects. ``artifacts`` accepts a
    ``_MatchArtifacts(gt, seg)`` to share the threshold-independent work
    across a threshold sweep (outputs identical either way).
    """
    art = _MatchArtifacts(gt, seg) if artifacts is None else artifacts
    gt = art.gt
    seg = art.seg
    a_vals = art.a_vals
    b_vals = art.b_vals
    n_true = art.n_true
    n_pred = art.n_pred
    above = art.iou >= iou_threshold
    rows, cols, iou = art.rows[above], art.cols[above], art.iou[above]
    tp = 0
    matched_iou = []
    matched_pairs = []
    if len(iou):
        # dense assignment over the (small) candidate submatrix;
        # (row, col) pairs are unique so the scatter has no collisions
        ur, rinv = np.unique(rows, return_inverse=True)
        uc, cinv = np.unique(cols, return_inverse=True)
        mat = np.zeros((len(ur), len(uc)))
        mat[rinv, cinv] = iou
        ri, ci = linear_sum_assignment(-mat)
        for r, c in zip(ri, ci):
            if mat[r, c] >= iou_threshold:
                tp += 1
                matched_iou.append(mat[r, c])
                matched_pairs.append((ur[r], uc[c]))
    fn = n_true - tp
    fp = n_pred - tp
    # localisation error: mean centroid distance of matched objects
    loc_err = 0.0
    if matched_pairs:
        gl = [int(a_vals[r]) for r, _ in matched_pairs]
        sl = [int(b_vals[c]) for _, c in matched_pairs]
        gc, sc = art.centroids(gl, sl)
        loc_err = float(
            np.mean(np.linalg.norm(np.array(gc) - np.array(sc), axis=1))
        )
    results = MatchResults(
        IoU=float(np.mean(matched_iou)) if matched_iou else 0.0,
        Jaccard=tp / (tp + fp + fn) if (tp + fp + fn) else 0.0,
        pixel_identity=art.pixel_identity,
        localization_error=loc_err,
    )
    return SegmentationMetrics(
        n_true_labels=n_true,
        n_pred_labels=n_pred,
        n_true_positives=tp,
        n_false_positives=fp,
        n_false_negatives=fn,
        results=results,
    )


# ---------------------------------------------------------------------------
# Accuracy-metric driver (parity: metrics.py:45-258)
# ---------------------------------------------------------------------------


def get_accuracy_metrics(
    slices,
    gt_data,
    model_result,
    name: str,
    prefix: str,
    VI: bool = True,
    AP: bool = True,
    ND: bool = True,
    out_path=None,
    exclude_chunks: int = 10,
):
    """Chunkwise VI / AP / count metrics with CSV output.

    ``slices``: list of (slice, crop) pairs from
    ``core.chunks.get_slices_from_chunks``. Chunks whose GT contains at most
    ``exclude_chunks + 1`` labels (incl. background) are skipped
    (metrics.py:102).

    Returns ``((scores, ap_scores), statistics)``: column dicts where the
    JAX package returns DataFrames (``ap_scores`` is None when the AP
    columns did not survive the one-chunk filter).
    """
    scores = _collect_chunk_scores(
        slices, gt_data, model_result, VI=VI, AP=AP, ND=ND,
        exclude_chunks=exclude_chunks,
    )
    return _finalize_scores(scores, name, prefix, out_path, AP=AP)


def _collect_chunk_scores(slices, gt_data, model_result, VI=True, AP=True,
                          ND=True, exclude_chunks=10):
    """The per-chunk scoring loop of ``get_accuracy_metrics``: returns the
    raw column-list dict (``parallel.multihost_accuracy_metrics`` scores
    each host's share of the chunk list with it)."""
    scores = {
        "VI: GT | Output": [],
        "VI: Output | GT": [],
        "Number objects (GT)": [],
        "Number objects (model)": [],
        "Count difference": [],
        "Count difference (%)": [],
    }
    scores.update(generate_IoU_dict())
    # lazy: 4D zarr-backed inputs are sliced one chunk at a time below,
    # never materialised whole (pod-scale stacks exceed host RAM)
    gt_data = _layer_data(gt_data, lazy=True)
    model_result = _layer_data(model_result, lazy=True)
    if gt_data.ndim != model_result.ndim:
        dim_dif = gt_data.ndim - model_result.ndim
        if dim_dif == -1:
            gt_data = np.stack([np.asarray(gt_data)] * model_result.shape[0])
        elif dim_dif == 1:
            model_result = np.stack(
                [np.asarray(model_result)] * gt_data.shape[0]
            )
        else:
            raise ValueError(
                "Ground truth and model result must be either 3D or 4D "
                "arrays"
            )
    if gt_data.ndim == 3:
        # the chunk slices carry a leading frame slice; promote to 1-frame
        # 4D (the reference only supports 4D inputs here)
        gt_data = np.asarray(gt_data)[None]
        model_result = np.asarray(model_result)[None]
    for s_, c_ in slices:
        gt = np.squeeze(np.asarray(gt_data[s_]))[c_]
        n_objects = _n_unique(gt)
        if n_objects > exclude_chunks + 1:
            mr = np.squeeze(np.asarray(model_result[s_]))[c_]
            # one contingency/IoU precomputation shared by VI, the
            # 13-threshold sweep and the object counts (bit-identical)
            art = _MatchArtifacts(gt, mr)
            if VI:
                vi = variation_of_information(gt, mr, pairs=art.pairs)
                scores["VI: GT | Output"].append(vi[0])
                scores["VI: Output | GT"].append(vi[1])
            if AP:
                generate_IoU_data(gt, mr, scores, artifacts=art)
            if ND:
                n_mr = art.b_vals.size
                nd = n_mr - n_objects
                scores["Count difference (%)"].append(nd / n_objects * 100)
                scores["Number objects (GT)"].append(n_objects)
                scores["Number objects (model)"].append(n_mr)
                scores["Count difference"].append(nd)
    return scores


def _names(name, n):
    """A string column of ``n`` rows (pandas' object column)."""
    return np.array([name] * n, dtype=object)


def _finalize_scores(scores, name, prefix, out_path, AP=True):
    """Turn a raw score dict into the (scores, AP) column dicts + stats and
    write the CSVs — the tail of ``get_accuracy_metrics``."""
    # the reference's len > 1 filter: a one-chunk run keeps no column
    to_keep = [key for key in scores if len(scores[key]) > 1]
    new_scores = {key: np.asarray(scores[key]) for key in to_keep}
    statistics = single_sample_stats(new_scores, to_keep, name)
    n_rows = len(new_scores[to_keep[0]]) if to_keep else 0
    new_scores["model_name"] = _names(name, n_rows)
    if out_path is not None:
        os.makedirs(out_path, exist_ok=True)
        write_csv(os.path.join(out_path, f"{prefix}_{name}_scores.csv"),
                  new_scores)
        _write_transposed_csv(
            os.path.join(out_path, f"{prefix}_{name}_stats.csv"), statistics)
    ap_scores = None
    if AP and f"t{THRESHOLDS[0]}_true_positives" in new_scores:
        ap_scores = generate_ap_scores(new_scores, name)
        if out_path is not None:
            write_csv(os.path.join(out_path, f"{prefix}_{name}_AP_curve.csv"),
                      ap_scores)
    return (new_scores, ap_scores), statistics


def _cell_text(v):
    """One cell of an object column as ``to_csv`` writes it: a float by its
    shortest repr (never ``repr`` of an ``np.float64``, which numpy 2 spells
    ``np.float64(...)``), NaN as an empty field, anything else by ``str``."""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    return str(v)


def _write_transposed_csv(path, columns):
    """``pd.DataFrame(columns).T.to_csv(path)``: one line a column (its name,
    then its values), under a header of the row numbers. With no rows the
    header is a lone empty field, which the csv module writes as ``""``."""
    n_rows = len(next(iter(columns.values()))) if columns else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + [str(i) for i in range(n_rows)])
        for key, values in columns.items():
            w.writerow([key] + [_cell_text(v) for v in values])


def _layer_data(obj, lazy=False):
    """Unwrap a napari layer / array-like to its data.

    ``lazy=True`` keeps disk-backed array-likes (zarr, ZarrArray, dask)
    un-materialised — the per-chunk scoring loop slices them one chunk at
    a time, so pod-scale assessment of a stack that doesn't fit in host
    RAM stays O(chunk). Plain numpy semantics otherwise."""
    if hasattr(obj, "data") and not isinstance(obj, np.ndarray):
        if not isinstance(getattr(obj, "data"), memoryview):
            obj = obj.data
    if (lazy and not isinstance(obj, np.ndarray)
            and hasattr(obj, "shape") and hasattr(obj, "__getitem__")):
        return obj
    return np.asarray(obj)


@lru_cache(maxsize=None)
def _t_quantiles(alpha, df):
    """Standard-t interval quantiles, cached per degrees-of-freedom (the
    expensive ``t.ppf`` is df-only; loc/scale are applied as scipy does:
    ``_ppf(q, df) * scale + loc``)."""
    return stats.t.interval(alpha, df)


def _t_interval(alpha, df, loc, scale):
    """``stats.t.interval(alpha, df, loc, scale)`` bit-exactly, with the
    df-dependent quantiles cached (asserted against scipy in
    tests/test_metrics.py, incl. the scale<=0 -> nan domain rule)."""
    if not scale > 0:
        # scipy's domain check: scale <= 0 (incl. 0 from a constant
        # column) or nan yields the bad value for both ends
        return (np.nan, np.nan)
    qlo, qhi = _t_quantiles(alpha, int(df))
    return (qlo * scale + loc, qhi * scale + loc)


def single_sample_stats(df, columns, name):
    """Mean/SEM/95% t-CI per metric column (parity: metrics.py:145-160), as a
    one-row column dict (no row when ``columns`` is empty). ``df`` is a
    column dict (or anything indexable by column name)."""
    results = {}
    alpha = 0.95
    for c in columns:
        vals = np.asarray(df[c])
        sample_mean = np.mean(vals)
        # literal scipy.stats.sem (std(ddof=1)/sqrt(n)) without the
        # nan-policy wrapper overhead; bit-equality asserted in
        # tests/test_metrics.py
        sample_sem = np.std(vals, ddof=1) / np.sqrt(vals.size)
        CI = _t_interval(alpha, vals.size - 1, sample_mean, sample_sem)
        n = str(c) + "_"
        results[n + "mean"] = [sample_mean]
        results[n + "sem"] = [sample_sem]
        results[n + "95pcntCI_2-5pcnt"] = [CI[0]]
        results[n + "95pcntCI_97-5pcnt"] = [CI[1]]
    results = {k: np.asarray(v, dtype=np.float64) for k, v in results.items()}
    results["model_name"] = _names(name, 1 if results else 0)
    return results


def calc_ap(result):
    denominator = (
        result.n_true_positives
        + result.n_false_negatives
        + result.n_false_positives
    )
    return result.n_true_positives / denominator if denominator else 0.0


def generate_IoU_dict(thresholds=THRESHOLDS):
    IoU_dict = {"n_predicted": [], "n_true": [], "n_diff": []}
    for t in thresholds:
        for suffix in (
            "true_positives",
            "false_positives",
            "false_negatives",
            "IoU",
            "Jaccard",
            "pixel_identity",
            "localization_error",
            "per_image_average_precision",
        ):
            IoU_dict[f"t{t}_{suffix}"] = []
    return IoU_dict


def generate_IoU_data(gt, seg, IoU_dict, thresholds=THRESHOLDS,
                      artifacts=None):
    if artifacts is None:
        artifacts = _MatchArtifacts(gt, seg)
    for t in thresholds:
        result = calculate(gt, seg, strict=True, iou_threshold=t,
                           artifacts=artifacts)
        IoU_dict[f"t{t}_true_positives"].append(result.n_true_positives)
        IoU_dict[f"t{t}_false_positives"].append(result.n_false_positives)
        IoU_dict[f"t{t}_false_negatives"].append(result.n_false_negatives)
        IoU_dict[f"t{t}_IoU"].append(result.results.IoU)
        IoU_dict[f"t{t}_Jaccard"].append(result.results.Jaccard)
        IoU_dict[f"t{t}_pixel_identity"].append(
            result.results.pixel_identity
        )
        IoU_dict[f"t{t}_localization_error"].append(
            result.results.localization_error
        )
        IoU_dict[f"t{t}_per_image_average_precision"].append(
            calc_ap(result)
        )
        if t == thresholds[0]:
            IoU_dict["n_predicted"].append(result.n_pred_labels)
            IoU_dict["n_true"].append(result.n_true_labels)
            IoU_dict["n_diff"].append(
                result.n_true_labels - result.n_pred_labels
            )


def generate_ap_scores(df, name, thresholds=THRESHOLDS):
    """The AP curve over ``thresholds`` from the per-chunk counts (int64
    sums, as pandas' ``Series.sum``), as a column dict."""
    ap_scores = {"average_precision": [], "threshold": []}
    for t in thresholds:
        ap_scores["threshold"].append(t)
        tp = np.asarray(df[f"t{t}_true_positives"]).sum()
        fp = np.asarray(df[f"t{t}_false_positives"]).sum()
        fn = np.asarray(df[f"t{t}_false_negatives"]).sum()
        denom = tp + fn + fp
        ap_scores["average_precision"].append(tp / denom if denom else 0.0)
    return {"average_precision": np.asarray(ap_scores["average_precision"],
                                            dtype=np.float64),
            "threshold": np.asarray(ap_scores["threshold"], dtype=np.float64),
            "model_name": _names(name, len(thresholds))}


def plot_accuracy_metrics(
    data,
    prefix: str,
    save_dir: str,
    name: str,
    variation_of_information: bool,
    average_precision: bool,
    object_count: bool,
    show: bool = True,
):
    """Render VI / AP / count-difference plots
    (parity: metrics.py:265-306)."""
    from .plots import VI_plot, plot_AP, plot_count_difference

    df0, df1 = data
    if variation_of_information:
        VI_path = os.path.join(save_dir, f"{prefix}_{name}_VI_plot.pdf")
        VI_plot(df0, cond_ent_over="VI: GT | Output",
                cond_ent_under="VI: Output | GT", save=VI_path, show=show)
    if average_precision:
        AP_path = os.path.join(save_dir, f"{prefix}_{name}_AP_plot.pdf")
        plot_AP([df1], [prefix], AP_path, "Average precision", show=show)
    if object_count:
        OD_path = os.path.join(save_dir, f"{prefix}_{name}_OD_plot.pdf")
        plot_count_difference(df0, "Object count difference", OD_path,
                              show=show)


def affinity_sum_graph(img, affs=(1, 2, 3, 5, 10, 20, 40)):
    """Experimental image-texture curve (parity: metrics.py:380-392).

    For each order ``a`` in ``affs``, difference the image ``a`` times
    along every axis and record the absolute normalised sum
    ``|sum(diff)| / diff.size``, summed over axes — a cheap smoothness /
    drift signature across scales. Upstream ships this experimental and
    unused; kept for symbol parity.

    Returns ``(list(affs), results)`` with one scalar per order.
    """
    img = np.asarray(img)
    results = []
    for a in affs:
        total = 0.0
        for ax in range(img.ndim):
            d = np.diff(img, n=a, axis=ax)
            total += np.abs(np.sum(d) / d.size)
        results.append(total)
    return list(affs), results
