#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``iterseg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (or
several: phases ``multi`` and ``space`` use them all), the CUDA toolkit (``nvcc``) and
``g++``. It imports nothing of JAX or of
``iterseg_tpu``. Phases, each printing one JSON line:

1. the card (``nvidia-smi`` name and power limit) and the build: the two
   CUDA flood kernels and the window-attention kernel (``nvcc``, sm_90a),
   the host C++ floods and the zstd decoder (``g++``), all started
   together, into
   ``build/iterseg_tpu_torch``;
2. kernel vs plain: the CUDA affinity flood and its plain torch version on a
   seeded smooth (33, 256, 256) fixture, and the CUDA image flood and its
   plain version on a seeded −EDT (33, 256, 256) fixture, ``inner_cap`` 1
   and 4 — labels equal bit for bit, the same step count and the same
   tile-steps as the plain frontier schedule, converged, two kernel
   launches (init and the one persistent step kernel) per flood;
3. forward parity: one (10, 256, 256) chunk through the full-width U-Net
   (``iterseg_tpu/data/default_unet.npz``, ~10.0 M parameters) on the card
   with TF32 off and on the CPU, max-abs <= 5e-4;
4. the main path on one (33, 512, 512) uint16 volume through
   ``affinity_unet_watershed`` with ``device_flood=False`` (exact host
   flood) and ``"pallas"`` (the CUDA flood): two kernel launches per
   flood, no flood fell back, the native host library loaded, equal label
   support and id sets, agreement >= 0.9; plus the fast path against the
   generic ``predict_volume`` + ``segment_output_image`` path, bit-equal;
5. a (2, 33, 256, 256) stack through ``segment_stack``: every frame labelled;
6. the DoG path on the same (33, 512, 512) uint16 volume through
   ``dog_blob_watershed`` with ``device_flood=False`` (exact host bucket
   flood) and ``"pallas"`` (the CUDA image flood): two image kernel
   launches per flood, no flood fell back, no warning, the native library
   loaded, equal label support and id sets, agreement >= 0.9; plus, on a (33, 256,
   256) float volume, the card's ``DoGPipeline`` against the host path and
   against the port's own CPU run, bit-equal;
7. a (2, 33, 256, 256) stack through ``dog_blob_watershed``: every frame
   labelled;
8. ``floods`` (one line a pipeline, and one ``card_vs_cpu`` line): the
   device floods of ROADMAP slice 3 through both segmenters on the same
   (33, 512, 512) volume. ``"exact"``: labels bit-equal to phases 4 and 6's
   default-flood labels, with its path, uncertain and tie fractions and
   the certificate's seconds. ``"xla"``: equal support and ids, agreement
   >= 0.9, no fallback, labels bit-equal to the CUDA flood's (the same
   claim rule at ``inner_cap=1``), with ``n_iters``. ``"pallas"`` with
   ``flood_telemetry`` (affinity): the labels' disagreement with the
   default flood within ``flood_disagreement_bound``, the certificate
   converged. ``True``: the probed link rate, ``linkprobe.MEASURED``, what
   ``True`` resolved to (``"pallas"`` or ``False``, never ``"xla"``) and
   the crossover ``W*`` from phases 4 and 6's profiles. The certificate's
   seconds a phase on the inputs each path gave it. Then on a seeded
   (16, 128, 128) fixture, card against CPU bit for bit: the certificate
   (all five outputs), the verified flood with both guards off (the
   repair runs; when resolved, equal to the host heap) and
   ``wavefront_flood`` in both modes;
9. ``train_parity``: one train-mode forward and backward of the full-width
   U-Net (``default_unet.npz``) on a seeded (10, 64, 64) batch with targets
   from the port's ``get_training_labels``, on the card and on the CPU:
   BCE loss within 1e-5 relative, every gradient within 5e-3 x the largest
   gradient, the new BatchNorm running stats within 1e-5 of each
   statistic's largest magnitude;
10. ``train``: ``run_experiment`` on the card fine-tunes ``default_unet.npz``
   for 2 epochs on (10, 256, 256) chunks of the (33, 512, 512) volume
   (ground truth: its thresholded blobs, labelled): finite losses, CSV rows,
   per-epoch and final checkpoints, validation TIFFs read back by the port's
   reader, and the final checkpoint segments the volume through
   ``affinity_unet_watershed``, launching neither flood kernel; with ms a
   step, voxels/s, peak memory, the step's FLOP bound and a CUDA-event
   split of one step;
11. ``loop``: iterseg's loop through the CLI (``cli.main``, in this
   process) on the same volume, saved as a zarr store: ``segment
   --device-flood pallas`` with each segmenter (two launches of its flood
   kernel, none of the other, labels bit-equal to phases 4 and 6); ground
   truth harvested from two 128 x 128 ROIs of phase 4's default-flood labels
   (``_ground_truth_from_ROI``); ``train`` on it (1 epoch, ``--n-each 2``);
   ``segment --network`` with the new checkpoint and the default flood (no
   kernel launch); and ``widgets.model_assessment`` of that segmentation
   against the default-flood labels (scores, stats and AP CSVs, finite rows,
   VI >= 0). The CLI's ``assess`` is not called: it plots, and the card's
   machine may have no matplotlib;
12. ``serve``: ``serve --once`` with ``{"unet": "default", "device_flood":
   "pallas"}`` drains a watch directory of three zarr stores (phase 4's
   volume, a second (33, 512, 512) volume, a (2, 33, 256, 256) stack): exit
   status 0, three ``.done`` markers, two affinity launches a frame, the
   first volume's labels bit-equal to ``loop``'s CLI labels; each volume's
   seconds from its marker (the first pays the server's U-Net load);
13. ``multi`` (one line each: ``multi_cards``, ``multi_frames`` a
   pipeline, ``multi_pod``, ``multi_train``): every card, listed twice
   when there is one (``[cuda:0, cuda:0]``), so the round-robin and its
   lookahead run. A (4, 33, 512, 512) uint16 stack through
   ``affinity_unet_watershed`` and ``dog_blob_watershed`` with
   ``"pallas"`` on the list: labels bit-equal to one card, two launches
   of the path's flood kernel a frame, no fallback. Two processes of
   ``python -m iterseg_tpu_torch pod-segment`` joined by gloo over a zarr
   of the stack (the shipped U-Net, ``"pallas"``, ``--gt``): each owns
   frames ``t % 2 == id``, the shared output equals one process's labels
   and the metrics CSVs one process's ``get_accuracy_metrics`` bytes.
   Data-parallel training on the full-width ``default_unet.npz``, five
   (10, 256, 256) chunks over the list (the last step repeat-padded): the
   first step against the same step over ``[cpu, cpu]`` with phase 9's
   bounds, then one epoch of ``train_unet(mesh=...)`` on the cards (ms a
   step, peak memory a card);
14. ``space`` (one line each: ``space_apply``, ``space_predict``,
   ``space_train``): the mesh's ``space`` axis, each chunk's x split over
   ``make_mesh()``'s cards with halo exchanges, or over the one card listed
   four times (a (1, 4) mesh). One (10, 256, 256) chunk through
   ``sharded_apply`` against one card's forward (max-abs <= 1e-5, ms and
   peak GB a card each); the (33, 512, 512) volume through
   ``sharded_predict_volume`` against ``predict_volume`` (<= 1e-5), each
   feature map flooded by the CUDA affinity kernel with the seeds and mask
   of ``segment_output_image`` (two launches a flood; labels bit-equal
   when the features are, else the agreement printed); the first train
   step against the same step over the CPU with phase 9's bounds, then
   ``train_unet`` on the mesh (``n_devices=`` on several cards) and the
   batch-1 loop on one card over five (10, 256, 256) chunks (ms a step,
   peak GB a card);
15. ``orbax``: checkpoints without orbax (no orbax, tensorstore or
   zstandard on this machine). The committed fixture
   ``tests/data/torch_orbax`` (written by orbax: an OCDBT checkpoint with
   zstd chunks and a plain one) reads equal to its ``.npz``, with the C++
   zstd decoder's MB/s on its largest chunk; ``default_unet.npz`` goes
   through the CLI's ``convert`` to an orbax directory and back, bit for
   bit, with the directory's and the ``.npz``'s load seconds; and
   ``affinity_unet_watershed(unet=<that directory>, device_flood="pallas")``
   on phase 4's volume gives phase 4's ``"pallas"`` labels bit for bit,
   with two affinity kernel launches;
16. ``swin``: a Swin UNETR (MONAI v1, feature size 48, 62.2 M seeded
   parameters) written as a MONAI-named ``.pt`` and run through
   ``affinity_unet_watershed`` on a (96, 512, 512) uint16 volume in 96^3
   chunks at margin 12 with the host flood: 8 launches of the
   window-attention kernel a microbatch over that call (two blocks a
   stage), the call's seconds and objects; then the kernel against its
   plain version (<= 1e-5) and ``scaled_dot_product_attention`` (the same
   bias and mask as an additive tensor) on stage 0's (49, 49, 49) grid at
   the program's microbatch, unshifted and shifted, and on stage 3's
   clipped 6^3 window (24 heads);
17. the ``kernels`` line: each hand-written kernel timed on the inputs its
   path gave it, against its plain version, with its launches on its path,
   its bound, and for the floods their steps and tile-steps (equal to the
   plain frontier schedule's) and the split of their time into the init
   kernel and the step kernel; the window-attention kernel's row has
   phase 16's stage-0 numbers, with SDPA's ms as ``library_ms``;
18. ``host_flood``: the exact host flood's bucketed queue
   (``native.priority_flood``) against its heap (``priority_flood_heap``)
   on a seeded (96, 512, 512) frame, a blob mask of 12.5% and 4,900 seeds,
   with smooth sigmoid affinities (gain 4) and saturated ones (gain 40):
   labels equal voxel for voxel, no fallback, both times (the host's, not
   the card's) and each one's peak queue size.

Then the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without CUDA the script exits 2 and prints no result.
"""
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    """A failed phase raises (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def smooth_fixture(shape, n, seed):
    """Smooth affinity field with ridges at object boundaries and seeds at
    object peaks: the flood's realistic input class."""
    import numpy as np
    from scipy import ndimage as ndi

    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(3, s - 3, size=n) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1.5, 3, 3))
    vol /= vol.max()
    aff = np.stack([1.0 - vol] * 3).astype(np.float32)
    mask = vol > 0.08
    for a in range(3):
        mask[(slice(None),) * a + (0,)] = False
        mask[(slice(None),) * a + (-1,)] = False
    peaks = np.argwhere((vol == ndi.maximum_filter(vol, size=5)) & mask)
    seeds = np.zeros(shape, np.int32)
    seeds[tuple(peaks.T)] = np.arange(1, len(peaks) + 1, dtype=np.int32)
    return aff, seeds, mask


def blob_volume(shape, n, seed):
    """Seeded synthetic uint16 microscopy-like volume of blurred blobs."""
    import numpy as np
    from scipy import ndimage as ndi

    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(2, s - 2, size=n) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1, 4, 4))
    vol = vol / vol.max() * 50000 + r.integers(0, 500, size=shape)
    return vol.astype(np.uint16)


def edt_fixture(shape, n, seed):
    """Seeded blobs -> mask, values = -EDT, labelled markers at the
    distance peaks: the image flood's input class on the DoG path."""
    import numpy as np
    from scipy import ndimage as ndi

    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(3, s - 3, size=n) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1.5, 4, 4))
    vol /= vol.max()
    mask = vol > 0.15
    dist = ndi.distance_transform_edt(mask)
    peaks = np.argwhere((dist == ndi.maximum_filter(dist, size=3)) & mask)
    markers = np.zeros(shape, np.int32)
    markers[tuple(peaks.T)] = 1
    markers, _ = ndi.label(markers)
    return (-dist).astype(np.float32), markers.astype(np.int32), mask


def blob_labels(vol):
    """Ground truth of a ``blob_volume``: its blobs above a quarter of the
    maximum, labelled by 6-connectivity."""
    import numpy as np
    from scipy import ndimage as ndi

    return ndi.label(vol > 0.25 * vol.max())[0].astype(np.int32)


def train_step_on(params, x, y, device):
    """One train-mode forward and backward of a fresh U-Net holding
    ``params``, on ``device``: (BCE loss, gradients, new running stats),
    the tensors on the CPU, by state-dict key."""
    import torch

    from iterseg_tpu_torch.device import f32_numerics
    from iterseg_tpu_torch.models.convert import params_from_numpy
    from iterseg_tpu_torch.train.losses import bce_loss

    net = params_from_numpy(params).to(device).train()
    with f32_numerics():
        loss = bce_loss(net(torch.from_numpy(x).to(device)),
                        torch.from_numpy(y).to(device))
        loss.backward()
    grads = {k: p.grad.cpu() for k, p in net.named_parameters()}
    stats = {k: v.cpu() for k, v in net.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return float(loss.detach()), grads, stats


def conv_flops(net, x):
    """Forward FLOPs of every convolution of ``net`` on ``x`` (2 per
    multiply-add), counted by hooks from the shapes each one sees."""
    import math

    import torch

    total = []

    def hook(m, inp, out):
        total.append(2 * out.numel() * m.in_channels // m.groups
                     * math.prod(m.kernel_size))

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, torch.nn.Conv3d)]
    with torch.no_grad():
        net(x)
    for h in hooks:
        h.remove()
    return sum(total)


def run_training(vol, chans, dev, chunk=(10, 256, 256), margin=(1, 64, 64)):
    """``run_experiment`` fine-tunes ``default_unet.npz`` for two epochs on
    ``chunk``-shaped crops of ``vol`` on ``dev``; checks its outputs and
    that the checkpoint segments ``vol``; returns the phase's line."""
    import statistics
    import tempfile

    import numpy as np
    import torch

    from iterseg_tpu_torch.device import f32_numerics
    from iterseg_tpu_torch.engine.predict import DEFAULT_UNET_PATH, load_unet
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed
    from iterseg_tpu_torch.helpers import read_csv, read_tiff
    from iterseg_tpu_torch.train.experiments import (get_experiment_dict,
                                                     run_experiment)
    from iterseg_tpu_torch.train.losses import bce_loss

    epochs = 2
    prof = {}
    exp = get_experiment_dict(
        [chans], ["finetune"],
        [{"epochs": epochs, "weights": DEFAULT_UNET_PATH, "profile": prof}],
        name="smoke-train", n_each=6, validation_prop=0.34)
    exp["get_train_data"]["rng"] = np.random.default_rng(7)
    exp["get_train_data"]["shape"] = chunk
    gt = blob_labels(vol)
    with tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (path,) = run_experiment(exp, [vol], [gt], out_dir, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        cond = os.path.dirname(path)
        loss = read_csv(os.path.join(cond, "loss_finetune.csv"))
        val = read_csv(os.path.join(cond, "validation-loss_finetune.csv"))
        n_train = len(loss["loss"]) // epochs
        n_val = len(val["validation_loss"]) // (1 + epochs)
        check(n_train >= 1 and n_val >= 1 and n_train + n_val <= 6,
              f"chunks: {n_train} train, {n_val} validation")
        check(len(loss["loss"]) == n_train * epochs
              and len(val["validation_loss"]) == n_val * (1 + epochs),
              "CSV rows")
        check(all(np.isfinite(loss[c]).all() for c in ("loss",) + chans)
              and np.isfinite(val["validation_loss"]).all(),
              "a non-finite loss")
        names = os.listdir(cond)
        for e in range(epochs):
            check(any(n.endswith(f"_unet_finetune_epoch-{e}.npz")
                      for n in names), f"no epoch-{e} checkpoint")
        tifs = sorted(n for n in names if n.endswith("_output.tif"))
        check(len(tifs) == n_val, f"{len(tifs)} validation TIFFs")
        for n in tifs:
            pages = read_tiff(os.path.join(cond, n))
            check(pages.shape == (len(chans) * chunk[0],) + chunk[1:]
                  and np.isfinite(pages).all(), f"TIFF {n} {pages.shape}")
        model = load_unet(path)
        t0 = time.perf_counter()
        labels = affinity_unet_watershed(None, vol, None, "smoke-trained",
                                         path, chunk_size=chunk,
                                         margin=margin, debug=True,
                                         devices=[dev])
        seg_s = time.perf_counter() - t0
        check(labels.shape == vol.shape and int(labels.max()) > 0,
              "the fine-tuned U-Net segmented nothing")
    steps = prof["step_s"]
    median_s = statistics.median(steps[1:])
    # one step at the chunk shape, split by CUDA events: forward (with the
    # graph kept for backward), backward, the two Adam steps
    net = model.module(dev).train()
    opt = torch.optim.Adam(net.parameters(), lr=0.01)
    x = torch.rand((1, 1) + chunk, device=dev, generator=torch.Generator(
        dev).manual_seed(0))
    y = (torch.rand((1, len(chans)) + chunk, device=dev) > 0.5).float()
    with f32_numerics():
        flops = conv_flops(net, x)
        fwd_ms = cuda_ms(lambda: bce_loss(net(x), y))

        def fwd_bwd():
            opt.zero_grad(set_to_none=True)
            bce_loss(net(x), y).backward()

        fwd_bwd_ms = cuda_ms(fwd_bwd)
        adam_ms = cuda_ms(lambda: (opt.step(), opt.step()))
    bound_ms = 3 * flops / F32_OPS_PER_S * 1e3
    return {"phase": "train", "chunk": list(chunk), "epochs": epochs,
            "train_chunks": n_train, "validation_chunks": n_val,
            "losses_first_last": [loss["loss"][0], loss["loss"][-1]],
            "validation_first_last": [val["validation_loss"][0],
                                      val["validation_loss"][-1]],
            "first_step_ms": steps[0] * 1e3,
            "median_step_ms": median_s * 1e3,
            "step_ms": [s * 1e3 for s in steps],
            "train_voxels_per_s": int(np.prod(chunk)) / median_s,
            "load_ms_median": statistics.median(prof["load_s"]) * 1e3,
            "validation_s": prof["validation_s"],
            "run_experiment_s": run_s, "peak_bytes": peak,
            "forward_conv_flops": flops, "flop_bound_ms": bound_ms,
            "bound_share": bound_ms / (median_s * 1e3),
            "split_ms": {"forward": fwd_ms, "backward": fwd_bwd_ms - fwd_ms,
                         "adam_x2": adam_ms},
            "segment_s": seg_s, "segment_objects": int(labels.max())}


def read_zarr(path):
    """A zarr store (level 0 of an OME-Zarr one), as numpy."""
    import numpy as np

    from iterseg_tpu_torch.io.zarr_io import zarr_open

    return np.asarray(zarr_open(path))


def save_volume(path, data):
    """``data`` as a zarr store at ``path``, one chunk a frame."""
    from iterseg_tpu_torch.io.zarr_io import open_zarr

    arr = open_zarr(path, shape=data.shape,
                    chunks=(1,) * (data.ndim - 3) + data.shape[-3:],
                    dtype=data.dtype)
    arr[...] = data
    return path


def cli_segment(argv):
    """``python -m iterseg_tpu_torch segment ...`` in this process, with
    both floods' launch counts set to 0 just before and read just after;
    returns ({flood: launches}, seconds)."""
    import torch

    from iterseg_tpu_torch.cli import main
    from iterseg_tpu_torch.ops import flood_kernel as fk
    from iterseg_tpu_torch.ops import image_flood_kernel as ifk

    fk.reset_launches()
    ifk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(main(["segment"] + argv) == 0, f"segment {argv} failed")
    torch.cuda.synchronize()
    return ({"affinity_flood": fk.launches(), "image_flood": ifk.launches()},
            time.perf_counter() - t0)


def run_loop(vol, main_labels, dog_labels, work):
    """Phase ``loop``: iterseg's loop through the CLI on ``vol`` (segment
    with each CUDA flood, harvest ground truth from two ROIs, train,
    segment with the new checkpoint, assess); returns the phase's line and
    the affinity CLI labels."""
    import numpy as np

    from iterseg_tpu_torch import widgets
    from iterseg_tpu_torch.cli import main
    from iterseg_tpu_torch.core.chunks import get_slices_from_chunks
    from iterseg_tpu_torch.helpers import read_csv
    from iterseg_tpu_torch.viewer import Viewer

    src = save_volume(os.path.join(work, "vol.zarr"), vol)
    out = os.path.join(work, "seg")
    line = {"phase": "loop", "shape": list(vol.shape)}
    # 1-2. both segmenters with the CUDA flood, against phases 4 and 6
    runs = {}
    for name, flood, extra, want in (
            ("affinity", "affinity_flood", [], main_labels["pallas"]),
            ("dog", "image_flood", ["--segmenter", "DoG-blob-watershed"],
             dog_labels["pallas"])):
        launches, seconds = cli_segment([
            "--input", src, "--output-dir", out, "--name", name,
            "--device-flood", "pallas"] + extra)
        labels = read_zarr(os.path.join(out, f"{name}.ome.zarr"))
        check(launches == {"affinity_flood": 0, "image_flood": 0,
                           flood: 2},
              f"CLI {name} flood: {launches} launches, not 2")
        check(np.array_equal(labels, want),
              f"CLI {name} labels differ from the direct call's")
        runs[name] = labels
        line[f"segment_{name}_pallas"] = {
            "launches": launches, "seconds": seconds,
            "voxels_per_s": vol.size / seconds, "equal_to_direct": True,
            "objects": int(labels.max())}
    # 3. harvest ground truth from two 128 x 128 ROIs of the default labels
    viewer = Viewer()
    image = viewer.add_image(vol, name="image")
    truth = viewer.add_labels(main_labels["host"], name="labels")
    rois = viewer.add_shapes(
        [np.array([[0, y, x], [0, y, x + 127], [0, y + 127, x + 127],
                   [0, y + 127, x]], float)
         for y, x in ((64, 64), (vol.shape[1] - 192, vol.shape[2] - 192))],
        name="rois")
    np.random.seed(0)
    t0 = time.perf_counter()
    widgets._ground_truth_from_ROI(viewer, image, truth, rois, work,
                                   "roi-gt")
    harvest_s = time.perf_counter() - t0
    gt_frames = read_zarr(os.path.join(work, "roi-gt_labels.zarr"))
    check(gt_frames.shape == (2,) + vol.shape and gt_frames.max() > 0,
          f"harvested ground truth {gt_frames.shape}")
    # 4. train on the harvested frames
    t0 = time.perf_counter()
    check(main(["train", "--images", os.path.join(work, "roi-gt_img.zarr"),
                "--labels", os.path.join(work, "roi-gt_labels.zarr"),
                "--output-dir", os.path.join(work, "train"),
                "--training-name", "loop", "--epochs", "1", "--n-each", "2",
                "--validation-prop", "0.5", "--no-predict"]) == 0,
          "train failed")
    train_s = time.perf_counter() - t0
    ckpts = [os.path.join(d, f)
             for d, _, files in os.walk(os.path.join(work, "train"))
             for f in files if f.endswith("_unet_loop.npz")]
    check(len(ckpts) == 1, f"checkpoints: {ckpts}")
    # 5. segment with the new checkpoint and the default flood
    launches, retrained_s = cli_segment([
        "--input", src, "--output-dir", out, "--name", "retrained",
        "--network", ckpts[0]])
    check(launches == {"affinity_flood": 0, "image_flood": 0},
          f"the default flood launched a kernel: {launches}")
    retrained = read_zarr(os.path.join(out, "retrained.ome.zarr"))
    check(retrained.shape == vol.shape, f"labels {retrained.shape}")
    # 6. assess against the default-flood labels (the CLI's assess also
    # plots, and this machine may have no matplotlib)
    assess_dir = os.path.join(work, "assess")
    slices = get_slices_from_chunks(vol.shape, (10, 256, 256), (1, 64, 64))
    t0 = time.perf_counter()
    (scores, ap), stats = widgets.model_assessment(
        main_labels["host"], retrained, "loop", "retrained", slices,
        assess_dir, True, True, True, 10)
    assess_s = time.perf_counter() - t0
    for f in ("scores", "stats", "AP_curve"):
        check(os.path.exists(os.path.join(assess_dir,
                                          f"loop_retrained_{f}.csv")),
              f"no {f} CSV")
    table = read_csv(os.path.join(assess_dir, "loop_retrained_scores.csv"))
    numbers = [c for c in table if c != "model_name"]
    check(len(table["model_name"]) >= 2 and ap is not None,
          f"{len(table['model_name'])} assessed chunks")
    check(all(np.isfinite(np.asarray(table[c], float)).all()
              for c in numbers), "a non-finite score")
    vi = np.asarray(table["VI: GT | Output"] + table["VI: Output | GT"])
    check((vi >= 0).all(), "a negative VI")
    line.update({
        "harvest_s": harvest_s, "harvested_shape": list(gt_frames.shape),
        "train_s": train_s, "checkpoint": os.path.basename(ckpts[0]),
        "retrained_segment_s": retrained_s,
        "retrained_flood_launches": launches,
        "retrained_objects": int(retrained.max()),
        "assess_s": assess_s, "assessed_chunks": len(table["model_name"]),
        "vi_gt_given_output_mean": float(np.mean(
            table["VI: GT | Output"])),
        "vi_output_given_gt_mean": float(np.mean(
            table["VI: Output | GT"])),
        "ap_at_0.5": float(ap["average_precision"][4]),
        "cli_assess": "not run: it plots, and matplotlib may be absent here",
    })
    return line, runs["affinity"]


def run_serve(vol, stack, loop_labels, work):
    """Phase ``serve``: ``serve --once`` drains a watch directory of three
    stores with a ``"pallas"`` config; returns the phase's line."""
    import numpy as np

    from iterseg_tpu_torch.cli import main
    from iterseg_tpu_torch.ops import flood_kernel as fk

    watch_dir, out = os.path.join(work, "in"), os.path.join(work, "out")
    os.makedirs(watch_dir)
    inputs = (("a-vol", vol), ("b-vol", blob_volume(vol.shape, 900, 8)),
              ("c-stack", stack))
    now = time.time()
    for i, (stem, data) in enumerate(inputs):
        path = save_volume(os.path.join(watch_dir, stem + ".zarr"), data)
        os.utime(path, (now - 60 + i, now - 60 + i))  # served in this order
    cfg = os.path.join(work, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"unet": "default", "device_flood": "pallas"}, f)
    fk.reset_launches()
    t0 = time.perf_counter()
    rc = main(["serve", "--watch-dir", watch_dir, "--output-dir", out,
               "--network", cfg, "--once"])
    serve_s = time.perf_counter() - t0
    launches = fk.launches()
    check(rc == 0, f"serve exited {rc}")
    frames = sum(1 if d.ndim == 3 else d.shape[0] for _, d in inputs)
    check(launches == 2 * frames,
          f"serve: {launches} affinity launches for {frames} frames")
    seconds, served = {}, {}
    for stem, data in inputs:
        marker = os.path.join(out, stem + ".done")
        check(os.path.exists(marker), f"no marker {marker}")
        with open(marker) as f:
            seconds[stem] = float(f.read().splitlines()[1].rstrip("s"))
        served[stem] = read_zarr(os.path.join(out, stem + ".ome.zarr"))
        check(served[stem].shape == data.shape
              and int(served[stem].max()) > 0, f"served {stem}")
    check(np.array_equal(served["a-vol"], loop_labels),
          "served labels differ from the CLI's")
    return {"phase": "serve", "inputs": {s: list(d.shape) for s, d in inputs},
            "config": {"unet": "default", "device_flood": "pallas"},
            "exit_status": rc, "affinity_launches": launches,
            "frames": frames, "equal_to_cli": True,
            "seconds": seconds, "serve_s": serve_s,
            "cold_voxels_per_s": vol.size / seconds["a-vol"],
            "warm_voxels_per_s": vol.size / seconds["b-vol"],
            "stack_voxels_per_s": stack.size / seconds["c-stack"],
            "objects": {s: int(v.max()) for s, v in served.items()}}


def run_multi(work, kwargs):
    """Phase ``multi``: every card (``[cuda:0, cuda:0]`` on a one-card
    machine, so the round-robin and its lookahead still run), frame
    parallelism in both pipelines, a two-process ``pod-segment`` and
    data-parallel training. Returns the phase's lines."""
    import socket

    import numpy as np
    import torch

    from iterseg_tpu_torch.core.chunks import get_slices_from_chunks
    from iterseg_tpu_torch.engine import device_pipeline as dp
    from iterseg_tpu_torch.engine.segmentation import (
        affinity_unet_watershed, dog_blob_watershed)
    from iterseg_tpu_torch.eval.metrics import get_accuracy_metrics
    from iterseg_tpu_torch.ops import flood_kernel as fk
    from iterseg_tpu_torch.ops import image_flood_kernel as ifk

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(n_cards)]
    if n_cards == 1:
        devices = devices * 2
    distinct = len(set(devices))
    lines = [{"phase": "multi_cards", "device_count": n_cards,
              "names": [torch.cuda.get_device_name(i)
                        for i in range(n_cards)],
              "devices": [str(d) for d in devices],
              "distinct_cards": distinct}]

    # frame parallelism: a (4, 33, 512, 512) stack, both pipelines, one
    # card against the list, two launches of the path's flood a frame
    stack = np.stack([blob_volume((33, 512, 512), 900, s)
                      for s in (20, 21, 22, 23)])
    frames = {}
    for name, call, launches, reset in (
            ("affinity", lambda devs: affinity_unet_watershed(
                None, stack, None, "multi", None, devices=devs,
                device_flood="pallas", **kwargs),
             fk.launches, fk.reset_launches),
            ("dog", lambda devs: dog_blob_watershed(
                None, stack, None, "multi-dog", None, devices=devs,
                device_flood="pallas", debug=True),
             ifk.launches, ifk.reset_launches)):
        got, secs, counts = {}, {}, {}
        # "all_first": each further card builds its U-Net replica and
        # initialises its libraries at its first frame; "all" is warm
        for key, devs in (("one", devices[:1]), ("all_first", devices),
                          ("all", devices)):
            reset()
            dp.reset_flood_fallbacks()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got[key] = np.asarray(call(devs))
            for d in set(devs):
                torch.cuda.synchronize(d)
            secs[key] = time.perf_counter() - t0
            counts[key] = launches()
            check(dp.flood_fallbacks() == 0, f"multi {name}: a fallback")
            check(counts[key] == 2 * len(stack),
                  f"multi {name}: {counts[key]} launches for "
                  f"{len(stack)} frames")
        check(got["one"].shape == stack.shape
              and all(int(f.max()) > 0 for f in got["one"]),
              f"multi {name}: an unlabelled frame")
        check(np.array_equal(got["all"], got["one"])
              and np.array_equal(got["all_first"], got["one"]),
              f"multi {name}: the device list changes the labels")
        frames[name] = got["one"]
        lines.append({"phase": "multi_frames", "pipeline": name,
                      "shape": list(stack.shape),
                      "devices": [str(d) for d in devices],
                      "distinct_cards": distinct, "launches": counts,
                      "equal_to_one_device": True, "seconds": secs,
                      "voxels_per_s": {k: stack.size / v
                                       for k, v in secs.items()}})

    # the pod: two processes of pod-segment joined by gloo over a zarr of
    # the stack, the shipped U-Net with the CUDA flood, sharded metrics
    gt = np.stack([blob_labels(f) for f in stack]).astype(np.uint32)
    inp = save_volume(os.path.join(work, "in.zarr"), stack)
    gtp = save_volume(os.path.join(work, "gt.zarr"), gt)
    cfg = os.path.join(work, "pod.json")
    with open(cfg, "w") as f:
        json.dump({"unet": "default", "device_flood": "pallas"}, f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(work, "pod.zarr")
    argv = ["pod-segment", "--input", inp, "--output", out, "--network",
            cfg, "--gt", gtp, "--metrics-dir", os.path.join(work, "pod-m"),
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "iterseg_tpu_torch"] + argv
        + ["--process-id", str(pid)], cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    pod_s = time.perf_counter() - t0
    for pid, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"pod process {pid} exited {p.returncode}:\n{text[-3000:]}")
        mine = [t for t in range(len(stack)) if t % 2 == pid]
        check(f"host frames: {mine}" in text,
              f"pod process {pid} did not own {mine}:\n{text[-2000:]}")
    pod = read_zarr(out)
    check(np.array_equal(pod, frames["affinity"].astype(np.uint32)),
          "pod labels differ from one process's")
    slices = get_slices_from_chunks(pod.shape, kwargs["chunk_size"],
                                    kwargs["margin"])
    one_dir = os.path.join(work, "one-m")
    get_accuracy_metrics(slices, gt, frames["affinity"], "pod",
                         "pod-metrics", out_path=one_dir)
    names = sorted(os.listdir(one_dir))
    check(names and sorted(os.listdir(os.path.join(work, "pod-m")))
          == names, f"pod metrics files {names}")
    for n in names:
        with open(os.path.join(one_dir, n), "rb") as a, open(
                os.path.join(work, "pod-m", n), "rb") as b:
            check(a.read() == b.read(), f"pod metrics {n} differ")
    lines.append({"phase": "multi_pod", "processes": 2,
                  "shape": list(stack.shape),
                  "process_devices": [str(torch.device(
                      "cuda", pid % n_cards)) for pid in (0, 1)],
                  "equal_to_one_process": True, "metrics_csvs": names,
                  "metrics_equal": True, "wall_s": pod_s,
                  "voxels_per_s": stack.size / pod_s})
    lines.append(run_dp_training(stack, devices, distinct, work))
    lines[-1]["multi_phase_s"] = time.perf_counter() - t_phase
    return lines


def run_dp_training(stack, devices, distinct, work):
    """Data-parallel training over ``devices`` on the full-width
    ``default_unet.npz``: five (10, 256, 256) chunks of ``stack``, so the
    third step's batch is repeat-padded. The first step against the same
    step over ``[cpu, cpu]`` (loss, every gradient, the running stats, with
    ``train_parity``'s bounds), then one epoch of ``train_unet(mesh=...)``
    on the cards; returns the phase's line."""
    import numpy as np
    import torch

    from iterseg_tpu_torch.engine.predict import DEFAULT_UNET_PATH, load_unet
    from iterseg_tpu_torch.helpers import read_csv
    from iterseg_tpu_torch.models.convert import params_from_numpy
    from iterseg_tpu_torch.parallel.mesh import Mesh, make_sharded_train_step
    from iterseg_tpu_torch.train.labels import get_training_labels
    from iterseg_tpu_torch.train.losses import make_loss_function
    from iterseg_tpu_torch.train.train import train_unet

    chans = ("z-1", "y-1", "x-1", "mask", "centreness-log")
    chunk = (10, 256, 256)
    xs, ys = [], []
    for i in range(5):
        z0, y0, x0 = 4 * i, 64 * (i % 3), 128 * (i % 2)
        crop = stack[i % len(stack), z0:z0 + chunk[0], y0:y0 + chunk[1],
                     x0:x0 + chunk[2]]
        xs.append((crop / crop.max()).astype(np.float32))
        ys.append(get_training_labels(blob_labels(crop), chans, (4, 1, 1),
                                      device=devices[0]).astype(np.float32))
    params = load_unet(None).params
    first = {}
    for name, devs in (("card", devices),
                       ("cpu", [torch.device("cpu")] * len(devices))):
        net = params_from_numpy(params).to(devs[0]).train()
        step = make_sharded_train_step(
            Mesh([[d] for d in devs]), net, make_loss_function("BCELoss"),
            torch.optim.SGD(net.parameters(), lr=0.0), double_step=False)
        t0 = time.perf_counter()
        loss = float(step(np.stack(xs[:len(devs)])[:, None],
                          np.stack(ys[:len(devs)]), 0))
        first[name] = (loss, {k: p.grad.cpu() for k, p in
                              net.named_parameters()},
                       {k: v.cpu() for k, v in net.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))},
                       time.perf_counter() - t0)
    card, host = first["card"], first["cpu"]
    loss_rel = abs(card[0] - host[0]) / abs(host[0])
    gmax = max(float(g.abs().max()) for g in host[1].values())
    grad_rel = max(float((card[1][k] - g).abs().max())
                   for k, g in host[1].items()) / gmax
    stats_rel = max(float((card[2][k] - v).abs().max() / v.abs().max())
                    for k, v in host[2].items())
    check(loss_rel <= 1e-5, f"DP loss card vs CPU: {loss_rel}")
    check(grad_rel <= 5e-3, f"DP gradients card vs CPU: {grad_rel}")
    check(stats_rel <= 1e-5, f"DP running stats card vs CPU: {stats_rel}")
    out_dir = os.path.join(work, "dp-train")
    cards = sorted(set(devices), key=str)
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    prof = {}
    t0 = time.perf_counter()
    train_unet(xs, [], ys, [], out_dir=out_dir, name="dp", channels=chans,
               epochs=1, validate=False, weights=DEFAULT_UNET_PATH,
               mesh=Mesh([[d] for d in devices]), profile=prof)
    epoch_s = time.perf_counter() - t0
    peaks = {str(d): torch.cuda.max_memory_allocated(d) for d in cards}
    rows = read_csv(os.path.join(out_dir, "loss_dp.csv"))
    dp = len(devices)
    want_ids = [";".join(dict.fromkeys(
        f"dp_{min(i, 4)}" for i in range(b, b + dp)))
        for b in range(0, 5, dp)]
    check(list(rows["data_id"]) == want_ids,
          f"DP steps {list(rows['data_id'])}, not {want_ids}")
    check(np.isfinite(rows["loss"]).all(), "a non-finite DP loss")
    epoch_rel = abs(rows["loss"][0] - card[0]) / abs(card[0])
    check(epoch_rel <= 1e-6, f"train_unet's first loss {rows['loss'][0]} "
          f"vs the first step's {card[0]}")
    return {"phase": "multi_train", "chunk": list(chunk), "chunks": 5,
            "devices": [str(d) for d in devices],
            "distinct_cards": distinct, "steps": len(rows["loss"]),
            "data_ids": list(rows["data_id"]), "loss": card[0],
            "loss_rel": loss_rel, "loss_bound": 1e-5, "grad_max": gmax,
            "grad_resid_rel": grad_rel, "grad_bound": 5e-3,
            "stats_resid_rel": stats_rel, "stats_bound": 1e-5,
            "first_step_s": {"card": card[3], "cpu": host[3]},
            "step_ms": [s * 1e3 for s in prof["step_s"]],
            "epoch_s": epoch_s, "peak_bytes": peaks}


def synced(fn, cards, reps=3):
    """``fn()``'s result and its mean wall ms over ``reps`` runs after one
    warm-up, each run ending in a synchronise of every card in ``cards``."""
    import torch

    out = fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        for d in cards:
            torch.cuda.synchronize(d)
    return out, (time.perf_counter() - t0) / reps * 1e3


def peak_gb(fn, cards):
    """``fn()``'s result and the peak GB it allocated on each card."""
    import torch

    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    out = fn()
    return out, {str(d): torch.cuda.max_memory_allocated(d) / 1e9
                 for d in cards}


def flood_features(feats, dev):
    """The CUDA affinity flood on a (5, z, y, x) feature map, with the
    seeds and mask that ``ops/watershed.segment_output_image`` takes from
    it (the card's feature prep, peaks, Otsu mask, size band). Returns the
    cropped labels and the flood's kernel launches."""
    import numpy as np
    import torch

    from iterseg_tpu_torch.ops import flood_kernel as fk
    from iterseg_tpu_torch.ops.cc import size_band_filter
    from iterseg_tpu_torch.ops.peaks import peak_local_max
    from iterseg_tpu_torch.ops.watershed import _prep_feature_maps

    aff, cent, otsu = _prep_feature_maps(*(
        torch.as_tensor(np.ascontiguousarray(f), device=dev)
        for f in (feats[:3], feats[4], feats[3])))
    centroids = peak_local_max(cent, threshold_abs=0.04) + 1
    mask = np.pad(feats[3] > np.float32(otsu.item()), 1)
    mask, centroids = size_band_filter(mask, centroids, min_area=10,
                                       max_area=10000000)
    seeds = torch.zeros(mask.shape, dtype=torch.int32, device=dev)
    seeds[tuple(torch.as_tensor(centroids.T, device=dev).long())] = (
        torch.arange(1, len(centroids) + 1, dtype=torch.int32, device=dev))
    before = fk.launches()
    labels, _, converged = fk.affinity_flood(
        aff, seeds, torch.from_numpy(mask).to(dev), inner_cap=1)
    n_launched = fk.launches() - before
    check(converged, "space_predict: the CUDA flood did not converge")
    return labels[1:-1, 1:-1, 1:-1].cpu().numpy(), n_launched


def run_space(vol, dev, t_main, chunk=(10, 256, 256), margin=(1, 64, 64)):
    """Phase ``space``: the mesh's ``space`` axis, each chunk's x split over
    the cards with halo exchanges. ``make_mesh()`` over every card, or
    ``[dev] * 4`` on a one-card machine; the eval forward of a ``chunk``,
    ``vol`` through ``sharded_predict_volume`` and the flood of its
    features, and the train step and ``train_unet`` on five chunks of
    ``vol``, each against one card (the step against the CPU). Returns the
    phase's lines."""
    import numpy as np
    import torch

    from iterseg_tpu_torch.engine.predict import (DEFAULT_UNET_PATH,
                                                  load_unet, predict_volume)
    from iterseg_tpu_torch.models.convert import params_from_numpy
    from iterseg_tpu_torch.parallel import mesh as pm
    from iterseg_tpu_torch.train.labels import get_training_labels
    from iterseg_tpu_torch.train.losses import make_loss_function
    from iterseg_tpu_torch.train.train import train_unet

    n_cards = torch.cuda.device_count()
    mesh = (pm.make_mesh() if n_cards > 1
            else pm.make_mesh(devices=[dev] * 4))
    dp, sp = mesh.shape["data"], mesh.shape["space"]
    devices = list(mesh.devices.flat)
    cards = sorted(set(devices), key=str)
    base = {"mesh": mesh.shape, "devices": [str(d) for d in devices],
            "distinct_cards": len(cards)}
    model = load_unet(None)
    lines = []

    # space_apply: one chunk a data row, against one card
    blobs = blob_volume(chunk, 60, 1).astype(np.float32)
    x = np.stack([blobs / blobs.max()] * dp)[:, None]
    run = pm.sharded_apply(pm.replicate_params(model.params, mesh),
                           model.spec, mesh)
    (got, peaks), ms = synced(lambda: peak_gb(lambda: run(x), cards), cards)
    (want, one_peak), one_ms = synced(lambda: peak_gb(
        lambda: model(x, device=dev), [dev]), [dev])
    err = float((got - want).abs().max())
    check(got.shape == (dp, 5) + chunk
          and bool(torch.isfinite(got).all()), f"space_apply {got.shape}")
    check(err <= 1e-5, f"space_apply: {err} against one card")
    lines.append(dict(base, phase="space_apply", shape=list(x.shape),
                      max_abs=err, bound=1e-5, ms=ms, one_card_ms=one_ms,
                      peak_gb=peaks, one_card_peak_gb=one_peak))

    # space_predict: the volume through the mesh and through one card, then
    # the CUDA flood of each feature map, two launches a flood
    v = (vol / vol.max()).astype(np.float32)
    grid = dict(chunk_size=chunk, margin=margin)
    t0 = time.perf_counter()
    feats = pm.sharded_predict_volume(model, v, mesh, **grid)
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = predict_volume(model, v, device=dev, **grid)
    one_s = time.perf_counter() - t0
    err = float(np.abs(feats - one).max())
    check(feats.shape == (5,) + v.shape and np.isfinite(feats).all(),
          f"space_predict features {feats.shape}")
    check(err <= 1e-5, f"space_predict: {err} against one card")
    labels, launches = flood_features(feats, dev)
    one_labels, one_launches = flood_features(one, dev)
    check(launches == one_launches == 2,
          f"space_predict: {launches}, {one_launches} flood launches")
    check(int(labels.max()) > 0, "space_predict: nothing labelled")
    features_equal = bool(np.array_equal(feats, one))
    sel = one_labels > 0
    agreement = float((labels[sel] == one_labels[sel]).mean())
    if features_equal:
        check(np.array_equal(labels, one_labels),
              "space_predict: equal features, labels differ")
    lines.append(dict(base, phase="space_predict", shape=list(v.shape),
                      max_abs=err, bound=1e-5,
                      features_equal=features_equal,
                      labels_equal=bool(np.array_equal(labels, one_labels)),
                      agreement=agreement, objects=int(labels.max()),
                      flood_launches=[launches, one_launches],
                      seconds=predict_s, one_card_seconds=one_s))

    # space_train: the first step against the same step over the CPU, with
    # train_parity's bounds, then train_unet on the mesh against one card
    chans = ("z-1", "y-1", "x-1", "mask", "centreness-log")
    xs, ys = [], []
    for i in range(5):
        z0, y0, x0 = (i * (s - c) // 4 for s, c in zip(vol.shape, chunk))
        crop = vol[z0:z0 + chunk[0], y0:y0 + chunk[1], x0:x0 + chunk[2]]
        xs.append((crop / crop.max()).astype(np.float32))
        ys.append(get_training_labels(blob_labels(crop), chans, (4, 1, 1),
                                      device=dev).astype(np.float32))
    first = {}
    for name, m in (("card", mesh), ("cpu", pm.Mesh(
            [[torch.device("cpu")] * sp] * dp))):
        net = params_from_numpy(model.params).to(m.devices.flat[0]).train()
        step = pm.make_sharded_train_step(
            m, net, make_loss_function("BCELoss"),
            torch.optim.SGD(net.parameters(), lr=0.0), double_step=False)
        t0 = time.perf_counter()
        loss = float(step(np.stack(xs[:dp])[:, None], np.stack(ys[:dp]), 0))
        first[name] = (loss, {k: p.grad.cpu() for k, p in
                              net.named_parameters()},
                       {k: v.cpu() for k, v in net.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))},
                       time.perf_counter() - t0)
    card, host = first["card"], first["cpu"]
    loss_rel = abs(card[0] - host[0]) / abs(host[0])
    gmax = max(float(g.abs().max()) for g in host[1].values())
    grad_rel = max(float((card[1][k] - g).abs().max())
                   for k, g in host[1].items()) / gmax
    stats_rel = max(float((card[2][k] - v).abs().max() / v.abs().max())
                    for k, v in host[2].items())
    check(loss_rel <= 1e-5, f"space loss card vs CPU: {loss_rel}")
    check(grad_rel <= 5e-3, f"space gradients card vs CPU: {grad_rel}")
    check(stats_rel <= 1e-5, f"space running stats card vs CPU: {stats_rel}")
    kw = dict(epochs=1, validate=False, weights=DEFAULT_UNET_PATH,
              channels=chans)
    prof, one_prof = {}, {}
    call = (dict(n_devices=n_cards) if n_cards > 1 else dict(mesh=mesh))
    _, train_peaks = peak_gb(lambda: train_unet(
        xs, [], ys, [], profile=prof, **call, **kw), cards)
    _, one_train_peak = peak_gb(lambda: train_unet(
        xs, [], ys, [], profile=one_prof, device=dev, **kw), [dev])
    check(len(prof["step_s"]) == -(-5 // dp), f"space steps {prof}")
    lines.append(dict(base, phase="space_train", chunk=list(chunk),
                      chunks=5, train_call=list(call), loss=card[0],
                      loss_rel=loss_rel, loss_bound=1e-5, grad_max=gmax,
                      grad_resid_rel=grad_rel, grad_bound=5e-3,
                      stats_resid_rel=stats_rel, stats_bound=1e-5,
                      first_step_s={"card": card[3], "cpu": host[3]},
                      step_ms=[s * 1e3 for s in prof["step_s"]],
                      one_card_step_ms=[s * 1e3
                                        for s in one_prof["step_s"]],
                      peak_gb=train_peaks, one_card_peak_gb=one_train_peak,
                      script_s=time.perf_counter() - t_main))
    return lines


def prod_fixture(shape, n, seed):
    """Three distinct smooth affinity channels (a trained U-Net's class,
    where the certificate certifies or repairs), seeds at the 5³ peaks."""
    import numpy as np
    from scipy import ndimage as ndi

    r = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(3, s - 3, size=n) for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (1.5, 3, 3))
    vol /= vol.max()
    aff = np.stack([ndi.gaussian_filter(
        1.0 - vol + r.normal(0, 0.01, shape).astype(np.float32), 0.5)
        for _ in range(3)]).astype(np.float32)
    mask = vol > 0.08
    for a in range(3):
        mask[(slice(None),) * a + (0,)] = False
        mask[(slice(None),) * a + (-1,)] = False
    peaks = np.argwhere((vol == ndi.maximum_filter(vol, size=5)) & mask)
    return aff, peaks, mask


def profiled_calls(cls):
    """Patch ``cls.segment`` so that every call records its profile dict;
    returns the list of dicts and a function that undoes the patch."""
    real = cls.segment
    profiles = []

    def segment(self, *args, profile=None, **kw):
        profiles.append({} if profile is None else profile)
        return real(self, *args, profile=profiles[-1], **kw)

    cls.segment = segment
    return profiles, lambda: setattr(cls, "segment", real)


def crossover_mbps(default, pallas):
    """``W*`` of one pipeline (``engine/linkprobe``'s derivation): the
    bytes the ``"pallas"`` path moves beyond the default path's, over the
    seconds it saves (the default's ``flood`` + ``gather_*`` less its
    ``device_flood``), in MB/s; 0 when it moves no more bytes, infinite
    when it saves no time."""
    def moved(p):
        return sum(v for k, v in p.items() if k.startswith("bytes_"))

    extra = moved(pallas) - moved(default)
    saved = (default["flood"] + sum(v for k, v in default.items()
                                    if k.startswith("gather_"))
             - pallas["device_flood"])
    w = float("inf") if saved <= 0 else max(extra, 0) / saved / 2 ** 20
    return {"extra_bytes": extra, "saved_s": saved, "w_mbps": w,
            "default_bytes": {k: v for k, v in default.items()
                              if k.startswith("bytes_")},
            "pallas_bytes": {k: v for k, v in pallas.items()
                             if k.startswith("bytes_")}}


def run_floods(vol, main_labels, dog_labels, profiles, dev, kwargs):
    """Phase ``floods``: the device floods of ROADMAP slice 3 through the
    entry points on phases 4's and 6's volume (``"exact"``, ``"xla"``,
    ``"pallas"`` with ``flood_telemetry``, ``True``), the certificate's
    time a phase on the inputs the paths gave it, the link crossover, and
    the certificate, the verified flood and both wavefront modes held card
    against CPU on a seeded (16, 128, 128) fixture. Returns the lines."""
    import numpy as np
    import torch

    from iterseg_tpu_torch.engine import device_pipeline as dp
    from iterseg_tpu_torch.engine import linkprobe
    from iterseg_tpu_torch.engine.segmentation import (
        affinity_unet_watershed, dog_blob_watershed)
    from iterseg_tpu_torch.ops import device_flood as df
    from iterseg_tpu_torch.ops import flood_exact as fe
    from iterseg_tpu_torch.ops.watershed import affinity_watershed

    lines = []
    captured = {}
    originals = {name: getattr(fe, name) for name in (
        "verified_exact_flood", "verified_exact_image_flood")}

    def capture(name):
        def run(*args, **kw):
            captured[name] = args[:3]  # the inputs the path gave the flood
            return originals[name](*args, **kw)
        return run
    for pipe, cls, entry, want_labels in (
            ("affinity", dp.AffinityPipeline, affinity_unet_watershed,
             main_labels),
            ("dog", dp.DoGPipeline, dog_blob_watershed, dog_labels)):
        host = want_labels["host"]
        sel = host > 0
        profiles_now, undo = profiled_calls(cls)
        for name in originals:
            setattr(fe, name, capture(name))
        runs = {}
        modes = [("exact", "exact", {}), ("xla", "xla", {})]
        if pipe == "affinity":
            modes.append(("pallas_telemetry", "pallas",
                          {"flood_telemetry": True}))
        for name, mode, extra in modes:
            dp.reset_flood_fallbacks()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = entry(None, vol, None, "smoke-" + name, None,
                           device_flood=mode, **kwargs, **extra)
            torch.cuda.synchronize()
            runs[name] = (labels, time.perf_counter() - t0,
                          profiles_now[-1], dp.flood_fallbacks())
        undo()
        for name, real in originals.items():
            setattr(fe, name, real)
        line = {"phase": "floods", "pipeline": pipe,
                "shape": list(vol.shape),
                "profile": {k: v[2] for k, v in runs.items()}}
        labels, sec, prof, _ = runs["exact"]
        check(np.array_equal(labels, host),
              f"{pipe} exact labels differ from the default flood's")
        line["exact"] = {
            "equal_to_default": True, "seconds": sec,
            "certificate_s": prof.get("flood_certificate"),
            **{k: prof.get(k) for k in (
                "flood_exact_path", "flood_uncertain_frac",
                "flood_tie_frac", "flood_tie_frac_scope",
                "flood_speculative", "flood_spec_waited", "flood",
                "device_flood")}}
        labels, sec, prof, fallbacks = runs["xla"]
        check(fallbacks == 0 and "flood_fallback" not in prof,
              f"{pipe} xla fell back")
        check(np.array_equal(labels > 0, sel)
              and set(np.unique(labels)) == set(np.unique(host)),
              f"{pipe} xla support or ids differ")
        agreement = float((labels[sel] == host[sel]).mean())
        check(agreement >= 0.9, f"{pipe} xla agreement {agreement}")
        # the CUDA kernels at inner_cap=1 run the same claim rule to the
        # same fixed point
        check(np.array_equal(labels, want_labels["pallas"]),
              f"{pipe} xla labels differ from the CUDA flood's")
        line["xla"] = {"seconds": sec, "n_iters": prof["flood_iters"],
                       "device_flood_s": prof["device_flood"],
                       "agreement": agreement, "equal_to_pallas": True,
                       "fallbacks": fallbacks}
        if pipe == "affinity":
            labels, sec, prof, _ = runs["pallas_telemetry"]
            disagree = int((labels != host).sum())
            bound = prof["flood_disagreement_bound"] * prof[
                "flood_mask_voxels"]
            check(prof["flood_certificate_converged"] is True,
                  "telemetry certificate did not converge")
            check(disagree <= bound + 0.5,
                  f"telemetry bound {bound} < {disagree} disagreeing")
            check(np.array_equal(labels, main_labels["pallas"]),
                  "pallas labels changed under telemetry")
            line["pallas_telemetry"] = {
                "seconds": sec, "disagreeing_voxels": disagree,
                "bound_voxels": bound,
                **{k: prof[k] for k in (
                    "flood_uncertain_frac", "flood_mismatch_certain_frac",
                    "flood_disagreement_bound", "flood_mask_voxels",
                    "flood_certificate_converged", "flood_telemetry")}}
        cross = crossover_mbps(profiles[pipe]["host"],
                               profiles[pipe]["pallas"])
        resolved = cls.normalize_device_flood(True)
        check(resolved in ("pallas", False), f"True resolved to {resolved}")
        line["true"] = {"link_mbps": linkprobe.measure_link_mbps(),
                        "measured": dict(linkprobe.MEASURED),
                        "resolved": resolved, "crossover": cross}
        # the certificate a phase on this path's inputs, the tie probe off
        # (with it on, a tie-heavy landscape skips the certificate)
        key = ("verified_exact_flood" if pipe == "affinity"
               else "verified_exact_image_flood")
        check(key in captured, f"{pipe} exact never reached {key}")
        inputs = captured[key]
        core = (fe.certificate_flood_core if pipe == "affinity"
                else fe.image_certificate_flood_core)
        _, unc, _, _, conv = core(*inputs)  # also the warm-up
        phases = {}
        core(*inputs, phase_s=phases)
        verified = fe.verified_exact_flood if pipe == "affinity" else \
            fe.verified_exact_image_flood
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = verified(*inputs, tie_probe=0.0)
        torch.cuda.synchronize()
        line["certificate"] = {
            "grid": list(inputs[2].shape), "phase_s": phases,
            "converged": conv, "uncertain": int(unc.sum()),
            "mask_voxels": int(inputs[2].sum()),
            "verified_probe_off_s": time.perf_counter() - t0,
            "verified_probe_off": {"resolved": out[1], "unc_count": out[2]}}
        lines.append(line)

    # card against CPU, bit for bit, on a seeded (16, 128, 128) fixture
    cpu = torch.device("cpu")
    # 30 objects, seed 3: 5 voxels stay uncertain and the repair resolves
    aff, coords, mask = prod_fixture((16, 128, 128), 30, 3)
    seeds = np.zeros(mask.shape, np.int32)
    seeds[tuple(coords.T)] = np.arange(1, len(coords) + 1, dtype=np.int32)
    on = {d: [torch.from_numpy(a).to(d) for a in (aff, seeds, mask)]
          for d in (dev, cpu)}
    card = fe.certificate_flood_core(*on[dev])
    host_c = fe.certificate_flood_core(*on[cpu])
    for g, w, what in zip(card[:4], host_c[:4], ("rep", "unc", "v_lb",
                                                  "v_ub")):
        check(torch.equal(g.cpu(), w), f"certificate {what}: card != CPU")
    check(card[4] == host_c[4] and card[4], "certificate convergence")
    card = fe.verified_exact_flood(*on[dev], tie_probe=0.0, repair_doom=0.0)
    host_v = fe.verified_exact_flood(*on[cpu], tie_probe=0.0,
                                     repair_doom=0.0)
    check(torch.equal(card[0].cpu(), host_v[0]) and card[1:] == host_v[1:],
          "verified flood: card != CPU")
    check(card[1] and card[2] > 0, f"the repair did not run and resolve: "
          f"{card[1:]}")
    check(np.array_equal(card[0].cpu().numpy(),
                         affinity_watershed(aff, coords, mask)),
          "verified flood != host heap")
    wave = {}
    for mode in ("claim", "minimax"):
        got = df.wavefront_flood(*on[dev], mode=mode)
        want = df.wavefront_flood(*on[cpu], mode=mode)
        check(torch.equal(got[0].cpu(), want[0]) and got[1:] == want[1:],
              f"wavefront {mode}: card != CPU")
        wave[mode] = {"n_iters": got[1], "converged": got[2]}
    lines.append({"phase": "floods", "pipeline": "card_vs_cpu",
                  "shape": list(mask.shape), "seeds": len(coords),
                  "certificate_equal": True,
                  "certificate_uncertain": int(host_c[1].sum()),
                  "verified_equal": True, "verified_resolved": card[1],
                  "verified_unc_count": card[2],
                  "verified_equals_heap": True,
                  "wavefront_equal": wave})
    return lines


def cuda_ms(fn, reps=3):
    """Mean time of ``fn()`` in ms over ``reps`` runs after one warm-up,
    by CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split_ms(fn, reps=3):
    """Mean ``setup_ms`` (init kernel) and ``steps_ms`` (step kernel) that
    ``fn(stats)`` reports over ``reps`` runs after one warm-up."""
    fn({})
    runs = []
    for _ in range(reps):
        runs.append({})
        fn(runs[-1])
    return {k: sum(r[k] for r in runs) / reps
            for k in ("setup_ms", "steps_ms")}


def kernel_vs_plain(flood, plain, launches, inputs, what, **kw):
    """One flood through the kernel, its plain version (the full sweep) and
    the plain frontier schedule: labels and steps equal to the full sweep,
    tile-steps equal to the frontier's, converged, two launches. Returns
    the labels and a row of the numbers."""
    before = launches()
    stats, frontier = {}, {}
    lk, nk, ck = flood(*inputs, stats=stats, **kw)
    n_launched = launches() - before
    lp, np_, cp = plain(*inputs, **kw)
    plain(*inputs, stats=frontier, **kw)
    err = int((lk.long() - lp.long()).abs().max()) if lk.numel() else 0
    check(err == 0, f"{what} kernel differs from plain by {err} ({kw})")
    check(nk == np_ and ck and cp,
          f"{what} steps {nk} vs {np_}, converged {ck} {cp}")
    check(stats["tile_steps"] == frontier["tile_steps"]
          and frontier["missed"] == 0,
          f"{what} tile-steps {stats} vs {frontier}")
    check(n_launched == 2, f"{what} made {n_launched} launches, not 2")
    return lk, {"inner_cap": kw["inner_cap"], "steps": nk,
                "launches": n_launched, "tile_steps": stats["tile_steps"],
                "tiles": frontier["tiles"],
                "tiles_per_step": frontier["lists"], "max_abs_err": err,
                "tolerance": 0}


def run_orbax(vol, kwargs, want, work):
    """Phase 15: orbax checkpoints read and written by the port alone;
    returns the phase's line."""
    import numpy as np
    import torch

    from iterseg_tpu_torch import cli
    from iterseg_tpu_torch.engine.predict import DEFAULT_UNET_PATH
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed
    from iterseg_tpu_torch.io.ocdbt import OcdbtReader
    from iterseg_tpu_torch.models.convert import load_checkpoint
    from iterseg_tpu_torch.native import zstd
    from iterseg_tpu_torch.ops import flood_kernel as fk

    def same(got, ref, what):
        check(set(got) == set(ref), f"{what}: keys differ")
        for k in ref:
            check(got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
                  and got[k].tobytes() == ref[k].tobytes(), f"{what}: {k}")

    line = {"phase": "orbax"}
    blocked = [m for m in ("orbax", "zstandard", "jax")
               if sys.modules.get(m) is not None]
    check(not blocked, f"the port imported {blocked}")
    # 1. the committed fixture, written by orbax's own checkpointers
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", "torch_orbax")
    with np.load(os.path.join(fixture, "truth.npz")) as f:
        truth = dict(f)
    for layout in ("ocdbt", "plain"):
        same(load_checkpoint(os.path.join(fixture, layout)), truth, layout)
    frame = OcdbtReader(os.path.join(fixture, "ocdbt")).read(
        "b.conv/0.0.0.0.0")
    size = truth["b.conv"].nbytes
    check(zstd.decompress(frame, size).tobytes()
          == truth["b.conv"].tobytes(), "fixture chunk decodes wrong")
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        zstd.decompress(frame, size)
    dt = time.perf_counter() - t0
    line["fixture"] = {"arrays": len(truth), "chunk_bytes": len(frame),
                       "decoded_bytes": size,
                       "decode_mb_per_s": reps * size / dt / 1e6}
    # 2. default_unet.npz -> orbax directory -> .npz through the CLI
    out_dir = os.path.join(work, "unet-orbax")
    back = os.path.join(work, "back.npz")
    check(cli.main(["convert", "--input", DEFAULT_UNET_PATH,
                    "--output", out_dir]) == 0, "convert to orbax failed")
    check(cli.main(["convert", "--input", out_dir, "--output", back]) == 0,
          "convert from orbax failed")
    ref = load_checkpoint(DEFAULT_UNET_PATH)
    same(load_checkpoint(out_dir), ref, "orbax directory")
    same(load_checkpoint(back), ref, "round trip")
    seconds = {}
    for name, path in (("orbax_dir", out_dir), ("npz", DEFAULT_UNET_PATH)):
        seconds[name] = []
        for _ in range(3):
            t0 = time.perf_counter()
            load_checkpoint(path)
            seconds[name].append(time.perf_counter() - t0)
    line["unet"] = {"arrays": len(ref),
                    "values": int(sum(v.size for v in ref.values())),
                    "dir_bytes": sum(
                        os.path.getsize(os.path.join(d, f))
                        for d, _, fs in os.walk(out_dir) for f in fs),
                    "load_s": seconds}
    # 3. the main path's "pallas" call with the U-Net from the directory
    fk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = affinity_unet_watershed(None, vol, None, "smoke", out_dir,
                                     device_flood="pallas", **kwargs)
    torch.cuda.synchronize()
    launches = fk.launches()
    check(launches == 2, f"{launches} affinity kernel launches, not 2")
    check(np.array_equal(labels, want), "orbax U-Net labels differ from the "
          ".npz U-Net's")
    line["segment"] = {"shape": list(vol.shape), "device_flood": "pallas",
                       "kernel_launches": launches,
                       "labels_equal_npz": True, "objects": int(labels.max()),
                       "seconds": time.perf_counter() - t0}
    return line


def host_flood_fixture(shape, gain, seed):
    """The exact host flood's arguments on a (z, y, x) frame, padded as the
    pipeline pads it: a blob mask of 12.5% of the voxels, 4,900 seeds at
    random in it (a (96, 512, 512) frame's worth, scaled by volume) with
    labels 1..n, and three smooth sigmoid affinity channels of ``gain``,
    each divided by its maximum."""
    import numpy as np
    from scipy import ndimage as ndi

    from iterseg_tpu_torch.ops.watershed_oracle import neighbor_offsets

    r = np.random.default_rng(seed)
    scale = np.prod(shape) / (96 * 512 * 512)
    vol = np.zeros(shape, np.float32)
    pts = np.stack([r.integers(2, s - 2, size=int(2700 * scale))
                    for s in shape], 1)
    vol[tuple(pts.T)] = 1.0
    vol = ndi.gaussian_filter(vol, (2, 4, 4))
    mask = np.pad(vol > np.quantile(vol, 0.875), 1).astype(np.uint8)
    del vol
    pshape = mask.shape
    aff = np.empty((3, mask.size), np.float32)
    for c in range(3):
        noise = ndi.gaussian_filter(
            r.standard_normal(shape).astype(np.float32), 2)
        with np.errstate(over="ignore"):
            a = 1 / (1 + np.exp(-gain * noise / noise.std()))
        aff[c] = np.pad(a / a.max(), 1).ravel()
    markers = r.permutation(np.flatnonzero(mask))[:int(4900 * scale)]
    offsets, axes = neighbor_offsets(pshape)
    val_off = offsets.copy()
    val_off[:len(offsets) // 2] = 0
    seeded = np.zeros(mask.size, np.int32)
    seeded[markers] = np.arange(1, len(markers) + 1, dtype=np.int32)
    return ((aff, offsets, axes, val_off, markers,
             np.zeros(len(markers), np.float32), mask.ravel()), seeded)


def run_host_flood(shape=(96, 512, 512), reps=2):
    """Phase 18: the bucketed queue against the heap on
    ``host_flood_fixture`` frames of gain 4 and 40, ``reps`` runs each,
    alternated; labels equal, no fallback. Times are the host's."""
    import numpy as np

    from iterseg_tpu_torch import native

    lib = native.get_lib()

    def flood(entry, args, seeded):
        output = seeded.copy()
        t0 = time.perf_counter()
        peak = native._flood(entry, *args, output)
        return output, time.perf_counter() - t0, peak

    cases = []
    for gain in (4, 40):
        args, seeded = host_flood_fixture(shape, gain, 18)
        times = {"heap": [], "queue": []}
        for _ in range(reps):
            heap, t_heap, heap_peak = flood(lib.priority_flood_heap, args,
                                            seeded)
            queue, t_queue, queue_peak = flood(lib.priority_flood, args,
                                               seeded)
            check(np.array_equal(heap, queue),
                  f"gain {gain}: the queue's labels differ from the heap's")
            check(queue_peak >= 0,
                  f"gain {gain}: the queue fell back to the heap")
            times["heap"].append(t_heap)
            times["queue"].append(t_queue)
        cases.append({"gain": gain,
                      "mask_share": float(args[-1].sum() / np.prod(shape)),
                      "seeds": len(args[4]),
                      "labelled": int((queue > 0).sum()),
                      "heap_s": times["heap"], "queue_s": times["queue"],
                      "speedup": min(times["heap"]) / min(times["queue"]),
                      "heap_peak": heap_peak, "queue_peak": queue_peak})
        del args, seeded, heap, queue
    return {"phase": "host_flood", "frame": list(shape),
            "cpus": os.cpu_count(), "cases": cases}


def window_attention_case(qkv, table, heads, window, shift):
    """The window-attention kernel on one stage's tokens against its plain
    version, and ``scaled_dot_product_attention`` given the windows and
    the same additive bias and mask: ms of each, the kernel's bound from
    its inputs, and the kernel's and the library's largest gaps to the
    plain version."""
    import torch
    import torch.nn.functional as F

    from iterseg_tpu_torch.device import f32_numerics
    from iterseg_tpu_torch.ops import window_attention as wa

    b, dp, hp, wp, c3 = qkv.shape
    n = window[0] * window[1] * window[2]
    width = c3 // 3 // heads
    windows = b * dp * hp * wp // n * heads
    # the SDPA inputs: the rolled grid's windows, bias and mask made whole
    x = torch.roll(qkv, [-s for s in shift], (1, 2, 3)) if any(shift) else qkv
    win = wa._partition(x, window)
    q, k, v = (t.contiguous() for t in win.reshape(
        -1, n, 3, heads, width).permute(2, 0, 3, 1, 4))
    mask = table[wa.relative_index(n, qkv.device).reshape(-1)].reshape(
        n, n, heads).permute(2, 0, 1)[None].expand(q.shape[0], -1, -1, -1)
    if any(shift):
        ids = wa._partition(wa.region_ids((dp, hp, wp), window, shift,
                                          qkv.device)[None, ..., None],
                            window)[..., 0]
        region = torch.where(ids[:, None, :] != ids[:, :, None],
                             wa.MASK_VALUE, 0.0)
        mask = (mask.reshape(b, -1, heads, n, n)
                + region[None, :, None]).reshape(-1, heads, n, n)
    mask = mask.contiguous()
    with f32_numerics():
        got = wa.window_attention(qkv, table, heads, window, shift)
        want = wa.window_attention_plain(qkv, table, heads, window, shift)
        lib = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        lib = wa._reverse(lib.transpose(1, 2).reshape(-1, n, heads * width),
                          window, (b, dp, hp, wp))
        if any(shift):
            lib = torch.roll(lib, list(shift), (1, 2, 3))
        row = {
            "shape": list(qkv.shape), "heads": heads, "window": list(window),
            "shift": list(shift), "window_heads": windows,
            "max_abs_err": float((got - want).abs().max()),
            "library_max_abs_err": float((lib - want).abs().max()),
            "ms": cuda_ms(lambda: wa.window_attention(qkv, table, heads,
                                                      window, shift),
                          reps=10),
            "plain_ms": cuda_ms(lambda: wa.window_attention_plain(
                qkv, table, heads, window, shift), reps=1),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), reps=3),
        }
    # least time: 4 n^2 width operations a window-head at the card's f32
    # rate, or q, k, v read and the output written once (and the table)
    ops_s = windows * 4 * n * n * width / F32_OPS_PER_S
    io_s = 4 * (windows * 4 * n * width + table.numel()) / HBM_BYTES_PER_S
    row.update(bound_ms=max(ops_s, io_s) * 1e3,
               bound_by="operations" if ops_s >= io_s else "bytes")
    check(row["max_abs_err"] <= 1e-5,
          f"window attention differs from plain by {row['max_abs_err']} "
          f"({row['shape']}, shift {shift})")
    return row


def run_swin(dev, work):
    """Phase 16: Swin UNETR (MONAI v1, feature size 48, seeded weights)
    through ``affinity_unet_watershed`` on a (96, 512, 512) uint16 frame in
    96^3 chunks (margin 12), the window-attention kernel's launches counted
    over that call (8 a microbatch: two blocks a stage), then the kernel
    against its plain version and SDPA on stage 0's grid at the program's
    microbatch, unshifted and shifted, and on stage 3's clipped 6^3 window.
    Returns the phase's line and the kernel's row."""
    import numpy as np
    import torch

    from iterseg_tpu_torch.engine import device_pipeline as dp
    from iterseg_tpu_torch.engine.predict import load_unet
    from iterseg_tpu_torch.engine.segmentation import affinity_unet_watershed
    from iterseg_tpu_torch.models import swin_unetr as swin
    from iterseg_tpu_torch.ops import window_attention as wa

    chunk, margin = (96, 96, 96), (12, 12, 12)
    net = swin.SwinUNETR(swin.SwinUNETRSpec(feature_size=48)).init_weights(0)
    ckpt = os.path.join(work, "swin_unetr.pt")
    torch.save(net.state_dict(), ckpt)
    vol = blob_volume((96, 512, 512), 2700, 16)
    model = load_unet(ckpt)
    program = dp.get_feature_program(model, vol.shape, chunk, margin,
                                     device=dev)
    batches, microbatch = len(program.slab_of), program.microbatch

    def segment():
        return affinity_unet_watershed(None, vol, None, "swin", ckpt,
                                       chunk_size=chunk, margin=margin,
                                       debug=True, device_flood=False)

    segment()
    torch.cuda.synchronize()
    wa.reset_launches()
    t0 = time.perf_counter()
    labels = np.asarray(segment())
    seconds = time.perf_counter() - t0
    launched = wa.launches()
    check(launched == 8 * batches,
          f"window attention launched {launched} times, not 8 x {batches}")

    gen = torch.Generator(device=dev).manual_seed(16)
    cases = []
    stages = net.swinViT
    for grid, stage, block, window, shift in (
            ((49, 49, 49), stages.layers1, 0, (7, 7, 7), (0, 0, 0)),
            ((49, 49, 49), stages.layers1, 1, (7, 7, 7), (3, 3, 3)),
            ((6, 6, 6), stages.layers4, 0, (6, 6, 6), (0, 0, 0))):
        attn = stage[0].blocks[block].attn
        qkv = torch.randn((microbatch,) + grid + (attn.qkv.out_features,),
                          device=dev, generator=gen)
        table = attn.relative_position_bias_table.detach().to(dev)
        cases.append(window_attention_case(qkv, table, attn.num_heads,
                                           window, shift))
        del qkv
        torch.cuda.empty_cache()
    line = {"phase": "swin", "learnt_parameters": sum(
                p.numel() for p in net.parameters()),
            "frame": list(vol.shape), "chunk": list(chunk),
            "margin": list(margin), "microbatch": microbatch,
            "microbatches": batches, "launches": launched,
            "seconds": seconds, "objects": int(labels.max()),
            "labelled_share": float((labels > 0).mean()),
            "kernel_cases": cases}
    row = {"name": "window_attention", "route": "cuda",
           "source": "iterseg_tpu_torch/csrc/window_attention.cu",
           "replaces": None, "launches": launched,
           "library": "torch.nn.functional.scaled_dot_product_attention",
           "tolerance": 1e-5, "cases": cases,
           **{k: cases[0][k] for k in ("shape", "ms", "plain_ms",
                                       "bound_ms", "library_ms")},
           "max_abs_err": max(c["max_abs_err"] for c in cases)}
    return line, row


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from iterseg_tpu_torch import native
    from iterseg_tpu_torch.device import f32_numerics
    from iterseg_tpu_torch.native import zstd
    from iterseg_tpu_torch.engine import device_pipeline as dp
    from iterseg_tpu_torch.engine.predict import load_unet, predict_volume
    from iterseg_tpu_torch.engine.segmentation import (
        affinity_unet_watershed, dog_blob_watershed,
        dog_blob_watershed_for_chunks)
    from iterseg_tpu_torch.ops import flood_kernel as fk
    from iterseg_tpu_torch.ops import image_flood_kernel as ifk
    from iterseg_tpu_torch.ops import window_attention as wa
    from iterseg_tpu_torch.ops.watershed import segment_output_image
    from iterseg_tpu_torch.train.labels import get_training_labels

    t_main = time.perf_counter()
    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu, flush=True)

    # 1. build the four compiled libraries at once
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        jobs = {name: pool.submit(timed, fn) for name, fn in (
            ("affinity_flood", fk.build), ("image_flood", ifk.build),
            ("window_attention", wa.build), ("native", native.get_lib),
            ("zstd", zstd.get_lib))}
        each = {name: j.result() for name, j in jobs.items()}
    emit({"phase": "build", "gpu": gpu, "build_s": time.perf_counter() - t0,
          "build_s_each": each, "native_loaded": native.loaded(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. kernel vs plain on a smooth fixture
    aff, seeds, mask = (torch.from_numpy(x).to(dev)
                        for x in smooth_fixture((33, 256, 256), 400, 0))
    rows = []
    for cap in (1, 4):
        lk, row = kernel_vs_plain(fk.affinity_flood, fk.affinity_flood_plain,
                                  fk.launches, (aff, seeds, mask),
                                  "affinity", inner_cap=cap)
        rows.append(dict(row, **{
            "ms": cuda_ms(lambda: fk.affinity_flood(aff, seeds, mask,
                                                    inner_cap=cap)),
            "plain_ms": cuda_ms(lambda: fk.affinity_flood_plain(
                aff, seeds, mask, inner_cap=cap), reps=1),
        }))
    emit({"phase": "kernel_vs_plain", "shape": list(mask.shape),
          "labelled": int((lk > 0).sum()), "seeds": int(seeds.max()),
          "runs": rows})
    values, markers, emask = (torch.from_numpy(x).to(dev)
                              for x in edt_fixture((33, 256, 256), 250, 0))
    rows = []
    for cap in (1, 4):
        lk, row = kernel_vs_plain(ifk.image_flood, ifk.image_flood_plain,
                                  ifk.launches, (values, markers, emask),
                                  "image", inner_cap=cap)
        rows.append(dict(row, **{
            "ms": cuda_ms(lambda: ifk.image_flood(values, markers, emask,
                                                  inner_cap=cap)),
            "plain_ms": cuda_ms(lambda: ifk.image_flood_plain(
                values, markers, emask, inner_cap=cap), reps=1),
        }))
    emit({"phase": "image_kernel_vs_plain", "shape": list(emask.shape),
          "labelled": int((lk > 0).sum()), "seeds": int(markers.max()),
          "runs": rows})

    # 3. forward parity, one chunk, card (TF32 off) vs CPU
    model = load_unet(None)
    n_params = sum(v.size for v in model.params.values())
    chunk = blob_volume((10, 256, 256), 60, 1).astype(np.float32)
    chunk = (chunk / chunk.max())[None, None]
    t0 = time.perf_counter()
    with torch.no_grad(), f32_numerics():
        y_gpu = model.module(dev)(torch.from_numpy(chunk).to(dev)).cpu()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        y_cpu = model.module("cpu")(torch.from_numpy(chunk))
    cpu_s = time.perf_counter() - t0
    resid = float((y_gpu - y_cpu).abs().max())
    check(y_gpu.shape == (1, 5, 10, 256, 256),
          f"forward shape {y_gpu.shape}")
    check(bool(torch.isfinite(y_gpu).all()), "non-finite features")
    check(resid <= 5e-4, f"forward residual {resid} > 5e-4")
    emit({"phase": "forward_parity", "params": int(n_params),
          "max_abs": resid, "bound": 5e-4, "gpu_s": gpu_s, "cpu_s": cpu_s})

    # 4. the main path, one (33, 512, 512) volume, both flood modes
    vol = blob_volume((33, 512, 512), 900, 2)
    kwargs = dict(chunk_size=(10, 256, 256), margin=(1, 64, 64), debug=True)
    profiles, undo_profiles = profiled_calls(dp.AffinityPipeline)
    captured = []
    flood = fk.affinity_flood

    def capture(*args, **kw):
        captured.append((args, kw))
        return flood(*args, **kw)

    fk.affinity_flood = capture
    runs = {}
    for name, mode in (("host_cold", False), ("host", False),
                       ("pallas", "pallas")):
        if mode == "pallas":
            fk.reset_launches()
            dp.reset_flood_fallbacks()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = affinity_unet_watershed(None, vol, None, "smoke", None,
                                         device_flood=mode, **kwargs)
        torch.cuda.synchronize()
        runs[name] = (labels, time.perf_counter() - t0, profiles[-1])
    main_launches = fk.launches()
    fk.affinity_flood = flood
    undo_profiles()
    host, pallas = runs["host"][0], runs["pallas"][0]
    main_labels = {"host": host, "pallas": pallas}
    check(captured and main_launches == 2 * len(captured),
          f"{main_launches} kernel launches for {len(captured)} floods")
    check(dp.flood_fallbacks() == 0, "the device flood fell back")
    check(native.loaded(), "the native host flood did not load")
    check(host.shape == vol.shape and host.dtype == np.int32,
          f"labels {host.shape} {host.dtype}")
    check(np.array_equal(host, runs["host_cold"][0]), "repeat run differs")
    check(np.array_equal(host > 0, pallas > 0), "label support differs")
    check(set(np.unique(host)) == set(np.unique(pallas)), "id sets differ")
    sel = host > 0
    agreement = float((host[sel] == pallas[sel]).mean())
    check(agreement >= 0.9, f"agreement {agreement} < 0.9")
    # fast path vs the generic path on a smaller float volume
    small = blob_volume((33, 256, 256), 250, 3).astype(np.float32)
    small /= small.max()
    fast = dp.AffinityPipeline(model, chunk_size=(10, 256, 256),
                               margin=(1, 64, 64)).segment(small)
    feats = predict_volume(model, small, (10, 256, 256), (1, 64, 64))
    generic, _, _ = segment_output_image(feats, (0, 1, 2), 4, 3)
    check(np.array_equal(fast, generic), "fast path != generic path")
    emit({"phase": "main_path", "shape": list(vol.shape),
          "objects": int(host.max()), "labelled_frac": float(sel.mean()),
          "agreement": agreement, "kernel_launches": main_launches,
          "floods": len(captured),
          "flood_fallbacks": dp.flood_fallbacks(),
          "fast_equals_generic": True,
          "seconds": {k: v[1] for k, v in runs.items()},
          "voxels_per_s": {k: vol.size / v[1] for k, v in runs.items()},
          "profile": {k: v[2] for k, v in runs.items()}})

    # 5. a stack through segment_stack
    stack = np.stack([blob_volume((33, 256, 256), 250, s) for s in (4, 5)])
    t0 = time.perf_counter()
    st = affinity_unet_watershed(None, stack, None, "smoke-stack", None,
                                 **kwargs)
    stack_s = time.perf_counter() - t0
    check(st.shape == stack.shape, f"stack labels {st.shape}")
    check(all(st[t].max() > 0 for t in range(len(st))), "unlabelled frame")
    emit({"phase": "stack", "shape": list(stack.shape),
          "objects": [int(st[t].max()) for t in range(len(st))],
          "seconds": stack_s, "voxels_per_s": stack.size / stack_s})

    # 6. the DoG path, one (33, 512, 512) volume, both flood modes
    import warnings

    dog_profiles, undo_profiles = profiled_calls(dp.DoGPipeline)
    image_captured = []
    image_flood = ifk.image_flood

    def image_capture(*args, **kw):
        image_captured.append((args, kw))
        return image_flood(*args, **kw)

    ifk.image_flood = image_capture
    dog_runs = {}
    ifk.reset_launches()
    dp.reset_flood_fallbacks()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, mode in (("host_cold", False), ("host", False),
                           ("pallas", "pallas")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = dog_blob_watershed(None, vol, None, "smoke-dog", None,
                                        debug=True, device_flood=mode)
            torch.cuda.synchronize()
            dog_runs[name] = (labels, time.perf_counter() - t0,
                              dog_profiles[-1])
    dog_launches = ifk.launches()
    dog_fallbacks = dp.flood_fallbacks()
    ifk.image_flood = image_flood
    undo_profiles()
    host, pallas = dog_runs["host"][0], dog_runs["pallas"][0]
    dog_labels = {"host": host, "pallas": pallas}
    check(image_captured and dog_launches == 2 * len(image_captured),
          f"{dog_launches} image kernel launches for "
          f"{len(image_captured)} floods")
    check(dog_fallbacks == 0, "the device image flood fell back")
    check(not [w for w in caught if issubclass(w.category, RuntimeWarning)],
          f"warnings: {[str(w.message) for w in caught]}")
    check(native.loaded(), "the native host flood did not load")
    check(host.shape == vol.shape and host.dtype == np.int32,
          f"DoG labels {host.shape} {host.dtype}")
    check(int(host.max()) > 0, "the DoG path labelled nothing")
    check(np.array_equal(host, dog_runs["host_cold"][0]),
          "DoG repeat run differs")
    check(np.array_equal(host > 0, pallas > 0), "DoG label support differs")
    check(set(np.unique(host)) == set(np.unique(pallas)),
          "DoG id sets differ")
    sel = host > 0
    dog_agreement = float((host[sel] == pallas[sel]).mean())
    check(dog_agreement >= 0.9, f"DoG agreement {dog_agreement} < 0.9")
    # the card's DoGPipeline against the host path and the CPU run
    small = blob_volume((33, 256, 256), 250, 3).astype(np.float32)
    small /= small.max()
    t0 = time.perf_counter()
    fast = dp.DoGPipeline().segment(small)
    fast_s = time.perf_counter() - t0
    ref = np.zeros(fast.shape, np.int32)
    dog_blob_watershed_for_chunks(small, ref, None, None, 1, 1.5, 0.02,
                                  use_device_pipeline=False)
    check(np.array_equal(fast, ref), "DoG fast path != host path")
    t0 = time.perf_counter()
    on_cpu = dp.DoGPipeline(device="cpu").segment(small)
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(fast, on_cpu), "DoG labels: card != CPU")
    emit({"phase": "dog_path", "shape": list(vol.shape),
          "objects": int(host.max()), "labelled_frac": float(sel.mean()),
          "agreement": dog_agreement, "image_kernel_launches": dog_launches,
          "floods": len(image_captured),
          "flood_fallbacks": dog_fallbacks, "runtime_warnings": 0,
          "fast_equals_host": True, "card_equals_cpu": True,
          "small_shape": list(small.shape), "small_card_s": fast_s,
          "small_cpu_s": cpu_s,
          "seconds": {k: v[1] for k, v in dog_runs.items()},
          "voxels_per_s": {k: vol.size / v[1] for k, v in dog_runs.items()},
          "profile": {k: v[2] for k, v in dog_runs.items()}})

    # 7. a DoG stack
    t0 = time.perf_counter()
    st = dog_blob_watershed(None, stack, None, "smoke-dog-stack", None,
                            debug=True)
    dog_stack_s = time.perf_counter() - t0
    check(st.shape == stack.shape, f"DoG stack labels {st.shape}")
    check(all(st[t].max() > 0 for t in range(len(st))),
          "unlabelled DoG frame")
    emit({"phase": "dog_stack", "shape": list(stack.shape),
          "objects": [int(st[t].max()) for t in range(len(st))],
          "seconds": dog_stack_s, "voxels_per_s": stack.size / dog_stack_s})

    # 8. the device floods of slice 3 on the same volume: "exact", "xla",
    # "pallas" with telemetry, True; the certificate's phases; card vs CPU
    for line in run_floods(vol, main_labels, dog_labels, {
            "affinity": {k: runs[k][2] for k in ("host", "pallas")},
            "dog": {k: dog_runs[k][2] for k in ("host", "pallas")}},
            dev, kwargs):
        emit(line)

    # 9. one train step, card against CPU
    chans = ("z-1", "y-1", "x-1", "mask", "centreness-log")
    patch = blob_volume((10, 64, 64), 40, 6)
    xb = (patch / patch.max()).astype(np.float32)[None, None]
    yb = get_training_labels(blob_labels(patch), chans, (4, 1, 1)).astype(
        np.float32)[None]
    card = train_step_on(model.params, xb, yb, dev)
    host = train_step_on(model.params, xb, yb, torch.device("cpu"))
    loss_rel = abs(card[0] - host[0]) / abs(host[0])
    gmax = max(float(g.abs().max()) for g in host[1].values())
    grad_rel = max(float((card[1][k] - g).abs().max())
                   for k, g in host[1].items()) / gmax
    stats_rel = max(float((card[2][k] - v).abs().max() / v.abs().max())
                    for k, v in host[2].items())
    check(loss_rel <= 1e-5, f"train loss card vs CPU: {loss_rel} > 1e-5")
    check(grad_rel <= 5e-3, f"gradients card vs CPU: {grad_rel} > 5e-3")
    check(stats_rel <= 1e-5, f"running stats card vs CPU: {stats_rel}")
    emit({"phase": "train_parity", "shape": list(xb.shape),
          "channels": list(chans), "loss": card[0], "loss_rel": loss_rel,
          "loss_bound": 1e-5, "grad_max": gmax, "grad_resid_rel": grad_rel,
          "grad_bound": 5e-3, "stats_resid_rel": stats_rel,
          "stats_bound": 1e-5, "gradients": len(host[1]),
          "running_stats": len(host[2])})

    # 10. fine-tune default_unet.npz through run_experiment on the card; the
    # training path (and the default-flood segmentation after it) launches
    # neither flood kernel
    fk.reset_launches()
    ifk.reset_launches()
    train_phase = run_training(vol, chans, dev)
    train_phase["flood_kernel_launches"] = {"affinity_flood": fk.launches(),
                                            "image_flood": ifk.launches()}
    check(fk.launches() == 0 and ifk.launches() == 0,
          "the training path launched a flood kernel")
    emit(train_phase)

    # 11-12. the loop and the server through the CLI, each path with the
    # launch counts set to 0 just before it and read just after
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        loop_phase, loop_labels = run_loop(vol, main_labels, dog_labels,
                                           work)
        emit(loop_phase)
    with tempfile.TemporaryDirectory() as work:
        emit(run_serve(vol, stack, loop_labels, work))

    # 13. several cards: frame parallelism, a two-process pod, data-
    # parallel training; each path's launch counts set to 0 just before it
    with tempfile.TemporaryDirectory() as work:
        for line in run_multi(work, kwargs):
            emit(line)

    # 14. the mesh's space axis: each chunk's x split over the cards
    for line in run_space(vol, dev, t_main):
        emit(line)

    # 15. orbax checkpoints without orbax; the affinity launch count set to
    # 0 just before the segmentation and read just after
    with tempfile.TemporaryDirectory() as work:
        emit(run_orbax(vol, kwargs, main_labels["pallas"], work))

    # 16. Swin UNETR on the affinity path, and its attention kernel; the
    # kernel's launch count set to 0 just before the segmentation
    with tempfile.TemporaryDirectory() as work:
        swin_line, swin_row = run_swin(dev, work)
    emit(swin_line)

    # 17. each kernel on its path's own inputs
    kernels = []
    for name, mod, flood, plain, calls, path_launches, line, in_bytes in (
            ("affinity_flood", fk, fk.affinity_flood,
             fk.affinity_flood_plain, captured, main_launches, 84,
             3 * 4 + 4 + 1 + 4),
            ("image_flood", ifk, ifk.image_flood, ifk.image_flood_plain,
             image_captured, dog_launches, 359, 4 + 4 + 1 + 4)):
        inputs, kw = calls[-1][0][:3], calls[-1][1]
        mask = inputs[2]
        _, row = kernel_vs_plain(flood, plain, mod.launches, inputs, name,
                                 **kw)
        # least time for this flood: its inputs (affinities or values,
        # seeds, mask) read once and its labels written once, or the claim
        # steps its free voxels need at the card's f32 rate, whichever is
        # larger
        voxels = mask.numel()
        io_s = in_bytes * voxels / HBM_BYTES_PER_S
        free = int((mask & (inputs[1] <= 0)).sum())
        ops_s = (mod.OPS_PER_FREE_VOXEL_STEP * free * row["steps"]
                 * kw["inner_cap"] / F32_OPS_PER_S)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"iterseg_tpu_torch/csrc/{name}.cu",
            "header": "iterseg_tpu_torch/csrc/flood_schedule.cuh",
            "replaces": f"iterseg_tpu/ops/pallas_flood.py:{line}",
            "launches": path_launches,
            "shape": list(mask.shape),
            "tile": list(mod.TILE),
            "steps": row["steps"],
            "tile_steps": row["tile_steps"],
            "tiles": row["tiles"],
            "tiles_per_step": row["tiles_per_step"],
            "max_abs_err": row["max_abs_err"],
            "tolerance": 0,
            "ms": cuda_ms(lambda: flood(*inputs, **kw)),
            **split_ms(lambda st: flood(*inputs, stats=st, **kw)),
            "plain_ms": cuda_ms(lambda: plain(*inputs, **kw), reps=1),
            "bound_ms": max(io_s, ops_s) * 1e3,
            "bound_by": "bytes" if io_s >= ops_s else "operations",
            # the traffic of the kernel's own schedule: the init pass, and
            # the halo'd tiles the frontier processed
            "schedule_bound_ms": (mod.INIT_BYTES_PER_VOXEL * voxels
                                  + mod.BYTES_PER_TILE_STEP
                                  * row["tile_steps"])
            / HBM_BYTES_PER_S * 1e3,
            "free_voxels": free,
            "library_ms": None,
        })
    kernels.append(swin_row)
    emit({"kernels": kernels})

    # 18. the exact host flood: the bucketed queue against the heap
    emit(run_host_flood())
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
