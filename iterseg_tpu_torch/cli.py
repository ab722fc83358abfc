"""Command-line interface: ``python -m iterseg_tpu_torch <command>``.

The port of ``iterseg_tpu/cli.py``: the same subcommands and options, a
thin argparse layer over the port's headless API:

- ``segment``  → ``widgets.segment_data``       (reference
  ``_dock_widgets.segment_data``, _dock_widgets.py:544)
- ``train``    → ``widgets._train_from_viewer`` (_dock_widgets.py:82)
- ``assess``   → ``widgets._assess_segmentation`` (_dock_widgets.py:791)
- ``pod-segment`` → ``parallel.multihost.multihost_segment_zarr`` (+
  ``multihost_accuracy_metrics`` with ``--gt``)
- ``serve``    → ``engine.serve.SegmentationServer`` + ``watch``
- ``convert``  → ``models.convert`` (``.npz``, ``.pt``/``.pth``, orbax)
- ``info``     → environment / registry report

One option is the port's own: ``--device``, before the subcommand, names
the torch device that ``segment``, ``train``, ``serve`` and ``pod-segment``
run on (default: CUDA, an error without a card; ``--device cpu`` runs on
the CPU). ``pod-segment`` without ``--device`` puts process ``p`` on
``cuda:{p % device_count}``; ``--local-devices`` (``pod-segment`` and
``serve``) round-robins frames over every card of the host instead.

Every command prints the paths it wrote so shell pipelines can consume
them. All heavy compute runs through the exact same code paths as the
library API, so labels/CSVs are bit-identical to script-driven runs.
"""
import argparse
import os
import sys


def _tuple3(text):
    """'10,256,256' → (10, 256, 256)."""
    parts = tuple(int(p) for p in str(text).split(","))
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(
            f"expected 3 comma-separated ints, got {text!r}"
        )
    return parts


def _scale3(text):
    parts = tuple(float(p) for p in str(text).split(","))
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(
            f"expected 3 comma-separated numbers, got {text!r}"
        )
    return parts


def _load_layer(viewer, path, layer_name, layer_type, scale, data_type):
    """Route one --input/--ground-truth path through ``_load_data``:
    ``*.zarr``/``*.zar`` stores and frame directories load via
    ``directory=``, single tiffs via ``data_file=``."""
    from .widgets import _load_data

    path = str(path)
    if os.path.isfile(path) and path.endswith((".tif", ".tiff")):
        kwargs = {"data_file": path}
    else:
        kwargs = {"directory": path}
    _load_data(viewer, layer_name=layer_name, layer_type=layer_type,
               data_type=data_type, scale=scale, translate=(0, 0, 0),
               **kwargs)
    return viewer.layers[layer_name]


def _devices(args):
    """The ``devices`` list of one device for the segmenters and the server
    (``None``: CUDA)."""
    import torch

    return None if args.device is None else [torch.device(args.device)]


def _local_devices():
    """Every CUDA card of this host, for ``--local-devices``: a stack's
    frames round-robin over them. Raises ``RuntimeError`` without a card,
    as ``resolve_device`` does."""
    import torch

    from .device import resolve_device

    resolve_device(None)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _cmd_segment(args):
    from .engine.segmentation import segmenters
    from .viewer import Viewer
    from .widgets import segment_data

    if args.segmenter not in segmenters:
        print(f"unknown segmenter {args.segmenter!r}; "
              f"registered: {sorted(segmenters)}", file=sys.stderr)
        return 2
    viewer = Viewer()
    layer = _load_layer(viewer, args.input, "images", "Image",
                        args.scale, args.data_type)
    os.makedirs(args.output_dir, exist_ok=True)
    extra = {}
    if args.device_flood:
        extra["device_flood"] = (True if args.device_flood == "auto"
                                 else args.device_flood)
    if args.flood_telemetry:
        extra["flood_telemetry"] = True
    # debug=False → synchronous headless run that SAVES (debug skips
    # saving, reference parity — segmentation.py:767-768)
    if extra:
        # the flood keywords bypass the signature-parity widget
        seg_func = segmenters[args.segmenter]
        seg_func(viewer, layer, args.output_dir, args.name,
                 args.network, None, args.chunk_size, args.margin,
                 False, devices=_devices(args), **extra)
    else:
        segment_data(
            viewer, layer, save_dir=args.output_dir, name=args.name,
            segmenter=args.segmenter,
            network_or_config_file=args.network,
            chunk_size=args.chunk_size, margin=args.margin, debug=False,
            devices=_devices(args),
        )
    out = os.path.join(args.output_dir, f"{args.name}.ome.zarr")
    if args.pyramid_levels:
        from .io.zarr_io import add_pyramid_levels

        add_pyramid_levels(out, n_levels=args.pyramid_levels)
    print(out)
    return 0


def _cmd_train(args):
    from .viewer import Viewer
    from .widgets import _train_from_viewer

    viewer = Viewer()
    images = _load_layer(viewer, args.images, "images", "Image",
                         args.scale, args.data_type)
    labels = _load_layer(viewer, args.labels, "gt", "Labels",
                         args.scale, args.data_type)
    os.makedirs(args.output_dir, exist_ok=True)
    u_path = _train_from_viewer(
        viewer, images, labels, args.output_dir, args.scale,
        mask_prediction=args.mask, centre_prediciton=args.centre,
        affinities_extent=args.affinities_extent,
        training_name=args.training_name, loss_function=args.loss,
        learning_rate=args.learning_rate, epochs=args.epochs,
        validation_prop=args.validation_prop, n_each=args.n_each,
        predict_labels=args.predict_labels,
        chunk_size=args.chunk_size, margin=args.margin,
        train_shape=args.train_shape, device=args.device,
    )
    for p in u_path:
        print(p)
    return 0


def _cmd_assess(args):
    from .viewer import Viewer
    from .widgets import _assess_segmentation

    viewer = Viewer()
    gt = _load_layer(viewer, args.ground_truth, "gt", "Labels",
                     (1.0, 1.0, 1.0), args.data_type)
    seg = _load_layer(viewer, args.segmentation, "seg", "Labels",
                      (1.0, 1.0, 1.0), args.data_type)
    os.makedirs(args.output_dir, exist_ok=True)
    _assess_segmentation(
        gt, seg, chunk_size=args.chunk_size, margin=args.margin,
        save_dir=args.output_dir, save_prefix=args.prefix,
        name=args.name, show=False,
        exclude_chunks_less_than=args.exclude_chunks_less_than,
    )
    name = args.name if args.name is not None else args.prefix
    print(os.path.join(args.output_dir,
                       f"{args.prefix}_{name}_scores.csv"))
    return 0


def _pod_devices(args, process_id):
    """This process's devices: every card with ``--local-devices``, the
    ``--device`` when given, else ``cuda:{process_id % device_count}`` (so
    the processes of one host spread over its cards)."""
    import torch

    from .device import resolve_device

    if args.local_devices:
        return _local_devices()
    if args.device is not None:
        return [torch.device(args.device)]
    resolve_device(None)
    return [torch.device("cuda", process_id % torch.cuda.device_count())]


def _cmd_pod_segment(args):
    from .parallel import multihost as mh

    if args.coordinator is not None:
        mh.init_multihost(args.coordinator,
                          num_processes=args.num_processes,
                          process_id=args.process_id,
                          run_nonce=args.run_nonce)
    elif args.run_nonce is not None:
        mh.set_run_nonce(args.run_nonce)
    host_id, _ = mh._resolve_host(args.process_id, args.num_processes)
    done = mh.multihost_segment_zarr(
        args.input, args.output, segmenter=args.segmenter,
        network_or_config_file=args.network,
        chunk_size=args.chunk_size, margin=args.margin,
        host_id=args.process_id, n_hosts=args.num_processes,
        devices=_pod_devices(args, host_id),
    )
    print(f"host frames: {done}")
    if args.gt is not None:
        from .core.chunks import get_slices_from_chunks
        from .io.zarr_io import open_zarr

        # zarr-backed on purpose: the metrics shard reads only this
        # host's chunks
        gt = open_zarr(args.gt)
        seg = open_zarr(args.output)
        metrics_dir = args.metrics_dir or os.path.dirname(
            str(args.output).rstrip("/")
        )
        slices = get_slices_from_chunks(seg.shape, args.chunk_size,
                                        args.margin)
        mh.multihost_accuracy_metrics(
            slices, gt, seg, "pod", args.prefix, out_path=metrics_dir,
            exclude_chunks=args.exclude_chunks_less_than,
            host_id=args.process_id, n_hosts=args.num_processes,
        )
        print(os.path.join(metrics_dir, f"{args.prefix}_pod_scores.csv"))
    print(args.output)
    return 0


def _cmd_serve(args):
    from .engine.serve import SegmentationServer, watch

    devices = _local_devices() if args.local_devices else _devices(args)
    server = SegmentationServer(
        segmenter=args.segmenter,
        network_or_config_file=args.network,
        chunk_size=args.chunk_size, margin=args.margin,
        devices=devices,
    )
    errors = []
    done = watch(args.watch_dir, args.output_dir, server,
                 poll_seconds=args.poll_seconds, once=args.once,
                 max_volumes=args.max_volumes,
                 pyramid_levels=args.pyramid_levels, errors=errors)
    for stem in done:
        print(os.path.join(args.output_dir, stem + ".ome.zarr"))
    return 1 if errors else 0


def _cmd_convert(args):
    from .models.convert import (load_checkpoint, save_checkpoint,
                                 save_checkpoint_orbax)

    params = load_checkpoint(args.input)
    out = str(args.output)
    if out.endswith((".npz", ".pt", ".pth")):
        written = save_checkpoint(params, out)
    else:
        written = save_checkpoint_orbax(params, out)
    print(written)
    return 0


def _cmd_info(args):
    import torch

    from . import __name__ as pkg
    from .engine.segmentation import segmenters
    from .engine.predict import DEFAULT_UNET_PATH

    names = [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]
    print(f"package: {pkg}")
    print(f"torch: {torch.__version__}")
    print(f"cuda: {torch.version.cuda}")
    print("devices: " + (", ".join(names) if names else "no CUDA device"))
    print("segmenters: " + ", ".join(sorted(segmenters)))
    print(f"default unet: {DEFAULT_UNET_PATH} "
          f"({'present' if os.path.exists(DEFAULT_UNET_PATH) else 'MISSING'})")
    return 0


def _add_common_io(p):
    p.add_argument("--data-type", default="individual frames",
                   choices=["individual frames", "image stacks"],
                   help="how directory frames stack (read_data semantics)")
    p.add_argument("--chunk-size", type=_tuple3, default=(10, 256, 256),
                   metavar="Z,Y,X")
    p.add_argument("--margin", type=_tuple3, default=(1, 64, 64),
                   metavar="Z,Y,X")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="iterseg-tpu-torch",
        description=(
            "Iterative 3D instance segmentation on PyTorch and CUDA — "
            "headless drivers for the segment / train / assess loop."
        ),
    )
    ap.add_argument("--device", default=None,
                    help="torch device that segment, train and serve run "
                         "on (default: CUDA; 'cpu' runs on the CPU)")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("segment", help="segment a volume/timeseries into "
                       "an OME-Zarr labels store")
    p.add_argument("--input", required=True,
                   help="zarr store, tiff file, or directory of frames")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--name", default="labels-prediction")
    p.add_argument("--segmenter", default="affinity-unet-watershed")
    p.add_argument("--network", default=None,
                   help=".npz/.pt checkpoint or segmenter config JSON "
                        "(default: bundled default U-Net)")
    p.add_argument("--scale", type=_scale3, default=(1.0, 1.0, 1.0),
                   metavar="Z,Y,X")
    p.add_argument("--pyramid-levels", type=int, default=0,
                   help="append N downsampled NGFF levels to the output "
                        "labels store (level 0 stays the exact labels)")
    p.add_argument("--device-flood", default=None,
                   choices=["auto", "xla", "pallas", "exact"],
                   help="run the watershed flood on the device: pallas "
                        "= the approximate CUDA flood kernel, xla = the "
                        "approximate torch recurrence, exact = the "
                        "verified flood (labels bit-equal to the host "
                        "flood's), auto = pallas or the host flood by the "
                        "measured link rate (xla on the CPU)")
    p.add_argument("--flood-telemetry", action="store_true",
                   help="report a rigorous per-run disagreement bound "
                        "for approximate flood modes")
    _add_common_io(p)
    p.set_defaults(fn=_cmd_segment)

    p = sub.add_parser("train", help="train an affinity U-Net from image "
                       "+ ground-truth frames")
    p.add_argument("--images", required=True,
                   help="zarr store, tiff file, or directory of frames")
    p.add_argument("--labels", required=True,
                   help="matching ground-truth store/file/directory")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--training-name", default="my-unet")
    p.add_argument("--scale", type=_scale3, default=(1.0, 1.0, 1.0),
                   metavar="Z,Y,X")
    p.add_argument("--mask", default="mask")
    p.add_argument("--centre", default="centreness-log")
    p.add_argument("--affinities-extent", type=int, default=1)
    p.add_argument("--loss", default="BCELoss")
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--validation-prop", type=float, default=0.2)
    p.add_argument("--n-each", type=int, default=50)
    p.add_argument("--no-predict", dest="predict_labels",
                   action="store_false",
                   help="skip segmenting the training stack with the "
                        "fresh network")
    p.add_argument("--train-shape", type=_tuple3, default=None,
                   metavar="Z,Y,X",
                   help="random-crop shape for training data (default: "
                        "the reference-fixed 10,256,256)")
    _add_common_io(p)
    p.set_defaults(fn=_cmd_train)

    p = sub.add_parser("assess", help="VI / AP / object-count metrics of "
                       "a segmentation against ground truth")
    p.add_argument("--ground-truth", required=True)
    p.add_argument("--segmentation", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--prefix", default="segmentation-metrics")
    p.add_argument("--name", default=None)
    p.add_argument("--exclude-chunks-less-than", type=int, default=10)
    _add_common_io(p)
    p.set_defaults(fn=_cmd_assess)

    p = sub.add_parser("pod-segment", help="multi-host segmentation of a "
                       "shared zarr: frames round-robin over processes "
                       "joined by torch.distributed (gloo)")
    p.add_argument("--input", required=True, help="shared tzyx zarr store")
    p.add_argument("--output", required=True,
                   help="shared output zarr (host 0 creates it, "
                        "one-frame-per-chunk)")
    p.add_argument("--segmenter", default="affinity-unet-watershed")
    p.add_argument("--network", default=None,
                   help=".npz/.pt checkpoint or segmenter config JSON")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process 0's address for the gloo process "
                        "group; omit on a single host (or shard via "
                        "--process-id/--num-processes over a shared "
                        "filesystem)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--run-nonce", default=None,
                   help="string identical on every host of THIS run; "
                        "scopes the file-based metric exchange")
    p.add_argument("--local-devices", action="store_true",
                   help="round-robin this host's frame shard across all "
                        "its cards (default: one card a process, "
                        "cuda:{process_id %% device_count}, or --device)")
    p.add_argument("--gt", default=None,
                   help="optional ground-truth zarr: pod-sharded "
                        "VI/AP/count metrics after segmentation")
    p.add_argument("--metrics-dir", default=None)
    p.add_argument("--prefix", default="pod-metrics")
    p.add_argument("--exclude-chunks-less-than", type=int, default=10)
    _add_common_io(p)
    p.set_defaults(fn=_cmd_pod_segment)

    p = sub.add_parser("serve", help="prep-once serve-many: watch a "
                       "directory and segment volumes as they arrive")
    p.add_argument("--watch-dir", required=True,
                   help="directory where *.zarr stores / *.tif files land")
    p.add_argument("--output-dir", required=True,
                   help="labels land at <output-dir>/<stem>.ome.zarr with "
                        "a <stem>.done marker")
    p.add_argument("--segmenter", default="affinity-unet-watershed")
    p.add_argument("--network", default=None,
                   help=".npz/.pt checkpoint or segmenter config JSON")
    p.add_argument("--poll-seconds", type=float, default=5.0)
    p.add_argument("--once", action="store_true",
                   help="drain the pending inputs once and exit")
    p.add_argument("--max-volumes", type=int, default=None,
                   help="stop after serving this many volumes")
    p.add_argument("--local-devices", action="store_true",
                   help="round-robin 4D frames across all local cards")
    p.add_argument("--pyramid-levels", type=int, default=0,
                   help="append N downsampled NGFF levels per served "
                        "store (level 0 stays the exact labels)")
    _add_common_io(p)
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("convert", help="convert U-Net checkpoints between "
                       ".pt/.pth (torch), .npz (native) and orbax "
                       "(directory) formats")
    p.add_argument("--input", required=True,
                   help=".npz / .pt / .pth file or orbax directory")
    p.add_argument("--output", required=True,
                   help="suffix picks the format: .npz / .pt / .pth, "
                        "anything else is written as an orbax directory")
    p.set_defaults(fn=_cmd_convert)

    p = sub.add_parser("info", help="report torch, CUDA, devices, "
                       "registered segmenters and bundled weights")
    p.set_defaults(fn=_cmd_info)

    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
