"""Readings that the limits of ``correct`` are set from.

    python3 portbench/controls.py --workload <name> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--seconds 1] [--out <file.jsonl>]

In one process, at the cell's own sizes: for each of ``--seeds`` a short
window of the program (as a run makes it) and its numbers against the
reference (the lower readings); for each of ``--control-seeds`` the
reference in the precision below the configuration's, against the
reference (the upper readings), and the driver's planted faults: for a
stack, half of its frames left out (the program's labels of every other
frame zeroed) and the program's own bfloat16 path (affinity segmenter);
for training, half of the batch left out. One JSON line a reading. Needs
the cell's cards.
"""
import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import bench  # noqa: E402


@contextlib.contextmanager
def half_the_frames():
    """The stack driver zeroes the labels of every other frame."""
    from iterseg_tpu_torch.engine import device_pipeline as dp

    real = dp._drive_stack

    def half(stack, output_labels, *args):
        for t in real(stack, output_labels, *args):
            if t % 2:
                output_labels[t] = 0
            yield t

    dp._drive_stack = half
    try:
        yield
    finally:
        dp._drive_stack = real


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 3
    bench.set_cache_dirs()
    _, work, cfg, mix, _ = bench.load_cell(args.workload)
    chips = int(work["chips"])
    if torch.cuda.device_count() < chips:
        print(f"controls: the cell needs {chips} CUDA cards", file=sys.stderr)
        return 3
    cards = [torch.device("cuda", i) for i in range(chips)]
    out = open(args.out, "a") if args.out else None
    train = mix["driver"] == "train"
    stack = mix["driver"] == "segment" and mix["frames_per_call"] > 0

    def emit(row):
        row = dict(row, workload=args.workload,
                   card=torch.cuda.get_device_name(0))
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def ctx(seed, **cfg_kw):
        return bench.Context(args.workload, dict(cfg, **cfg_kw), mix, seed,
                             cards)

    def program(seed, **cfg_kw):
        """A run's numbers (training: with the median leaf's beside)."""
        d = bench.make_driver(ctx(seed, **cfg_kw))
        d.warm()
        d.window(args.seconds)
        d.release()
        if train:
            checks = d.check(median=True)
            checks["left_out"] = d.left_out
            return checks
        return d.check()

    for seed in args.seeds:
        t0 = time.perf_counter()
        emit({"side": "program", "seed": seed, **program(seed),
              "s": time.perf_counter() - t0})
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        d = bench.make_driver(ctx(seed))
        emit({"side": "control", "seed": seed,
              **(d.control(median=True) if train else d.control()),
              "s": time.perf_counter() - t0})
        if train:
            emit({"side": "fault_half_batch", "seed": seed,
                  **d.fault_half_batch(median=True)})
            emit({"side": "fault_state_unchanged", "seed": seed,
                  **d.fault_state_unchanged()})
        del d
        if stack:
            with half_the_frames():
                emit({"side": "fault_half_frames", "seed": seed,
                      **program(seed)})
        if not train and (cfg["segment"]["segmenter"]
                          == "affinity-unet-watershed"):
            emit({"side": "program_bfloat16", "seed": seed,
                  **program(seed, dtype="bfloat16")})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
