"""Shared set-up of the benchmark's tests: its folder and the repository
on ``sys.path``, and its cells cut to a size the CPU runs in seconds.

    python -m pytest portbench/tests -q            # CPU (card tests skip)
    python -m pytest portbench/tests -q -m cuda    # on a CUDA card
"""
import os
import sys

import pytest

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [PORTBENCH, os.path.dirname(PORTBENCH)]


def tiny(name, frame=(10, 64, 96)):
    """``(spec, cfg, mix, limits)`` of the cell ``name`` cut to a tiny
    size: frames of ``frame`` with 12 blobs, (10, 64, 64) chunks with
    (1, 16, 16) margins, small pools and short calls."""
    from harness import bench

    spec, _, cfg, mix, limits = bench.load_cell(name)
    cfg = dict(cfg, frame=list(frame),
               assumed=dict(cfg["assumed"], blobs_per_frame=12))
    if "chunk" in cfg["segment"]:
        cfg["segment"] = dict(cfg["segment"], chunk=[10, 64, 64],
                              margin=[1, 16, 16])
    mix = dict(mix)
    if mix["driver"] == "segment":
        per_call = min(mix["frames_per_call"], 2)
        calls = 2 if per_call else 3
        mix.update(pool=3, frames_per_call=per_call, devices=per_call or 1,
                   checked_frames=min(mix["checked_frames"],
                                      max(per_call, 1) * calls))
        if per_call:
            mix.update(distinct_calls=calls)
    else:
        mix.update(pool=4, chunk=[10, 32, 64], source_frames=2, min_steps=2,
                   warm_steps=5)
    return spec, cfg, mix, limits


@pytest.fixture
def cpu_context():
    """A function making a CPU ``Context`` of a tiny cell."""
    import torch
    from harness import bench

    def make(name, seed=2**31 + 11, **kw):
        spec, cfg, mix, limits = tiny(name, **kw)
        ctx = bench.Context(name, cfg, mix, seed, [torch.device("cpu")])
        return ctx, limits

    return make


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 and the cells' sizes exist "
                    "only there")
    return torch.device("cuda")
