"""Profile the full-width U-Net train step on one CUDA card.

    python -m iterseg_tpu_torch.train.step_profile [--steps 5]

The step is the one ``train_unet`` runs: the shipped ``default_unet.npz``
in train mode on a (1, 1, 10, 256, 256) chunk with 5 target channels, BCE,
backward and two Adam steps, inside ``device.f32_numerics()`` (TF32 off,
deterministic cuDNN). After warm-up steps it prints one JSON line:

- ``step_ms``: the mean step time by CUDA events;
- ``busy_share``: the union of the device's kernel intervals over the
  traced window of ``--steps`` steps (``torch.profiler``), or null when the
  trace holds no device time;
- ``top_kernels``: the kernels with the most device time in that window,
  each with its share of the summed kernel time;
- ``nondeterministic_step_ms``: the same step timed with cuDNN allowed its
  nondeterministic algorithms and autotuning (TF32 still off), for
  comparison only: the port always trains deterministic.

Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _step_fn(net, opt, x, y):
    from .losses import bce_loss

    def step():
        opt.zero_grad(set_to_none=True)
        bce_loss(net(x), y).backward()
        opt.step()
        opt.step()

    return step


def _event_ms(fn, reps):
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _busy_and_kernels(prof, top):
    """Union of the device kernel intervals over the traced window, and
    the kernels with the most device time. User annotations on the device
    timeline (``Optimizer.step#Adam.step``) span the gaps between their
    kernels, so they are left out."""
    spans, per_name = [], {}
    for e in prof.events():
        if (str(e.device_type).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False)
                and e.time_range.end > e.time_range.start):
            spans.append((e.time_range.start, e.time_range.end))
            per_name[e.name] = per_name.get(e.name, 0) + (
                e.time_range.end - e.time_range.start)
    if not spans:
        return None, []
    spans.sort()
    busy, (cur_s, cur_e) = 0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    total = sum(per_name.values())
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return busy / window, [{"name": n[:120], "ms": us / 1e3,
                            "share": us / total} for n, us in ranked]


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_profile: no CUDA card", file=sys.stderr)
        return 2
    from ..device import f32_numerics
    from ..engine.predict import load_unet

    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    gen = torch.Generator(dev).manual_seed(0)
    chunk = (1, 1, 10, 256, 256)
    x = torch.rand(chunk, device=dev, generator=gen)
    y = (torch.rand((1, 5) + chunk[2:], device=dev, generator=gen)
         > 0.5).float()
    net = load_unet(None).module(dev).train()
    opt = torch.optim.Adam(net.parameters(), lr=0.01)
    step = _step_fn(net, opt, x, y)
    with f32_numerics():
        step_ms = _event_ms(step, args.steps)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
    busy, kernels = _busy_and_kernels(prof, args.top)
    with f32_numerics():  # restores both settings on exit
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        nondet_ms = _event_ms(step, args.steps)
    print(json.dumps({
        "gpu": gpu, "chunk": list(chunk), "steps": args.steps,
        "step_ms": step_ms, "busy_share": busy,
        "nondeterministic_step_ms": nondet_ms, "top_kernels": kernels,
        "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
