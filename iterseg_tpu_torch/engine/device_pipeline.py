"""Device-resident segmentation pipelines: the affinity U-Net watershed
(``AffinityPipeline``) and the DoG blob watershed (``DoGPipeline``).

The port of ``iterseg_tpu/engine/device_pipeline.py``. ``AffinityPipeline``
keeps everything up to the candidates on the GPU; the host receives only the
bit-packed threshold mask, the live prefix of the sorted peak candidates and
the affinities at masked voxels (an async copy into pinned memory that runs
under the host's spacing and size-filter work), then runs the exact C++ heap
flood. The ``device_flood`` modes move the flood onto the device:

- ``"pallas"``: the hand-written CUDA kernel (``ops/flood_kernel``), only
  labels come back (approximate: equal support and ids);
- ``"xla"``: the torch claim recurrence (``ops/device_flood``), JAX's
  ``"xla"`` labels bit for bit (approximate as well);
- ``"exact"``: the verified exact flood (``ops/flood_exact``) behind a tie
  probe, with the exact host flood running on a worker thread meanwhile:
  labels bit-equal to the default's on every path;
- ``True``: ``"pallas"`` on CUDA when the measured link reaches
  ``linkprobe.MEASURED``'s crossover, else the host flood; ``"xla"`` on
  the CPU.

``flood_telemetry=True`` runs the certificate beside ``"pallas"`` and
``"xla"`` and reports a rigorous bound on their disagreement with the heap.

Stages, per volume:

  F  chunk-grid, microbatched U-Net forward and margin-crop reassembly
     (``get_feature_program``; ``predict_volume`` runs the same program, so
     the fast and the generic path are bit-identical by construction);
  P  feature prep (``ops.watershed._prep_feature_maps``);
  C  threshold compare + MSB-first bit-pack, 3³ max-filter peak candidates
     above 0.04 in the interior, a stable argsort capped at 2^18;
  H  host half: spacing, native size-band filter, masked affinity gather,
     exact heap flood (or the device flood).

``DoGPipeline`` (no network) computes on the GPU, per volume: the DoG
threshold mask (bit-packed), the ``blob_dog`` scale-space candidates
(stable-sorted, capacity-capped) and the exact squared EDT, which stays on
the card. The host prunes the blobs and labels the seeds, while the masked
d² gather downloads underneath, then runs the exact bucket flood (the heap
past ``native.BUCKET_FLOOD_MAX_KEY``). With ``device_flood="pallas"`` the
flood runs on the GPU in the hand-written CUDA image kernel
(``ops/image_flood_kernel``) on ``-sqrt(d²)``, at every frame width;
``"xla"`` runs the torch hop-tie recurrence there, and ``"exact"`` the
verified exact image flood on ``-d²``. Both run one skeleton
(``_Pipeline``).
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from ..core.chunks import chunk_slices, make_chunks
from ..device import f32_numerics, resolve_device
from ..ops.cc import size_band_filter
from ..ops.filters import maximum_filter
from ..ops.watershed_oracle import neighbor_offsets
from ..utils import carried, count, frame_span, group, recording, span
from .. import native

__all__ = ["AffinityPipeline", "DoGPipeline", "get_feature_program",
           "flood_fallbacks", "reset_flood_fallbacks"]

_CAND_CAP = 1 << 18  # max pre-sorted peak candidates shipped to host
# the device floods' cap: launches of a CUDA kernel, steps of a recurrence
_FLOOD_MAX_STEPS = 512
_flood_fallbacks = 0


def flood_fallbacks() -> int:
    """Device floods that did not converge and fell back to the host flood
    since the last reset."""
    return _flood_fallbacks


def reset_flood_fallbacks():
    global _flood_fallbacks
    _flood_fallbacks = 0


def _on(device):
    """The CUDA device guard of ``device`` (a no-op for the CPU and for
    ``None``): work dispatched under it, events and the flood kernels'
    launches included, runs on that card whichever card is current."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _HostCopy:
    """A device tensor on its way to host memory: a non-blocking copy into
    pinned memory on the tensor's card's current stream, fenced by an
    event. ``get()`` waits for that event only, so a thread may wait on it
    while later work runs on the stream, and hands its pinned buffer to the
    array it returns: a copy is read once, and the buffer is freed (which
    records CUDA events) when that array goes, inside the span that last
    uses it. ``tensor`` is the device tensor. CPU tensors pass through."""

    def __init__(self, t: torch.Tensor):
        self.tensor = t
        self._event = None
        if t.device.type == "cuda":
            with torch.cuda.device(t.device):
                self._host = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                self._host.copy_(t, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record()
        else:
            self._host = t

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        host, self._host = self._host, None
        return host.numpy()


def _host(x) -> np.ndarray:
    return x.get() if isinstance(x, _HostCopy) else x.cpu().numpy()


class _Speculative:
    """Run ``fn(profile_dict)`` on a worker thread; ``join`` returns
    ``(result, profile_dict)`` or re-raises the thread's exception.

    ``device_flood="exact"`` runs the exact host flood here while the main
    thread runs the certificate: a fallback then costs about the larger of
    the two, not their sum. The worker touches only its own buffers and
    the pipeline's host scatter buffer (which the main thread does not use
    in that mode), waits only on the gather's own event (``_HostCopy``),
    and the caller always joins it before returning. Its spans carry the
    caller's call and frame."""

    def __init__(self, fn):
        import threading

        self._prof = {}
        self._result = None
        self._exc = None

        def run():
            try:
                self._result = fn(self._prof)
            except BaseException as e:  # re-raised on join
                self._exc = e

        self._thread = threading.Thread(
            target=carried(run), name="iterseg-speculative-flood",
            daemon=True)

    def start(self):
        self._thread.start()

    def join(self):
        self._thread.join()
        if self._exc is not None:
            raise self._exc
        return self._result, self._prof


def _flood_prep(bits, coords, labs, pshape):
    """Unpack the host-packed mask bits (MSB first) and scatter the seed
    labels (max over duplicates) on the device of ``bits``."""
    psize = int(np.prod(pshape))
    mask = _unpack_bits(bits, pshape)
    seeds = torch.zeros(psize, dtype=torch.int32, device=bits.device)
    strides = torch.tensor([pshape[1] * pshape[2], pshape[2], 1],
                           dtype=torch.int64, device=bits.device)
    flat_idx = (coords.to(torch.int64) * strides).sum(1)
    seeds.scatter_reduce_(0, flat_idx, labs, reduce="amax")
    return mask, seeds.reshape(pshape)


def _unpack_bits(bits, shape):
    """The bool tensor of ``shape`` that MSB-first ``bits`` (uint8) pack."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=bits.device)
    flat = ((bits[:, None] >> shifts) & 1).reshape(-1)[:int(np.prod(shape))]
    return flat.to(torch.bool).reshape(shape)


def _tie_probe(mask_packed, aff_pad):
    """The fraction (a float32 tensor on the device) of in-mask voxels whose
    claim competition is exactly tied, on the pre-filter mask (JAX
    ``_cached_tie_probe``): dispatched at the top of ``_finalize`` for
    ``device_flood="exact"``, read after the host filter work."""
    from ..ops.flood_exact import _affinity_ties, _edge_weights

    zyx = tuple(s - 2 for s in aff_pad.shape[1:])
    mask = torch.nn.functional.pad(_unpack_bits(mask_packed, zyx),
                                   (1, 1, 1, 1, 1, 1))
    ties = _affinity_ties(_edge_weights(aff_pad), mask)
    n = mask.sum().clamp_min(1)
    return ties.sum().to(torch.float32) / n.to(torch.float32)


def _integer_wire(dtype) -> bool:
    """The frames' wire format: an integer frame of at most 4 bytes a voxel
    crosses the link in its own dtype and is converted, and divided by its
    max, on the device — bit-identical to the host's ``prepare_volume``
    (int -> f32 rounds alike on both, max is exact selection, the same f32
    division); any other frame crosses as float32."""
    return bool(np.issubdtype(dtype, np.integer)
                and np.dtype(dtype).itemsize <= 4)


def _prepare_frame(raw):
    """Per-frame input contract of the device pipelines: ``(vol, kept,
    device_normalize)``. Integer frames (``_integer_wire``) keep their
    source dtype and are normalised on the device; others take the host
    ``prepare_volume`` path."""
    from ..core.volume import prepare_volume, remove_sum_zero_slices

    orig_shape = raw.shape
    if _integer_wire(raw.dtype):
        vol, kept = raw, None
        if vol.min() == 0:
            vol, kept = remove_sum_zero_slices(vol, return_kept=True)
            if vol.shape == orig_shape:
                kept = None
        return np.ascontiguousarray(vol), kept, True
    vol, kept = prepare_volume(raw.astype(np.float32), return_kept=True)
    return np.ascontiguousarray(vol), kept, False


# each card's frame streams, made once: the caching allocator keeps its
# blocks per stream, so streams made anew for each stack would strand them
_frame_streams = {}


def _card_index(device):
    """The CUDA card ``device`` names (the current one for a bare
    ``cuda``), or ``None`` for the CPU and for ``None``."""
    if device is None:
        return None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return (device.index if device.index is not None
            else torch.cuda.current_device())


class _CardStreams:
    """The streams a stack's frames take on each CUDA card of ``cards``,
    in turn: one for each frame that can be in flight there (the card's
    count in ``cards``, plus one, with the lookahead at ``len(cards)``)."""

    def __init__(self, cards):
        counts = collections.Counter(_card_index(c) for c in cards)
        counts.pop(None, None)
        self._pools = {}
        for index, n in counts.items():
            pool = _frame_streams.setdefault(index, [])
            while len(pool) <= n:
                pool.append(torch.cuda.Stream(device=index))
            self._pools[index] = pool[:n + 1]
        self._taken = collections.Counter()
        self._dispatched = {}

    @contextlib.contextmanager
    def dispatching(self, card):
        """Make the card's next stream current (``None`` on the CPU) and
        order its work after the card's previous dispatch, so the card runs
        the frames in turn while the host runs ahead of it."""
        index = _card_index(card)
        if index is None:
            yield None
            return
        pool = self._pools[index]
        stream = pool[self._taken[index] % len(pool)]
        self._taken[index] += 1
        with torch.cuda.stream(stream):
            if index in self._dispatched:
                stream.wait_event(self._dispatched[index])
            yield stream
            done = self._dispatched[index] = torch.cuda.Event()
            done.record(stream)


def _frame_stream(stream):
    """Make ``stream`` (``None``: leave the current stream) current."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def _drive_stack(stack, output_labels, skip_labelled, devices,
                 dispatch_one, finalize_one, own_device=None):
    """Pipelined 4D drive: frame t+1's device work is dispatched before
    frame t's host finalisation, with warm-restart skipping of labelled
    frames. ``devices``: frames round-robin over the list (frame
    parallelism), with the dispatch lookahead widened to its length so
    every card has a frame queued; ``None`` is the pipeline's own device,
    ``own_device``. ``dispatch_one(t, device)`` returns a job,
    ``finalize_one(job)`` the frame's labels; both run under the frame's
    device guard and its ``frame`` span.

    On CUDA each frame in flight owns a stream of its card
    (``_CardStreams``), current while its dispatch and its finalisation
    run (never across a ``yield``): a frame's host reads wait for that
    frame's work alone, and a dispatch does not wait for the card. The
    counter ``async_dispatch`` counts the frames whose stream still has
    work queued when their dispatch returns (one non-blocking query):
    their dispatch did not wait for their work to run."""
    todo = [t for t in range(stack.shape[0])
            if not (skip_labelled and np.any(np.asarray(output_labels[t])))]
    cards = [own_device] if devices is None else list(devices)
    streams = _CardStreams(cards)
    lookahead = len(cards)
    pending = []
    next_dispatch = 0
    for i in range(len(todo)):
        while next_dispatch < len(todo) and next_dispatch <= i + lookahead:
            t = todo[next_dispatch]
            card = cards[next_dispatch % len(cards)]
            device = None if devices is None else card
            frame = frame_span(t, card)
            with _on(device), frame, streams.dispatching(card) as stream:
                job = dispatch_one(t, device)
                if stream is not None and not stream.query():
                    count("async_dispatch")
            pending.append((t, device, frame, stream, job))
            next_dispatch += 1
        jt, device, frame, stream, job = pending.pop(0)
        with _on(device), frame, _frame_stream(stream):
            labels = finalize_one(job)
            with span("restore"):
                output_labels[jt] = labels
        frame.close()
        yield jt


def _valid_grid(zyx, chunk_size, margin, mults=(2, 16, 16)):
    """Pad/clamp logic shared with predict_volume: each chunk axis a
    multiple of ``mults`` (the model's ``chunk_multiples``; by default the
    U-Net's: z even, y/x %16)."""
    pads = []
    for s, c, m in zip(zyx, chunk_size, mults):
        usable = min(c, s)
        # pad only when the VOLUME axis is below the minimum; a chunk axis
        # below it is bumped up to the minimum instead
        pads.append((0, 0) if usable >= m else (0, max(m - s, 0)))
    padded = tuple(s + p[1] for s, p in zip(zyx, pads))
    chunk = tuple(
        (max(min(int(c), int(s)), m) // m) * m
        for c, s, m in zip(chunk_size, padded, mults)
    )
    marg = tuple(
        min(int(mg), (min(int(s), int(c)) - 1) // 2)
        for mg, s, c in zip(margin, padded, chunk)
    )
    return pads, padded, chunk, marg


def _upload_frame(vol, device, normalize):
    """The numpy volume ``vol`` as float32 on ``device``, divided by its max
    when ``normalize`` (the max of the converted volume: the host's
    ``np.max(vol.astype(np.float32))``, as int -> f32 is exact and max
    selects). It is uploaded once, in its wire dtype (``_integer_wire``):
    on CUDA staged in pinned memory and copied with ``non_blocking`` on the
    current stream, so the host does not wait for the work queued there (a
    pageable copy would); torch's pinned pool reuses the staging buffer
    only once that copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(
        vol, None if _integer_wire(vol.dtype) else np.float32))
    if torch.device(device).type == "cuda":
        staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        np.copyto(staged.numpy(), t.numpy())
        t = staged.to(device, non_blocking=True)
    frame = t.to(device=device, dtype=torch.float32)
    return frame / torch.amax(frame) if normalize else frame


def _build_feature_program(model, zyx, chunk_size, margin, microbatch,
                           normalize=False):
    """``program(vol numpy zyx, device) -> (C, zyx) float32 tensor on
    device``: the overlapping chunk grid, grouped into z-ordered microbatches
    of ``microbatch`` chunks (the last one zero-padded, so every forward has
    the same batch), each reading one z-slab of the volume, which is
    uploaded once and converted (and /max-normalised) on the device
    (``_upload_frame``: on CUDA the host does not wait for the card), then
    the margin-cropped pieces concatenated back together."""
    pads, padded, chunk, marg = _valid_grid(zyx, chunk_size, margin,
                                            model.chunk_multiples)
    starts, crops = make_chunks(padded, chunk, marg)
    n = len(starts)
    B = int(min(microbatch, n))
    nb = -(-n // B)
    z_starts = sorted({s[0] for s in starts})
    y_starts = sorted({s[1] for s in starts})
    x_starts = sorted({s[2] for s in starts})
    crop_of = {tuple(s): c for s, c in zip(starts, crops)}
    order = sorted(range(n), key=lambda i: tuple(starts[i]))
    batches = [order[b * B:(b + 1) * B] for b in range(nb)]
    slab_of, rel_starts, pos_of = [], [], {}
    for b, idxs in enumerate(batches):
        z0 = min(starts[i][0] for i in idxs)
        z1 = max(starts[i][0] for i in idxs) + chunk[0]
        slab_of.append((int(z0), int(z1)))
        rel_starts.append(tuple(
            (int(starts[i][0] - z0),) + tuple(int(s) for s in starts[i][1:])
            for i in idxs))
        for slot, i in enumerate(idxs):
            pos_of[tuple(starts[i])] = (b, slot)

    def program(vol, device):
        vol = np.asarray(vol)
        if any(p[1] for p in pads):
            vol = np.pad(vol, pads, mode="edge")
        net = model.module(device)
        ys = []
        with torch.no_grad(), f32_numerics():
            frame = _upload_frame(vol, device, normalize)
            for b, (z0, z1) in enumerate(slab_of):
                v = frame[z0:z1]
                xs = torch.stack([v[chunk_slices(s, chunk)]
                                  for s in rel_starts[b]])[:, None]
                if len(rel_starts[b]) < B:
                    xs = torch.cat([xs, xs.new_zeros(
                        (B - len(rel_starts[b]),) + xs.shape[1:])])
                ys.append(net(xs.to(model.compute_dtype)).float())

        def piece(s):
            b, slot = pos_of[s]
            cr = crop_of[s]
            return ys[b][slot][(slice(None),) + tuple(
                slice(int(a), int(b_)) for a, b_ in cr)]

        zrows = []
        for zs in z_starts:
            yrows = [torch.cat([piece((zs, ysr, xsr)) for xsr in x_starts],
                               dim=3) for ysr in y_starts]
            zrows.append(torch.cat(yrows, dim=2))
        out = torch.cat(zrows, dim=1)
        return out[:, :zyx[0], :zyx[1], :zyx[2]].contiguous()

    program.slab_of = slab_of
    program.microbatch = B
    return program


def get_feature_program(model, zyx, chunk_size=(10, 256, 256),
                        margin=(1, 64, 64), microbatch=None,
                        normalize=False, device=None):
    """The chunked-forward program for this model and geometry.
    ``microbatch=None`` resolves through ``predict._pick_batch_size`` so the
    fast and the generic path run the same batch (part of the numerics)."""
    count("feature_programs")
    zyx = tuple(int(s) for s in zyx)
    chunk_size = tuple(int(c) for c in chunk_size)
    margin = tuple(int(m) for m in margin)
    if microbatch is None:
        from .predict import _pick_batch_size

        _, padded, chunk, marg = _valid_grid(zyx, chunk_size, margin,
                                             model.chunk_multiples)
        starts, _ = make_chunks(padded, chunk, marg)
        microbatch = _pick_batch_size(len(starts), chunk,
                                      model.out_channels, device,
                                      model.activation_bytes(chunk))
    return _build_feature_program(model, zyx, chunk_size, margin,
                                  int(microbatch), normalize)


def _pack_mask_bits(mask):
    """Pack a boolean tensor MSB-first (the np.unpackbits layout) into
    uint8. The bit shifts are made on the device: a host-made tensor would
    be a synchronising copy."""
    mbits = mask.reshape(-1)
    pad_bits = (-mbits.numel()) % 8
    if pad_bits:
        mbits = torch.cat([mbits, mbits.new_zeros(pad_bits)])
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=mask.device)
    return (mbits.reshape(-1, 8).to(torch.uint8) << shifts).sum(
        1, dtype=torch.uint8)


_MODES = (False, "xla", "pallas", "exact")


def _f32(x) -> float:
    """A python float that is exactly ``x`` rounded to float32, for
    scalars that JAX would take as weak-typed f32."""
    return float(np.float32(x))


def _host_mask(mask_packed, shape, profile=None):
    """The uint8 mask of ``shape`` that the MSB-first bits ``mask_packed``
    (a ``_HostCopy`` or a tensor) pack, on the host."""
    mask = np.unpackbits(_host(mask_packed))[:int(np.prod(shape))]
    _moved(profile, "bytes_mask", mask_packed)
    return mask.reshape(shape)


def _masked_gather(t, mask, profile=None):
    """``t``'s values at the voxels of the host ``mask`` (its last axes),
    gathered on the device, with their copy to host started: ``(flat
    indices, their count, the copy)``."""
    flat = np.flatnonzero(mask.ravel())
    idx = torch.from_numpy(flat).to(t.device)
    vals = _HostCopy(t.reshape(t.shape[:t.dim() - mask.ndim] + (-1,))[
        ..., idx])
    _moved(profile, "bytes_gather", idx)
    _moved(profile, "bytes_gather", vals)
    return flat, len(flat), vals


class _Pipeline:
    """The skeleton both segmenters run: a frame's device program
    (``_device_outputs``), then its host half (``_finalize``), which ends in
    ``_flood``. A subclass gives those two, its mask and seed upload, its
    device floods (``_approx_flood``, ``_verified``), its host flood and
    the masked gather that flood reads; ``fin`` is its flood inputs."""

    normalize = False  # the card's ``/ max`` where a call does not say
    flood_telemetry = False
    # "exact" runs the host flood on a worker thread under the certificate
    # when the gather was dispatched early (``_flood_exact``); the labels
    # are the same either way
    speculative_flood = True
    _keeps_ring = False  # whether ``_finalize``'s labels keep the pad ring

    @staticmethod
    def normalize_device_flood(value, device=None):
        """The canonical ``device_flood`` setting: ``False`` (the exact host
        flood), ``"xla"`` (the torch recurrence of ``ops/device_flood``),
        ``"pallas"`` (the hand-written CUDA flood, at every frame width: it
        replaces the Pallas one, so JAX callers move over unchanged) or
        ``"exact"`` (the verified exact flood of ``ops/flood_exact``, labels
        bit-equal to the host flood's). ``True`` resolves as JAX resolves
        it, with the CUDA card in the TPU's role: on a CUDA ``device``
        (``None``: CUDA when a card is visible) to ``"pallas"`` when the
        measured link rate (``linkprobe.measure_link_mbps``) reaches
        ``MEASURED["device_flood_crossover_mbps"]``, else to ``False``; on
        the CPU to ``"xla"``. ``None`` is ``False``. Cache keys use it, so
        ``True`` and what it resolves to share one pipeline."""
        if value is True:
            if device is None:
                device = "cuda" if torch.cuda.is_available() else "cpu"
            device = torch.device(device)
            if device.type == "cuda":
                from . import linkprobe

                mbps = linkprobe.measure_link_mbps(device)
                value = ("pallas" if mbps is not None and mbps
                         >= linkprobe.MEASURED["device_flood_crossover_mbps"]
                         else False)
            else:
                value = "xla"
        value = value or False
        if value not in _MODES:
            raise ValueError(f"unknown device_flood {value!r}; expected one "
                             "of False, True, 'xla', 'pallas', 'exact'")
        return value

    def segment(self, volume, out=None, profile=None, normalize=None):
        """Instance labels (int32) of one prepared zyx volume: of
        ``volume.shape`` for the affinity, of ``volume.shape + 2`` for the
        DoG (the padded frame, the reference's ``current_output`` contract).
        ``out``: the affinity's flat padded buffer or the DoG's padded
        frame, which takes the labels. ``normalize``: divide by the volume's
        max on the device (``None``: the pipeline's ``normalize``). Integer
        volumes upload in their source dtype (``_upload_frame``)."""
        volume = np.asarray(volume)
        with _on(self.device):
            with span("dispatch", profile, "device_program"):
                outs = self._device_outputs(
                    volume, self.device, (self.normalize if normalize is None
                                          else normalize))
            return self._finalize(volume.shape, outs, out=out,
                                  profile=profile)

    def segment_stack(self, stack, output_labels, skip_labelled=True,
                      profile=None, devices=None):
        """Pipelined 4D (t, z, y, x) segmentation: frame t+1's device work is
        queued before frame t's host half runs. Writes the frame's labels
        into ``output_labels[t]`` and yields t (warm restart when
        ``skip_labelled``). ``devices``: a list of ``torch.device``s the
        frames round-robin over (frame parallelism); each device builds
        what it runs at its first frame, and the labels are those of the
        one-device call."""
        from ..core.volume import restore_labels

        inner = (slice(1, -1) if self._keeps_ring else slice(None),) * 3

        def dispatch_one(t, device):
            with span("dispatch", profile, "device_program"):
                raw = np.asarray(stack[t])
                vol, kept, dev_norm = _prepare_frame(raw)
                outs = self._device_outputs(
                    vol, self.device if device is None else device,
                    dev_norm or self.normalize)
            return vol.shape, outs, kept, raw.shape

        def finalize_one(job):
            zyx, outs, kept, orig_shape = job
            labels = self._finalize(zyx, outs, profile=profile)
            with span("restore"):
                return restore_labels(labels[inner], kept, orig_shape)

        # the module's ``_drive_stack``, looked up now: a control may wrap it
        yield from _drive_stack(stack, output_labels, skip_labelled,
                                devices, dispatch_one, finalize_one,
                                self.device)

    def _flood(self, fin, n, gather, out=None, profile=None, probe=None):
        """The frame's labels by the ``device_flood`` mode, written into
        ``out`` when it is given. A device mode runs on a frame with seeds
        (``n`` of them); where it returns ``None``, the exact host flood
        runs, on ``gather`` (the masked gather, dispatched early) or on one
        dispatched now. ``probe``: ``_flood_exact``'s."""
        labels = None
        if self.device_flood and n:
            labels = (self._flood_exact(fin, n, gather, out, profile, probe)
                      if self.device_flood == "exact"
                      else self._flood_on_device(fin, n, out, profile))
        if labels is None:
            if gather is None:
                with span("gather_dispatch", profile):
                    gather = self._gather(fin, profile)
            labels = self._host_flood(fin, gather, out=out, profile=profile)
        return labels

    def _flood_on_device(self, fin, n, out=None, profile=None):
        """``"pallas"`` and ``"xla"``, the approximate device floods: upload
        the filtered mask and the seeds, flood on the device with the
        subclass's CUDA kernel (``"pallas"``, its steps in
        ``flood_launches``) or torch recurrence (``"xla"``, its steps in
        ``flood_iters``), both capped at ``_FLOOD_MAX_STEPS``, and download
        the labels. With ``flood_telemetry`` the certificate runs beside it
        (``_telemetry``). ``None`` when the flood did not converge."""
        global _flood_fallbacks
        with span("upload_mask_seeds", profile):
            mask_dev, seeds_dev = self._upload_mask_seeds(fin, profile)
            values, kernel, recurrence = self._approx_flood(fin)
        with span("device_flood", profile):
            if self.device_flood == "pallas":
                lab_dev, n_steps, conv = kernel(
                    values, seeds_dev, mask_dev,
                    max_launches=_FLOOD_MAX_STEPS, inner_cap=1)
                key = "flood_launches"  # steps of the one persistent launch
            else:
                lab_dev, n_steps, conv = recurrence(
                    values, seeds_dev, mask_dev, mode="claim",
                    max_iters=_FLOOD_MAX_STEPS)
                key = "flood_iters"
            if profile is not None:
                profile[key] = n_steps
        if self.flood_telemetry and profile is not None:
            with span("flood_telemetry", profile):
                _telemetry(values, seeds_dev, mask_dev, lab_dev, profile)
        if not conv:
            _flood_fallbacks += 1
            if profile is not None:
                profile["flood_fallback"] = True
            return None
        return self._into(out, self._download(lab_dev, n, profile))

    def _flood_exact(self, fin, n, gather=None, out=None, profile=None,
                     probe=None):
        """``"exact"``: the subclass's verified exact flood (``_verified``,
        behind the tie probe) on the device, labels bit-equal to the exact
        host flood's, or ``None`` for that flood.

        ``probe``: an early-dispatched tie density (the affinity's, on the
        pre-filter mask); past ``TIE_PROBE_DEFAULT`` the mode returns
        ``None`` at once. ``gather``: the early-dispatched gather; with it
        the exact host flood runs on a worker thread (``_Speculative``)
        while this thread runs the certificate, and its labels are taken
        on every fallback."""
        from ..ops.flood_exact import TIE_PROBE_DEFAULT

        if probe is not None:
            with span("tie_probe"):
                pre_tie_frac = float(probe)
            if pre_tie_frac > TIE_PROBE_DEFAULT:
                if profile is not None:
                    profile["flood_tie_frac"] = pre_tie_frac
                    # the early probe saw the pre-size-filter mask, a superset
                    profile["flood_tie_frac_scope"] = "prefilter"
                    profile["flood_exact_path"] = "fallback:tie-density"
                return None
        # this mode's phases; ``profile`` takes some of them below
        phases = None if profile is None else {}
        with span("upload_mask_seeds", phases):
            mask_dev, seeds_dev = self._upload_mask_seeds(fin, profile)
        spec = None
        if gather is not None and self.speculative_flood:
            spec = _Speculative(lambda prof: self._host_flood(
                fin, gather, profile=prof))
            spec.start()
        try:
            with span("flood_certificate", phases):
                lab_dev, resolved, unc_count, n_mask, tie_frac, max_key = (
                    self._verified(fin, mask_dev, seeds_dev))
        finally:
            # the worker's labels are proven equal to resolved device labels
            if spec is not None:
                with span("flood_spec_waited", phases):
                    spec_labels, spec_prof = spec.join()
        path = _exact_path(profile, resolved, unc_count, n_mask, tie_frac,
                           max_key=max_key)
        if profile is not None:
            profile["flood_certificate"] = phases["flood_certificate"]
            if spec is not None:
                profile["flood_spec_waited"] = phases["flood_spec_waited"]
        if path.startswith("fallback"):
            if spec is None:
                return None
            if profile is not None:
                profile["flood_speculative"] = True
                for k, v in spec_prof.items():
                    profile[k] = profile.get(k, 0.0) + v
            return self._into(out, spec_labels)
        if profile is not None:
            profile["device_flood"] = profile.get("device_flood", 0.0) + (
                phases["upload_mask_seeds"] + phases["flood_certificate"])
        return self._into(out, self._download(lab_dev, n, profile))

    def _download(self, lab_dev, n, profile=None):
        """The device labels as int32 on the host, in the frame that
        ``_finalize`` returns; they cross the link as uint16 when the seed
        count ``n`` allows."""
        with span("download_labels", profile):
            if not self._keeps_ring:
                lab_dev = lab_dev[1:-1, 1:-1, 1:-1]
            wire = lab_dev.to(torch.int32 if n >= 2 ** 16 else torch.uint16)
            _moved(profile, "bytes_labels", wire)
            return _host(wire).astype(np.int32)

    def _into(self, out, labels):
        """``labels`` written into ``out`` under ``restore``: the DoG's
        padded frame takes them whole; the affinity's flat padded buffer
        takes them inside a zero ring, and its view of them is returned in
        their place. ``labels`` themselves without ``out``."""
        if out is None:
            return labels
        with span("restore"):
            if self._keeps_ring:
                out[...] = labels
                return labels
            out[:] = 0
            view = out.reshape(tuple(s + 2 for s in labels.shape))[
                1:-1, 1:-1, 1:-1]
            view[:] = labels
        return view


class AffinityPipeline(_Pipeline):
    """U-Net → watershed segmentation of one zyx volume, device-resident."""

    def __init__(self, model, chunk_size=(10, 256, 256),
                 margin=(1, 64, 64), absolute_thresh=None,
                 microbatch=None, cand_capacity: int = _CAND_CAP,
                 normalize: bool = False, device_flood=False,
                 flood_telemetry: bool = False, device=None):
        self.model = model
        self.chunk_size = tuple(chunk_size)
        self.margin = tuple(margin)
        self.absolute_thresh = absolute_thresh
        self.microbatch = microbatch
        self.cand_capacity = cand_capacity
        self.normalize = normalize
        self.device = resolve_device(device)
        self.device_flood = self.normalize_device_flood(device_flood,
                                                        self.device)
        # the certificate beside the approximate floods: the profile gets a
        # rigorous bound on the share of labels that differ from the heap's
        self.flood_telemetry = bool(flood_telemetry)
        self._programs = {}
        # (pshape, buffer): reused host scatter buffer of the flood's input
        self._aff_host = (None, None)

    def _cand_program(self, zyx):
        """Mask packing + sorted peak candidates from P's outputs (exact
        arithmetic: compare, max filter, stable argsort)."""
        if zyx in self._programs:
            return self._programs[zyx]
        K = self.cand_capacity

        def program(cent_smooth, masking_img, thresh):
            mask_packed = _pack_mask_bits(masking_img > thresh)
            cand = (cent_smooth == maximum_filter(cent_smooth, 3))
            cand = cand & (cent_smooth > 0.04)
            interior = torch.zeros_like(cand)
            interior[1:-1, 1:-1, 1:-1] = True
            cand = cand & interior
            scores = torch.where(cand, -cent_smooth,
                                 float("inf")).reshape(-1)
            order = torch.argsort(scores, stable=True)[:K].to(torch.int32)
            n_cand = cand.sum().to(torch.int32)
            return mask_packed, order, n_cand

        self._programs[zyx] = program
        return program

    def _threshold(self, otsu):
        if self.absolute_thresh is None:
            return otsu
        t = self.absolute_thresh
        if isinstance(t, np.floating) and t.dtype == np.float64:
            # NumPy float64 scalars are not NEP-50 "weak": the host compares
            # f32_array > t in float64. The f32 compare that agrees with it
            # for every f32 voxel value uses the largest f32 <= t
            t64 = float(t)
            t32 = np.float32(t64)
            if np.float64(t32) > t64:
                t32 = np.nextafter(t32, np.float32(-np.inf))
        else:
            # python floats and f32 scalars compare in f32 on the host
            t32 = np.float32(float(t))
        # filled on the device: no host copy, so no wait for the forward
        return torch.full((), float(t32), dtype=torch.float32,
                          device=otsu.device)

    def _device_outputs(self, x, device, normalize):
        """Run F → P → C on a host volume on ``device`` (no host
        synchronisation) and start the host copies of the mask bits and the
        candidate count."""
        from ..ops.watershed import _prep_feature_maps

        zyx = tuple(int(s) for s in x.shape)
        # the microbatch is resolved on the pipeline's own device, so a
        # frame's forward (hence its labels) does not depend on the card
        # that took it
        program = get_feature_program(
            self.model, zyx, self.chunk_size, self.margin,
            microbatch=self.microbatch, normalize=normalize,
            device=self.device,
        )
        out = program(x, device=device)
        aff_pad, cent_smooth, otsu = _prep_feature_maps(out[:3], out[4],
                                                        out[3])
        thresh = self._threshold(otsu)
        mask_packed, order, n_cand = self._cand_program(zyx)(
            cent_smooth, out[3], thresh)
        return (aff_pad, _HostCopy(mask_packed), order, _HostCopy(n_cand),
                thresh, cent_smooth)

    @staticmethod
    def _gather(fin, profile=None):
        """The host flood's input ``(pre_idx, m, vals)``: the affinities at
        the voxels of ``fin``'s mask (``_masked_gather``)."""
        return _masked_gather(fin[0], fin[1], profile)

    def _upload_mask_seeds(self, fin, profile=None):
        """The filtered mask (as packed bits) and the seeds, labels 1..n in
        row order, on the device of the padded affinities."""
        aff_pad, mask_pad, centroids = fin
        dev = aff_pad.device
        bits = np.packbits(mask_pad.view(np.bool_).ravel())
        coords = np.ascontiguousarray(centroids, np.int64)
        _moved(profile, "bytes_mask_seeds", bits)
        _moved(profile, "bytes_mask_seeds", coords)
        return _flood_prep(
            torch.from_numpy(bits).to(dev), torch.from_numpy(coords).to(dev),
            torch.arange(1, len(centroids) + 1, dtype=torch.int32,
                         device=dev), mask_pad.shape)

    @staticmethod
    def _approx_flood(fin):
        """The approximate floods over the device-resident padded
        affinities: the CUDA kernel (``ops/flood_kernel``) and the torch
        claim recurrence (``ops/device_flood.wavefront_flood``)."""
        from ..ops.device_flood import wavefront_flood
        from ..ops.flood_kernel import affinity_flood

        return fin[0], affinity_flood, wavefront_flood

    @staticmethod
    def _verified(fin, mask_dev, seeds_dev):
        """``ops/flood_exact.verified_exact_flood`` on the padded
        affinities."""
        from ..ops.flood_exact import TIE_PROBE_DEFAULT, verified_exact_flood

        return verified_exact_flood(fin[0], seeds_dev, mask_dev,
                                    tie_probe=TIE_PROBE_DEFAULT) + (None,)

    def _finalize(self, zyx, outs, out=None, profile=None):
        """Host half: wait for the device, unpack the mask, spacing, size
        filter, masked affinity gather, flood. The gather is taken at the
        pre-filter mask (a superset of what the flood reads), so its
        download runs under the host's spacing and size-filter work."""
        from ..ops.peaks import _ensure_spacing

        aff_pad, mask_packed, order, n_cand, thresh, cent_smooth = outs
        with group("finalize"):
            with span("device_wait", profile, "device_program"):
                n_cand = int(_host(n_cand))
            with span("download_mask_cands", profile):
                overflow = n_cand > self.cand_capacity
                order_small = None if overflow else _HostCopy(order[:n_cand])
                mask_pad = np.pad(_host_mask(mask_packed, zyx, profile), 1)
            probe = gather = None
            if self.device_flood in (False, "exact"):
                with span("gather_dispatch", profile):
                    # exact mode: the tie probe on the device-resident
                    # outputs, read after the host filter work it hides
                    # under
                    if self.device_flood:
                        probe = _tie_probe(mask_packed.tensor if isinstance(
                            mask_packed, _HostCopy) else mask_packed,
                            aff_pad)
                    # the gather at the pre-filter mask downloads under the
                    # host's spacing and size filter (in exact mode it is
                    # the fallback's input, and the speculative host
                    # flood's)
                    gather = self._gather((aff_pad, mask_pad), profile)
            with span("host_spacing", profile):
                if overflow:
                    from ..ops.peaks import peak_local_max

                    cand_coords = peak_local_max(cent_smooth,
                                                 threshold_abs=0.04)
                else:
                    cand_coords = np.stack(np.unravel_index(
                        _host(order_small)[:n_cand], zyx), axis=1)
                centroids = _ensure_spacing(cand_coords, spacing=1) + 1
            with span("host_mask_filter", profile):
                try:
                    mask_pad = native.band_filter_cc6(mask_pad, 10, 10000000)
                    if len(centroids):
                        centroids = centroids[mask_pad[tuple(centroids.T)]]
                except native.NativeUnavailable:
                    mask_pad, centroids = size_band_filter(
                        mask_pad.view(np.bool_), centroids,
                        min_area=10, max_area=10000000,
                    )
            return self._flood((aff_pad, mask_pad, centroids), len(centroids),
                               gather, out=out, profile=profile, probe=probe)

    def _host_flood(self, fin, gather, out=None, profile=None):
        """The exact host-heap half: take the masked affinity gather,
        scatter it into the reused host buffer, seed the markers and run the
        C++ priority flood (pure-python oracle fallback). Returns cropped
        int32 labels, written into the flat padded ``out`` when it is given.
        Also the speculative body of ``_flood_exact``, then with
        ``out=None`` (the caller copies into ``out`` after the join)."""
        _, mask_pad, centroids = fin
        pre_idx, m, vals = gather
        with span("gather_affinities", profile):
            vals = _host(vals)[:, :m]
        with span("flood", profile):
            pshape = mask_pad.shape
            # every index the flood reads (in-mask voxels of this call) is
            # written below, so stale values from an earlier frame are
            # never consumed
            if self._aff_host[0] != pshape:
                self._aff_host = (pshape,
                                  np.empty((3, mask_pad.size), np.float32))
            aff_host = self._aff_host[1]
            aff_host[:, pre_idx] = vals
            del vals  # its pinned buffer is freed here, inside the span
            offsets, axes = neighbor_offsets(pshape)
            n_half = len(offsets) // 2
            val_off = offsets.copy()
            val_off[:n_half] = 0
            if out is None:
                output = np.zeros(mask_pad.size, np.int32)
            else:
                output = out
                output[:] = 0
            if len(centroids):
                markers = np.ravel_multi_index(tuple(centroids.T), pshape)
                output[markers] = np.arange(len(markers), dtype=np.int32) + 1
                try:
                    native.priority_flood(
                        aff_host, offsets, axes, val_off,
                        markers.astype(np.int64),
                        np.zeros(len(markers), np.float32),
                        mask_pad.ravel(), output,
                    )
                except native.NativeUnavailable:
                    from ..ops import watershed_oracle as oracle

                    output[:] = 0
                    oracle.affinity_flood_py(
                        aff_host.reshape((3,) + pshape), centroids,
                        mask_pad.view(np.bool_), output=output,
                    )
            return output.reshape(pshape)[1:-1, 1:-1, 1:-1]


class DoGPipeline(_Pipeline):
    """DoG blob segmentation of one zyx volume, device-resident (the
    device twin of ``dog_blob_watershed_for_chunks``): labels bit-equal to
    the host path. The device ships the SQUARED EDT (exact integers) and
    the host flood orders by it, which is the order of scipy's f64 EDT."""

    _keeps_ring = True

    def __init__(self, min_sigma=1, max_sigma=1.5, threshold=0.02,
                 sigma_ratio=1.6, cand_capacity: int = _CAND_CAP,
                 device_flood=False, device=None):
        self.min_sigma = float(min_sigma)
        self.max_sigma = float(max_sigma)
        self.threshold = float(threshold)
        self.sigma_ratio = float(sigma_ratio)
        self.cand_capacity = cand_capacity
        self.device = resolve_device(device)
        self.device_flood = self.normalize_device_flood(device_flood,
                                                        self.device)
        k = int(np.log(self.max_sigma / self.min_sigma)
                / np.log(self.sigma_ratio) + 1)
        self.sigma_list = np.array(
            [self.min_sigma * self.sigma_ratio ** i for i in range(k + 1)])

    def _program(self, vol):
        """The device half on an uploaded float32 frame; returns
        ``(mask_packed, order, n_cand, dist_sq, cube)``, all on zyx + 2."""
        from ..ops.edt import edt_sq
        from ..ops.filters import gaussian

        thr = _f32(self.threshold)
        sf = _f32(1.0 / (self.sigma_ratio - 1.0))
        vol_pad = torch.nn.functional.pad(vol, (1, 1, 1, 1, 1, 1))
        # threshold mask from the classic DoG image (segmentation.py:635)
        dog = (gaussian(vol_pad, self.min_sigma)
               - gaussian(vol_pad, self.max_sigma))
        mask_packed = _pack_mask_bits(dog > thr)
        # blob_dog scale space (ops/blob.py semantics)
        gs = [gaussian(vol_pad, float(s)) for s in self.sigma_list]
        cube = torch.stack([(gs[i] - gs[i + 1]) * sf
                            for i in range(len(gs) - 1)], dim=-1)
        cand = (cube == maximum_filter(cube, 3)) & (cube > thr)
        scores = torch.where(cand, -cube, float("inf")).reshape(-1)
        order = torch.argsort(scores, stable=True)[:self.cand_capacity]
        n_cand = cand.sum().to(torch.int32)
        # exact squared EDT of the padded volume's nonzero support; the
        # cube stays on the card for the candidate-overflow path only
        dist_sq = edt_sq(vol_pad != 0)
        return mask_packed, order.to(torch.int32), n_cand, dist_sq, cube

    def _device_outputs(self, volume, device, normalize):
        """Upload one volume to ``device`` (``_upload_frame``) and run the
        device half (no host synchronisation); starts the host copies of the
        candidate count and, unless the flood runs on the device, of the
        mask bits."""
        mask_packed, order, n_cand, dist_sq, cube = self._program(
            _upload_frame(np.asarray(volume), device, normalize))
        if not self.device_flood:
            mask_packed = _HostCopy(mask_packed)
        return mask_packed, order, _HostCopy(n_cand), dist_sq, cube

    def _gather(self, fin, profile=None, mask=None):
        """The host flood's input ``(mask, m, vals)``: the bool mask (unpacked
        from ``fin``'s bits unless given) and the masked d² gather (the host
        flood reads distances at masked voxels only), whose copy runs under
        the host blob pruning."""
        mask_packed, dist_sq = fin[:2]
        if mask is None:
            mask = _host_mask(mask_packed, dist_sq.shape, profile).view(
                np.bool_)
        return (mask,) + _masked_gather(dist_sq, mask, profile)[1:]

    def _upload_mask_seeds(self, fin, profile=None):
        """The flood's mask from the device-resident bits and the seeds
        (``markers``' labels at their voxels), on the device of the squared
        EDT."""
        mask_packed, dist_sq, markers = fin
        dev = dist_sq.device
        coords = np.argwhere(markers > 0)
        labs = markers[tuple(coords.T)].astype(np.int32)
        _moved(profile, "bytes_mask_seeds", coords)
        _moved(profile, "bytes_mask_seeds", labs)
        # a device mode leaves the bits on the device (``_device_outputs``)
        return _flood_prep(mask_packed.to(dev),
                           torch.from_numpy(coords).to(dev),
                           torch.from_numpy(labs).to(dev),
                           tuple(dist_sq.shape))

    @staticmethod
    def _approx_flood(fin):
        """The approximate floods on ``-sqrt(d²)``: the CUDA image kernel
        (``ops/image_flood_kernel``) and the torch hop-tie recurrence
        (``ops/device_flood.wavefront_image_flood_core``)."""
        from ..ops.device_flood import wavefront_image_flood_core
        from ..ops.image_flood_kernel import image_flood

        # f32 sqrt is correctly rounded, like the host's f64 sqrt cast to
        # f32, so these are the host path's priorities
        return -torch.sqrt(fin[1]), image_flood, wavefront_image_flood_core

    @staticmethod
    def _verified(fin, mask_dev, seeds_dev):
        """``ops/flood_exact.verified_exact_image_flood`` on ``-d²``, not
        ``-sqrt(d²)``: a strictly monotone transform keeps every comparison
        and every exact tie, and ``-d²`` is an exact f32 integer. It orders
        as the host flood's ``-sqrt`` priorities do below
        ``native.BUCKET_FLOOD_MAX_KEY``, which the returned ``max_key`` (the
        largest masked d²) is checked against."""
        from ..ops.flood_exact import (TIE_PROBE_DEFAULT,
                                       verified_exact_image_flood)

        dist_sq = fin[1]
        found = verified_exact_image_flood(-dist_sq, seeds_dev, mask_dev,
                                           tie_probe=TIE_PROBE_DEFAULT)
        return found + (int(torch.where(mask_dev, dist_sq, 0).max().to(
            torch.int32)),)

    def _finalize(self, zyx, outs, out=None, profile=None):
        """Host half: wait for the device, blob pruning, seed labelling and
        the seeded flood on the EDT landscape. Returns int32 labels of
        zyx + 2."""
        from ..ops.blob import _prune_blobs
        from ..ops.cc import label_np
        from ..ops.peaks import _ensure_spacing

        mask_packed, order, n_cand, dist_sq, cube = outs
        pshape = tuple(int(s) + 2 for s in zyx)
        with group("finalize"):
            with span("device_wait", profile, "device_program"):
                n_cand = int(_host(n_cand))
            with span("download", profile):
                cube_shape = pshape + (len(self.sigma_list) - 1,)
                if n_cand > self.cand_capacity:
                    # overflow: the ranking past the capacity was dropped on
                    # the device, so recompute the full candidate order on
                    # the host from the cube — the same stable argsort of
                    # the same f32 scores
                    from scipy.ndimage import maximum_filter as ndi_max

                    cube_np = _host(cube)
                    cand = cube_np == ndi_max(cube_np, size=3, mode="nearest")
                    cand &= cube_np > np.float32(self.threshold)
                    scores = np.where(cand, -cube_np, np.inf).ravel()
                    idx_sorted = np.argsort(scores, kind="stable")[:n_cand]
                else:
                    idx_sorted = _host(order[:n_cand])
                coords4 = np.stack(np.unravel_index(idx_sorted, cube_shape),
                                   axis=1)
                mask = (None if self.device_flood else _host_mask(
                    mask_packed, pshape, profile).view(np.bool_))
            gather = None
            if mask is not None:
                with span("gather_dispatch", profile):
                    gather = self._gather((mask_packed, dist_sq), profile,
                                          mask)
            with span("host_blobs", profile):
                coords4 = _ensure_spacing(coords4, spacing=1)
                lm = coords4.astype(np.float64)
                sigmas = self.sigma_list[coords4[:, -1]][:, None]
                blobs = _prune_blobs(np.hstack([lm[:, :-1], sigmas]), 0.5,
                                     sigma_dim=1)
                centroids = np.zeros(pshape, dtype=bool)
                if len(blobs):
                    centroids[tuple(blobs.T.astype(int))[:-1]] = True
                markers, n = label_np(centroids)
            return self._flood((mask_packed, dist_sq, markers), n, gather,
                               out=out, profile=profile)

    def _host_flood(self, fin, gather, out=None, profile=None):
        """The exact flood on the host, over the frame padded once more
        (the native floods need a ring outside the mask): the bucket queue
        over integer d² below ``BUCKET_FLOOD_MAX_KEY``, the heap on
        ``-sqrt(d²)`` past it, the pure-python heap without the native
        library. Returns int32 labels of zyx + 2, written into ``out``
        when it is given."""
        markers = fin[2]
        mask, m, vals = gather
        with span("gather_distance", profile):
            vals_sq = _host(vals)[:m]
        with span("flood", profile):
            mask_w = np.pad(mask, 1, constant_values=False)
            markers_w = np.pad(markers, 1, constant_values=0)
            masked_idx = np.flatnonzero(mask_w.ravel())
            wshape = mask_w.shape
            output = np.where(mask_w, markers_w, 0).astype(np.int32).ravel()
            marker_locations = np.flatnonzero(output).astype(np.int64)
            offsets, _ = neighbor_offsets(wshape)
            max_key = int(vals_sq.max()) if m else 0

            def priorities():
                # the f32 cast of the f64 sqrt: image_watershed's -EDT image
                prio = np.zeros(mask_w.size, np.float32)
                prio[masked_idx] = (-np.sqrt(
                    vals_sq.astype(np.float64))).astype(np.float32)
                return prio

            try:
                if max_key < native.BUCKET_FLOOD_MAX_KEY:
                    keys = np.zeros(mask_w.size, np.int32)
                    keys[masked_idx] = vals_sq.astype(np.int32)
                    native.bucket_flood_image(keys, offsets,
                                              marker_locations,
                                              mask_w.ravel(), output)
                else:
                    prio = priorities()
                    native.priority_flood(
                        prio[None], offsets, np.zeros(len(offsets), np.int64),
                        offsets, marker_locations, prio[marker_locations],
                        mask_w.ravel(), output)
            except native.NativeUnavailable:
                from ..ops import watershed_oracle as oracle

                inner = (slice(1, -1),) * 3
                labels_p = oracle.image_flood_py(
                    priorities().reshape(wshape)[inner], markers, mask)
                output = np.pad(labels_p, 1).astype(np.int32).ravel()
            del vals_sq  # its pinned buffer is freed here, inside the span
            labels = output.reshape(wshape)[1:-1, 1:-1, 1:-1]
        return self._into(out, labels)


def _telemetry(aff_pad, seeds, mask, lab_flood, profile):
    """The approximate floods' fidelity bound (JAX
    ``_cached_flood_telemetry``): the heap equals the certificate's ``rep``
    on certain voxels, so the flood can differ from the heap only on
    uncertain voxels or where it differs from ``rep`` on certain ones."""
    from ..ops.flood_exact import certificate_flood_core

    rep, unc, _lb, _ub, conv = certificate_flood_core(aff_pad, seeds, mask)
    certain = mask & ~unc
    unc_n = int(unc.sum())
    mism_n = int((certain & (lab_flood.to(torch.int32) != rep)).sum())
    mask_n = int(mask.sum())
    profile["flood_uncertain_frac"] = unc_n / mask_n if mask_n else 0.0
    profile["flood_mismatch_certain_frac"] = (
        mism_n / mask_n if mask_n else 0.0)
    profile["flood_disagreement_bound"] = (
        (unc_n + mism_n) / mask_n if mask_n else 0.0)
    profile["flood_mask_voxels"] = mask_n
    profile["flood_certificate_converged"] = bool(conv)


def _exact_path(profile, resolved, unc_count, n_mask, tie_frac,
                max_key=None):
    """The verified flood's path (JAX ``_flood_exact``'s decode), recorded
    in ``profile`` with ``flood_tie_frac``, its scope and
    ``flood_uncertain_frac``. ``max_key`` (DoG): past
    ``native.BUCKET_FLOOD_MAX_KEY`` distinct d² can collide in the f32
    ``-sqrt`` priorities of the host flood, so ``-d²`` no longer provably
    orders as they do."""
    if unc_count < 0:
        path = "fallback:tie-density"
    elif max_key is not None and max_key >= native.BUCKET_FLOOD_MAX_KEY:
        path = "fallback:sqrt-collision"
    elif not resolved:
        path = "fallback:unresolved"
    else:
        path = "certified" if unc_count == 0 else "repaired"
    if profile is not None:
        profile["flood_tie_frac"] = float(tie_frac)
        profile["flood_tie_frac_scope"] = "filtered"
        if unc_count >= 0:
            profile["flood_uncertain_frac"] = (
                unc_count / n_mask if n_mask else 0.0)
        profile["flood_exact_path"] = path
    return path


def _moved(profile, key, x):
    """Add the bytes of ``x`` (a tensor, a ``_HostCopy`` or an array), a
    transfer between host and device, to ``profile[key]`` and to the
    counter ``key``."""
    if profile is None and not recording():
        return
    if isinstance(x, _HostCopy):
        x = x.tensor
    n = (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
         else x.nbytes)
    if profile is not None:
        profile[key] = profile.get(key, 0) + n
    count(key, n)
