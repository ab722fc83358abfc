"""Observability utilities: spans and counters, phase timers and device
profiler traces.

The port of ``iterseg_tpu/utils.py``. ``phase_timer`` accumulates wall-clock
per pipeline stage (the dict ``AffinityPipeline.segment(profile=...)``
fills), and ``device_trace`` wraps ``torch.profiler`` in place of
``jax.profiler``, writing a Chrome trace (``chrome://tracing``, Perfetto).
There is no XLA compilation cache to enable, so ``enable_compilation_cache``
is not ported.

``phase_timer`` is also the program's span. While a ``torch.profiler``
session records in the process, every span is entered as
``record_function("iterseg.<name>")`` (so it shares the device trace's
clock and shows in the Chrome trace) and kept in an in-memory recorder
with its call, frame, card and parent; ``count`` records counters the same
way. The profiler gets leaf spans only: a span opened inside another span
on the same thread is recorded but not given to the profiler, so the
profiler's top-level host ops are the program's leaf spans. The grouping
spans (``call_span``, ``frame_span``, ``group``) live in the recorder
alone. ``spans()`` returns what was recorded (the last ``RECORD_LIMIT``
entries) and ``clear_spans()`` empties it. With no profiler recording and
no dict given, a span costs one flag check.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Optional

from torch.autograd import profiler as _autograd_profiler

__all__ = ["phase_timer", "device_trace", "Stopwatch", "span", "group",
           "call_span", "frame_span", "carried", "count", "recording",
           "spans", "clear_spans", "RECORD_LIMIT"]

RECORD_LIMIT = 1 << 16
PREFIX = "iterseg."


class Stopwatch:
    """Accumulating named phase timer."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self):
        total = sum(self.times.values())
        lines = [f"total {total:.3f}s"]
        for k, v in sorted(self.times.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:24s} {v:8.3f}s ({v / max(total, 1e-9):5.1%})")
        return "\n".join(lines)


def recording() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    return _autograd_profiler._is_profiler_enabled


class _Recorder:
    """The last ``RECORD_LIMIT`` spans and counters, as dicts."""

    def __init__(self, limit):
        self._items = collections.deque(maxlen=limit)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    def new_id(self):
        with self._lock:
            return next(self._ids)

    def add(self, item):
        with self._lock:
            self._items.append(item)

    def copy(self):
        with self._lock:
            return list(self._items)

    def clear(self):
        with self._lock:
            self._items.clear()


_recorder = _Recorder(RECORD_LIMIT)


class _Context:
    """Where a span is opened: the public call (``_Call``), the frame and
    card, the innermost open span's id, and whether a leaf span is open on
    this thread (the profiler then gets no further span)."""

    __slots__ = ("call", "frame", "card", "parent", "leaf")

    def __init__(self, call=None, frame=None, card=None, parent=None,
                 leaf=False):
        self.call, self.frame, self.card = call, frame, card
        self.parent, self.leaf = parent, leaf

    def child(self, parent, leaf=None, **kw):
        c = _Context(self.call, self.frame, self.card, parent,
                     self.leaf if leaf is None else leaf)
        for k, v in kw.items():
            setattr(c, k, v)
        return c


_context = contextvars.ContextVar("iterseg_span_context",
                                  default=_Context())


def _record(kind, name, ctx, parent, **fields):
    call = ctx.call
    _recorder.add(dict(kind=kind, name=name,
                       thread=threading.get_ident(),
                       call=None if call is None else call.id,
                       frame=ctx.frame, card=ctx.card, parent=parent,
                       **fields))


class _Null:
    """The span, group or frame when nothing is recorded or timed."""

    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("name", "profile", "key", "seconds", "_rec", "_t0", "_rf",
                 "_token", "_ctx", "_id")

    def __init__(self, name, profile, key, rec):
        self.name, self.profile, self.key = name, profile, key
        self.seconds = 0.0
        self._rec, self._rf = rec, None

    def __enter__(self):
        if self._rec:
            ctx = self._ctx = _context.get()
            self._id = _recorder.new_id()
            if not ctx.leaf:
                self._rf = _autograd_profiler.record_function(
                    PREFIX + self.name)
                self._rf.__enter__()
            self._token = _context.set(ctx.child(self._id, leaf=True))
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.seconds = (t1 - self._t0) / 1e9
        if self._rec:
            _context.reset(self._token)
            if self._rf is not None:
                self._rf.__exit__(None, None, None)
            _record("span", self.name, self._ctx, self._ctx.parent,
                    id=self._id, start_ns=self._t0, end_ns=t1)
        if self.profile is not None:
            self.profile[self.key] = self.profile.get(self.key, 0.0) + (
                self.seconds)
        return False


def span(name: str, profile: Optional[dict] = None,
         key: Optional[str] = None):
    """A leaf span around a stage: adds its seconds to ``profile[key]``
    (``key`` defaults to ``name``; nothing without a dict) and, while a
    profiler records, enters ``record_function("iterseg.<name>")`` and
    records itself. ``seconds`` holds the duration after the block when
    either happened."""
    if profile is None and not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, profile, name if key is None else key,
                 _autograd_profiler._is_profiler_enabled)


def phase_timer(profile: Optional[dict], name: str):
    """Accumulate elapsed seconds into ``profile[name]`` (no-op if None);
    the span ``name`` while a profiler records (``span``)."""
    return span(name, profile)


class _Group:
    """A grouping span in the recorder only: open from creation to
    ``close()``, the parent of what runs while it is entered (it may be
    entered more than once, as a pipelined frame is)."""

    __slots__ = ("name", "_ctx", "_id", "_t0", "_tokens", "_closed")

    def __init__(self, name, ctx):
        self.name, self._ctx = name, ctx
        self._id = _recorder.new_id()
        self._tokens, self._closed = [], False
        self._t0 = time.perf_counter_ns()

    def __enter__(self):
        self._tokens.append(_context.set(self._ctx.child(
            self._id, leaf=_context.get().leaf)))
        return self

    def __exit__(self, *exc):
        _context.reset(self._tokens.pop())
        return False

    def close(self):
        if not self._closed:
            self._closed = True
            _record("span", self.name, self._ctx, self._ctx.parent,
                    id=self._id, start_ns=self._t0,
                    end_ns=time.perf_counter_ns())


class _Closing(_Group):
    __slots__ = ()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.close()
        return False


def group(name: str):
    """A grouping span around a block (recorder only), e.g. a frame's
    host half (``finalize``)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Closing(name, _context.get())


class _Call:
    __slots__ = ("id", "entry", "thread")

    def __init__(self):
        self.entry = None


class _CallSpan(_Group):
    """The ``call`` group of one public entry call, with the leaf span
    ``entry`` open from its start to its first frame (``frame_span``)."""

    __slots__ = ("call",)

    def __init__(self):
        call = self.call = _Call()
        call.thread = threading.get_ident()
        super().__init__("call", _context.get())
        call.id = self._id
        self._ctx = self._ctx.child(self._ctx.parent, call=call,
                                    frame=None, card=None)

    def __enter__(self):
        super().__enter__()
        self.call.entry = _Span("entry", None, "entry", True).__enter__()
        return self

    def __exit__(self, *exc):
        _end_entry(self.call, force=True)
        super().__exit__(*exc)
        self.close()
        return False


def _end_entry(call, force=False):
    """Close the call's ``entry`` span on the thread that opened it, if it
    is the innermost open span there (``force``: in any case)."""
    entry = call.entry
    if (entry is not None and call.thread == threading.get_ident()
            and (force or _context.get().parent == entry._id)):
        call.entry = None
        entry.__exit__(None, None, None)


def call_span():
    """The ``call`` group around one public entry call: every span opened
    inside it (on worker threads too, given the context) carries its id."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _CallSpan()


def frame_span(index, card):
    """The ``frame`` group of frame ``index`` on ``card``, open until
    ``close()``; its spans run while it is entered. Opening the call's
    first frame ends the call's ``entry`` span."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    ctx = _context.get()
    if ctx.call is not None:
        _end_entry(ctx.call)
        ctx = _context.get()
    return _Group("frame", ctx.child(ctx.parent, frame=int(index),
                                     card=str(card)))


def carried(fn):
    """``fn``, to run on another thread with this thread's call, frame and
    card, the spans it opens there children of the innermost group open
    here (the call's, not its ``entry``)."""
    ctx = _context.get()
    parent = ctx.parent
    if ctx.call is not None and ctx.call.entry is not None and (
            parent == ctx.call.entry._id):
        parent = ctx.call.id

    def run(*args, **kwargs):
        _context.set(ctx.child(parent, leaf=False))
        return fn(*args, **kwargs)

    return run


def count(name: str, value=1):
    """Record counter ``name`` (``value`` of it) at the current call,
    frame and card, while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        ctx = _context.get()
        _record("counter", name, ctx, ctx.parent, value=value,
                time_ns=time.perf_counter_ns())


def spans() -> list:
    """A copy of the recorded spans and counters, oldest first. A span:
    ``kind`` "span", ``name``, ``id``, ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``), ``thread``, ``call``, ``frame``, ``card``
    and ``parent`` (the enclosing span's id). A counter: ``kind``
    "counter", ``name``, ``value``, ``time_ns`` and the same context."""
    return _recorder.copy()


def clear_spans():
    """Empty the recorder."""
    _recorder.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, *, device=None):
    """``torch.profiler`` trace of the block, written as a Chrome trace
    ``trace-<pid>-<ns>.json`` into ``log_dir``; the program's spans show in
    it as ``iterseg.*`` ranges (and in ``spans()``). ``device``: the device
    whose activity is traced with the host's (``None``: CUDA, which raises
    without a card; ``"cpu"`` traces the host alone). Yields the profiler
    (``key_averages()`` sums time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from .device import resolve_device

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
