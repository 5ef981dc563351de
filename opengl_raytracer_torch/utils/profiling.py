"""Profiling & timing utilities (the port of
``opengl_raytracer_tpu/utils/profiling.py``).

The reference's only instrumentation is wall-clock prints (BVH build time
scene.py:139-143, per-frame fps in the caption main.py:405-407).  Here:

* spans, kept by the program in memory where its work happens, and read
  with :func:`spans`.  A span has a name, a start and an end in
  ``time.time_ns()`` (the clock of ``torch.profiler``'s events, so a span
  lies beside the card's kernels of a trace), its parent (the span open on
  the same thread when it began) and the renderer's step it belongs to
  (:func:`set_step`).  Spans of a run's set-up (``scene.*``,
  ``step.capture``, ``kernels.load``, ``kernels.build``,
  ``native.build``) are always recorded; per-step spans (``step.block``,
  ``step.replay`` or ``step.body``, ``sync.wait``, ``sync.read``, a
  mesh step's ``mesh.fold``, and the App's ``app.input``, ``app.present``
  and ``display.convert``) only while :func:`tracing`, and otherwise cost
  one flag test.  The program opens no ``record_function`` or NVTX range:
  the profiler copies such a range onto the card's timeline, where a
  reader of device events would count it as a kernel;
* device spans, marked only while :func:`tracing`: two CUDA events on
  one card (:func:`device_mark`, :func:`device_span`), read at the next
  :func:`device_sync` of a mesh's ``accum`` and recorded as a span whose
  ``args`` hold ``device_ms``, the card's time between them (a mesh
  step's ``mesh.card``, one an owner card);
* counters, always kept, read with :func:`counts`: ``app.presented``
  (frames the App handed to its display sink), ``app.resets`` (its
  ``resetFrames``), ``step.captures`` (CUDA graphs of a step captured),
  ``step.block_ahead_hits`` / ``step.block_ahead_misses`` (steps
  whose block was written ahead / written at the step, ``renderer.py``)
  and ``mesh.bytes_moved`` (bytes a mesh step copied between distinct
  devices, ``parallel/sharding.py``);
* :func:`device_sync`, which fences on the card, or on every card of a
  mesh's ``accum``, before reading back (torch returns before a CUDA card
  finishes), the read queued before the fence;
* :func:`trace`, a ``torch.profiler`` block that writes a Chrome trace
  with the program's spans of the block on a track of their own.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_enabled = False
_step: int | None = None
_spans: list = []
_counts: dict[str, int] = {}
_local = threading.local()  # .stack: the thread's open spans
_readbacks: dict = {}  # (device, dtype, slot) -> pinned scalar, its view
_marks: list = []  # device spans whose events are not read yet


class Span:
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns``),
    ``parent`` (a Span or None), ``step`` and ``args`` (a dict or None).
    Used as a context manager: it begins on entry and is recorded on
    exit."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "step", "args")

    def __init__(self, name: str, args: dict | None = None):
        self.name, self.args = name, args
        self.start_ns = self.end_ns = 0
        self.parent = self.step = None

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.step = _step
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        _local.stack.remove(self)
        _spans.append(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Off:
    """The per-step span while tracing is off: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def enable(on: bool = True) -> None:
    """Record per-step spans even with no profiler running."""
    global _enabled
    _enabled = on


def tracing() -> bool:
    """True while per-step spans are recorded: after ``enable(True)``, or
    while a ``torch.profiler`` runs."""
    return _enabled or _autograd_profiler._is_profiler_enabled


def set_step(step: int | None) -> None:
    """The step that spans begun from now on belong to (a renderer's step
    sequence number)."""
    global _step
    _step = step


def per_step(name: str, **args):
    """A per-step span to use with ``with``: a :class:`Span` while
    :func:`tracing`, else a stand-in that records nothing."""
    return Span(name, args or None) if tracing() else _OFF


def spans() -> list[Span]:
    """The recorded spans, in the order they ended."""
    return list(_spans)


def clear() -> None:
    _spans.clear()
    _marks.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counts() -> dict[str, int]:
    """The counters, by name (a counter never added to is absent)."""
    return dict(_counts)


def timing_event(device: torch.device) -> torch.cuda.Event:
    """A timing event recorded now on card ``device``'s current stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def device_mark(device: torch.device):
    """On a card, the start of a device span: a :func:`timing_event`;
    None on the CPU, which has no events.  Callers mark only while
    :func:`tracing`."""
    if device.type != "cuda":
        return None
    return device, timing_event(device), time.time_ns(), _step


def device_span(name: str, start, **args) -> None:
    """End the device span begun by ``start`` (:func:`device_mark`; None
    records nothing): an event recorded now on the same card.  The next
    :func:`device_sync` of a mesh's ``accum`` reads the card's ms between
    the two events and records span ``name`` over the host's time between
    the marks, with ``args`` and ``device_ms``."""
    if start is None:
        return
    device, begin, start_ns, step = start
    end = timing_event(device)
    span = Span(name, args)
    span.start_ns, span.end_ns, span.step = start_ns, time.time_ns(), step
    _marks.append((span, begin, end))


def _read_marks() -> None:
    """Record the queued device spans; every card they ran on has been
    waited for."""
    for span, begin, end in _marks:
        span.args["device_ms"] = begin.elapsed_time(end)
        _spans.append(span)
    _marks.clear()


def _readback(head: torch.Tensor, slot: int = 0) -> tuple:
    """The pinned host scalar of ``head``'s device and dtype that
    :func:`device_sync` copies into (one a slice of a mesh's ``accum``:
    ``slot``), made at its first use, and a NumPy view of it (read with
    no torch call)."""
    key = (head.device, head.dtype, slot)
    out = _readbacks.get(key)
    if out is None:
        pinned = torch.empty((), dtype=head.dtype, pin_memory=True)
        out = _readbacks[key] = (pinned, pinned.numpy())
    return out


def device_sync(x) -> float:
    """Wait for everything queued on ``x``'s card (when it is a CUDA
    tensor), then read back a scalar: the sum of ``x``'s first four
    values.  Spans ``sync.wait`` and ``sync.read``.

    On a card the sum and its copy into a pinned host scalar are queued
    before the wait, behind the work already queued on ``x``'s stream, so
    the host launches nothing on a card gone idle and reads the scalar
    with no CUDA call after it.

    ``x`` may also be a mesh's ``accum`` (``parallel.RowShardedAccum``):
    each slice's sum and copy are queued on its card, every card before
    the host waits on any, then each card is waited for; it returns slice
    0's sum, and records the queued device spans (:func:`device_span`)."""
    if not isinstance(x, torch.Tensor):
        return _mesh_sync(x.slices)
    view = None
    with per_step("sync.wait"):
        if x.is_cuda:
            head = x.reshape(-1)[:4].sum()
            pinned, view = _readback(head)
            pinned.copy_(head, non_blocking=True)
            torch.cuda.synchronize(x.device)
    with per_step("sync.read"):
        return float(x.reshape(-1)[:4].sum() if view is None else view)


def _mesh_sync(slices) -> float:
    """:func:`device_sync` of a mesh's ``accum`` slices."""
    first = slices[0]
    view = None
    with per_step("sync.wait"):
        if first.is_cuda:
            for j, s in enumerate(slices):
                head = s.reshape(-1)[:4].sum()
                pinned, v = _readback(head, j)
                pinned.copy_(head, non_blocking=True)
                view = v if j == 0 else view
            for device in dict.fromkeys(s.device for s in slices):
                torch.cuda.synchronize(device)
            if _marks:
                _read_marks()
    with per_step("sync.read"):
        return float(first.reshape(-1)[:4].sum() if view is None else view)


def _export_spans(path: str, since_ns: int) -> None:
    """Add the spans begun at or after ``since_ns`` to the Chrome trace at
    ``path``, as complete events on a track of their own, on the file's
    time base (``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), 0
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": "program spans"}}]
    for s in _spans:
        if s.start_ns >= since_ns:
            events.append({
                "ph": "X", "cat": "program_span", "name": s.name,
                "pid": pid, "tid": tid, "ts": (s.start_ns - base) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"step": s.step,
                         "parent": s.parent.name if s.parent else None,
                         **(s.args or {})}})
    doc.setdefault("traceEvents", []).extend(events)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the block (CPU activity, plus CUDA activity
    when a card is present); writes ``trace.json``, a Chrome trace that
    also holds the program's spans of the block, into ``log_dir``
    (default ``oglrt-trace`` in the temporary directory) and yields the
    directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "oglrt-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    since = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _export_spans(path, since)


class FrameStats:
    """Running fps / frame-time tracker (the reference's caption metrics,
    main.py:405-428, as a reusable object)."""

    def __init__(self):
        self.last = time.time()
        self.delta = 0.0
        self.fps = 0.0
        self.frames = 0

    def tick(self) -> None:
        now = time.time()
        self.delta = now - self.last
        self.fps = 1.0 / self.delta if self.delta > 0 else 0.0
        self.last = now
        self.frames += 1

    def caption(self, frame_count: int, total: str) -> str:
        return (
            f"Fps: {round(self.fps)} Frame: {frame_count} "
            f"Frame render time: {round(self.delta * 1000)}ms "
            f"Total render time: {total}"
        )
