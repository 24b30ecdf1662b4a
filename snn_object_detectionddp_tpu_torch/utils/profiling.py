"""Tracing and FLOP counting.

The port's counterpart of the JAX package's ``utils/profiling.py``:

- The tracer. :func:`span` marks a phase of the program (a context
  manager), :func:`record` a span whose start was taken earlier, and
  :func:`count` adds to a counter. Spans record only while tracing is on:
  while a ``torch.profiler`` session records in the process, or between
  :func:`enable` and :func:`disable`. Off, a span is a read of two flags
  and a shared null context. Recorded spans sit in a bounded in-memory
  buffer (:func:`spans`, :func:`reset`); counters are always on
  (:func:`counters`).
- :func:`trace`: a ``torch.profiler`` trace of the block over all
  threads, written as a Chrome / Perfetto JSON file with the program's
  spans of every thread merged in, and the device's idle time put down to
  the spans (:func:`attribute_gaps`).
- :func:`flops_of`: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``.

Span names follow the layers: ``serve.*`` (serve.py), ``model.*``
(models/detector.py, models/unet.py), ``train.*`` (train/step.py); the
counters ``serve.*``, ``nms.sweeps`` (ops/nms.py) and
``token_lstm.plain_scans`` (models/token_lstm.py).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _ExperimentalConfig

# Spans the buffer holds; one more is dropped and counted in
# ``trace.dropped``. A profiled sub-window of the benchmark's cells
# records a few thousand.
MAX_SPANS = 200_000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "program_span"

# Spans record while _on (between enable() and disable()) or while a
# profiler session records in the process (torch's flag, global to the
# process; the profiler's per-thread flag is read only to mirror a span).
_on = False
_buffer: list = []  # (name, start_ns, end_ns, id, parent, thread, attrs, async)
_counts: dict = {}
_count_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()  # .stack: ids of this thread's open spans; .tid: its native id
_anchor = None  # (perf_counter_ns, time_ns) read together when tracing turned on


def new_id() -> int:
    """A fresh id, unique in the process: a request's, or a span's when
    none is given. Numbers of the program's own (a dispatch's, a step's)
    go into a span's attrs, not its id."""
    return next(_ids)


def _take_anchor() -> None:
    global _anchor
    _anchor = (time.perf_counter_ns(), time.time_ns())


def unix_ns(t_ns: int) -> int:
    """A ``time.perf_counter_ns`` reading as Unix time in ns, by the anchor
    taken when tracing turned on (the clock of a profiler trace's events:
    their ``ts`` plus its ``baseTimeNanoseconds``)."""
    if _anchor is None:
        _take_anchor()
    return t_ns + _anchor[1] - _anchor[0]


def _thread():
    """This thread's state: ``.stack``, ``.tid``."""
    try:
        _local.tid
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
    return _local


def _append(name, t0, t1, id_, parent, tid, attrs, is_async) -> None:
    if _anchor is None:
        _take_anchor()
    if len(_buffer) < MAX_SPANS:
        # attrs as a tuple of pairs: a tuple of plain values leaves the
        # collector's view, while one holding a dict stays tracked and a
        # full buffer makes every collection walk it
        _buffer.append((name, t0, t1, id_, parent, tid, tuple(attrs.items()), is_async))
    else:
        count("trace.dropped")


class _NullSpan:
    """What :func:`span` returns while tracing is off: enters and sets
    nothing."""

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "attrs", "t0", "_mirror")

    def __init__(self, name, id_, parent, attrs):
        self.name, self.id, self.parent, self.attrs = name, id_, parent, attrs

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (``sweeps`` of NMS)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _thread().stack
        if self.id is None:
            self.id = next(_ids)
        if self.parent is None and stack:
            self.parent = stack[-1]
        stack.append(self.id)
        # The profiler records its own thread only (unless it records all
        # threads): there the span also enters the trace as an annotation.
        self._mirror = None
        if torch._C._autograd._profiler_enabled():
            self._mirror = torch.profiler.record_function(self.name)
            self._mirror.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self._mirror is not None:
            self._mirror.__exit__(exc_type, exc, tb)
        here = _thread()
        here.stack.pop()
        _append(self.name, self.t0, t1, self.id, self.parent, here.tid, self.attrs, False)
        return None


def span(name: str, id=None, parent=None, **attrs):
    """``with span("train.forward"):`` records the block as a span of the
    calling thread: name, start and end (``time.perf_counter_ns``), ``id``
    (a fresh one when None), the id of ``parent`` (when None, the span
    open around it on this thread), the thread and ``attrs``; ``as s``
    then ``s.set(k=v)`` adds attributes. While tracing is off, or while
    ``torch.compile`` or ``torch.export`` traces, it records nothing and
    returns one shared null context."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return _NULL
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _NULL
    return _Span(name, id, parent, attrs)


def record(name: str, start_ns: int, end_ns: int, id=None, parent=None, **attrs) -> None:
    """An asynchronous span from ``start_ns`` to ``end_ns``
    (``time.perf_counter_ns`` readings), recorded while tracing is on: one
    that is not nested in the calling thread's spans, such as a request
    from its submit on another thread, or a queue wait that ends where its
    dispatch starts. :func:`trace` writes it on an async track, and
    :func:`attribute_gaps` puts no idle time down to it."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return
    _append(name, start_ns, end_ns, next(_ids) if id is None else id, parent, _thread().tid,
            attrs, True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (always on)."""
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    """The value of one counter (0 before its first count)."""
    return _counts.get(name, 0)


def counters() -> dict:
    """A snapshot of every counter, with the hand kernels' launches and
    empty-problem skips (``kernels/affine_lif.py``, ``kernels/lif.py``,
    ``kernels/token_lstm.py``) as ``<kernel>.launches`` /
    ``<kernel>.skipped_empty``, and ``token_lstm.plain_scans`` (scans that
    ran the plain loop on a CUDA tensor, models/token_lstm.py) always
    present."""
    from ..kernels import affine_lif, lif, token_lstm

    with _count_lock:
        out = dict(_counts)
    out.setdefault("token_lstm.plain_scans", 0)
    for mod in (affine_lif, lif, token_lstm):
        out.update({f"{k}.launches": v for k, v in mod.launch_counts.items()})
    out.update({f"{k}.skipped_empty": v for k, v in affine_lif.skipped_empty.items()})
    return out


def spans() -> list[dict]:
    """The recorded spans, oldest end first: ``{"name", "start_ns",
    "end_ns", "id", "parent", "thread", "attrs", "async"}`` (times on
    ``time.perf_counter_ns``'s clock; :func:`unix_ns` maps them; ``async``
    for a :func:`record`)."""
    keys = ("name", "start_ns", "end_ns", "id", "parent", "thread", "attrs", "async")
    return [dict(zip(keys, s[:6] + (dict(s[6]),) + s[7:])) for s in list(_buffer)]


def reset() -> None:
    """Clear the recorded spans and the counters (not the kernels')."""
    global _anchor
    _buffer.clear()
    with _count_lock:
        _counts.clear()
    _anchor = None


def enable() -> None:
    """Record spans until :func:`disable`, with or without a profiler."""
    global _on
    _take_anchor()
    _on = True


def disable() -> None:
    global _on
    _on = False


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """``with trace("runs/profile") as prof: ...`` records the CPU of every
    thread and, when a card is present, its kernels, then writes
    ``<log_dir>/trace.json`` (open it in Perfetto or ``chrome://tracing``)
    with the program's spans recorded meanwhile, of every thread, merged
    in as ``program_span`` events on their threads' rows, and
    ``<log_dir>/gaps.json`` (:func:`attribute_gaps`). Yields the profiler,
    so ``prof.key_averages()`` reads the same events."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _take_anchor()
    t0 = time.perf_counter_ns()
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=every_thread) as prof:
        try:
            yield prof
        finally:
            t1 = time.perf_counter_ns()  # before the profiler stops and holds every thread
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    pid = os.getpid()
    for s in spans():
        if s["end_ns"] < t0 or s["start_ns"] > t1:
            continue
        event = {"cat": SPAN_CAT, "name": s["name"], "pid": pid, "tid": s["thread"],
                 "ts": (unix_ns(s["start_ns"]) - base) / 1e3,
                 "args": {"id": s["id"], "parent": s["parent"], **s["attrs"]}}
        if s["async"]:  # overlapping spans: a nestable async track of their own
            end = dict(event, ph="e", ts=(unix_ns(s["end_ns"]) - base) / 1e3)
            doc["traceEvents"] += [dict(event, ph="b", id=s["id"]), dict(end, id=s["id"])]
        else:
            doc["traceEvents"].append(dict(event, ph="X", dur=(s["end_ns"] - s["start_ns"]) / 1e3))
    with open(path, "w") as f:
        json.dump(doc, f)
    (log_dir / "gaps.json").write_text(json.dumps(attribute_gaps(path), indent=1))


def attribute_gaps(trace_path: str | Path) -> dict:
    """The device's idle time in a trace written by :func:`trace`, put down
    to the program: each gap between device operations (kernels, copies,
    memsets), inside the extent of both the device operations and the
    program's spans, goes to the innermost (shortest) span, on any thread,
    that covers its midpoint; the async spans of :func:`record` take none.
    Without device operations the whole extent of the spans is idle.
    Returns ``{"window_s", "idle_s", "unattributed_s", "spans": {name: idle
    seconds}}``, the spans' largest first."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device, program = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") in DEVICE_CATS:
            device.append((e["ts"], e["ts"] + e["dur"]))
        elif e.get("cat") == SPAN_CAT:
            program.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    out = {"window_s": 0.0, "idle_s": 0.0, "unattributed_s": 0.0, "spans": {}}
    if not program:
        return out
    w0, w1 = min(p[0] for p in program), max(p[1] for p in program)
    if device:  # where the profiler recorded the card
        w0, w1 = max(w0, min(a for a, _ in device)), min(w1, max(b for _, b in device))
    if w1 <= w0:
        return out
    busy = []
    for a, b in sorted(device):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    by_span = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        covering = [p for p in program if p[0] <= mid <= p[1]]
        seconds = (b - a) * 1e-6
        out["idle_s"] += seconds
        if covering:
            by_span[min(covering, key=lambda p: p[1] - p[0])[2]] += seconds
        else:
            out["unattributed_s"] += seconds
    out["window_s"] = (w1 - w0) * 1e-6
    out["spans"] = dict(sorted(by_span.items(), key=lambda kv: -kv[1]))
    return out


def flops_of(fn, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)``, which is run once.

    Counted by ``FlopCounterMode`` over the operators the dispatcher sees:
    convolutions (``2 * K * K * Cin * Cout * Ho * Wo`` per image, groups
    dividing Cin) and matrix products (``2 * M * N * K``), and their
    backward when the call runs one. Elementwise work, reductions and
    NMS count nothing, and neither do the hand-written kernels
    (kernels/build.py calls them through ctypes, past the dispatcher): the
    normalize+LIF of every spiking block is not in the figure. XLA's cost
    analysis, which the JAX package reads instead, also counts elementwise
    work and no Pallas call, so the two totals differ."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())
