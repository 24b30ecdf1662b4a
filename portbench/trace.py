"""The device trace of a short sub-window: ``torch.profiler`` with CUDA
activity, exported as a Chrome trace into the run's temporary directory,
read back and deleted.

What it gives (:class:`Trace`): the window's length, the seconds in which
some operation (kernel, copy, memset) ran on the card, the summed device
time of each operation name, and the longest idle gaps, each named by the
host operations running at its midpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "pb.window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    op_seconds: dict = field(default_factory=dict)  # name -> summed device seconds
    op_counts: dict = field(default_factory=dict)  # name -> launches
    gaps: list = field(default_factory=list)  # [(label, seconds)], longest first

    def seconds_of(self, kernel: str) -> float:
        """Device seconds of the operations whose name holds ``kernel``."""
        return sum(s for n, s in self.op_seconds.items() if kernel in n)

    def count_of(self, kernel: str) -> int:
        return sum(c for n, c in self.op_counts.items() if kernel in n)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _label(cpu_ops, t: float) -> str:
    """The outermost and innermost host operations running at ``t``."""
    covering = [e for e in cpu_ops if e["ts"] <= t <= e["ts"] + e["dur"]]
    if not covering:
        return "host idle"
    outer = max(covering, key=lambda e: e["dur"])["name"]
    inner = min(covering, key=lambda e: e["dur"])["name"]
    return outer if outer == inner else f"{outer} > {inner}"


def read_trace(events: list) -> Trace:
    """A :class:`Trace` of the Chrome-trace events inside the ``pb.window``
    annotation."""
    marks = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the profiler trace has no window annotation")
    w0 = marks[0]["ts"]
    w1 = w0 + marks[0]["dur"]
    device, cpu_ops = [], []
    op_s, op_n = defaultdict(float), defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= w0 or a >= w1:
            continue
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            device.append((a, b))
            op_s[e["name"]] += (b - a) * 1e-6
            op_n[e["name"]] += 1
        elif e.get("cat") in ("cpu_op", "user_annotation") and e.get("name") != WINDOW:
            cpu_ops.append(e)
    merged = _merge(device)
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [(_label(cpu_ops, (a + b) / 2), (b - a) * 1e-6) for a, b in gaps[:10]]
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy, op_seconds=dict(op_s),
                 op_counts=dict(op_n), gaps=labelled)


def profile(fn) -> Trace:
    """Run ``fn()`` once under the profiler, between two synchronisations
    inside the window annotation, and read its trace."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read_trace(events)


def breakdown(trace: Trace) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten longest idle gaps."""
    ops = sorted(trace.op_seconds.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in trace.gaps[:10]]}
