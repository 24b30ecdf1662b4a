"""Profiling and FLOP counting.

The port's counterpart of the JAX package's ``utils/profiling.py``:

- :func:`trace`: a ``torch.profiler`` trace of the block, written as a
  Chrome / Perfetto JSON file.
- :func:`flops_of`: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``.
- :func:`device_memory_stats`: per-card memory in use, its peak and the
  card's size.
- :class:`Stopwatch`: retrieval-vs-compute wall-time segments with the
  FPS incl/excl report shape.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """``with trace("runs/profile") as prof: ...`` records the CPU and, when
    a card is present, its kernels, then writes ``<log_dir>/trace.json``
    (open it in Perfetto or ``chrome://tracing``). Yields the profiler, so
    ``prof.key_averages()`` reads the same events."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


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


def device_memory_stats() -> dict:
    """Bytes in use, their peak and the card's size, per CUDA card
    (``{"cuda:0": {...}}``; empty without a card)."""
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


class Stopwatch:
    """Segmented wall-clock accounting: ``with sw.measure("retrieval"):``
    around reading a frame, any other name around the compute."""

    def __init__(self):
        self.segments: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.segments[name] = self.segments.get(name, 0.0) + (time.perf_counter() - t0)
            self.counts[name] = self.counts.get(name, 0) + 1

    def fps_report(self, num_frames: int) -> dict:
        total = sum(self.segments.values())
        compute = total - self.segments.get("retrieval", 0.0)
        return {
            "num_frames": num_frames,
            "fps_incl_retrieval": num_frames / max(total, 1e-9),
            "fps_excl_retrieval": num_frames / max(compute, 1e-9),
            "segments_s": dict(self.segments),
        }
