"""The program's own spans, read after a run.

The port records spans (``utils/profiling.py``: name, start and end in
host ns, id, parent's id, thread, attributes) only while a profiler
session records in the process or after ``profiling.enable()``. In a
traced run that is the profiled sub-window (``trace.profile``), where the
device metrics are read too; the serving worker's spans are recorded
there though the profiler records only the main thread. A program
without the tracer, or a run that recorded none, gives no spans, and every
reader then finds nothing (None).
"""

from __future__ import annotations


def recorded() -> list[dict]:
    """Every span the program holds; none from a program without them."""
    try:
        from snn_object_detectionddp_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    return spans()


def _ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) * 1e-6


def mean_ms(name: str) -> float | None:
    """Mean host ms of the spans named ``name``."""
    got = [_ms(s) for s in recorded() if s["name"] == name]
    return sum(got) / len(got) if got else None


def per_parent_ms(parent: str, last: str, names: tuple) -> float | None:
    """Summed host ms of the spans named ``names`` a ``parent`` span (a
    step, a dispatch), over the parents whose ``last`` child was recorded:
    a parent cut by the end of the profiled sub-window is left out, and a
    child whose parent started before it has no recorded parent."""
    got = recorded()
    ids = {s["id"] for s in got if s["name"] == parent}
    whole = {s["parent"] for s in got if s["name"] == last and s["parent"] in ids}
    if not whole:
        return None
    return sum(_ms(s) for s in got if s["name"] in names and s["parent"] in whole) / len(whole)


def mean_attr(name: str, attr: str) -> float | None:
    """Mean of attribute ``attr`` over the spans named ``name``."""
    got = [s["attrs"][attr] for s in recorded() if s["name"] == name and attr in s["attrs"]]
    return sum(got) / len(got) if got else None
