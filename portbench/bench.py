"""The benchmark's core: find a cell's files by name, run its runner,
read every metric, decide ``correct`` and print the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration is ``configs/<config>.json``; the traffic is
``traffic/<traffic>.json``, whose ``kind`` names the runner
``runners/<kind>.py``; the limits of its correctness numbers are
``limits/<workload>.json``; every metric is read by
``metrics/<metric name>.py``. Adding a cell, a configuration, a traffic
mix or a metric is adding files and entries: nothing here changes.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .reference.model import ModelShape

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "snn_object_detectionddp_tpu")


@dataclass
class Cell:
    """One workload with everything found for it by name."""

    name: str
    base: Path  # the benchmark's folder: runners, metric readers, data
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def shape(self) -> ModelShape:
        return ModelShape.from_config(self.config["model"])


@dataclass
class Record:
    """What a runner hands back: the window's raw measurements (read by
    the metric readers) and the correctness numbers."""

    kind: str
    cell: Cell
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    counters: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)  # name -> [host seconds]
    latencies_s: list = field(default_factory=list)
    trace: object = None  # trace.Trace of the traced run's sub-window
    memory_peak_bytes: int = 0
    numbers: dict = field(default_factory=dict)  # correctness: name -> value


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    base = root / spec["paths"][0]

    def reports(metric, cell_metrics=()):
        if "workloads" in metric:
            return name in metric["workloads"]
        return metric.get("moves", metric["name"]) in cell_metrics

    e2e = [m for m in spec["end_to_end"] if reports(m, [m["name"]])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if reports(m, e2e_names)]
    return Cell(name=name, base=base, chips=w["chips"], config=load_json(root / conf["file"]),
                traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(base / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def _load(path: Path, what: str):
    if not path.exists():
        raise SystemExit(f"no {what} at {path}")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def runner(kind: str, base: Path = HERE):
    return _load(base / "runners" / f"{kind}.py", f"runner for traffic kind {kind!r}")


def read_metric(metric: dict, rec: Record):
    """The metric's reader's value, or None when it finds nothing to read."""
    value = _load(rec.cell.base / "metrics" / f"{metric['name']}.py", "metric reader").read(rec)
    if value is None:
        return None
    value = float(value)
    if not math.isfinite(value):
        raise RuntimeError(f"metric {metric['name']} read {value}")
    return value


def split_cores() -> tuple[set, set]:
    """(the cores for every thread, the core for the thread that drives
    the card): the allowed cores but the last, and the last."""
    allowed = sorted(os.sched_getaffinity(0))
    return set(allowed[:-1] or allowed), set(allowed[-1:])


@contextlib.contextmanager
def driving_core(device: torch.device):
    """Run the calling thread, and the threads it starts meanwhile, alone
    on the driving core (run.py keeps every other thread off it); a no-op
    off the card."""
    if device.type != "cuda":
        yield
        return
    rest, hot = split_cores()
    os.sched_setaffinity(0, hot)
    try:
        yield
    finally:
        os.sched_setaffinity(0, rest)


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that the program must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def free_device_memory():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def checks(rec: Record) -> dict:
    """Each correctness number beside its limit: ``{name: {"value",
    "limit"}}``. A number with no limit file entry is refused."""
    out = {}
    for name, value in rec.numbers.items():
        if name not in rec.cell.limits:
            raise RuntimeError(f"no limit for correctness number {name!r}")
        out[name] = {"value": value, "limit": rec.cell.limits[name]}
    return out


def is_correct(table: dict) -> bool:
    return bool(table) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in table.values())


def result_line(rec: Record, trace: bool) -> dict:
    metrics = {}
    for m in (rec.cell.per_layer if trace else rec.cell.end_to_end):
        if not rec.device.type == "cuda" and m.get("source") == "device_trace":
            continue  # a device number never comes from a run without the card
        value = read_metric(m, rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if rec.device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(rec.device),
               "count": rec.cell.chips, "memory_peak_bytes": rec.memory_peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
    table = checks(rec)
    line = {"correct": is_correct(table), "attempted": rec.attempted, "failed": rec.failed,
            "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        from .trace import breakdown

        line["breakdown"] = breakdown(rec.trace)
    line["checks"] = table
    return line


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, t_start: float | None = None,
             root: Path = ROOT) -> dict:
    """Run one cell once and return its result line. ``overrides``
    (tests) update the configuration's and the traffic's keys, for a run
    at a tiny size."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(name, root)
    for section, values in (overrides or {}).items():
        target = cell.traffic if section == "traffic" else cell.config[section]
        target.update(values)
    rec = Record(kind=cell.traffic["kind"], cell=cell, device=torch.device(device))
    runner(cell.traffic["kind"], cell.base).run(rec, seed=seed, seconds=seconds, trace=trace,
                                     t_start=t_start)
    return result_line(rec, trace)


def emit(line: dict) -> None:
    """The check lines on standard error, then the result on standard
    output as its last line."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
