"""The readers of the program's spans on the CPU. The runners profile only
on the card, so here tracing is held on (``profiling.enable()``) around a
tiny traced run of the serving cell and of a train cell: each reader of a
span or a span's counter finds a finite number there, and nothing (None)
once no span is recorded."""

import json
import math

import pytest

from conftest import ROOT, SEED, tiny

from portbench import bench
from snn_object_detectionddp_tpu_torch.utils import profiling

SPAN_METRICS = {
    "serve-yolo11m-convlstm-s32": ("serve.queue_wait_ms", "serve.state_host_ms",
                                   "serve.forward_host_ms", "serve.nms_ms",
                                   "serve.fetch_wait_ms", "nms.sweeps_per_dispatch"),
    "train-yolo11m-convlstm-b16": ("train.upload_host_ms", "train.forward_host_ms",
                                   "train.backward_host_ms", "train.optimizer_host_ms"),
}


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_span_readers_read_a_traced_run_and_nothing_without_spans(workload):
    spec = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    names = SPAN_METRICS[workload]
    assert all(workload in spec[n]["workloads"] for n in names)
    profiling.reset()
    profiling.enable()
    try:
        line = bench.run_cell(workload, SEED, 1.0, True, device="cpu", overrides=tiny(workload))
    finally:
        profiling.disable()
    try:
        assert line["correct"] is True, line["checks"]
        for n in names:
            value = line["metrics"][n]["value"]
            assert math.isfinite(value) and value > 0, (n, value)
            assert line["metrics"][n]["unit"] == spec[n]["unit"]
        cell = bench.find_cell(workload)
        rec = bench.Record(kind=cell.traffic["kind"], cell=cell, device=bench.torch.device("cpu"))
        profiling.reset()
        assert {n: bench.read_metric(spec[n], rec) for n in names} == dict.fromkeys(names)
    finally:
        profiling.reset()
