"""Shared settings of the benchmark's CPU tests: a tiny size of every cell,
run on the CPU through the same harness the card runs."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = {"yolo_model_name": "yolo11n.pt", "width_mult": 0.25, "image_size": [64, 96],
              "max_boxes": 8}
SEED = 2**31 + 977


def tiny(workload: str, precision: str = "f32") -> dict:
    """Overrides that shrink a cell to a CPU size (``bench.run_cell``)."""
    ov = {"model": dict(TINY_MODEL), "runtime": {"precision": precision}}
    if workload.startswith("serve"):
        ov["traffic"] = {"streams": 4, "max_batch": 4, "frames_per_stream": 3, "max_streams": 8,
                         "check_at": [0.3, 0.4]}
    else:
        ov.update({"training": {"batch_size": 2}, "dataset": {"train": {"seq_len": 2}},
                   "traffic": {"pool": 3}})
    return ov


@pytest.fixture
def workloads():
    import json

    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
