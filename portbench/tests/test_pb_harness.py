"""The harness on the CPU: the contract's shape of BENCHMARK.json, every
cell dry-run at a tiny size, the refusal without a card, and a new
configuration, cell and metric found from files alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SEED, tiny

from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert spec["paths"] == ["portbench"] and 1 <= spec["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert (ROOT / c["file"]).exists() and c["file"].startswith("portbench/")
    names = [w["name"] for w in spec["workloads"]]
    assert len(set(names)) == len(names)
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for w in m.get("workloads", names):  # each cell that reports it reports what it moves
            cell = bench.find_cell(w)
            assert m["moves"] in [x["name"] for x in cell.end_to_end]


@pytest.mark.parametrize("trace", [False, True])
def test_every_cell_dry_runs_and_prints_a_well_formed_line(workloads, trace, capsys):
    for w in workloads:
        bench.emit(bench.run_cell(w, SEED, 1.0, trace, device="cpu", overrides=tiny(w)))
        out, err = capsys.readouterr()
        line = json.loads(out.strip().splitlines()[-1])
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
        assert list(line)[-1] == "checks" and line["correct"] is True, line["checks"]
        assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                                  "memory_peak_bytes": 0}
        assert line["attempted"] > 0 and line["failed"] == 0
        cell = bench.find_cell(w)
        wanted = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)
                  if m["source"] != "device_trace" and "mfu" not in m["name"]}
        assert set(line["metrics"]) == wanted
        assert err.strip().splitlines()[-1].startswith("check ")


def test_a_run_without_a_card_refuses():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "train-yolo11m-convlstm-b16", "--seed", "1", "--seconds", "1",
                          "--trace", "1"], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_device_metrics_are_never_read_from_a_cpu_run():
    w = "train-yolo11m-convlstm-b16"
    line = bench.run_cell(w, SEED, 1.0, True, device="cpu", overrides=tiny(w))
    assert not {"lif_roofline.train", "mfu.train", "device_idle.train"} & set(line["metrics"])
    assert "busy_s" not in line["device"] and "breakdown" not in line


def test_a_new_config_cell_and_metric_are_found_from_files_alone(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "yolo11m-convlstm.json").read_text())
    conf["model"]["yolo_model_name"] = "yolo11s.pt"
    (pb / "configs" / "yolo11s-convlstm.json").write_text(json.dumps(conf))
    traffic = json.loads((pb / "traffic" / "train_b16.json").read_text())
    traffic["pool"] = 2
    (pb / "traffic" / "train_b8.json").write_text(json.dumps(traffic))
    limits = json.loads((pb / "limits" / "train-yolo11m-convlstm-b16.json").read_text())
    (pb / "limits" / "train-yolo11s-convlstm-b8.json").write_text(json.dumps(limits))
    (pb / "metrics" / "train.steps_in_window.py").write_text(
        "def read(rec):\n    return rec.counters['steps']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "yolo11s-convlstm", "source": "https://example.org/x",
                            "file": "portbench/configs/yolo11s-convlstm.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "train-yolo11s-convlstm-b8", "config": "yolo11s-convlstm",
                              "traffic": "train_b8", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "train.steps_in_window", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "Train step",
                              "moves": "train_frames_per_s"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_frames_per_s":
            m["workloads"].append("train-yolo11s-convlstm-b8")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    w = "train-yolo11s-convlstm-b8"
    cell = bench.find_cell(w, root)
    assert cell.config["model"]["yolo_model_name"] == "yolo11s.pt" and cell.traffic["pool"] == 2
    ov = tiny(w)
    ov["model"].pop("yolo_model_name")
    line = bench.run_cell(w, SEED, 1.0, True, device="cpu", overrides=ov, root=root)
    assert line["metrics"]["train.steps_in_window"]["value"] > 0
