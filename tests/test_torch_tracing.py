"""The port's tracer (utils/profiling.py) on the CPU: spans off and on,
nesting and ids across threads, counters, the mirror into a profiler
trace on the trace's clock, ``trace()``'s merged file and
``attribute_gaps``, and the spans of the serving worker and of the train
step at a tiny size (yolo11n, width 0.25, 64x64, fp32)."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu_torch.config import Config
from snn_object_detectionddp_tpu_torch.kernels import affine_lif, lif
from snn_object_detectionddp_tpu_torch.models.detector import Detector
from snn_object_detectionddp_tpu_torch.serve import DetectionService
from snn_object_detectionddp_tpu_torch.train.step import init_state, make_optimizer, make_step_fns
from snn_object_detectionddp_tpu_torch.utils import profiling

H = W = 64
PHASES = ("train.upload", "train.forward", "train.backward", "train.optimizer")
DISPATCH_CHILDREN = ("serve.gather", "serve.state_stack", "serve.upload", "serve.forward",
                     "serve.device_wait", "serve.nms", "serve.fetch", "serve.state_split",
                     "serve.reply")


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _cfg():
    cfg = Config()
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.model.image_size = (H, W)
    cfg.model.timesteps = 2
    cfg.runtime.precision = "f32"
    return cfg


def _named(name):
    return [s for s in profiling.spans() if s["name"] == name]


def test_off_records_nothing_and_returns_one_null_context():
    a, b = profiling.span("x"), profiling.span("y", id=3, k=1)
    assert a is b
    with a as s:
        s.set(sweeps=2)
    profiling.record("z", 0, 10)
    assert profiling.spans() == []
    profiling.enable()
    with profiling.span("x") as s:
        assert s is not a
    profiling.disable()
    assert [s["name"] for s in profiling.spans()] == ["x"]


def test_nesting_parent_ids_and_a_request_id_shared_across_threads():
    profiling.enable()
    rid = profiling.new_id()
    t_submit = time.perf_counter_ns()
    with profiling.span("outer", id=7, n=2) as outer:
        with profiling.span("inner") as inner:
            inner.set(sweeps=3)
        with profiling.span("explicit", parent=rid):
            pass

    def worker():
        with profiling.span("worker.phase", parent=rid):
            pass
        profiling.record("request", t_submit, time.perf_counter_ns(), id=rid)

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    got = {s["name"]: s for s in profiling.spans()}
    assert got["outer"]["id"] == 7 and got["outer"]["parent"] is None
    assert got["outer"]["attrs"] == {"n": 2}
    assert got["inner"]["parent"] == outer.id == 7 and got["inner"]["attrs"] == {"sweeps": 3}
    assert got["explicit"]["parent"] == rid
    assert got["worker.phase"]["parent"] == rid == got["request"]["id"]
    assert got["worker.phase"]["thread"] == got["request"]["thread"] != got["outer"]["thread"]
    assert got["outer"]["start_ns"] <= got["inner"]["start_ns"] <= got["inner"]["end_ns"] \
        <= got["outer"]["end_ns"]
    assert got["request"]["start_ns"] == t_submit <= got["worker.phase"]["start_ns"]
    assert got["request"]["async"] and not got["worker.phase"]["async"]


def test_counters_hold_counts_and_the_kernels_launches():
    profiling.count("serve.requests")
    profiling.count("serve.requests", 4)
    assert profiling.counter("serve.requests") == 5 and profiling.counter("never") == 0
    saved = dict(affine_lif.launch_counts), dict(affine_lif.skipped_empty), dict(lif.launch_counts)
    try:
        affine_lif.launch_counts["affine_lif_fwd"] += 3
        affine_lif.skipped_empty["affine_lif_bwd"] += 2
        lif.launch_counts["lif_scan_fwd"] += 1
        snap = profiling.counters()
        assert snap["serve.requests"] == 5
        assert snap["affine_lif_fwd.launches"] == saved[0]["affine_lif_fwd"] + 3
        assert snap["affine_lif_bwd.skipped_empty"] == saved[1]["affine_lif_bwd"] + 2
        assert snap["lif_scan_fwd.launches"] == saved[2]["lif_scan_fwd"] + 1
        assert {f"{k}.launches" for k in affine_lif.KERNELS + lif.KERNELS} <= set(snap)
    finally:
        affine_lif.launch_counts.update(saved[0])
        affine_lif.skipped_empty.update(saved[1])
        lif.launch_counts.update(saved[2])
    profiling.reset()
    assert "serve.requests" not in profiling.counters()


def test_a_span_under_the_profiler_is_mirrored_on_the_traces_clock(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("warm.up"):  # the first annotation of a session is slow to enter
            pass
        with profiling.span("mirror.me"):
            torch.ones(64, 64).sum()
    assert profiling.counter("trace.dropped") == 0
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base_us = int(doc["baseTimeNanoseconds"]) / 1e3
    mirrored = [e for e in doc["traceEvents"]
                if e.get("name") == "mirror.me" and e.get("cat") == "user_annotation"]
    (buffered,) = _named("mirror.me")
    assert len(mirrored) == 1
    start_us = mirrored[0]["ts"] + base_us
    assert abs(start_us - profiling.unix_ns(buffered["start_ns"]) / 1e3) < 1e3
    assert abs(start_us + mirrored[0]["dur"] - profiling.unix_ns(buffered["end_ns"]) / 1e3) < 1e3


def test_trace_merges_a_worker_threads_spans_and_gaps_are_put_down_to_spans(tmp_path):
    def worker(out):
        out.append(threading.get_native_id())
        with profiling.span("worker.phase"):
            torch.ones(32, 32).sum()
            time.sleep(0.01)

    tids = []
    with profiling.trace(tmp_path / "prof"):
        t0 = time.perf_counter_ns()
        with profiling.span("main.phase"):
            th = threading.Thread(target=worker, args=(tids,))
            th.start()
            th.join(timeout=30)
        profiling.record("a.request", t0, time.perf_counter_ns(), id=99)
    assert not th.is_alive()
    events = json.loads((tmp_path / "prof/trace.json").read_text())["traceEvents"]
    merged = {(e["name"], e["ph"]): e for e in events if e.get("cat") == profiling.SPAN_CAT}
    worker_span, main_span = merged["worker.phase", "X"], merged["main.phase", "X"]
    assert worker_span["tid"] == tids[0] != main_span["tid"]
    assert main_span["ts"] <= worker_span["ts"] <= worker_span["ts"] + worker_span["dur"] \
        <= main_span["ts"] + main_span["dur"]
    begin, end = merged["a.request", "b"], merged["a.request", "e"]
    assert begin["id"] == end["id"] == 99 and begin["ts"] <= main_span["ts"] <= end["ts"]
    assert any("sum" in e.get("name", "") for e in events if e.get("cat") == "cpu_op")
    gaps = json.loads((tmp_path / "prof/gaps.json").read_text())
    assert set(gaps) == {"window_s", "idle_s", "unattributed_s", "spans"}

    # a planted trace: kernels at [0, 100], [300, 400] and [600, 700] us;
    # the first gap's midpoint only the shorter of two spans on two threads
    # covers, the second's a span and an async span (which takes none);
    # time past the last kernel is not idle (the profiler stopped)
    span = {"ph": "X", "cat": profiling.SPAN_CAT}
    planted = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 300, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 600, "dur": 100},
        dict(span, name="outer", ts=0, dur=700, tid=1),
        dict(span, name="inner", ts=150, dur=100, tid=2),
        dict(span, name="late", ts=400, dur=200, tid=1),
        {"ph": "b", "cat": profiling.SPAN_CAT, "name": "wait", "id": 5, "ts": 450, "tid": 1},
        {"ph": "e", "cat": profiling.SPAN_CAT, "name": "wait", "id": 5, "ts": 550, "tid": 1},
        dict(span, name="after", ts=700, dur=300, tid=1),
    ]}
    path = tmp_path / "planted.json"
    path.write_text(json.dumps(planted))
    got = profiling.attribute_gaps(path)
    assert got["spans"] == {"inner": pytest.approx(200e-6), "late": pytest.approx(200e-6)}
    assert got["idle_s"] == pytest.approx(400e-6) and got["unattributed_s"] == 0
    assert got["window_s"] == pytest.approx(700e-6)


def test_serving_spans_and_counters_match_the_replies():
    det = Detector.from_config(_cfg(), device="cpu")
    params = det.init_params(torch.Generator().manual_seed(0))
    svc = DetectionService(det, params, conf=0.0, max_det=8, max_batch=4, max_streams=8)
    svc.warmup()
    svc.start()
    replies, lock = [], threading.Lock()

    def camera(s):
        for f in range(3):
            img = np.random.RandomState(10 * s + f).randint(0, 256, (H, W, 3), dtype=np.uint8)
            out = svc.detect(f"cam{s}", img)
            with lock:
                replies.append(out)

    profiling.enable()
    try:
        cams = [threading.Thread(target=camera, args=(s,)) for s in range(5)]
        for c in cams:
            c.start()
        for c in cams:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in cams)
    finally:
        svc.stop()
        profiling.disable()
    assert len(replies) == 15
    requests, waits = _named("serve.request"), _named("serve.queue_wait")
    dispatches = {s["attrs"]["dispatch"]: s for s in _named("serve.dispatch")}
    assert len(requests) == len(waits) == len(replies)
    assert sorted(dispatches) == list(range(1, len(dispatches) + 1))
    # one id a span, the requests' and the worker's alike
    ids = [s["id"] for s in profiling.spans()]
    assert len(set(ids)) == len(ids)
    assert sorted(s["parent"] for s in waits) == sorted(s["id"] for s in requests)
    # each request waited for the dispatch that replied: its n is the reply's batch
    assert sorted(dispatches[s["attrs"]["dispatch"]]["attrs"]["n"] for s in waits) == \
        sorted(r["batch"] for r in replies)
    for s in waits:
        assert s["end_ns"] <= dispatches[s["attrs"]["dispatch"]]["start_ns"] + 1_000_000
    c = profiling.counters()
    assert c["serve.requests"] == len(replies)
    assert c["serve.dispatches"] == len(dispatches)
    assert c["serve.padded_slots"] == sum(d["attrs"]["k"] - d["attrs"]["n"]
                                          for d in dispatches.values())
    for d in dispatches.values():
        kids = [s["name"] for s in profiling.spans() if s["parent"] == d["id"]
                and s["name"] in DISPATCH_CHILDREN]
        want = [n for n in DISPATCH_CHILDREN
                if d["attrs"]["k"] > 1 or n not in ("serve.state_stack", "serve.state_split")]
        assert kids == want
    for s in _named("serve.nms"):
        assert s["attrs"]["sweeps"] >= 1
    forward_ids = {s["id"] for s in _named("serve.forward")}
    assert {s["parent"] for s in _named("model.backbone")} <= forward_ids
    assert len(_named("model.bottleneck")) == len(_named("model.head")) == len(forward_ids)


def test_a_train_step_gives_one_step_span_with_its_four_phases():
    cfg = _cfg()
    det = Detector.from_config(cfg, device="cpu")
    tx, sched = make_optimizer(1e-3, 100)
    fns = make_step_fns(det, tx, sched)
    state = init_state(det.init_params(torch.Generator().manual_seed(0)), tx, sched)
    rng = np.random.RandomState(0)
    labels = np.zeros((2, 4, 5), np.float32)
    labels[:, 0] = [1.0, 0.5, 0.5, 0.4, 0.4]
    batch = {"images": rng.randint(0, 255, (2, 2, H, W, 3), dtype=np.uint8), "labels": labels,
             "label_mask": np.arange(4)[None].repeat(2, 0) < 1}
    profiling.enable()
    for _ in range(2):
        state, _ = fns.train_step(state, batch)
    profiling.disable()
    steps = _named("train.step")
    assert [s["attrs"]["step"] for s in steps] == [0, 1]
    ids = [s["id"] for s in profiling.spans()]
    assert len(set(ids)) == len(ids)
    for st in steps:
        kids = [s for s in profiling.spans() if s["parent"] == st["id"] and s["name"] in PHASES]
        assert [s["name"] for s in kids] == list(PHASES)
        assert all(st["start_ns"] <= s["start_ns"] <= s["end_ns"] <= st["end_ns"] for s in kids)
    assert not _named("train.collective")
    assert len(_named("model.backbone")) == 2
