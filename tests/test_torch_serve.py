"""The port's DetectionService on the CPU (tiny fp32 model): cross-stream
micro-batching equals per-stream sequential calls, a clip equals frame by
frame, reset zeroes a stream's state, the LRU bound holds, and the HTTP
surface answers.

Tolerance: batched and sequential runs do the same fp32 math on the same
weights; PyTorch's CPU convs may block a batch of K differently from a
batch of 1, so scores are compared to 1e-4 (they agree exactly in
practice)."""

import base64
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu_torch.config import Config
from snn_object_detectionddp_tpu_torch.models.detector import Detector
from snn_object_detectionddp_tpu_torch.serve import DetectionService, _Job, make_handler, serve, tree_map

H = W = 64


def _service(bottleneck="convlstm", **kw):
    cfg = Config()
    cfg.model.bottleneck = bottleneck
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.model.image_size = (H, W)
    cfg.runtime.precision = "f32"
    det = Detector.from_config(cfg, device="cpu")
    params = det.init_params(torch.Generator().manual_seed(0))
    return DetectionService(det, params, conf=0.0, max_det=8, **kw)


@pytest.fixture(scope="module")
def service():
    svc = _service(max_streams=16, max_batch=4, max_clip=4).start()
    svc.warmup()
    yield svc
    svc.stop()


def _frame(seed):
    return np.random.RandomState(seed).randint(0, 256, size=(H, W, 3), dtype=np.uint8)


def _same(a, b):
    assert len(a["scores"]) == len(b["scores"]) > 0
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
    np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
    assert a["classes"] == b["classes"]


def test_microbatched_streams_equal_sequential(service):
    """3 streams x 3 frames queued before the worker runs: the worker
    batches distinct streams and defers same-stream frames; each stream's
    results must equal its frames sent one by one."""
    svc = _service(max_streams=16, max_batch=4, max_clip=4)
    jobs = {s: [_Job(f"s{s}", _frame(10 * s + i)) for i in range(3)] for s in range(3)}
    for i in range(3):
        for s in range(3):
            svc._q.put(jobs[s][i])
    svc.start()
    try:
        batched = {s: [j.reply.get(timeout=120) for j in js] for s, js in jobs.items()}
    finally:
        svc.stop()
    assert max(r["batch"] for rs in batched.values() for r in rs) == 3
    for s in range(3):
        seq = [service.detect(f"seq{s}", _frame(10 * s + i)) for i in range(3)]
        for a, b in zip(batched[s], seq):
            _same(a, b)


def test_concurrent_clients(service):
    out = {}

    def client(s):
        out[s] = [service.detect(f"c{s}", _frame(50 + s)) for _ in range(2)]

    threads = [threading.Thread(target=client, args=(s,)) for s in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    fresh = service.detect("c_fresh", _frame(50))
    _same(out[0][0], fresh)
    assert out[0][1]["scores"] != out[0][0]["scores"]  # state advanced


def test_clip_equals_frame_by_frame(service):
    clip = np.stack([_frame(20 + i) for i in range(5)])  # chunks of 4 + 1
    seq = [service.detect("clip_seq", clip[i]) for i in range(5)]
    out = service.detect_clip("clip_par", clip)
    assert len(out["frames"]) == 5 and out["chunks"] == 2
    for a, b in zip(out["frames"], seq):
        _same(a, b)
    # Both streams hold the same post-clip state.
    _same(service.detect("clip_par", clip[0]), service.detect("clip_seq", clip[0]))


def test_reset_zeroes_state(service):
    service.detect("r", _frame(1))
    assert "r" in service._states
    before = service.num_streams
    service.reset("r")
    assert service.num_streams == before - 1 and "r" not in service._states
    # A reset stream restarts from the zero state: same as a fresh stream.
    _same(service.detect("r", _frame(2)), service.detect("r_fresh", _frame(2)))
    for leaf in (service._zero_state1["unet"]["bottleneck"][1],
                 service._zero_state1["backbone"]["stem1"]):
        assert leaf.shape[0] == 1 and not leaf.any()


def test_state_axes_and_lru_bound():
    svc = _service(max_streams=2, max_batch=2, max_clip=2).start()
    try:
        axes = []
        tree_map(axes.append, svc._state_axes)
        assert len(axes) == 19 and set(axes) == {0}  # 17 LIF membranes + ConvLSTM (h, c)
        for s in range(4):
            svc.detect(f"l{s}", _frame(s))
        assert svc.num_streams == 2 and set(svc._states) == {"l2", "l3"}
    finally:
        svc.stop()


def test_lstm_bottleneck_streams_batched_equal_alone():
    """``bottleneck: lstm``: the TokenLSTM carry is (layers, B, hidden), so
    its batch axis is 1 where every other state leaf's is 0. The service
    finds it by diffing a B=1 and a B=2 probe; two streams micro-batched
    into one forward must equal the same streams served alone, frame after
    frame (the carry is stacked, advanced and split along the right axis)."""
    svc = _service("lstm", max_streams=8, max_batch=2, max_clip=2)
    axes = []
    tree_map(axes.append, svc._state_axes)
    assert len(axes) == 19 and sorted(set(axes)) == [0, 1] and axes.count(1) == 2
    assert [tuple(t.shape) for t in svc._zero_state1["unet"]["bottleneck"]] == [(2, 1, 256)] * 2
    jobs = {s: [_Job(f"s{s}", _frame(30 * s + i)) for i in range(3)] for s in range(2)}
    for i in range(3):
        for s in range(2):
            svc._q.put(jobs[s][i])
    svc.start()
    try:
        batched = {s: [j.reply.get(timeout=120) for j in js] for s, js in jobs.items()}
        assert all(r["batch"] == 2 for rs in batched.values() for r in rs)
        for s in range(2):
            alone = [svc.detect(f"alone{s}", _frame(30 * s + i)) for i in range(3)]
            assert all(r["batch"] == 1 for r in alone)
            for a, b in zip(batched[s], alone):
                _same(a, b)
            assert alone[1]["scores"] != alone[0]["scores"]  # the state advanced
            for got, want in zip(svc._states[f"s{s}"]["unet"]["bottleneck"],
                                 svc._states[f"alone{s}"]["unet"]["bottleneck"]):
                assert tuple(got.shape) == (2, 1, 256)
                torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        # a clip of the lstm model equals its frames one by one
        clip = np.stack([_frame(70 + i) for i in range(2)])
        seq = [svc.detect("clip_seq", clip[i]) for i in range(2)]
        for a, b in zip(svc.detect_clip("clip_par", clip)["frames"], seq):
            _same(a, b)
    finally:
        svc.stop()


def test_shape_guard_and_stopped_worker(service):
    with pytest.raises(ValueError, match="expected"):
        service.detect("x", np.zeros((H + 1, W, 3), np.uint8))
    with pytest.raises(ValueError, match="clip"):
        service.detect_clip("x", np.zeros((2, H, W + 1, 3), np.uint8))
    idle = _service(max_batch=1, max_clip=1)
    with pytest.raises(RuntimeError, match="not running"):
        idle.detect("x", _frame(0))


def test_http_surface(service):
    import cv2

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        ok, png = cv2.imencode(".png", _frame(7)[:, :, ::-1])
        body = json.dumps({"stream": "http", "image": base64.b64encode(png).decode()}).encode()
        with urllib.request.urlopen(urllib.request.Request(f"{base}/detect", body), timeout=60) as r:
            out = json.loads(r.read())
        _same(out, service.detect("http_ref", _frame(7)))
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["backend"] == "cpu"
        req = urllib.request.Request(f"{base}/reset", json.dumps({"stream": "http"}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read()) == {"ok": True}
    finally:
        httpd.shutdown()
        th.join(timeout=10)


def test_serve_rejects_tensor_parallel():
    """Without a process group of two, a tensor axis of 2 raises: serving
    never drops to one device (tests/test_torch_tensor_parallel.py serves
    over two processes)."""
    cfg = Config()
    cfg.mesh.tensor = 2
    with pytest.raises(ValueError, match="mesh.tensor=2 must divide the world size of 1"):
        serve(cfg, None, device="cpu")
