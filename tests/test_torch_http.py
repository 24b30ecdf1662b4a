"""The port's HTTP endpoint without OpenCV, and ``serve()`` of the port's
own checkpoint.

- With ``cv2`` blocked, a PNG upload of the served size and of two other
  sizes reaches the port's service as exactly the frame the JAX package's
  handler (``cv2.imdecode`` + ``cv2.resize``) gives its service, and the
  reply is exactly the service's ``detect`` of that frame; against the JAX
  handler's reply on the same converted fp32 weights, detections agree to
  tests/test_torch_serve.py's tolerances (scores 1e-4, boxes 1e-2 px: the
  two frameworks sum convs in another order). A non-PNG upload is answered
  400 naming the missing decoder.
- ``serve()`` on the ``best.pt`` that ``main.train_code`` writes (one epoch
  at 48x64) loads those weights exactly and answers a POST with the
  detections of ``make_predict_fn`` on the same weights and thresholds.
"""

import base64
import json
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import jax
import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu import serve as jserve
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch import main, serve
from snn_object_detectionddp_tpu_torch.convert import params_from_jax
from snn_object_detectionddp_tpu_torch.data.synthetic import make_dataset
from snn_object_detectionddp_tpu_torch.evals.validator import make_predict_fn
from snn_object_detectionddp_tpu_torch.models.detector import Detector
from snn_object_detectionddp_tpu_torch.train.checkpoint import load_checkpoint

H = W = 64


def _tiny(mod):
    cfg = mod.Config()
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.model.image_size = (H, W)
    cfg.runtime.precision = "f32"
    return cfg


class _Recording:
    """Wraps a service: records the frames ``detect`` receives."""

    def __init__(self, service):
        self.service, self.frames = service, []
        self.image_hw, self.device = service.image_hw, getattr(service, "device", None)

    def detect(self, stream, image):
        self.frames.append(np.array(image))
        return self.service.detect(stream, image)

    def __getattr__(self, name):
        return getattr(self.service, name)


def _start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    return httpd, th, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, body):
    req = urllib.request.Request(f"{base}/detect", json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png(img_rgb):
    ok, buf = cv2.imencode(".png", img_rgb[:, :, ::-1])
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def _same(a, b):
    assert len(a["scores"]) == len(b["scores"]) > 0
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
    np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
    assert a["classes"] == b["classes"]


@pytest.fixture(scope="module")
def services():
    jdet = JDetector.from_config(_tiny(jconfig))
    jparams = jdet.init_params(jax.random.PRNGKey(0))
    tdet = Detector.from_config(_tiny(tconfig), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jsvc = jserve.DetectionService(jdet, jparams, conf=0.0, max_det=8, max_batch=1,
                                   max_clip=1).start()
    tsvc = serve.DetectionService(tdet, tparams, conf=0.0, max_det=8, max_batch=1,
                                  max_clip=1).start()
    yield jsvc, tsvc
    jsvc.stop()
    tsvc.stop()


@pytest.mark.parametrize("hw", [(H, W), (40, 50), (96, 80)], ids=["served", "up", "down"])
def test_png_upload_without_cv2_answers_as_the_jax_handler(services, hw, monkeypatch):
    jsvc, tsvc = services
    jrec, trec = _Recording(jsvc), _Recording(tsvc)
    jhttpd, jth, jbase = _start(jserve.make_handler(jrec))  # binds its cv2 now
    jpeg = base64.b64encode(cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))[1]).decode()
    monkeypatch.setitem(sys.modules, "cv2", None)  # the port may not reach OpenCV
    thttpd, tth, tbase = _start(serve.make_handler(trec))
    try:
        img = np.random.RandomState(sum(hw)).randint(0, 256, (*hw, 3), dtype=np.uint8)
        stream = f"s{hw[0]}x{hw[1]}"
        jcode, jout = _post(jbase, {"stream": stream, "image": _png(img)})
        tcode, tout = _post(tbase, {"stream": stream, "image": _png(img)})
        assert jcode == tcode == 200, (jout, tout)
        np.testing.assert_array_equal(trec.frames[0], jrec.frames[0])  # byte-equal frames
        assert trec.frames[0].shape == (H, W, 3)
        ref = tsvc.detect(f"{stream}_ref", trec.frames[0])
        assert {k: tout[k] for k in ("boxes", "scores", "classes")} == {
            k: ref[k] for k in ("boxes", "scores", "classes")}
        _same(tout, jout)
        code, out = _post(tbase, {"stream": "jpeg", "image": jpeg})
        assert code == 400 and "OpenCV (cv2)" in out["error"] and "not installed" in out["error"]
        code, out = _post(tbase, {"stream": "bad", "image": base64.b64encode(b"\x89PNG\r\n\x1a\n"
                                                                            + bytes(20)).decode()})
        assert code == 400 and "undecodable" in out["error"]
    finally:
        for httpd, th in ((jhttpd, jth), (thttpd, tth)):
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=10)


def test_serve_loads_the_ports_best_checkpoint(tmp_path):
    root = make_dataset(tmp_path / "dsec", num_sequences=3, splits=("train",), num_frames=5,
                        height=48, width=64)
    cfg = _tiny(tconfig)
    cfg.model.image_size, cfg.model.max_boxes = (48, 64), 8
    for split in ("train", "val", "test"):
        sc = cfg.dataset.split(split)
        sc.path, sc.seq_len = str(root / "train"), 2
    tr = cfg.training
    tr.batch_size, tr.num_workers, tr.epochs, tr.learning_rate = 2, 2, 1, 2e-3
    tr.save_dir = str(tmp_path / "run")
    det = Detector.from_config(cfg, device="cpu")
    main.train_code(cfg, det)
    best = tmp_path / "run" / "best.pt"
    assert best.read_bytes()[:4] == b"PK\x03\x04"
    params = load_checkpoint(best, {"params": dict(det.module.named_parameters())},
                             "cpu")["state"]["params"]

    ready, held = threading.Event(), {}

    def on_ready(httpd, service):
        held.update(httpd=httpd, service=service)
        ready.set()

    th = threading.Thread(target=serve.serve, args=(cfg, str(best)),
                          kwargs=dict(port=0, max_batch=1, max_clip=1, device="cpu",
                                      on_ready=on_ready), daemon=True)
    th.start()
    try:
        assert ready.wait(timeout=120), "serve() did not start listening"
        svc = held["service"]
        assert set(svc.params) == set(params)
        assert all(torch.equal(svc.params[k], v) for k, v in params.items())
        svc.conf = 0.0  # every candidate, so that the comparison is not empty
        frame = np.random.RandomState(5).randint(0, 256, (48, 64, 3), dtype=np.uint8)
        code, out = _post(f"http://127.0.0.1:{held['httpd'].server_address[1]}",
                          {"stream": "cam", "image": _png(frame)})
        assert code == 200, out
        want = make_predict_fn(det, conf=0.0, iou=svc.iou, max_det=svc.max_det,
                               pre_nms_topk=None)(params, frame[None, None])
        valid = want["valid"][0].numpy()
        assert valid.sum() > 0
        # The reply rounds boxes to 2 decimals and scores to 4.
        assert out["boxes"] == want["boxes"][0].numpy()[valid].round(2).tolist()
        assert out["scores"] == want["scores"][0].numpy()[valid].round(4).tolist()
        assert out["classes"] == want["classes"][0].numpy()[valid].tolist()
    finally:
        if "httpd" in held:
            held["httpd"].shutdown()
        th.join(timeout=30)
    assert not th.is_alive()
