"""The port's evaluation path (evals/map.py, evals/validator.py, greedy
NMS) against the JAX package.

- DetMetrics / match_predictions / ap_per_class: the port keeps its own
  copy of the numpy code, so on the same seeded predictions every number
  must be equal.
- The slice as a whole, in fp32 on converted weights: a dataset written by
  the JAX package's synthetic generator and read by its BatchLoader gives
  numpy batches; the same batches go through JAX ``make_predict_fn`` +
  ``DetMetrics`` and through the port's ``make_predict_fn`` +
  ``evaluate_batches`` at the evaluation thresholds (conf 0.001, iou 0.6,
  300 detections, pool 30000). Once with a fresh tiny model against JAX
  ``evaluate_model`` itself (its seeded validation split), once with the
  committed checkpoint ``fixtures/hard_nano_ckpt.pt`` on windows drawn with
  the generator settings of its training fixture, at
  ``scripts/hard_nano.yaml``'s geometry.

Tolerances of the slice: both sides run the same fp32 math, but XLA and
PyTorch sum convs in another order (~1e-6 relative), which moves scores by
~1e-6 and can swap two detections whose scores are that close, or flip a
knife-edge spike. Per image the number of detections must agree, the
descending scores to 1e-4, and — matched greedily by score and class — the
boxes to 1e-2 px for at least 99% of the detections. The results dict
(mAP50, mAP50-95, precision, recall, fitness) is held to 5e-3 absolute: a
swapped pair changes one step of a precision-recall curve of a few hundred
predictions.
"""

from pathlib import Path

import jax
import numpy as np
import pytest

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.data.dsec import DSECIndex, train_val_split
from snn_object_detectionddp_tpu.data.pipeline import BatchLoader
from snn_object_detectionddp_tpu.data.synthetic import make_dataset, make_sequence_hard
from snn_object_detectionddp_tpu.evals import map as jmap
from snn_object_detectionddp_tpu.evals import validator as jval
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector
from snn_object_detectionddp_tpu.ops.boxes import cxcywh_to_xyxy as j_cxcywh_to_xyxy
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.convert import load_flax_params, params_from_jax
from snn_object_detectionddp_tpu_torch.evals import map as tmap
from snn_object_detectionddp_tpu_torch.evals import validator as tval
from snn_object_detectionddp_tpu_torch.models.detector import Detector as TDetector
from snn_object_detectionddp_tpu_torch.parallel.mesh import make_mesh

REPO = Path(__file__).resolve().parents[1]
RESULT_ATOL = 5e-3


# -- metrics ------------------------------------------------------------------


def _seeded_predictions(seed, n_images=6, nc=3, empty_gt_image=None, empty_pred_image=None):
    """Per image: jittered copies of the ground truth plus clutter."""
    rng = np.random.RandomState(seed)
    images = []
    for i in range(n_images):
        n_gt = 0 if i == empty_gt_image else rng.randint(1, 6)
        xy = rng.uniform(0, 200, size=(n_gt, 2))
        wh = rng.uniform(10, 80, size=(n_gt, 2))
        gt_boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        gt_cls = rng.randint(0, nc, size=n_gt).astype(np.float32)
        hits = gt_boxes + rng.randn(n_gt, 4).astype(np.float32) * rng.uniform(0.5, 6)
        n_fp = rng.randint(0, 8)
        fxy = rng.uniform(0, 200, size=(n_fp, 2))
        fps = np.concatenate([fxy, fxy + rng.uniform(10, 80, size=(n_fp, 2))], 1).astype(np.float32)
        boxes = np.concatenate([hits, fps])
        cls = np.concatenate([np.where(rng.rand(n_gt) < 0.8, gt_cls, rng.randint(0, nc, n_gt)),
                              rng.randint(0, nc, n_fp)]).astype(np.int32)
        conf = rng.uniform(0.001, 1.0, size=len(boxes)).astype(np.float32)
        if i == empty_pred_image:
            boxes, cls, conf = boxes[:0], cls[:0], conf[:0]
        images.append(dict(pred_boxes=boxes, pred_conf=conf, pred_cls=cls,
                           gt_boxes=gt_boxes, gt_cls=gt_cls))
    return images


@pytest.mark.parametrize("case", [dict(seed=0), dict(seed=1, empty_gt_image=2),
                                  dict(seed=2, empty_pred_image=0), dict(seed=3, nc=5)],
                         ids=["plain", "image_without_gt", "image_without_predictions",
                              "absent_classes"])
def test_det_metrics_equal_the_jax_packages(case):
    nc = case.get("nc", 3)
    ours, theirs = tmap.DetMetrics(nc), jmap.DetMetrics(nc)
    for img in _seeded_predictions(**case):
        np.testing.assert_array_equal(
            tmap.match_predictions(img["pred_boxes"], img["pred_cls"], img["gt_boxes"], img["gt_cls"]),
            jmap.match_predictions(img["pred_boxes"], img["pred_cls"], img["gt_boxes"], img["gt_cls"]))
        ours.update(**img)
        theirs.update(**img)
    got, want = ours.results_dict(), theirs.results_dict()
    assert got == want
    assert set(got) == {"metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                        "metrics/mAP50-95(B)", "fitness"}
    assert 0.05 < got["metrics/mAP50(B)"] < 1.0  # a discriminating case, not 0 or 1


def test_det_metrics_empty_and_perfect():
    assert tmap.DetMetrics(3).results_dict() == jmap.DetMetrics(3).results_dict()
    m = tmap.DetMetrics(2)
    boxes = np.array([[0, 0, 10, 10], [20, 20, 40, 50]], np.float32)
    m.update(pred_boxes=boxes, pred_conf=np.array([0.9, 0.8], np.float32),
             pred_cls=np.array([0, 1], np.int32), gt_boxes=boxes, gt_cls=np.array([0.0, 1.0]))
    res = m.results_dict()
    assert res["metrics/mAP50(B)"] == pytest.approx(1.0, abs=1e-6)
    assert res["metrics/mAP50-95(B)"] == pytest.approx(1.0, abs=1e-6)
    assert tmap.IOU_THRESHOLDS.tolist() == jmap.IOU_THRESHOLDS.tolist()


# -- the slice as a whole ---------------------------------------------------------


def _jax_accumulate(metrics, out, batch):
    """The body of the JAX package's evaluate_model loop."""
    h, w = batch["images"].shape[2:4]
    scale = np.array([w, h, w, h], np.float32)
    for i in range(len(batch["paths"])):
        valid = out["valid"][i]
        gt = batch["labels"][i][batch["label_mask"][i]]
        gt_boxes = np.asarray(j_cxcywh_to_xyxy(gt[:, 1:] * scale) if gt.size else np.zeros((0, 4)))
        metrics.update(pred_boxes=out["boxes"][i][valid], pred_conf=out["scores"][i][valid],
                       pred_cls=out["classes"][i][valid], gt_boxes=gt_boxes,
                       gt_cls=gt[:, 0] if gt.size else np.zeros(0))


def _compare_image(got, ref, tag):
    """One image's NMS outputs (numpy dicts), see the module docstring."""
    n = int(ref["valid"].sum())
    assert int(got["valid"].sum()) == n, tag
    assert got["valid"][:n].all() and ref["valid"][:n].all()
    np.testing.assert_allclose(got["scores"][:n], ref["scores"][:n], atol=1e-4, err_msg=tag)
    assert (got["classes"][n:] == -1).all() and not got["scores"][n:].any()
    # Greedy match on (class, score): a swap of two near-equal scores moves slots.
    close, used = 0, np.zeros(n, bool)
    for k in range(n):
        cand = np.nonzero(~used & (ref["classes"][:n] == got["classes"][k])
                          & (np.abs(ref["scores"][:n] - got["scores"][k]) <= 1e-4))[0]
        if cand.size:
            err = np.abs(ref["boxes"][cand] - got["boxes"][k]).max(-1)
            j = cand[np.argmin(err)]
            if err.min() <= 1e-2:
                used[j] = True
                close += 1
    assert close >= 0.99 * n, f"{tag}: only {close} of {n} detections have a matching box"
    return n


def _both_sides(jdet, jparams, tdet, tparams, batches):
    """Run every batch through both packages; returns (port results dict,
    JAX results dict, detections compared)."""
    jpredict = jval.make_predict_fn(jdet)
    tpredict = tval.make_predict_fn(tdet)
    jmetrics = jmap.DetMetrics(jdet.cfg.model.num_classes)
    seen, n_det = [], 0

    def spying_predict(params, images):
        out = tpredict(params, images)
        seen.append({k: v.numpy() for k, v in out.items()})
        return out

    got = tval.evaluate_batches(tdet, tparams, batches, predict=spying_predict)
    assert len(seen) == len(batches)
    for bi, batch in enumerate(batches):
        jout = jax.device_get(jpredict(jparams, batch["images"]))
        _jax_accumulate(jmetrics, jout, batch)
        assert seen[bi]["boxes"].shape == (len(batch["images"]), 300, 4)
        for i in range(len(batch["paths"])):
            n_det += _compare_image({k: v[i] for k, v in seen[bi].items()},
                                    {k: np.asarray(v[i]) for k, v in jout.items()},
                                    f"batch {bi} image {i}")
    return got, jmetrics.results_dict(), n_det


def _cfgs(root, height, width, yaml=None):
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = mod.load_config(REPO / yaml) if yaml else mod.Config()
        if not yaml:
            cfg.model.num_classes = 3
            cfg.model.yolo_model_name = "yolo11n.pt"
            cfg.model.width_mult = 0.25
            cfg.model.hyp.reg_max = 8
            cfg.model.image_size = (height, width)
            cfg.model.max_boxes = 8
        cfg.runtime.precision = "f32"
        cfg.training.num_workers = 1
        for split in ("train", "val", "test"):
            sc = cfg.dataset.split(split)
            sc.path = str(root / "train")
            sc.seq_len = 3 if not yaml else sc.seq_len
        cfgs.append(cfg)
    return cfgs


def test_evaluation_slice_matches_jax_on_a_fresh_tiny_model(tmp_path):
    make_dataset(tmp_path, num_sequences=3, splits=("train",), num_frames=5, height=64, width=96)
    jcfg, tcfg = _cfgs(tmp_path, 64, 96)
    jdet = JDetector.from_config(jcfg)
    tdet = TDetector.from_config(tcfg, device="cpu")
    jparams = jdet.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")

    # The validation split as the JAX evaluate_model builds it.
    index = DSECIndex(jcfg, "train")
    _, val_idx = train_val_split(index, seed=jcfg.training.seed)
    assert len(val_idx) == 3  # one held-out sequence of 3 windows: a partial last batch
    batches = list(BatchLoader(index, val_idx, batch_size=2, max_boxes=jcfg.model.max_boxes,
                               shuffle=False, num_threads=1))
    assert [len(b["paths"]) for b in batches] == [2, 1]
    got, want, n_det = _both_sides(jdet, jparams, tdet, tparams, batches)
    assert n_det > 50  # conf 0.001 keeps the low-confidence tail (126 anchors an image)
    # ... and JAX evaluate_model itself, over the same split.
    reference = jval.evaluate_model(jcfg, jdet, jparams, batch_size=2)
    assert reference == want
    assert set(got) == set(reference)
    for k in reference:
        assert got[k] == pytest.approx(reference[k], abs=RESULT_ATOL), k


def test_evaluation_slice_matches_jax_on_the_fixture_checkpoint(tmp_path):
    from flax import serialization

    for i in range(2):  # the generator settings of the checkpoint's training fixture
        make_sequence_hard(tmp_path / "train" / f"seq_{i:02d}", num_frames=7, height=128,
                           width=160, num_objects=4, num_classes=3, seed=5000 + i,
                           min_scale=0.10, max_scale=0.28, noise=3.0, jitter=(0.90, 1.10),
                           num_distractors=4)
    jcfg, tcfg = _cfgs(tmp_path, 128, 160, yaml="scripts/hard_nano.yaml")
    assert tuple(tcfg.model.image_size) == (128, 160) and tcfg.dataset.split("val").seq_len == 5
    jdet = JDetector.from_config(jcfg)
    tdet = TDetector.from_config(tcfg, device="cpu")
    ckpt = REPO / "fixtures/hard_nano_ckpt.pt"
    template = jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0))
    raw = serialization.msgpack_restore(ckpt.read_bytes())
    jparams = jax.tree.map(lambda t, r: np.asarray(r, t.dtype), template,
                           serialization.from_state_dict(template, raw["params"]))
    tparams = params_from_jax(load_flax_params(ckpt), "cpu")

    index = DSECIndex(jcfg, "train")
    assert len(index) == 6  # 2 sequences x (7 - 5 + 1) windows
    batches = list(BatchLoader(index, list(range(6)), batch_size=2,
                               max_boxes=jcfg.model.max_boxes, shuffle=False, num_threads=1))
    assert batches[0]["images"].shape == (2, 5, 128, 160, 3)
    got, want, n_det = _both_sides(jdet, jparams, tdet, tparams, batches)
    assert n_det > 100
    assert want["metrics/mAP50(B)"] > 0.2  # the trained model does detect its training scenes
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=RESULT_ATOL), k


def test_entry_points_and_unported_paths():
    cfg = tconfig.Config()
    cfg.model.yolo_model_name, cfg.model.width_mult = "yolo11n.pt", 0.25
    det = TDetector.from_config(cfg, device="cpu")
    # The mesh argument is a data mesh (several processes:
    # tests/test_torch_parallel.py); over one process it changes nothing.
    mesh = make_mesh()
    assert tval.evaluate_batches(det, {}, [], mesh=mesh) == tval.evaluate_batches(det, {}, [])
    assert (tval.EVAL_CONF, tval.EVAL_IOU, tval.EVAL_MAX_DET, tval.EVAL_PRE_NMS_TOPK) == (
        jval.EVAL_CONF, jval.EVAL_IOU, jval.EVAL_MAX_DET, jval.EVAL_PRE_NMS_TOPK)
    # no batches: the empty results dict, as DetMetrics gives it
    assert tval.evaluate_batches(det, {}, []) == tmap.DetMetrics(cfg.model.num_classes).results_dict()
