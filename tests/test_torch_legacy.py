"""The port's tracker benchmark (evals/legacy.py) against the JAX package's
on the same numpy inputs.

Model: the tiny detector of tests/test_legacy.py (yolo11n, width 0.25,
2 classes, reg_max 8) in fp32, built once, its seeded JAX weights carried
across by ``convert.params_from_jax``. The class-logit biases are set to 0
(the seeded prior puts every score near 1e-3): the detector then keeps
boxes at the benchmark's conf 0.3, so that tracking, cropping and the
quality metrics see detections. Both sides run the same fp32 math with
convs summed in another order (~1e-6 relative): detector frames, crop
frames, flow frames and strides must be equal, per-frame boxes equal as
sets to 1e-3 px.
"""

import cv2
import jax
import numpy as np
import pytest

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.data.synthetic import make_dataset as jax_make_dataset
from snn_object_detectionddp_tpu.evals import flow as jflow
from snn_object_detectionddp_tpu.evals import legacy as jlegacy
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.convert import params_from_jax, pwclite_params_from_jax
from snn_object_detectionddp_tpu_torch.evals import flow as tflow
from snn_object_detectionddp_tpu_torch.evals import legacy as tlegacy
from snn_object_detectionddp_tpu_torch.models.detector import Detector

BOX_ATOL = 1e-3
N_FRAMES = 7


def _cfg(mod):
    cfg = mod.Config()
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.num_classes = 2
    cfg.model.hyp.reg_max = 8
    cfg.runtime.precision = "f32"
    return cfg


def _lively(jparams):
    """The seeded weights with every class-logit bias at 0."""
    params = jax.tree.map(np.asarray, jparams)
    head = dict(params["head"])
    for name in [k for k in head if k.startswith("cls") and k.endswith("_out")]:
        head[name] = dict(head[name], bias=np.zeros_like(head[name]["bias"]))
    return dict(params, head=head)


def _jax_init(jdet):
    """``jdet.init_params(PRNGKey(0))``, jitted (the same values in a
    quarter of the eager time)."""
    sample = jax.numpy.zeros((1, 1, 64, 64, 3), jax.numpy.float32)
    return jax.jit(lambda r: jdet.module.init(r, sample)["params"])(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def models():
    jdet = JDetector.from_config(_cfg(jconfig))
    jparams = _lively(_jax_init(jdet))
    return jdet, jparams, Detector.from_config(_cfg(tconfig), device="cpu"), params_from_jax(jparams, "cpu")


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """7 frames of 64x64: a bright block drifting right by 2 px a frame
    over seeded noise."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(0)
    base = rng.randint(0, 64, (64, 64, 3), np.uint8)
    paths = []
    for i in range(N_FRAMES):
        img = base.copy()
        img[20:44, 10 + 2 * i: 34 + 2 * i] = 255
        p = root / f"{i:06d}.png"
        cv2.imwrite(str(p), img)
        paths.append(str(p))
    return paths


def _same_boxes(got, want, tag):
    assert len(got) == len(want), tag
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, f"{tag} frame {i}: {g.shape} vs {w.shape}"
        g = g[np.lexsort(g.T[::-1])] if g.size else g
        w = w[np.lexsort(w.T[::-1])] if w.size else w
        np.testing.assert_allclose(g, w, atol=BOX_ATOL, err_msg=f"{tag} frame {i}")


def _hook(prev_iou, curr_iou, stride):
    return jlegacy.default_adaptive_stride(prev_iou, curr_iou, stride, lo=0.5, hi=0.8, max_stride=3)


CASES = {
    "entire_model": dict(method="entire_model"),
    "cropped_model": dict(method="cropped_model"),
    "optical_flow_model": dict(method="optical_flow", stride=3, flow_method="model"),
    "optical_flow_no": dict(method="optical_flow", stride=2, flow_method="no"),
    "optical_flow_farneback": dict(method="optical_flow", stride=3, flow_method="farneback"),
    "adaptive": dict(method="optical_flow", stride=1, flow_method="model", compute_stride=_hook),
}


@pytest.mark.parametrize("case", list(CASES))
def test_process_sequence_matches_jax(case, models, frames):
    jdet, jparams, tdet, tparams = models
    kw = CASES[case]
    if kw.get("flow_method") == "model":
        # the JAX package's process-wide flow model, carried across
        jmf = jflow.get_model_flow()
        jmf._ensure(32, 32)
        tflow.get_model_flow("cpu").net.load_state_dict(
            pwclite_params_from_jax(jax.tree.map(np.asarray, jmf._params), "cpu"))
    want = jlegacy.process_sequence(jdet, jparams, frames, **kw)
    got = tlegacy.process_sequence(tdet, tparams, frames, **kw)
    for key in ("num_frames", "det_count", "crop_det_count", "flow_count", "stride_list"):
        assert got[key] == want[key], key
    assert sum(d.shape[0] for d in want["detections"]) > 0  # boxes were tracked
    _same_boxes(got["detections"], want["detections"], case)
    if case == "cropped_model":
        assert got["crop_det_count"] > 0 and got["model_flops"] > 0
        assert got["blended_flops_per_frame"] < got["model_flops"]  # crops are cheaper


def test_process_dataset_matches_jax(models, tmp_path):
    """A written 1-sequence test split with tracks.npy, optical flow
    (Farneback: the port's own against OpenCV's) every other frame: the
    same quality metrics (the generator's 3 classes; the metrics ignore
    the class)."""
    jdet, jparams, tdet, tparams = models
    jax_make_dataset(tmp_path / "ds", num_sequences=1, splits=("test",), num_frames=5,
                     height=64, width=96)
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = _cfg(mod)
        cfg.dataset.test.path, cfg.dataset.test.seq_len = str(tmp_path / "ds/test"), 2
        cfg.training.save_dir = str(tmp_path / mod.__name__)
        cfgs.append(cfg)
    want = jlegacy.process_dataset(cfgs[0], jdet, jparams, stride=2, annotate=True)
    got = tlegacy.process_dataset(cfgs[1], tdet, tparams, stride=2, annotate=True)
    (w,), (g,) = want["per_sequence"].values(), got["per_sequence"].values()
    for key in ("det_count", "flow_count", "stride_list"):
        assert g[key] == w[key], key
    assert want["aggregate"]["num_detections"] > 0
    for key in ("avg_iou", "precision", "num_detections"):
        assert got["aggregate"][key] == pytest.approx(want["aggregate"][key], abs=1e-6), key
    assert g["gt_velocity_px_s"] == pytest.approx(w["gt_velocity_px_s"], rel=1e-6)
    # the annotated frames: the same names, pixels equal where boxes round alike
    from snn_object_detectionddp_tpu_torch.data.png import read_rgb

    jdir, tdir = (tmp_path / "snn_object_detectionddp_tpu.config/annotated/seq_00",
                  tmp_path / "snn_object_detectionddp_tpu_torch.config/annotated/seq_00")
    names = sorted(p.name for p in jdir.glob("*.png"))
    assert names and names == sorted(p.name for p in tdir.glob("*.png"))
    compared = 0
    for name, gb, wb in zip(names, g["detections"], w["detections"]):
        if np.array_equal(np.unique(gb.astype(int), axis=0), np.unique(wb.astype(int), axis=0)):
            np.testing.assert_array_equal(read_rgb(tdir / name),
                                          cv2.imread(str(jdir / name))[..., ::-1])
            compared += 1
    assert compared == len(names)  # every frame's boxes truncate alike here


def test_metrics_and_helpers_match_jax():
    rng = np.random.RandomState(3)

    def boxes(n):
        xy = rng.rand(n, 2) * 80
        return np.concatenate([xy, xy + 1 + rng.rand(n, 2) * 30], 1).astype(np.float32)

    for _ in range(20):
        dets = [boxes(rng.randint(0, 6)) for _ in range(5)]
        gts = [boxes(rng.randint(0, 4)) for _ in range(5)]
        for thr in (0.3, 0.5):
            assert tlegacy.eval_metric_dsec(dets, gts, thr) == jlegacy.eval_metric_dsec(dets, gts, thr)
        for d, g in zip(dets, gts):
            for top in (None, 2):
                assert tlegacy.compute_iou_list(d, g, top) == jlegacy.compute_iou_list(d, g, top)
        assert tlegacy.gt_velocity(gts) == jlegacy.gt_velocity(gts)
    hand = [np.array([[0, 0, 10, 10]], np.float32), np.array([[0, 0, 10, 5]], np.float32)]
    gt = [np.array([[0, 0, 10, 10]], np.float32)] * 2
    assert tlegacy.eval_metric_dsec(hand, gt) == jlegacy.eval_metric_dsec(hand, gt)
    assert tlegacy.eval_metric_dsec([], []) == jlegacy.eval_metric_dsec([], [])

    per_frame = {0: rng.rand(3, 5).astype(np.float32) * 50, 2: np.zeros((0, 5), np.float32)}
    for i in range(4):
        np.testing.assert_array_equal(tlegacy._gt_frame_xyxy(per_frame, i),
                                      jlegacy._gt_frame_xyxy(per_frame, i))
    for h in (1, 31, 32, 63, 64, 65, 100, 480, 481):
        for w in (1, 33, 64, 640, 641):
            assert tlegacy._crop_hw(h, w) == jlegacy._crop_hw(h, w)
    for prev in (0.0, 0.5, 1.0):
        for cur in (0.0, 0.39, 0.4, 0.55, 0.7, 0.71, 1.0):
            for stride in (1, 2, 5, 9, 10, 12):
                assert (tlegacy.default_adaptive_stride(prev, cur, stride)
                        == jlegacy.default_adaptive_stride(prev, cur, stride))
