"""The port's overlays and video (viz/) against the JAX package's viz/ on
the same numpy inputs: boxes are drawn byte for byte (data/raster.py
against cv2.rectangle), labels by cv2.putText in both, ``mode:
visualize``'s renderer on a written test split with the tiny model of
tests/test_legacy.py (fp32, its seeded JAX weights carried across, the
class-logit biases at 0 so that boxes pass conf 0.3), and OpenCV's
absence raises naming the call that needs it."""

import sys

import cv2
import jax
import numpy as np
import pytest

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.data.synthetic import make_dataset as jax_make_dataset
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector
from snn_object_detectionddp_tpu.viz import overlay as joverlay
from snn_object_detectionddp_tpu.viz import palette as jpalette
from snn_object_detectionddp_tpu.viz import video as jvideo
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.convert import params_from_jax
from snn_object_detectionddp_tpu_torch.data.png import read_rgb
from snn_object_detectionddp_tpu_torch.models.detector import Detector
from snn_object_detectionddp_tpu_torch.viz import overlay as toverlay
from snn_object_detectionddp_tpu_torch.viz import palette as tpalette
from snn_object_detectionddp_tpu_torch.viz import video as tvideo

NAMES = ["car", "pedestrian", "bicycle"]


def test_palette_equal():
    assert tpalette._PALETTE == jpalette._PALETTE
    for cls in range(-3, 20):
        assert tpalette.class_color(cls) == jpalette.class_color(cls)


def _box_sets(seed, n_sets, h=48, w=64):
    """Boxes inside, across and outside the image, degenerate (a point, a
    line, corners swapped) and on .5 coordinates (Python rounds half to even)."""
    rng = np.random.RandomState(seed)
    for _ in range(n_sets):
        n = rng.randint(0, 7)
        xy = rng.uniform(-30, [w + 30, h + 30], (n, 2))
        wh = rng.uniform(-10, 50, (n, 2)) * (rng.rand(n, 1) > 0.1)
        boxes = np.concatenate([xy, xy + wh], 1)
        half = rng.rand(n, 4) < 0.3
        boxes[half] = np.floor(boxes[half]) + 0.5
        yield (rng.randint(0, 256, (h, w, 3)).astype(np.uint8), boxes.astype(np.float32),
               rng.randint(0, 12, n), rng.rand(n).astype(np.float32))


def test_draw_bboxes_without_text_is_byte_equal():
    for img, boxes, classes, _ in _box_sets(0, 200):
        want = joverlay.draw_bboxes(img, boxes, None, classes)
        got = toverlay.draw_bboxes(img, boxes, None, classes)
        np.testing.assert_array_equal(got, want)
    img, boxes, _, _ = next(_box_sets(1, 1))
    np.testing.assert_array_equal(toverlay.draw_bboxes(img, boxes),
                                  joverlay.draw_bboxes(img, boxes))
    flipped = img[..., ::-1]  # a view, as run_visualization hands it over
    np.testing.assert_array_equal(toverlay.draw_bboxes(flipped, boxes),
                                  joverlay.draw_bboxes(flipped, boxes))


def test_draw_bboxes_labels_by_cv2(monkeypatch):
    for img, boxes, classes, scores in _box_sets(2, 40):
        np.testing.assert_array_equal(
            toverlay.draw_bboxes(img, boxes, scores, classes, NAMES),
            joverlay.draw_bboxes(img, boxes, scores, classes, NAMES))
    monkeypatch.setitem(sys.modules, "cv2", None)
    img, boxes, classes, scores = next(_box_sets(3, 1))
    with pytest.raises(ImportError, match=r"cv2\.putText"):
        toverlay.draw_bboxes(img, boxes, scores, classes, NAMES)
    toverlay.draw_bboxes(img, boxes, None, classes)  # no text: no OpenCV


def _cfg(mod, root, save_dir):
    cfg = mod.Config()
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.num_classes = 3
    cfg.model.hyp.reg_max = 8
    cfg.model.image_size = (64, 96)
    cfg.runtime.precision = "f32"
    cfg.dataset.test.path, cfg.dataset.test.seq_len = str(root / "test"), 2
    cfg.training.num_workers = 2
    cfg.training.save_dir = str(save_dir)
    return cfg


def _lively(jparams):
    params = jax.tree.map(np.asarray, jparams)
    head = dict(params["head"])
    for name in [k for k in head if k.startswith("cls") and k.endswith("_out")]:
        head[name] = dict(head[name], bias=np.zeros_like(head[name]["bias"]))
    return dict(params, head=head)


def test_run_visualization_matches_jax(tmp_path, monkeypatch):
    """Two sequences of 6 frames, windows of 2: 10 overlays, in batches of
    8 (a full batch and a partial one)."""
    jax_make_dataset(tmp_path / "ds", num_sequences=2, splits=("test",), num_frames=6,
                     height=64, width=96)
    jcfg = _cfg(jconfig, tmp_path / "ds", tmp_path / "jax")
    tcfg = _cfg(tconfig, tmp_path / "ds", tmp_path / "port")
    jdet = JDetector.from_config(jcfg)
    sample = jax.numpy.zeros((1, 1, 64, 96, 3), jax.numpy.float32)
    jparams = _lively(jax.jit(lambda r: jdet.module.init(r, sample)["params"])(jax.random.PRNGKey(0)))
    tdet = Detector.from_config(tcfg, device="cpu")
    tparams = params_from_jax(jparams, "cpu")

    # the boxes each side drew, to know where the pixels must agree
    drawn = {"jax": [], "port": []}
    for side, mod in (("jax", joverlay), ("port", toverlay)):
        plain = mod.draw_bboxes

        def spy(image, boxes, *rest, plain=plain, side=side):
            drawn[side].append(np.asarray(boxes).copy())
            return plain(image, boxes, *rest)

        monkeypatch.setattr(mod, "draw_bboxes", spy)
    want = joverlay.run_visualization(jcfg, jdet, jparams, tmp_path / "jax/vis", class_names=NAMES)
    got = toverlay.run_visualization(tcfg, tdet, tparams, tmp_path / "port/vis", class_names=NAMES)
    assert len(want) == 10
    assert [p.rsplit("/", 1)[1] for p in got] == [p.rsplit("/", 1)[1] for p in want]
    assert sum(len(b) for b in drawn["jax"]) > 0
    for tpath, jpath, tb, jb in zip(got, want, drawn["port"], drawn["jax"]):
        rounded = lambda b: np.unique(np.vectorize(round)(b.astype(np.float64)), axis=0)  # noqa: E731
        assert rounded(tb).tolist() == rounded(jb).tolist(), tpath
        np.testing.assert_array_equal(read_rgb(tpath), cv2.imread(jpath)[..., ::-1], err_msg=tpath)


def test_visualization_without_cv2_raises_first(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    cfg = _cfg(tconfig, tmp_path / "missing", tmp_path / "run")
    with pytest.raises(ImportError, match=r"cv2\.putText"):
        toverlay.run_visualization(cfg, None, None, tmp_path / "vis")
    assert not (tmp_path / "vis").exists()


def _frames(root, sizes):
    root.mkdir()
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate(sizes):
        cv2.imwrite(str(root / f"{i:03d}.png"), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return root


def _count(path):
    cap = cv2.VideoCapture(str(path))
    assert cap.isOpened()
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def test_videos_match_jax(tmp_path, monkeypatch):
    frames = _frames(tmp_path / "frames", [(32, 48)] * 4 + [(40, 50)])  # the last one resized
    want = jvideo.stitch_video(frames, tmp_path / "j/out.mp4", fps=10)
    got = tvideo.stitch_video(frames, tmp_path / "t/out.mp4", fps=10)
    assert _count(got) == _count(want) == 5
    with pytest.raises(FileNotFoundError):
        tvideo.stitch_video(tmp_path, tmp_path / "none.mp4")
    rng = np.random.RandomState(1)
    for stack in (rng.randint(0, 256, (5, 32, 48, 3)).astype(np.uint8),
                  rng.rand(4, 32, 48, 3).astype(np.float32)):
        n = len(stack)
        assert _count(tvideo.frames_to_video(stack, tmp_path / f"t{n}.mp4")) == _count(
            jvideo.frames_to_video(stack, tmp_path / f"j{n}.mp4")) == n
    with pytest.raises(ValueError):
        tvideo.frames_to_video(np.zeros((3, 32, 48)), tmp_path / "bad.mp4")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"cv2\.VideoWriter"):
        tvideo.stitch_video(frames, tmp_path / "x.mp4")
    with pytest.raises(ImportError, match=r"cv2\.VideoWriter"):
        tvideo.frames_to_video(stack, tmp_path / "y.mp4")
