"""The port's box geometry, anchors, Task-Aligned Assigner and detection
loss against the JAX package on the same numpy inputs (fp32, CPU).

Tolerances and their reasons: both sides evaluate the same fp32 formulas,
but XLA and PyTorch differ in the last bit of transcendental functions
(atan, pow, exp, log) and in the order of sums over anchors. Element-wise
geometry is held to 1e-5; the assigner's discrete outputs (foreground
mask, labels, boxes) must be equal, its soft scores to 1e-5; the loss
value to 1e-5 relative and its gradients to 1e-4 of the largest entry
(sums over thousands of anchors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu.losses import detection as jdl
from snn_object_detectionddp_tpu.losses import tal as jtal
from snn_object_detectionddp_tpu.ops import anchors as janc
from snn_object_detectionddp_tpu.ops import boxes as jbox
from snn_object_detectionddp_tpu_torch.losses import detection as tdl
from snn_object_detectionddp_tpu_torch.losses import tal as ttal
from snn_object_detectionddp_tpu_torch.ops import anchors as tanc
from snn_object_detectionddp_tpu_torch.ops import boxes as tbox

T = torch.from_numpy


def _boxes(rng, *lead):
    c = rng.rand(*lead, 2) * 60.0
    half = rng.rand(*lead, 2) * 20.0 + 0.5
    return np.concatenate([c - half, c + half], -1).astype(np.float32)


def test_box_conversions_iou_ciou_scale_match_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 5, 7), _boxes(rng, 5, 7)
    b[0, 0] = a[0, 0]  # identical pair
    b[0, 1] = a[0, 1] + 200.0  # disjoint pair
    a[0, 2, 2:] = a[0, 2, :2]  # degenerate (zero-area) box
    for name in ("cxcywh_to_xyxy", "xyxy_to_cxcywh"):
        np.testing.assert_allclose(getattr(tbox, name)(T(a)).numpy(),
                                   np.asarray(getattr(jbox, name)(jnp.asarray(a))), atol=1e-5)
    np.testing.assert_allclose(tbox.xyxy_to_cxcywh(tbox.cxcywh_to_xyxy(T(a))).numpy(), a, atol=1e-4)
    for name in ("elementwise_iou", "ciou"):
        np.testing.assert_allclose(getattr(tbox, name)(T(a), T(b)).numpy(),
                                   np.asarray(getattr(jbox, name)(jnp.asarray(a), jnp.asarray(b))),
                                   atol=1e-5, err_msg=name)
    # broadcast form used by the assigner: (B, M, 1, 4) x (B, 1, A, 4)
    np.testing.assert_allclose(
        tbox.ciou(T(a)[:, :3, None], T(b)[:, None]).numpy(),
        np.asarray(jbox.ciou(jnp.asarray(a)[:, :3, None], jnp.asarray(b)[:, None])), atol=1e-5)
    np.testing.assert_allclose(
        tbox.scale_boxes(T(a), (64, 64), (480, 640)).numpy(),
        np.asarray(jbox.scale_boxes(jnp.asarray(a), (64, 64), (480, 640))), rtol=1e-6)
    np.testing.assert_allclose(tbox.pairwise_iou(T(a), T(b)).numpy(),
                               np.asarray(jbox.pairwise_iou(jnp.asarray(a), jnp.asarray(b))),
                               atol=1e-6)


def test_ciou_gradient_matches_jax():
    """alpha is held constant under the gradient on both sides."""
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 40), _boxes(rng, 40)
    g_j = jax.grad(lambda x: jnp.sum(jbox.ciou(x, jnp.asarray(b))))(jnp.asarray(a))
    at = T(a).requires_grad_()
    (g_t,) = torch.autograd.grad(tbox.ciou(at, T(b)).sum(), at)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-5)


def test_bbox2dist_and_anchors_match_jax():
    rng = np.random.RandomState(2)
    pts_j, st_j = janc.make_anchors([(8, 10), (4, 5)], [8, 16])
    pts_t, st_t = tanc.make_anchors([(8, 10), (4, 5)], [8, 16], device="cpu")
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    boxes = (rng.rand(3, 100, 4) * 30.0 - 5.0).astype(np.float32)
    for reg_max in (8, 16):
        got = tanc.bbox2dist(T(boxes), pts_t, reg_max).numpy()
        np.testing.assert_allclose(
            got, np.asarray(janc.bbox2dist(jnp.asarray(boxes), pts_j, reg_max)), atol=1e-6)
        assert got.min() >= 0.0 and got.max() <= reg_max - 1 - 0.01 + 1e-6
    d = rng.rand(2, 100, 4).astype(np.float32) * 5
    np.testing.assert_allclose(tanc.dist2bbox(T(d), pts_t).numpy(),
                               np.asarray(janc.dist2bbox(jnp.asarray(d), pts_j)), atol=1e-6)


# ---------------------------------------------------------------------------
# Task-aligned assigner
# ---------------------------------------------------------------------------


def _assign_both(pd_scores, pd_boxes, anc_px, gt_labels, gt_boxes, mask_gt):
    args = (pd_scores, pd_boxes, anc_px, gt_labels, gt_boxes, mask_gt)
    ref = jtal.task_aligned_assign(*(jnp.asarray(x) for x in args))
    got = ttal.task_aligned_assign(*(T(np.asarray(x)) for x in args))
    return got, ref


def _assert_assign_equal(got, ref):
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(got.target_labels.numpy(), np.asarray(ref.target_labels))
    assert got.target_labels.dtype == torch.int32
    fg = got.fg_mask.numpy()
    np.testing.assert_allclose(got.target_bboxes.numpy()[fg], np.asarray(ref.target_bboxes)[fg],
                               atol=1e-5)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(ref.target_scores),
                               atol=1e-5)


def _grid_setup(nc=3):
    # One 8x8 grid at stride 8 -> 64 anchors over a 64x64 image, a fixed
    # 16x16 predicted box on each anchor, uniform class scores.
    anc, strides = janc.make_anchors([(8, 8)], [8])
    anc_px = np.asarray(anc * strides)
    pd_boxes = np.concatenate([anc_px - 8.0, anc_px + 8.0], -1)[None].astype(np.float32)
    pd_scores = np.full((1, anc_px.shape[0], nc), 0.5, np.float32)
    return anc_px, pd_boxes, pd_scores


def test_assign_single_gt():
    anc_px, pd_boxes, pd_scores = _grid_setup()
    gt_boxes = np.array([[[8.0, 8.0, 40.0, 40.0]] + [[0.0] * 4] * 3], np.float32)
    gt_labels = np.array([[2, 0, 0, 0]], np.int32)
    mask_gt = np.array([[True, False, False, False]])
    got, ref = _assign_both(pd_scores, pd_boxes, anc_px, gt_labels, gt_boxes, mask_gt)
    _assert_assign_equal(got, ref)
    fg = got.fg_mask.numpy()[0]
    # Equal metrics everywhere inside the box: the top-k tie order decides
    # which 10 anchors win, and must be the JAX one (lower index first).
    assert 0 < fg.sum() <= 10
    assert (got.target_labels.numpy()[0][fg] == 2).all()


def test_assign_no_gt():
    anc_px, pd_boxes, pd_scores = _grid_setup()
    got, ref = _assign_both(pd_scores, pd_boxes, anc_px, np.zeros((1, 4), np.int32),
                            np.zeros((1, 4, 4), np.float32), np.zeros((1, 4), bool))
    _assert_assign_equal(got, ref)
    assert got.fg_mask.sum() == 0 and got.target_scores.sum() == 0


def test_multi_gt_resolution_by_iou():
    anc_px, pd_boxes, pd_scores = _grid_setup()
    gt_boxes = np.array([[[0.0, 0.0, 64.0, 64.0], [12.0, 12.0, 28.0, 28.0]] + [[0.0] * 4] * 2],
                        np.float32)
    gt_labels = np.array([[1, 2, 0, 0]], np.int32)
    mask_gt = np.array([[True, True, False, False]])
    got, ref = _assign_both(pd_scores, pd_boxes, anc_px, gt_labels, gt_boxes, mask_gt)
    _assert_assign_equal(got, ref)
    idx = np.argmin(np.abs(anc_px - np.array([20.0, 20.0])).sum(-1))
    assert got.fg_mask.numpy()[0][idx] and got.target_labels.numpy()[0][idx] == 2


def test_assign_class_index_out_of_range_gives_zero_rows():
    """jax.nn.one_hot gives a zero row where F.one_hot would raise."""
    anc_px, pd_boxes, pd_scores = _grid_setup()
    gt_boxes = np.array([[[8.0, 8.0, 40.0, 40.0], [20.0, 20.0, 60.0, 60.0]]], np.float32)
    gt_labels = np.array([[7, 1]], np.int32)  # 7 >= nc
    got, ref = _assign_both(pd_scores, pd_boxes, anc_px, gt_labels, gt_boxes,
                            np.array([[True, True]]))
    _assert_assign_equal(got, ref)


@pytest.mark.parametrize("trial", range(6))
def test_assign_matches_jax_randomized(trial):
    """Random scenes: empty samples, padded gt rows, degenerate boxes and
    crowded anchors claimed by several gts."""
    rng = np.random.RandomState(100 + trial)
    anc, strides = janc.make_anchors([(8, 8), (4, 4)], [8, 16])
    anc_px = np.asarray(anc * strides)
    a, nc, m, b = anc_px.shape[0], 4, 6, 3
    pd_scores = rng.rand(b, a, nc).astype(np.float32)
    centers = rng.rand(b, a, 2) * 64.0
    halves = rng.rand(b, a, 2) * 24.0 + 2.0
    pd_boxes = np.concatenate([centers - halves, centers + halves], -1).astype(np.float32)
    gt_centers = rng.rand(b, m, 2) * 64.0
    gt_halves = rng.rand(b, m, 2) * 28.0 + 1.0
    gt_boxes = np.concatenate([gt_centers - gt_halves, gt_centers + gt_halves], -1).astype(np.float32)
    gt_labels = rng.randint(0, nc, size=(b, m)).astype(np.int32)
    mask_gt = rng.rand(b, m) < 0.7
    mask_gt[0] = False  # one all-padding sample
    gt_boxes[~mask_gt] = 0.0
    got, ref = _assign_both(pd_scores, pd_boxes, anc_px, gt_labels, gt_boxes, mask_gt)
    _assert_assign_equal(got, ref)
    assert got.fg_mask[1:].sum() > 0


# ---------------------------------------------------------------------------
# Detection loss
# ---------------------------------------------------------------------------

NC, REG_MAX = 3, 8


def _loss_inputs(seed, b=3, m=5, scale=1.0):
    rng = np.random.RandomState(seed)
    raw = [(scale * rng.randn(b, h, w, 4 * REG_MAX + NC)).astype(np.float32)
           for h, w in ((8, 8), (4, 4), (2, 2))]
    labels = np.zeros((b, m, 5), np.float32)
    labels[..., 0] = rng.randint(0, NC, (b, m))
    labels[..., 1:3] = 0.25 + 0.5 * rng.rand(b, m, 2)
    labels[..., 3:] = 0.15 + 0.35 * rng.rand(b, m, 2)
    mask = rng.rand(b, m) < 0.7
    mask[:, 0] = True
    return raw, labels, mask


def _both_losses(raw, labels, mask, sample_mask=None, grad=True):
    def jloss(maps):
        lc = jdl.detection_loss(maps, jnp.asarray(labels), jnp.asarray(mask), NC, REG_MAX,
                                sample_mask=None if sample_mask is None else jnp.asarray(sample_mask))
        return lc.total, lc

    maps_j = [jnp.asarray(r) for r in raw]
    (_, lc_j), g_j = jax.value_and_grad(jloss, has_aux=True)(maps_j)
    maps_t = [T(r).requires_grad_() for r in raw]
    lc_t = tdl.detection_loss(maps_t, T(labels), T(mask), NC, REG_MAX,
                              sample_mask=None if sample_mask is None else T(sample_mask))
    g_t = torch.autograd.grad(lc_t.total, maps_t)
    return lc_t, lc_j, g_t, g_j


def _assert_losses_close(lc_t, lc_j, g_t, g_j):
    for name in ("total", "box", "cls", "dfl", "fg"):
        np.testing.assert_allclose(float(getattr(lc_t, name)), float(getattr(lc_j, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for i, (gt, gj) in enumerate(zip(g_t, g_j)):
        gj = np.asarray(gj)
        assert np.isfinite(gt.numpy()).all()
        np.testing.assert_allclose(gt.numpy(), gj, atol=1e-4 * max(1.0, np.abs(gj).max()),
                                   err_msg=f"grad of map {i}")


@pytest.mark.parametrize("seed", [0, 1])
def test_detection_loss_value_and_gradient_match_jax(seed):
    raw, labels, mask = _loss_inputs(seed)
    lc_t, lc_j, g_t, g_j = _both_losses(raw, labels, mask)
    assert float(lc_t.fg) > 0  # the assigner found foreground: box and dfl terms are live
    _assert_losses_close(lc_t, lc_j, g_t, g_j)
    np.testing.assert_allclose(lc_t.vec3.detach().numpy(), np.asarray(lc_j.vec3), rtol=1e-5)


def test_detection_loss_no_label_batch():
    raw, labels, _ = _loss_inputs(2)
    lc_t, lc_j, g_t, g_j = _both_losses(raw, labels, np.zeros(labels.shape[:2], bool))
    assert float(lc_t.fg) == 0 and float(lc_t.box) == 0 and float(lc_t.dfl) == 0
    _assert_losses_close(lc_t, lc_j, g_t, g_j)


def test_detection_loss_sample_mask_equals_unpadded_batch():
    raw, labels, mask = _loss_inputs(3, b=3)
    sample_mask = np.array([True, True, False])
    labels[2] = 0.0
    mask[2] = False
    lc_t, lc_j, g_t, g_j = _both_losses(raw, labels, mask, sample_mask)
    _assert_losses_close(lc_t, lc_j, g_t, g_j)
    assert np.abs(g_t[0].numpy()[2]).max() == 0.0  # the padding row gets no gradient
    unpadded = tdl.detection_loss([T(r[:2]) for r in raw], T(labels[:2]), T(mask[:2]), NC, REG_MAX)
    np.testing.assert_allclose(float(lc_t.total), float(unpadded.total), rtol=1e-6)


def test_detection_loss_extreme_logits_stay_finite():
    """Saturated class logits: sigmoid underflows to 0 and the assigner's
    pow(score, 0.5) would have an infinite gradient if it were not detached."""
    raw, labels, mask = _loss_inputs(4, scale=60.0)
    lc_t, lc_j, g_t, g_j = _both_losses(raw, labels, mask)
    assert np.isfinite(float(lc_t.total))
    _assert_losses_close(lc_t, lc_j, g_t, g_j)


def test_dfl_loss_and_bce_match_jax():
    rng = np.random.RandomState(5)
    pred = rng.randn(2, 30, 4, REG_MAX).astype(np.float32)
    target = (rng.rand(2, 30, 4) * (REG_MAX - 1 - 0.01)).astype(np.float32)
    target[0, 0] = [0.0, REG_MAX - 1.01, 3.0, 2.5]  # bin edges and an integer target
    np.testing.assert_allclose(tdl._dfl_loss(T(pred), T(target)).numpy(),
                               np.asarray(jdl._dfl_loss(jnp.asarray(pred), jnp.asarray(target))),
                               atol=1e-5)
    # a target beyond the last bin: the right neighbour is out of range and counts zero
    over = np.full((1, 1, 4), REG_MAX - 0.5, np.float32)
    np.testing.assert_allclose(tdl._dfl_loss(T(pred[:1, :1]), T(over)).numpy(),
                               np.asarray(jdl._dfl_loss(jnp.asarray(pred[:1, :1]), jnp.asarray(over))),
                               atol=1e-5)
    logits = np.array([-90.0, -3.0, 0.0, 2.0, 90.0], np.float32)
    targets = np.array([0.0, 0.3, 0.5, 1.0, 1.0], np.float32)
    np.testing.assert_allclose(tdl.sigmoid_bce(T(logits), T(targets)).numpy(),
                               np.asarray(jdl.optax_sigmoid_bce(jnp.asarray(logits), jnp.asarray(targets))),
                               atol=1e-6)


def test_detection_loss_class_and_cross_replica():
    raw, labels, mask = _loss_inputs(6)

    class Hyp:
        box, cls, dfl, reg_max = 7.5, 0.5, 1.5, REG_MAX

    lc_t = tdl.DetectionLoss(NC, Hyp)([T(r) for r in raw], T(labels), T(mask))
    lc_j = jdl.DetectionLoss(NC, Hyp)([jnp.asarray(r) for r in raw], jnp.asarray(labels),
                                      jnp.asarray(mask))
    np.testing.assert_allclose(float(lc_t.total), float(lc_j.total), rtol=1e-5)
    with pytest.raises(NotImplementedError, match="cross_replica_axis"):
        tdl.DetectionLoss(NC, Hyp)([T(r) for r in raw], T(labels), T(mask),
                                   cross_replica_axis="data")
