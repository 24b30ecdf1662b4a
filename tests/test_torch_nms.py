"""Port NMS and box ops against the JAX package on seeded boxes.

Both sides run the same fixed-shape algorithm on the same fp32 inputs;
with continuous random scores there are no score ties among kept boxes,
so outputs must agree exactly (IoU values to fp32 rounding, 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu.ops import anchors as janc
from snn_object_detectionddp_tpu.ops import boxes as jbox
from snn_object_detectionddp_tpu.ops import nms as jnms
from snn_object_detectionddp_tpu_torch.ops import anchors as tanc
from snn_object_detectionddp_tpu_torch.ops import boxes as tbox
from snn_object_detectionddp_tpu_torch.ops import nms as tnms


def _boxes(b, a, nc, seed):
    """Boxes clustered around a few centers so suppression chains occur."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 300, size=(b, 12, 2))
    pick = rng.randint(0, 12, size=(b, a))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.randn(b, a, 2) * 6
    wh = rng.uniform(8, 60, size=(b, a, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 1, size=(b, a, nc)).astype(np.float32) ** 3
    return boxes, scores


def _compare(got, ref):
    assert set(got) == set(ref) == {"boxes", "scores", "classes", "valid"}
    for k in ref:
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape, k
        if k == "classes":
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, r)
        elif k == "valid":
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, atol=1e-6, err_msg=k)


@pytest.mark.parametrize(
    "a,nc,kwargs",
    [
        (300, 3, dict(conf_thres=0.05, iou_thres=0.45, max_det=50)),
        (300, 3, dict(conf_thres=0.05, iou_thres=0.45, max_det=50, multi_label=True)),
        (40, 2, dict(conf_thres=0.3, iou_thres=0.5, max_det=100)),  # pool < max_det: padded
        (1500, 3, dict(conf_thres=0.0, iou_thres=0.6, max_det=30, pre_nms_topk=1200)),  # k-step sweep
    ],
    ids=["single", "multi_label", "padded", "sweep"],
)
def test_batched_nms_matches_jax(a, nc, kwargs):
    boxes, scores = _boxes(2, a, nc, seed=a + nc)
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kwargs)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kwargs)
    assert int(got["valid"].sum()) > 0
    _compare(got, ref)


def test_single_image_nms_toy():
    boxes = torch.tensor([[0.0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]])
    scores = torch.tensor([[0.9, 0.0], [0.8, 0.0], [0.0, 0.7]])
    out = tnms.non_max_suppression(boxes, scores, conf_thres=0.1, iou_thres=0.5, max_det=5)
    assert out["valid"].tolist() == [True, True, False, False, False]
    assert out["classes"][:2].tolist() == [0, 1]
    np.testing.assert_allclose(out["scores"][:2].numpy(), [0.9, 0.7], atol=1e-6)


def test_greedy_pool_not_ported():
    """Kept under its first name: a pool above 4096 candidates used to
    raise; it now takes the greedy path and must equal JAX's."""
    boxes, scores = _boxes(1, 5000, 1, seed=0)
    kw = dict(conf_thres=0.0, iou_thres=0.45, max_det=20, pre_nms_topk=4097)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    assert int(got["valid"].sum()) == 20
    _compare(got, ref)


def _candidates(b, k, nc, seed, n_invalid=0):
    """Top-k candidates as batched_nms hands them to its two NMS paths:
    sorted by descending score, the last ``n_invalid`` below the threshold."""
    boxes, scores = _boxes(b, k, nc, seed)
    top_scores, top_idx = tnms._top_k(torch.from_numpy(scores).max(-1).values, k)
    top_cls = torch.gather(torch.from_numpy(scores).argmax(-1).to(torch.int32), -1, top_idx)
    top_boxes = torch.gather(torch.from_numpy(boxes), 1, top_idx[..., None].expand(b, k, 4))
    top_valid = torch.ones(b, k, dtype=torch.bool)
    if n_invalid:
        top_valid[:, -n_invalid:] = False
        top_scores[:, -n_invalid:] = -1.0
    return top_boxes, top_scores, top_cls, top_valid


@pytest.mark.parametrize("k,max_det,n_invalid", [(300, 50, 0), (1500, 300, 200), (4096, 100, 0),
                                                 (40, 60, 30)],
                         ids=["fixpoint_300", "sweep_1500", "matrix_limit_4096", "runs_dry"])
def test_greedy_equals_matrix_path(k, max_det, n_invalid):
    """The O(k) greedy path and the k x k matrix path are the same function
    wherever both can run: same kept boxes in the same order, invalid slots
    zeroed alike."""
    cand = _candidates(2, k, 3, seed=k, n_invalid=n_invalid)
    want = tnms._nms_matrix(*cand, 0.5, max_det)
    got = tnms._nms_greedy(*cand, 0.5, max_det)
    n = want["scores"].shape[-1]  # the matrix path returns min(max_det, k) slots
    assert got["scores"].shape[-1] == max_det
    for key in want:
        assert torch.equal(got[key][:, :n], want[key]), key
    assert not got["valid"][:, n:].any()
    assert 0 < int(want["valid"].sum()) <= 2 * min(max_det, k - n_invalid)


@pytest.mark.parametrize("multi_label", [False, True], ids=["single", "multi_label"])
def test_greedy_pool_matches_jax(multi_label):
    """Evaluation's setting on a pool above the matrix limit: conf 0.001,
    iou 0.6, pre_nms_topk 30000 over 5,000 anchors (15,000 candidates with
    multi_label) against JAX non_max_suppression, image by image."""
    boxes, scores = _boxes(2, 5000, 3, seed=11)
    kw = dict(conf_thres=0.001, iou_thres=0.6, max_det=300, pre_nms_topk=30000,
              multi_label=multi_label)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    assert int(got["valid"].sum()) > 100
    for i in range(2):
        ref = jnms.non_max_suppression(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), **kw)
        _compare({k: v[i] for k, v in got.items()}, ref)


def test_greedy_ties_take_the_lower_index():
    """Equal scores: argmax picks the first, as jnp.argmax does."""
    boxes = np.array([[[0, 0, 10, 10], [100, 100, 110, 110], [0, 0, 10, 10.5]]], np.float32)
    boxes = np.repeat(boxes, 1400, 1)  # 4,200 candidates: above the matrix limit
    scores = np.full((1, 4200, 1), 0.5, np.float32)
    kw = dict(conf_thres=0.1, iou_thres=0.5, max_det=4, pre_nms_topk=30000)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    _compare(got, ref)
    assert got["valid"][0].tolist() == [True, True, False, False]
    assert got["boxes"][0, 0].tolist() == [0, 0, 10, 10]


def test_box_ops_match_jax():
    a, _ = _boxes(1, 30, 1, seed=1)
    b, _ = _boxes(1, 20, 1, seed=2)
    a[0, 0] = [5, 5, 3, 3]  # degenerate box: area clamps to 0
    np.testing.assert_allclose(tbox.box_area(torch.from_numpy(a)).numpy(),
                               np.asarray(jbox.box_area(jnp.asarray(a))), rtol=1e-6)
    np.testing.assert_allclose(
        tbox.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jbox.pairwise_iou(jnp.asarray(a), jnp.asarray(b))), atol=1e-6,
    )


def test_anchors_match_jax():
    shapes, strides = [(8, 10), (4, 5), (2, 3)], [8, 16, 32]
    p_j, s_j = janc.make_anchors(shapes, strides)
    p_t, s_t = tanc.make_anchors(shapes, strides, device="cpu")
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    dist = np.random.RandomState(3).uniform(0, 7, size=(2, p_t.shape[0], 4)).astype(np.float32)
    np.testing.assert_allclose(
        tanc.dist2bbox(torch.from_numpy(dist), p_t).numpy(),
        np.asarray(janc.dist2bbox(jnp.asarray(dist), p_j)), atol=1e-6,
    )
