"""The frozen reference against the program, on the CPU at a tiny size in
float32: the forward, a whole train step of both configurations, and a
chained detect() sequence."""

import numpy as np
import pytest
import torch

from conftest import TINY_MODEL

from portbench import compare, inputs
from portbench.reference import detect as ref_detect
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

H, W = TINY_MODEL["image_size"]


def _program(bottleneck: str):
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector

    cfg = Config.from_dict({"model": {"yolo_model_name": "yolo11n.pt", "width_mult": 0.25,
                                      "image_size": [H, W], "bottleneck": bottleneck,
                                      "max_boxes": 8},
                            "runtime": {"precision": "f32"}})
    return Detector.from_config(cfg, device="cpu")


def _shape(bottleneck: str) -> ref_model.ModelShape:
    return ref_model.ModelShape(preset="yolo11n.pt", width_mult=0.25, image_size=(H, W),
                                bottleneck=bottleneck)


@pytest.mark.parametrize("bottleneck", ["convlstm", "lstm"])
def test_parameters_match_the_program(bottleneck):
    det = _program(bottleneck)
    mine = {k: tuple(v.shape) for k, v in det.module.named_parameters()}
    spec = {name: tuple(s) for name, s, _, _ in ref_model.param_spec(_shape(bottleneck))}
    assert mine == spec


@pytest.mark.parametrize("bottleneck", ["convlstm", "lstm"])
def test_forward_chained_matches_the_program(bottleneck):
    det, shape = _program(bottleneck), _shape(bottleneck)
    params = inputs.make_weights(shape, 11, "cpu")
    g = torch.Generator().manual_seed(1)
    state_p = state_r = None
    for _ in range(2):
        imgs = torch.randint(0, 256, (2, 3, H, W, 3), generator=g, dtype=torch.uint8)
        frames = ref_model.preprocess(imgs)
        got, state_p = det.apply(params, frames, state_p)
        want, state_r = ref_model.forward(params, frames, state_r, shape)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("bottleneck", ["convlstm", "lstm"])
def test_train_step_matches_the_program(bottleneck):
    from snn_object_detectionddp_tpu_torch.train.step import init_state, make_optimizer, make_step_fns

    det, shape = _program(bottleneck), _shape(bottleneck)
    traffic = {"boxes": [1, 4], "box_size": [0.2, 0.5], "speed": 2}
    batches = [inputs.train_batch(5, i, 2, 2, (H, W), traffic, 8, 8, "cpu") for i in range(3)]
    train_cfg = {"learning_rate": 1e-3, "weight_decay": 5e-4, "grad_clip_norm": 10.0,
                 "pct_start": 0.3, "total_steps": 50, "box": 7.5, "cls": 1.0, "dfl": 2.5}
    tx, sched = make_optimizer(1e-3, 50, 5e-4, 10.0, 0.3)
    params = inputs.make_weights(shape, 12, "cpu")
    p0 = {k: v.clone() for k, v in params.items()}
    state = init_state({k: v.clone() for k, v in params.items()}, tx, sched)
    fns = make_step_fns(det, tx, sched)
    losses = []
    for b in batches:
        state, m = fns.train_step(state, b)
        losses.append(float(m["loss"]))
    ref_params = {k: v.clone() for k, v in params.items()}
    want_losses, _, _ = ref_train.run_steps(ref_params, [{k: torch.as_tensor(v) for k, v in b.items()}
                                                         for b in batches], shape, train_cfg, 3,
                                            chunk=1)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    for k in params:
        got = state["params"][k] - p0[k]
        want = ref_params[k] - p0[k]
        # Adam divides by sqrt(v): a gradient element at round-off level moves
        # by a whole step, so leaves agree to 1e-2 of their change, not closer
        assert (got - want).norm() <= 1e-2 * want.norm() + 1e-9, k


def test_chained_detect_matches_the_reference():
    from snn_object_detectionddp_tpu_torch.serve import DetectionService

    det, shape = _program("convlstm"), _shape("convlstm")
    overrides = {f"cls{i}_out.bias": -1.0 for i in range(3)}
    params = inputs.make_weights(shape, 13, "cpu", overrides)
    service = DetectionService(det, params, conf=0.3, iou=0.45, max_det=100, max_batch=2).start()
    g = torch.Generator().manual_seed(2)
    frames = torch.randint(0, 256, (4, 2, H, W, 3), generator=g, dtype=torch.uint8)
    state, compared = None, 0
    try:
        for t in range(frames.shape[0]):
            replies = [service.detect(f"cam{s}", frames[t, s].numpy()) for s in range(2)]
            maps, state = ref_model.forward(params, ref_model.preprocess(frames[t][:, None]),
                                            state, shape)
            boxes, scores = ref_detect.decode(maps, shape.reg_max, shape.image_size)
            for s in range(2):
                want = ref_detect.nms(boxes[s], scores[s], 0.3, 0.45, 100)
                compared += len(want[0])
                assert compare.unmatched(replies[s], *want) == 0
    finally:
        service.stop()
    assert compared > 0
