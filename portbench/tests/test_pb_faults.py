"""``correct`` comes out false when the timed path is broken underneath,
and for the lower-precision control: a run on the CPU at a tiny size,
past the harness's look for a card, with the committed limits. The
program runs in float32 here so that its sound runs read far inside the
limits."""

import pytest
import torch

from conftest import SEED, tiny

from portbench import bench, control

TRAIN = ["train-yolo11m-convlstm-b16", "train-yolo11m-tokenlstm-b16"]
SERVE = "serve-yolo11m-convlstm-s32"


def _run(w):
    return bench.run_cell(w, SEED, 1.5, False, device="cpu", overrides=tiny(w))


@pytest.mark.parametrize("w", TRAIN + [SERVE])
def test_sound_runs_are_correct(w):
    line = _run(w)
    assert line["correct"], line["checks"]


def _unchanged_state(monkeypatch):
    from snn_object_detectionddp_tpu_torch.train import step

    def update(self, grads, opt_state, params, lr, norm_fn=None):
        return dict(opt_state, count=opt_state["count"] + 1)

    monkeypatch.setattr(step.Optimizer, "update", update)


def _half_batch(monkeypatch):
    from snn_object_detectionddp_tpu_torch.train import step

    make = step.make_step_fns

    def make_step_fns(*args, **kwargs):
        fns = make(*args, **kwargs)

        def train_step(state, batch):
            b = len(batch["images"])
            mask = torch.arange(b) < b // 2  # half of the batch left out of the loss
            return fns.train_step(state, dict(batch, sample_mask=mask))

        return fns._replace(train_step=train_step)

    monkeypatch.setattr(step, "make_step_fns", make_step_fns)


def _a3_scaled_gradient(monkeypatch):
    from snn_object_detectionddp_tpu_torch.models import layers

    monkeypatch.setattr(layers, "run_affine_lif_tb", control.a3_scaled())


@pytest.mark.parametrize("w", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch, _a3_scaled_gradient])
def test_a_broken_train_step_is_not_correct(w, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(w)
    assert not line["correct"], line["checks"]


def _serve_unchanged_state(monkeypatch):
    from snn_object_detectionddp_tpu_torch import serve

    monkeypatch.setattr(serve.DetectionService, "_commit_locked",
                        lambda self, stream, gen0, state: self._states.setdefault(stream, state))


def _serve_altered_answer(monkeypatch):
    from snn_object_detectionddp_tpu_torch import serve

    reply = serve.DetectionService._frame_reply

    def altered(host, r):
        out = reply(host, r)
        out["scores"] = [min(1.0, x + 0.01) for x in out["scores"]]
        return out

    monkeypatch.setattr(serve.DetectionService, "_frame_reply", staticmethod(altered))


def _serve_half_batch(monkeypatch):
    from snn_object_detectionddp_tpu_torch import serve

    predict = serve.DetectionService._predict

    def half(self, images_u8, rec_states, decode=True):
        images_u8 = images_u8.copy()
        images_u8[len(images_u8) // 2:] = 0  # the second half of the batch left out
        return predict(self, images_u8, rec_states, decode)

    monkeypatch.setattr(serve.DetectionService, "_predict", half)


@pytest.mark.parametrize("fault", [_serve_unchanged_state, _serve_altered_answer,
                                   _serve_half_batch])
def test_a_broken_service_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line = _run(SERVE)
    assert not line["correct"], line["checks"]


def _limits_fail(w, row) -> list:
    limits = bench.find_cell(w).limits
    return [k for k, v in row.items() if k in limits and v > limits[k]]


@pytest.mark.parametrize("w", TRAIN + [SERVE])
def test_the_float8_control_is_not_correct(w):
    cell = bench.find_cell(w)
    ov = tiny(w)
    for section, values in ov.items():
        (cell.traffic if section == "traffic" else cell.config[section]).update(values)
    cell.config["runtime"]["precision"] = "bf16"
    if w == SERVE:
        rows = control.serve_readings(cell, SEED, 2, torch.device("cpu"))
    else:
        rows = control.train_readings(cell, SEED, ["fp8"], torch.device("cpu"))
    assert _limits_fail(w, rows[0]), rows[0]
