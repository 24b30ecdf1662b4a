"""The port's command lines in their other modes, driven on the CPU with
the tiny model and tree of tests/test_torch_cli.py (its ``tree`` fixture
and ``_tiny`` config, imported from it): the cases split off that file so
that two test workers share its time.

- ``training.remat_policy: save_conv`` through ``main.train_code`` with
  ``remat_chunk`` and with ``remat``: bit for bit the plain epoch.
- the TF32 switches each precision sets, and ``tf32_policy`` restoring
  them.
- ``mode: visualize`` writes one overlay per test window, the tracker
  benchmark's command line (``eval``) prints ``process_dataset``'s
  aggregate, and NaN debugging catches a NaN made in the forward and one
  made in the backward, and leaves a train step's outputs bit for bit as
  they are; ``utils.debug.checked`` raises at the operator.
"""

import json
import math

import numpy as np
import pytest
import torch
from test_torch_cli import _tiny, tree  # noqa: F401  (tree: the shared module fixture)

from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch import eval as track_eval
from snn_object_detectionddp_tpu_torch import eval_2, main
from snn_object_detectionddp_tpu_torch.models.detector import Detector
from snn_object_detectionddp_tpu_torch.train.checkpoint import save_checkpoint


@pytest.mark.parametrize("remat", [dict(remat_chunk=2), dict(remat=True)], ids=["chunk", "whole"])
def test_save_conv_remat_trains_through_the_command_line(tree, tmp_path, remat):
    """``training.remat_policy: save_conv`` with ``remat_chunk`` and with
    ``remat``: the epoch ends where the plain one does, bit for bit (one
    checkpoint region per window: the same operators, recomputed on the
    CPU)."""
    cfg = _tiny(tconfig, tree, tmp_path / "plain")
    det = Detector.from_config(cfg, device="cpu")
    plain = main.train_code(cfg, det)["params"]
    cfg = _tiny(tconfig, tree, tmp_path / "remat")
    cfg.training.remat_policy = "save_conv"
    for key, value in remat.items():
        setattr(cfg.training, key, value)
    state = main.train_code(cfg, det)
    assert state["step"] == 4
    for k, v in plain.items():
        assert torch.equal(state["params"][k], v), k


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("entry", ["main", "eval_2"])
def test_tf32_policy_per_precision(entry, precision, tree, tmp_path, monkeypatch):
    """The command lines set the TF32 switches from ``runtime.precision``
    before they build a model: f32 runs convs and matmuls without TF32;
    bf16 lets cuDNN convs (all of bf16-valued operands) use it, never
    matmuls."""
    cfg = _tiny(tconfig, tree, tmp_path / "run")
    cfg.runtime.precision = precision
    seen = {}

    def record(*args, **kwargs):
        seen["flags"] = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        return {}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tconfig, "load_config", lambda path: cfg)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", precision == "f32")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    if entry == "main":
        monkeypatch.setattr(main, "process_device", lambda: "cpu")
        monkeypatch.setattr(main, "run", record)
        main.main(["--config", "unused.yaml"])
    else:
        monkeypatch.setattr(eval_2, "evaluate", record)
        eval_2.main(["--config", "unused.yaml"])
    assert seen["flags"] == (precision == "bf16", False)


@pytest.mark.parametrize("inner", ["f32", "bf16"])
def test_tf32_policy_block_restores_the_switches(inner, monkeypatch):
    """``tf32_policy`` sets a precision's switches inside its block and
    puts the process's own back on leaving it, also when the block
    raises."""
    from snn_object_detectionddp_tpu_torch.models.detector import set_tf32_policy, tf32_policy

    outer = "bf16" if inner == "f32" else "f32"
    # restored after the test
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    set_tf32_policy(outer)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with pytest.raises(RuntimeError, match="inside"):
        with tf32_policy(inner):
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == (inner == "bf16", False)
            raise RuntimeError("inside")
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


def test_visualize_mode_writes_overlays(tree, tmp_path, capsys):
    """``mode: visualize`` on a CPU detector: ``<save_dir>/best.pt`` (read by
    ``convert.load_packed_weights``, whose flax branch
    test_evaluation_matches_jax drives) to one overlay PNG per test window,
    named after its last frame."""
    from snn_object_detectionddp_tpu_torch.data.png import read_rgb

    cfg = _tiny(tconfig, tree, tmp_path / "run")
    cfg.mode = "visualize"
    det = Detector.from_config(cfg, device="cpu")
    params = det.init_params(torch.Generator().manual_seed(0))
    save_checkpoint(tmp_path / "run/best.pt", {"params": params}, 0, 0.25)
    saved = main.run(cfg, det)
    out = capsys.readouterr().out
    assert "Model with val loss 0.25 loaded successfully for visualization." in out
    # 3 sequences x 4 windows of 2 frames; the sequences share frame names
    # (an overlay is named after its last frame, as in the JAX package)
    assert len(saved) == 12
    vis = tmp_path / "run/visualizations"
    assert {p.name for p in vis.glob("*.png")} == {p.rsplit("/", 1)[1] for p in saved}
    for p in vis.glob("*.png"):
        assert read_rgb(p).shape == (48, 64, 3)


def test_tracker_command_line_prints_the_aggregate(tree, tmp_path, monkeypatch, capsys):
    """``python -m snn_object_detectionddp_tpu_torch.eval`` on a CPU detector
    (the seam of the command-line tests above): the printed JSON is
    ``process_dataset``'s aggregate; without a checkpoint it warns and
    benchmarks the seeded initialisation."""
    from snn_object_detectionddp_tpu_torch.evals.legacy import process_dataset

    cfg = _tiny(tconfig, tree, tmp_path / "run")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tconfig, "load_config", lambda path: cfg)
    monkeypatch.setattr(track_eval, "process_device", lambda: "cpu")
    report = track_eval.main(["--config", "unused.yaml", "--method", "entire_model",
                              "--max-frames", "3"])
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint" in out
    printed = json.loads(out[out.index("{"):])
    assert printed == report["aggregate"]
    det = Detector.from_config(cfg, device="cpu")
    want = process_dataset(cfg, det, det.init_params(torch.Generator().manual_seed(0)),
                           method="entire_model", max_frames_per_seq=3)["aggregate"]
    assert set(printed) == set(want)
    for key in ("blended_flops_per_frame", "avg_iou", "precision", "num_detections"):
        assert printed[key] == want[key], key
    save_checkpoint(tmp_path / "run/best.pt", {"params": det.init_params()}, 0, 0.5)
    track_eval.main(["--config", "unused.yaml", "--method", "optical_flow", "--stride", "2",
                     "--adaptive-stride", "--max-frames", "3"])
    assert "Loaded checkpoint" in capsys.readouterr().out


def test_nan_debugging_forward_backward_and_off(tree):
    """NaN debugging raises at the operator that makes a NaN: in the
    forward (an infinite weight of the head's last conv, summed over inputs of
    both signs) and in the backward (an infinite
    cotangent), where without it the NaN passes silently. It changes no
    value: a train step with it on equals the step with it off, bit for
    bit, and off no dispatch mode is left behind."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from snn_object_detectionddp_tpu_torch.train.step import init_state, make_optimizer, make_step_fns
    from snn_object_detectionddp_tpu_torch.utils.debug import nan_debugging

    cfg = _tiny(tconfig, tree)
    det = Detector.from_config(cfg, device="cpu")
    params = det.init_params(torch.Generator().manual_seed(0))
    frames = torch.rand(2, 1, 48, 64, 3, generator=torch.Generator().manual_seed(1))

    bad = dict(params)
    bad["head.cls0_out.weight"] = torch.full_like(bad["head.cls0_out.weight"], math.inf)
    assert not all(torch.isfinite(r).all() for r in det.apply(bad, frames)[0])  # silent
    with nan_debugging(), pytest.raises(FloatingPointError, match=r"NaN in the output of aten\."):
        det.apply(bad, frames)

    leaf = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    raw, _ = det.apply_train(leaf, frames)
    cot = [torch.full_like(r, math.inf) for r in raw]
    with nan_debugging(), pytest.raises(FloatingPointError, match=r"NaN in the output of aten\."):
        raw, _ = det.apply_train(leaf, frames)
        torch.autograd.backward(raw, cot)
    assert _get_current_dispatch_mode() is None

    tx, sched = make_optimizer(1e-3, 4)
    fns = make_step_fns(det, tx, sched)
    batch = {"images": (frames.permute(1, 0, 2, 3, 4) * 255).to(torch.uint8).numpy(),
             "labels": np.zeros((1, 2, 5), np.float32), "label_mask": np.zeros((1, 2), bool)}
    batch["labels"][0, 0] = [1, 0.5, 0.5, 0.3, 0.3]
    batch["label_mask"][0, 0] = True
    outs = []
    for on in (False, True):
        state = init_state({k: v.clone() for k, v in params.items()}, tx, sched)
        with nan_debugging(on):
            state, metrics = fns.train_step(state, batch)
        outs.append((state, metrics))
    (s0, m0), (s1, m1) = outs
    assert _get_current_dispatch_mode() is None
    for k in m0:
        assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
    for k in s0["params"]:
        assert torch.equal(s0["params"][k], s1["params"][k]), k


def test_checked_raises_at_the_operator():
    """``utils.debug.checked``: a non-finite result (an inf included) or an
    index out of bounds raises at the operator; finite work passes."""
    from snn_object_detectionddp_tpu_torch.utils.debug import checked

    assert torch.equal(checked(lambda x: x * 2)(torch.ones(3)), torch.full((3,), 2.0))
    with pytest.raises(FloatingPointError, match=r"non-finite value in the output of aten\.div"):
        checked(lambda x: x / 0)(torch.ones(3))
    for fn in (lambda x: x[torch.tensor([3])], lambda x: x.gather(0, torch.tensor([-4])),
               lambda x: x.index_select(0, torch.tensor([5]))):
        with pytest.raises(IndexError, match="out of bounds"):
            checked(fn)(torch.zeros(3))
    assert checked(lambda x: x[torch.tensor([-3, 2])])(torch.arange(3.0)).tolist() == [0.0, 2.0]
