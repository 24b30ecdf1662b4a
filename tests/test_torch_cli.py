"""The port's command lines (main.py, eval_2.py) and ``evaluate_model``,
driven on the CPU with a tiny model over DSEC-shaped trees.

- ``main.train_code`` (yolo11n, width 0.25, 48x64, T=2, B=2, fp32) trains
  from a tree written by the port's generator through the port's index,
  split and loader, writes ``latest.pt`` and ``best.pt`` and resumes
  where it stopped; its optimizer branches (frozen backbone, parameter
  groups, backbone transfer) do what they say.
- ``evaluate_model`` and ``eval_2.evaluate`` on converted fp32 weights
  against the JAX package's ``evaluate_model`` on the same tree. Both run
  the same fp32 math but sum convs in another order (~1e-6 relative),
  which can swap two detections of nearly equal score: the results dict
  is held to ``RESULT_ATOL`` = 5e-3, as tests/test_torch_eval.py does.
- what is not ported raises, naming the ROADMAP item that ports it; a
  data axis larger than the world raises ValueError; ``mode: visualize``
  without OpenCV raises naming cv2.putText before it reads the checkpoint,
  ``runtime.debug_nans`` raises at the operator that made a NaN.
- ``mode: visualize`` writes one overlay per test window, the tracker
  benchmark's command line (``eval``) prints ``process_dataset``'s
  aggregate, and NaN debugging catches a NaN made in the forward and one
  made in the backward, and leaves a train step's outputs bit for bit as
  they are.
"""

import json
import math
import sys


import jax
import numpy as np
import pytest
import torch
from flax import serialization

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.data.synthetic import make_dataset as jax_make_dataset
from snn_object_detectionddp_tpu.evals import validator as jval
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch import eval as track_eval
from snn_object_detectionddp_tpu_torch import eval_2, main
from snn_object_detectionddp_tpu_torch.convert import params_from_jax
from snn_object_detectionddp_tpu_torch.data.synthetic import make_dataset
from snn_object_detectionddp_tpu_torch.evals import validator as tval
from snn_object_detectionddp_tpu_torch.models.detector import Detector
from snn_object_detectionddp_tpu_torch.parallel.mesh import make_mesh
from snn_object_detectionddp_tpu_torch.train.checkpoint import save_checkpoint

RESULT_ATOL = 5e-3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 3 sequences x 5 frames, seq_len 2: 4 windows each; the split keeps 2
    # sequences for training (8 windows, 4 steps at B=2) and 1 for validation.
    return make_dataset(tmp_path_factory.mktemp("dsec"), num_sequences=3, splits=("train",),
                        num_frames=5, height=48, width=64)


def _tiny(mod, root, save_dir=None, hw=(48, 64), seq_len=2):
    cfg = mod.Config()
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.model.image_size = hw
    cfg.model.max_boxes = 8
    cfg.runtime.precision = "f32"
    for split in ("train", "val", "test"):
        sc = cfg.dataset.split(split)
        sc.path, sc.seq_len = str(root / "train"), seq_len
    cfg.training.batch_size = 2
    cfg.training.num_workers = 2
    cfg.training.epochs = 1
    cfg.training.learning_rate = 2e-3
    if save_dir is not None:
        cfg.training.save_dir = str(save_dir)
        cfg.training.weights_path = str(save_dir / "latest.pt")
    return cfg


def _ckpt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_train_code_writes_checkpoints_and_resumes(tree, tmp_path):
    cfg = _tiny(tconfig, tree, tmp_path / "run")
    det = Detector.from_config(cfg, device="cpu")
    state = main.train_code(cfg, det)
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    latest, best = _ckpt(tmp_path / "run/latest.pt"), _ckpt(tmp_path / "run/best.pt")
    assert latest["epoch"] == best["epoch"] == 0 and latest["state"]["step"] == 4
    first = {k: v.clone() for k, v in state["params"].items()}
    for k, v in first.items():
        assert torch.equal(latest["state"]["params"][k], v), k

    # Resume: epoch 2 of 2, the step counter and the schedule carry on.
    cfg.training.resume_training, cfg.training.epochs = True, 2
    state = main.train_code(cfg, det)
    assert state["step"] == 8 and state["opt_state"]["count"] == 8
    assert state["sched"] == latest["state"]["sched"]
    latest = _ckpt(tmp_path / "run/latest.pt")
    assert latest["epoch"] == 1 and latest["state"]["step"] == 8
    assert any(not torch.equal(first[k], v) for k, v in state["params"].items())
    assert all(torch.isfinite(v).all() for v in state["params"].values())


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


def test_frozen_backbone_from_a_transferred_checkpoint(tree, tmp_path):
    """``backbone_init`` loads the backbone of another checkpoint on a
    fresh start; ``freeze_backbone`` then keeps it exactly, while the rest
    of the model trains."""
    cfg = _tiny(tconfig, tree, tmp_path / "run")
    det = Detector.from_config(cfg, device="cpu")
    donor = det.init_params(torch.Generator().manual_seed(123))
    save_checkpoint(tmp_path / "donor.pt", {"params": donor}, 0, 1.0)
    cfg.model.backbone_init = str(tmp_path / "donor.pt")
    cfg.model.freeze_backbone = True
    params = main.train_code(cfg, det)["params"]
    fresh = det.init_params(torch.Generator().manual_seed(cfg.training.seed))
    for k, v in params.items():
        if k.startswith("backbone."):
            assert torch.equal(v, donor[k]), k
    assert any(not torch.equal(v, fresh[k]) for k, v in params.items() if k.startswith("head."))


def test_parameter_groups(tree, tmp_path):
    cfg = _tiny(tconfig, tree, tmp_path / "run")
    cfg.training.param_groups = True
    det = Detector.from_config(cfg, device="cpu")
    params = main.train_code(cfg, det)["params"]
    fresh = det.init_params(torch.Generator().manual_seed(cfg.training.seed))
    moved = {k.split(".")[0] for k, v in params.items() if not torch.equal(v, fresh[k])}
    assert moved == {"backbone", "unet", "head"}
    cfg.model.freeze_backbone = True
    with pytest.raises(ValueError, match="pick one optimizer structure"):
        main.train_code(cfg, det)


def test_evaluation_matches_jax(tmp_path, capsys):
    """``evaluate_model`` and ``eval_2.evaluate`` (through ``best.pt``) on
    converted fp32 weights against JAX ``evaluate_model`` on one tree: 3
    sequences, the validation split one of them (3 windows, a partial last
    batch at B=2)."""
    jax_make_dataset(tmp_path, num_sequences=3, splits=("train",), num_frames=5, height=64,
                     width=96)
    jcfg = _tiny(jconfig, tmp_path, hw=(64, 96), seq_len=3)
    tcfg = _tiny(tconfig, tmp_path, tmp_path / "run", hw=(64, 96), seq_len=3)
    jdet = JDetector.from_config(jcfg)
    jparams = jdet.init_params(jax.random.PRNGKey(0))
    tdet = Detector.from_config(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    want = jval.evaluate_model(jcfg, jdet, jparams, batch_size=2)
    got = tval.evaluate_model(tcfg, tdet, tparams, batch_size=2)
    assert set(got) == set(want) and all(np.isfinite(v) for v in got.values())
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=RESULT_ATOL), k
    assert "--- Evaluation Results ---" in capsys.readouterr().out

    save_checkpoint(tmp_path / "run/best.pt", {"params": tparams}, 3, 0.5)
    assert eval_2.evaluate(tcfg, device="cpu") == got
    assert "Loaded checkpoint" in capsys.readouterr().out
    save_checkpoint(tmp_path / "other.pt", {"params": tparams}, 3, 0.5)
    assert eval_2.evaluate(tcfg, str(tmp_path / "other.pt"), device="cpu") == got
    # a flax file of the JAX package, told apart by its content
    (tmp_path / "jax_best.pt").write_bytes(serialization.to_bytes({"params": jparams}))
    assert eval_2.evaluate(tcfg, str(tmp_path / "jax_best.pt"), device="cpu") == got
    assert "Loaded flax checkpoint" in capsys.readouterr().out


def test_test_mode_evaluates_a_fresh_init_without_a_checkpoint(tree, tmp_path, capsys):
    cfg = _tiny(tconfig, tree, tmp_path / "empty")
    cfg.mode = "test"
    det = Detector.from_config(cfg, device="cpu")
    res = main.run(cfg, det)
    assert "WARNING: no checkpoint" in capsys.readouterr().out
    fresh = tval.evaluate_model(cfg, det, det.init_params(torch.Generator().manual_seed(0)))
    assert res == fresh
    cfg.mode = "eval"
    assert main.run(cfg, det) == fresh


def _set(path, value):
    def apply(cfg):
        obj = cfg
        *parents, leaf = path.split(".")
        for p in parents:
            obj = getattr(obj, p)
        setattr(obj, leaf, value)
    return apply


# What stays unported raises, naming its ROADMAP item. mesh.data and
# mesh.spatial are ported: on a one-process run, a data or spatial axis of
# 2 does not fit the world and raises ValueError naming the world size (a
# spatial mesh over gloo processes: tests/test_torch_spatial.py). A tensor
# axis is inference-only, so training with one raises ValueError. The test runs without OpenCV, as a
# GPU host may: visualize raises naming cv2.putText before it reads
# best.pt. debug_nans with a NaN learning rate raises at the first update.
UNPORTED = {
    "mesh_tensor": (_set("mesh.tensor", 2), ValueError, "inference-only"),
    "mesh_data": (_set("mesh.data", 2), ValueError, "world size of 1"),
    "mesh_spatial": (_set("mesh.spatial", 2), ValueError, "world size of 1"),
    "debug_nans": (lambda cfg: (_set("runtime.debug_nans", True)(cfg),
                                _set("training.learning_rate", math.nan)(cfg)),
                   FloatingPointError, r"NaN in the output of aten\."),
    "visualize": (_set("mode", "visualize"), ImportError, r"cv2\.putText"),
}


@pytest.mark.parametrize("case", list(UNPORTED))
def test_unported_branches_raise(tree, tmp_path, case, monkeypatch):
    change, error, match = UNPORTED[case]
    monkeypatch.setitem(sys.modules, "cv2", None)
    cfg = _tiny(tconfig, tree, tmp_path / "run")
    det = Detector.from_config(cfg, device="cpu")
    change(cfg)
    with pytest.raises(error, match=match):
        main.run(cfg, det)
    assert not (tmp_path / "run" / "latest.pt").exists()


def test_evaluation_on_several_devices_raises(tree, tmp_path):
    """Evaluation takes a data mesh (two processes:
    tests/test_torch_parallel.py), a tensor axis (four processes:
    tests/test_torch_tensor_parallel.py) and a spatial axis (four
    processes: tests/test_torch_spatial.py); a data, spatial or tensor axis
    that the world cannot hold raises."""
    cfg = _tiny(tconfig, tree, tmp_path / "run")
    det = Detector.from_config(cfg, device="cpu")
    params = det.init_params(torch.Generator().manual_seed(0))
    assert (tval.evaluate_model(cfg, det, params, mesh=make_mesh())
            == tval.evaluate_model(cfg, det, params))
    cfg.mesh.data = 4
    with pytest.raises(ValueError, match="world size of 1"):
        eval_2.evaluate(cfg, device="cpu")
    cfg.mesh.data, cfg.mesh.spatial = -1, 2
    with pytest.raises(ValueError, match=r"mesh.spatial=2 must divide the world size of 1"):
        eval_2.evaluate(cfg, device="cpu")
    cfg.mesh.spatial, cfg.mesh.tensor = 1, 2
    with pytest.raises(ValueError, match=r"mesh.tensor=2 must divide the world size of 1"):
        eval_2.evaluate(cfg, device="cpu")
    cfg.mesh.tensor, cfg.mode = 1, "serve"
    with pytest.raises(ValueError, match="unknown mode"):
        main.run(cfg, det)


@pytest.mark.parametrize("cli", [main, eval_2, track_eval], ids=["main", "eval_2", "eval"])
def test_command_lines_need_a_card(cli, monkeypatch):
    """Without a card the command lines stop before reading the config,
    with a message (there is no CPU path)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        cli.main(["--config", "no-such-file.yaml"])


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
