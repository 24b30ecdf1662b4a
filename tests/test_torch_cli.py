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

Save_conv remat through the command line, the TF32 switches, visualize,
the tracker's command line and NaN debugging are in
tests/test_torch_cli_modes.py, which shares this file's ``tree``.
"""

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
