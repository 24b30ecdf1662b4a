"""The port's checkpointing, logging and training loop (train/checkpoint.py,
train/loop.py, utils/) on the CPU at a tiny size, and the pieces that have
a JAX counterpart against it: spike rates, DelayedFetch, the log tags."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector
from snn_object_detectionddp_tpu.utils import logging as jlog
from snn_object_detectionddp_tpu.utils.pipelining import DelayedFetch as JDelayedFetch
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.convert import params_from_jax
from snn_object_detectionddp_tpu_torch.models.detector import Detector
from snn_object_detectionddp_tpu_torch.train import checkpoint as ckpt
from snn_object_detectionddp_tpu_torch.train import step as tstep
from snn_object_detectionddp_tpu_torch.train.loop import train_loop
from snn_object_detectionddp_tpu_torch.utils import logging as tlog
from snn_object_detectionddp_tpu_torch.utils.pipelining import DelayedFetch


def _tiny(mod=tconfig, width=0.25):
    cfg = mod.Config()
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = width
    cfg.model.hyp.reg_max = 8
    cfg.runtime.precision = "f32"
    return cfg


def _batch(seed, b=2, t=2, hw=64, m=4):
    rng = np.random.RandomState(seed)
    labels = np.zeros((b, m, 5), np.float32)
    labels[:, 0] = [1.0, 0.5, 0.5, 0.4, 0.4]
    mask = np.zeros((b, m), bool)
    mask[:, 0] = True
    return {"images": rng.randint(0, 255, (b, t, hw, hw, 3), dtype=np.uint8),
            "labels": labels, "label_mask": mask}


@pytest.fixture(scope="module")
def trained():
    """A tiny detector with a state one step in (non-zero moments)."""
    cfg = _tiny()
    det = Detector.from_config(cfg, device="cpu")
    tx, sched = tstep.make_optimizer(1e-3, 8)
    fns = tstep.make_step_fns(det, tx, sched)
    state, _ = fns.train_step(tstep.init_state(det.init_params(), tx, sched), _batch(0))
    return cfg, det, tx, sched, fns, state


def _assert_state_equal(a, b):
    assert a["step"] == b["step"] and a["sched"] == b["sched"]
    assert a["opt_state"]["count"] == b["opt_state"]["count"]
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
        for m in ("mu", "nu"):
            assert torch.equal(a["opt_state"][m][k], b["opt_state"][m][k]), (m, k)


def test_save_load_round_trip(tmp_path, trained):
    *_, state = trained
    path = tmp_path / "sub" / "latest.pt"
    ckpt.save_checkpoint(path, state, epoch=3, best_val_loss=1.25)
    assert path.exists() and not path.with_suffix(".pt.tmp").exists()
    # the template only gives structure and shapes: meta tensors do
    template = ckpt.tree_map(lambda t: torch.empty_like(t, device="meta"), state)
    packed = ckpt.load_checkpoint(path, template, device="cpu")
    assert packed["epoch"] == 3 and packed["best_val_loss"] == 1.25
    _assert_state_equal(packed["state"], state)
    assert packed["state"]["params"]["head.cls0_out.bias"].device.type == "cpu"


def test_load_rejects_other_shapes_and_foreign_files(tmp_path, trained):
    cfg, det, tx, sched, _, state = trained
    path = tmp_path / "latest.pt"
    ckpt.save_checkpoint(path, state, 0, 0.0)
    wide = Detector.from_config(_tiny(width=0.5), device="cpu")
    wide_state = tstep.init_state(wide.init_params(), tx, sched)
    with pytest.raises(ValueError, match="shapes do not match"):
        ckpt.load_checkpoint(path, wide_state, device="cpu")
    torch.save({"weights": 1}, tmp_path / "foreign.pt")
    with pytest.raises(ValueError, match="no state/params"):
        ckpt.load_checkpoint(tmp_path / "foreign.pt", state, device="cpu")


def test_params_only_restore_when_optimizer_state_does_not_fit(tmp_path, trained, capsys):
    *_, state = trained
    stripped = {"params": state["params"], "opt_state": {"other": 1}, "step": 5, "sched": (1, 2, 3)}
    ckpt.save_checkpoint(tmp_path / "old.pt", stripped, 2, 0.5)
    fresh = ckpt.tree_map(torch.zeros_like, state)
    packed = ckpt.load_checkpoint(tmp_path / "old.pt", fresh, device="cpu")
    assert "restored params only" in capsys.readouterr().out
    assert packed["epoch"] == 2
    assert torch.equal(packed["state"]["params"]["head.cls0_out.bias"],
                       state["params"]["head.cls0_out.bias"])
    assert packed["state"]["opt_state"] is fresh["opt_state"]


def test_async_checkpointer_snapshots_before_the_next_step(tmp_path, trained):
    cfg, det, tx, sched, fns, state = trained
    state = ckpt.tree_map(torch.clone, state)
    want = ckpt.tree_map(torch.clone, state)
    saver = ckpt.AsyncCheckpointer()
    saver.save(state, 1, 0.75, tmp_path / "latest.pt", tmp_path / "best.pt")
    state, _ = fns.train_step(state, _batch(1))  # in place, while the save is in flight
    saver.wait()
    for name in ("latest.pt", "best.pt"):
        packed = ckpt.load_checkpoint(tmp_path / name, want, device="cpu")
        _assert_state_equal(packed["state"], want)
        assert packed["best_val_loss"] == 0.75
    # a failing save surfaces on wait()
    saver.save(state, 1, 0.0, tmp_path / "latest.pt" / "not_a_dir.pt")
    with pytest.raises(OSError):
        saver.wait()


def test_resume_or_init(tmp_path, trained, capsys):
    cfg, det, tx, sched, _, state = trained
    cfg = _tiny()
    template = ckpt.tree_map(torch.zeros_like, state)
    fresh = lambda: "fresh"  # noqa: E731
    assert ckpt.resume_or_init(cfg, template, fresh, device="cpu") == ("fresh", 0, float("inf"))
    cfg.training.resume_training = True
    cfg.training.weights_path = str(tmp_path / "missing.pt")
    assert ckpt.resume_or_init(cfg, template, fresh, device="cpu")[0] == "fresh"
    assert "not found" in capsys.readouterr().out
    (tmp_path / "torn.pt").write_bytes(b"not a checkpoint")
    cfg.training.weights_path = str(tmp_path / "torn.pt")
    assert ckpt.resume_or_init(cfg, template, fresh, device="cpu")[0] == "fresh"
    assert "unreadable" in capsys.readouterr().out
    ckpt.save_checkpoint(tmp_path / "latest.pt", state, 4, 2.5)
    cfg.training.weights_path = str(tmp_path / "latest.pt")
    got, start_epoch, best = ckpt.resume_or_init(cfg, template, fresh, device="cpu")
    assert (start_epoch, best) == (5, 2.5)
    _assert_state_equal(got, state)
    assert ckpt.resume_or_init(_tiny(), template, None, device="cpu")[0] is template


def test_load_backbone_params_partial_restore(tmp_path, trained):
    cfg, det, tx, sched, _, state = trained
    ckpt.save_checkpoint(tmp_path / "latest.pt", state, 0, 0.0)
    fresh = det.init_params(torch.Generator().manual_seed(7))
    out = ckpt.load_backbone_params(tmp_path / "latest.pt", fresh)
    assert out is not fresh
    for k, v in out.items():
        src = state["params"] if k.startswith("backbone.") else fresh
        assert torch.equal(v, src[k]), k
    with pytest.raises(ValueError, match="no 'neck' subtree"):
        ckpt.load_backbone_params(tmp_path / "latest.pt", fresh, subtree="neck")
    wide = Detector.from_config(_tiny(width=0.5), device="cpu").init_params()
    with pytest.raises(ValueError, match="shapes do not match"):
        ckpt.load_backbone_params(tmp_path / "latest.pt", wide)
    headless = {"params": {k: v for k, v in state["params"].items() if k.startswith("head.")}}
    ckpt.save_checkpoint(tmp_path / "head.pt", headless, 0, 0.0)
    with pytest.raises(ValueError, match="no 'backbone' params"):
        ckpt.load_backbone_params(tmp_path / "head.pt", fresh)


def test_train_loop_two_epochs_writes_latest_and_best(tmp_path, trained, monkeypatch):
    from snn_object_detectionddp_tpu_torch.train import loop

    # read the scalars back from the JSONL writer whether or not tensorboardX is installed
    monkeypatch.setattr(loop, "make_writer", lambda d: tlog.JsonlWriter(str(d / "runs")))
    cfg, det, tx, sched, fns, _ = trained
    cfg = _tiny()
    cfg.training.epochs = 2
    state = tstep.init_state(det.init_params(), tx, sched)
    train, val = [_batch(0), _batch(1)], [_batch(2)]
    state = train_loop(state, fns, sched, train, val, cfg, tmp_path, detector=det)
    assert state["step"] == 4
    latest = ckpt.load_checkpoint(tmp_path / "latest.pt", state, device="cpu")
    best = ckpt.load_checkpoint(tmp_path / "best.pt", state, device="cpu")
    assert latest["epoch"] == 1
    _assert_state_equal(latest["state"], state)
    assert np.isfinite(best["best_val_loss"]) and best["best_val_loss"] == latest["best_val_loss"]
    assert best["state"]["step"] == 2 * (best["epoch"] + 1)
    rows = [json.loads(l) for l in (tmp_path / "runs" / "scalars.jsonl").read_text().splitlines()]
    tags = {r["tag"] for r in rows}
    assert {"Loss/train_batch", "Loss/val_batch", "Loss/train", "Loss/val", "LearningRate",
            "LearningRate/batch", "Assign/fg_anchors_batch", "SpikeRates/backbone/stem1",
            "Train_Loss_Components/box_loss", "Val_Loss_Components_Batch/dfl_loss_batch"} <= tags
    assert sum(r["tag"] == "Loss/train_batch" for r in rows) == 4
    assert sorted(r["step"] for r in rows if r["tag"] == "Loss/train_batch") == [0, 1, 2, 3]
    # resume: start_epoch past the last epoch runs nothing and keeps the state
    again = train_loop(state, fns, sched, train, val, cfg, tmp_path, start_epoch=2)
    assert again is state and again["step"] == 4


def test_spike_rates_match_jax():
    jcfg, tcfg = _tiny(jconfig), _tiny()
    jdet, tdet = JDetector.from_config(jcfg), Detector.from_config(tcfg, device="cpu")
    jparams = jdet.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    frames = np.random.RandomState(0).rand(2, 2, 64, 64, 3).astype(np.float32)
    want = jdet.spike_rates(jparams, jnp.asarray(frames))
    got = tdet.spike_rates(tparams, torch.from_numpy(frames))
    assert set(got) == set(want) and len(got) == 17 and "backbone/stem1" in got
    for k, v in want.items():  # a rate moves by 1/numel per flipped spike
        assert abs(got[k] - v) <= 1e-3, k


def test_delayed_fetch_and_log_tags_match_jax(tmp_path):
    for cls in (DelayedFetch, JDelayedFetch):
        seen = []
        fetch = cls(lambda a, b: seen.append((a, b)))
        fetch.push("m0", 0)
        assert seen == []
        fetch.push("m1", 1)
        assert seen == [("m0", 0)]
        fetch.flush()
        fetch.flush()
        assert seen == [("m0", 0), ("m1", 1)]
    metrics = {"loss": 1.0, "box": 0.1, "cls": 0.2, "dfl": 0.3, "lr": 1e-3, "fg": 4.0}
    files = []
    for mod, writer_cls in ((tlog, tlog.JsonlWriter), (jlog, jlog._JsonlWriter)):
        d = tmp_path / mod.__name__
        logger = mod.MetricsLogger(writer_cls(str(d)))
        logger.train_batch(metrics, 0)
        logger.val_batch(metrics, 1)
        logger.epoch(0, 1.0, 2.0, [0.1, 0.2, 0.3], [0.4, 0.5, 0.6], 1e-3)
        logger.writer.close()
        files.append((d / "scalars.jsonl").read_text())
    assert files[0] == files[1] and len(files[0].splitlines()) == 19
    tlog.NullWriter().add_scalar("x", 1, 0)
    tlog.NullWriter().add_scalars("x", {"a": 1}, 0)
