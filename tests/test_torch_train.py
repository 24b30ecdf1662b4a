"""The port's training step (train/step.py, train/schedule.py,
train/param_groups.py, convert.train_state_from_jax) against the JAX
package on the same numpy inputs (tiny model: yolo11n, width 0.25, 64x64,
T=2, B=2, fp32, CPU).

The JAX side is one jitted loss-and-gradient function (one compile for the
file) plus the optax chain of the JAX package's own ``make_optimizer``,
driven eagerly the way its train step drives it.

Tolerances and their reasons:
- schedule: 1e-5 relative plus 1e-6 of the peak — the port evaluates the
  same formula in fp64 on the host, JAX in fp32, where ``1 - cos`` cancels
  near the ends of a segment.
- optimizer on fed gradients: 1e-6 absolute on parameters of order 1 —
  identical arithmetic, fp32 rounding only.
- one model step: loss and components 1e-4 relative; per gradient leaf
  ``|g_port - g_jax|_2 <= 2e-3 |g_jax|_2 + 1e-4 |g|_2(all leaves)``. XLA
  and PyTorch sum convs in another order (~1e-6 relative) and a spike that
  flips between them perturbs downstream activations, so gradients agree
  to a few 1e-4, not to rounding. Post-Adam parameters of the model step
  are not compared: Adam's first update is sign-like and amplifies 1e-8
  gradient noise; the first moment ``mu`` (linear in the gradient) is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.utils.checkpoint
from flax import serialization
from torch.utils._python_dispatch import TorchDispatchMode

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.data import encoding as jenc
from snn_object_detectionddp_tpu.losses import detection as jdl
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector
from snn_object_detectionddp_tpu.train import checkpoint as jckpt
from snn_object_detectionddp_tpu.train import param_groups as jgroups
from snn_object_detectionddp_tpu.train import schedule as jsched
from snn_object_detectionddp_tpu.train import step as jstep
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.convert import (
    load_flax_state,
    params_from_jax,
    train_state_from_jax,
)
from snn_object_detectionddp_tpu_torch.models.detector import Detector as TDetector
from snn_object_detectionddp_tpu_torch.models.layers import CONV_OUT, conv_name
from snn_object_detectionddp_tpu_torch.train import param_groups as tgroups
from snn_object_detectionddp_tpu_torch.train import schedule as tsched
from snn_object_detectionddp_tpu_torch.train import step as tstep

LR, TOTAL = 1e-3, 100


def _tiny(mod):
    cfg = mod.Config()
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.runtime.precision = "f32"
    return cfg


def _batch(seed, b=2, t=2, h=64, w=64, m=4, identical=False):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, size=(b, t, h, w, 3), dtype=np.uint8)
    if identical:
        images[:] = images[:1]
    labels = np.zeros((b, m, 5), np.float32)
    mask = np.zeros((b, m), bool)
    labels[:, 0] = [1.0, 0.5, 0.5, 0.4, 0.4]
    labels[:, 1] = [2.0, 0.3, 0.6, 0.3, 0.5]
    mask[:, :2] = True
    return {"images": images, "labels": labels, "label_mask": mask,
            "sample_mask": np.ones((b,), bool)}


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,peak,pct", [(100, 1e-3, 0.3), (10, 2e-4, 0.3), (7, 1.0, 0.5),
                                            (1, 1e-3, 0.3)])
def test_onecycle_lr_matches_jax(total, peak, pct):
    for step in list(range(0, total + 3)) + [10 * total]:
        want = float(jsched.onecycle_lr(step, total, peak, pct))
        got = tsched.onecycle_lr(step, total, peak, pct)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * peak, err_msg=str(step))
    sched = tstep.make_optimizer(peak, total, pct_start=pct)[1]
    assert sched.consts == (float(total), float(peak), float(pct))
    assert sched(3) == tsched.onecycle_lr(3, total, peak, pct)


# ---------------------------------------------------------------------------
# The optimizer alone, on fed gradients
# ---------------------------------------------------------------------------


def _toy_params(rng):
    return {
        "backbone": {"w": rng.randn(4, 8).astype(np.float32), "b": rng.randn(8).astype(np.float32)},
        "head": {"w": rng.randn(8, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)},
    }


def _flat(tree):
    return {f"{m}.{k}": torch.tensor(np.asarray(v)) for m, sub in tree.items()
            for k, v in sub.items()}


def _jax_inject_and_update(tx, state, grads):
    """The optimizer half of the JAX package's train step."""
    sched = state["sched"]
    lr = jsched.onecycle_lr(state["step"], sched[0], sched[1], sched[2])
    opt_state = state["opt_state"]
    if hasattr(opt_state[-1], "hyperparams"):
        inner = opt_state[-1]
        inner = inner._replace(hyperparams={**inner.hyperparams, "learning_rate": lr})
        opt_state = opt_state[:-1] + (inner,)
    updates, opt_state = tx.update(grads, opt_state, state["params"])
    return {"params": optax.apply_updates(state["params"], updates), "opt_state": opt_state,
            "step": state["step"] + 1, "sched": sched}, float(lr)


@pytest.mark.parametrize("variant", ["plain", "frozen", "groups"])
def test_optimizer_matches_optax_on_fed_gradients(variant):
    rng = np.random.RandomState(0)
    params = _toy_params(rng)
    if variant == "groups":
        jtx, _ = jgroups.make_grouped_optimizer(params, LR, 20)
        ttx, tsch = tgroups.make_grouped_optimizer(_flat(params), LR, 20)
        jschedule = type("S", (), {"consts": (20.0, LR, 0.3)})()
    else:
        frozen = "backbone" if variant == "frozen" else None
        jtx, jschedule = jstep.make_optimizer(
            LR, 20, frozen_mask=jstep.module_frozen_mask(frozen) if frozen else None)
        ttx, tsch = tstep.make_optimizer(
            LR, 20, frozen_mask=tstep.module_frozen_mask(frozen) if frozen else None)
    jstate = jstep.init_state(jax.tree.map(jnp.asarray, params), jtx, jschedule)
    tstate = tstep.init_state(_flat(params), ttx, tsch)
    assert tstate["sched"] == (20.0, LR, 0.3)
    for i in range(6):
        # every other step is far above the clip norm of 10
        scale = 40.0 if i % 2 else 0.5
        grads = jax.tree.map(lambda p: (scale * rng.randn(*p.shape)).astype(np.float32), params)
        jstate, jlr = _jax_inject_and_update(jtx, jstate, jax.tree.map(jnp.asarray, grads))
        lr = tsched.onecycle_lr(tstate["step"], *tstate["sched"])
        if variant != "groups":  # grouped optax reads its own schedule by count
            np.testing.assert_allclose(lr, jlr, rtol=1e-6)
        tstate["opt_state"] = ttx.update(_flat(grads), tstate["opt_state"], tstate["params"], lr)
        tstate["step"] += 1
        for name, got in tstate["params"].items():
            m, k = name.split(".")
            np.testing.assert_allclose(got.numpy(), np.asarray(jstate["params"][m][k]), atol=1e-6,
                                       err_msg=f"{variant} step {i} {name}")
    if variant == "frozen":
        for k in ("w", "b"):  # exactly unchanged: no update, no weight decay
            np.testing.assert_array_equal(tstate["params"][f"backbone.{k}"].numpy(),
                                          params["backbone"][k])
    assert tstate["opt_state"]["count"] == 6


def test_param_group_labels_match_jax():
    rng = np.random.RandomState(1)
    params = _toy_params(rng)
    want = jax.tree_util.tree_map_with_path(jgroups._group_of, params)
    for name, leaf in _flat(params).items():
        m, k = name.split(".")
        assert tgroups.group_of(name, leaf) == want[m][k]


def test_clip_matches_optax_not_torch():
    """optax scales by max_norm / norm only above max_norm, with no
    epsilon; a norm exactly at the threshold is left untouched."""
    g = {"a.w": torch.tensor([6.0, 8.0])}  # norm exactly 10
    tx = tstep.Optimizer(weight_decay=0.0, grad_clip_norm=10.0)
    p = {"a.w": torch.zeros(2)}
    st = tx.update(g, tx.init(p), p, lr=1.0)
    np.testing.assert_allclose(st["mu"]["a.w"].numpy(), [0.6, 0.8], rtol=1e-6)
    assert float(tstep.global_norm(g.values())) == 10.0


# ---------------------------------------------------------------------------
# The model step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _tiny(jconfig), _tiny(tconfig)
    jdet = JDetector.from_config(jcfg)
    tdet = TDetector.from_config(tcfg, device="cpu")
    jparams = jdet.init_params(jax.random.PRNGKey(0))
    jtx, jschedule = jstep.make_optimizer(LR, TOTAL)
    ttx, tschedule = tstep.make_optimizer(LR, TOTAL)
    loss_fn = jdl.DetectionLoss(jcfg.model.num_classes, jcfg.model.hyp)

    @jax.jit
    def jgrads(params, batch):
        frames = jenc.preprocess_video(batch["images"], dtype=jdet.module.dtype)

        def objective(p):
            raw, _ = jdet.module.apply({"params": p}, frames)
            lc = loss_fn(raw, batch["labels"], batch["label_mask"],
                         sample_mask=batch["sample_mask"])
            return lc.total, lc

        (_, lc), grads = jax.value_and_grad(objective, has_aux=True)(params)
        return grads, lc

    def fresh_tstate():
        return tstep.init_state(params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
                                ttx, tschedule)

    return dict(jdet=jdet, tdet=tdet, jparams=jparams, jtx=jtx, jschedule=jschedule, ttx=ttx,
                tschedule=tschedule, jgrads=jgrads, fresh_tstate=fresh_tstate,
                fns=tstep.make_step_fns(tdet, ttx, tschedule))


def _assert_grads_close(got: dict, want_tree, what=""):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree), "cpu")
    assert set(got) == set(want)
    total = float(torch.sqrt(sum(g.double().pow(2).sum() for g in want.values())))
    for k, w in want.items():
        err = float((got[k] - w).double().norm())
        allowed = 2e-3 * float(w.double().norm()) + 1e-4 * total
        assert err <= allowed, f"{what}{k}: err {err:.3g} > {allowed:.3g}"


def test_model_gradients_match_jax(setup):
    batch = _batch(0)
    g_j, lc_j = setup["jgrads"](setup["jparams"], batch)
    state = setup["fresh_tstate"]()
    g_t, lc_t = setup["fns"].grads(state["params"], batch)
    assert float(lc_t.fg) == float(lc_j.fg) > 0
    for name in ("total", "box", "cls", "dfl"):
        np.testing.assert_allclose(float(getattr(lc_t, name)), float(getattr(lc_j, name)),
                                   rtol=1e-4, err_msg=name)
    _assert_grads_close(g_t, g_j)
    # the step's metrics are the same loss, and grad_norm is the raw global norm
    state, metrics = setup["fns"].train_step(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(lc_j.total), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(g_j)),
                               rtol=1e-3)
    assert metrics["lr"] == tsched.onecycle_lr(0, TOTAL, LR, 0.3) and state["step"] == 1
    ev = setup["fns"].eval_step(state["params"], batch)
    assert set(ev) == {"loss", "box", "cls", "dfl", "fg"} and np.isfinite(float(ev["loss"]))


def test_train_step_reduces_loss_and_updates_in_place(setup):
    state = setup["fresh_tstate"]()
    held = state["params"]["head.cls0_out.weight"]
    before = held.clone()
    batch = _batch(1)
    losses = []
    for _ in range(20):
        state, metrics = setup["fns"].train_step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0]
    assert state["params"]["head.cls0_out.weight"] is held and not torch.equal(held, before)
    assert state["step"] == state["opt_state"]["count"] == 20


@pytest.mark.parametrize("kwargs", [dict(remat=True), dict(remat_chunk=1), dict(remat_chunk=2),
                                    dict(grad_accum=2), dict(grad_accum=2, remat_chunk=1),
                                    dict(remat=True, remat_policy="save_conv"),
                                    dict(remat_chunk=1, remat_policy="save_conv")],
                         ids=lambda k: "-".join(f"{a}{b}" for a, b in k.items()))
def test_remat_and_accumulation_reproduce_the_plain_step(setup, kwargs):
    """Same loss, gradient norm and first moment (linear in the gradient)
    as the plain step: 1e-5 relative, fp32 reassociation only. The
    accumulated step is fed a batch of two identical samples, where summing
    the microbatches reproduces the full batch."""
    batch = _batch(2, identical="grad_accum" in kwargs)
    plain, m0 = setup["fns"].train_step(setup["fresh_tstate"](), batch)
    fns = tstep.make_step_fns(setup["tdet"], setup["ttx"], setup["tschedule"], **kwargs)
    other, m1 = fns.train_step(setup["fresh_tstate"](), batch)
    for k in ("loss", "box", "cls", "dfl", "grad_norm"):
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-5, err_msg=k)
    scale = max(float(v.abs().max()) for v in plain["opt_state"]["mu"].values())
    for k, v in plain["opt_state"]["mu"].items():
        np.testing.assert_allclose(other["opt_state"]["mu"][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5 * scale, err_msg=k)


def test_step_options_that_raise(setup):
    tdet, ttx, sch = setup["tdet"], setup["ttx"], setup["tschedule"]
    state = setup["fresh_tstate"]()
    with pytest.raises(ValueError, match="remat_chunk"):
        tstep.make_step_fns(tdet, ttx, sch, remat_chunk=2).train_step(state, _batch(3, t=3))
    with pytest.raises(ValueError, match="grad_accum"):
        tstep.make_step_fns(tdet, ttx, sch, grad_accum=2).train_step(state, _batch(3, b=3))
    # save_conv builds (it is trained and counted in the tests below)
    assert callable(tstep.make_step_fns(tdet, ttx, sch, remat_policy="save_conv").train_step)
    with pytest.raises(ValueError, match="remat_policy"):
        tstep.make_step_fns(tdet, ttx, sch, remat_policy="half")
    # A tensor axis is inference-only. A spatial axis in the config with no
    # mesh given builds the one-device step (the command lines make the
    # mesh from the config; tests/test_torch_spatial.py runs it on one):
    # the same loss as the plain step. FSDP needs a mesh.
    for key, val, error, match in (("spatial", 2, None, None),
                                   ("tensor", 2, ValueError, "inference-only")):
        cfg = _tiny(tconfig)
        setattr(cfg.mesh, key, val)
        if error is None:
            fns = tstep.make_step_fns(TDetector.from_config(cfg, device="cpu"), ttx, sch)
            batch = _batch(3)
            params = setup["fresh_tstate"]()["params"]
            assert fns.mesh is None
            assert float(fns.eval_step(params, batch)["loss"]) == float(
                setup["fns"].eval_step(params, batch)["loss"])
            continue
        with pytest.raises(error, match=match):
            tstep.make_step_fns(TDetector.from_config(cfg, device="cpu"), ttx, sch)
    with pytest.raises(ValueError, match="requires a device mesh"):
        tstep.make_step_fns(tdet, ttx, sch, fsdp=True)


@pytest.fixture(scope="module")
def long_window(setup):
    """A T=4 batch and the unchunked step's loss and gradients on it."""
    batch = _batch(5, t=4)
    params = setup["fresh_tstate"]()["params"]
    grads, lc = setup["fns"].grads(params, batch)
    return batch, params, grads, lc


@pytest.mark.parametrize("chunk", [2, 4])
def test_save_conv_matches_the_unchunked_step(setup, long_window, chunk):
    """remat_policy="save_conv" under chunked remat: the same loss (1e-5
    relative) and every gradient (1e-4 relative, plus 1e-6 of the leaf's
    largest entry for entries near 0) as the unchunked step, which
    test_model_gradients_match_jax holds to JAX. fp32 reassociation only:
    the chunks carry the same state."""
    batch, params, want, lc0 = long_window
    fns = tstep.make_step_fns(setup["tdet"], setup["ttx"], setup["tschedule"],
                              remat_chunk=chunk, remat_policy="save_conv")
    got, lc = fns.grads(params, batch)
    for name in ("total", "box", "cls", "dfl"):
        np.testing.assert_allclose(float(getattr(lc, name)), float(getattr(lc0, name)),
                                   rtol=1e-5, err_msg=name)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(w.abs().max()), err_msg=k)


class _ConvCount(TorchDispatchMode):
    """Counts the convolutions dispatched, by phase (the forward, or the
    backward that recomputes a checkpoint region) and by whether they run
    under the name ``conv_out``."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            key = ("backward" if torch._C._current_graph_task_id() != -1 else "forward",
                   conv_name() == CONV_OUT)
            self.n[key] = self.n.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", [dict(remat_chunk=2), dict(remat=True)],
                         ids=["chunk2", "whole"])
@pytest.mark.parametrize("policy", ["full", "save_conv"])
def test_save_conv_recomputes_only_the_untagged_convs(setup, long_window, remat, policy):
    """The backward recomputes every conv of the forward under "full" and
    only those not named conv_out under "save_conv" (the JAX package's
    three checkpoint_name sites: spiking blocks, ConvBlocks, the ConvLSTM's
    input half). Early stopping is off, so a recompute runs its whole
    region."""
    batch, params, _, _ = long_window
    fns = tstep.make_step_fns(setup["tdet"], setup["ttx"], setup["tschedule"],
                              remat_policy=policy, **remat)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False), _ConvCount() as count:
        fns.grads(params, batch)
    fwd_tagged, fwd_other = count.n[("forward", True)], count.n[("forward", False)]
    assert fwd_tagged > 0 and fwd_other > 0
    recomputed = {True: count.n.get(("backward", True), 0),
                  False: count.n.get(("backward", False), 0)}
    if policy == "full":
        assert recomputed == {True: fwd_tagged, False: fwd_other}
    else:
        assert recomputed == {True: 0, False: fwd_other}


def test_frozen_backbone_step(setup):
    tx, sch = tstep.make_optimizer(LR, TOTAL, frozen_mask=tstep.module_frozen_mask("backbone"))
    state = tstep.init_state(_clone(setup["fresh_tstate"]()["params"]), tx, sch)
    before = _clone(state["params"])
    state, metrics = tstep.make_step_fns(setup["tdet"], tx, sch).train_step(state, _batch(4))
    same = {k for k, v in state["params"].items() if torch.equal(v, before[k])}
    assert {k for k in before if k.startswith("backbone.")} <= same
    # A box branch whose scale got no foreground anchor has a zero gradient
    # and a decay below fp32 resolution; everything else moves.
    rest = [k for k in before if not k.startswith("backbone.")]
    assert all(k.startswith("head.box") for k in same if not k.startswith("backbone."))
    assert sum(k not in same for k in rest) > 0.7 * len(rest)
    assert float(metrics["grad_norm"]) > 0


def test_train_state_from_jax_continues_identically(setup, tmp_path):
    """Two JAX steps, the state carried across (in memory, and through a
    checkpoint file the JAX package wrote), then the same third step on
    both sides."""
    jstate = jstep.init_state(setup["jparams"], setup["jtx"], setup["jschedule"])
    for seed in (10, 11):
        grads, _ = setup["jgrads"](jstate["params"], _batch(seed))
        jstate, _ = _jax_inject_and_update(setup["jtx"], jstate, grads)
    carried = serialization.to_state_dict(jax.device_get(jstate))
    tstate = train_state_from_jax(carried, device="cpu")
    assert tstate["step"] == tstate["opt_state"]["count"] == 2
    np.testing.assert_allclose(tstate["sched"], (TOTAL, LR, 0.3), rtol=1e-6)
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]), "cpu")
    assert all(torch.equal(tstate["params"][k], v) for k, v in want.items())
    assert any(float(v.abs().max()) > 0 for v in tstate["opt_state"]["nu"].values())
    jckpt.save_checkpoint(tmp_path / "latest.pt", jstate, 1, 0.5)
    packed = load_flax_state(tmp_path / "latest.pt")
    assert packed["epoch"] == 1 and packed["best_val_loss"] == 0.5
    from_file = train_state_from_jax(packed["state"], device="cpu")
    assert from_file["step"] == 2 and from_file["sched"] == tstate["sched"]
    for part in (lambda s: s["params"], lambda s: s["opt_state"]["mu"], lambda s: s["opt_state"]["nu"]):
        assert all(torch.equal(part(from_file)[k], v) for k, v in part(tstate).items())

    batch = _batch(12)
    grads, lc_j = setup["jgrads"](jstate["params"], batch)
    before = _clone(tstate["params"])
    jstate3, jlr = _jax_inject_and_update(setup["jtx"], jstate, grads)
    tstate3, metrics = setup["fns"].train_step(tstate, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(lc_j.total), rtol=1e-4)
    np.testing.assert_allclose(metrics["lr"], jlr, rtol=1e-6)
    adam = [s for s in jax.tree.leaves(jstate3["opt_state"],
                                       is_leaf=lambda n: hasattr(n, "mu")) if hasattr(s, "mu")][0]
    _assert_grads_close(tstate3["opt_state"]["mu"], adam.mu, "mu ")
    _assert_grads_close(tstate3["opt_state"]["nu"], adam.nu, "nu ")
    assert tstate3["step"] == 3 and int(adam.count) == tstate3["opt_state"]["count"] == 3
    # The update itself: the step each side took from the shared start, held
    # to 2% of the learning rate per element on average (an Adam step is
    # lr * mu_hat / sqrt(nu_hat): of order lr where the gradient is not noise).
    want3 = params_from_jax(jax.tree.map(np.asarray, jstate3["params"]), "cpu")
    diff = sum(float((tstate3["params"][k] - want3[k]).abs().sum()) for k in want3)
    moved = sum(float((tstate3["params"][k] - before[k]).abs().sum()) for k in want3)
    assert moved > 0 and diff <= 0.02 * moved


def test_train_state_from_jax_rejects_grouped_optimizers(setup):
    jtx, _ = jgroups.make_grouped_optimizer(setup["jparams"], LR, TOTAL)
    state = {"params": setup["jparams"], "opt_state": jtx.init(setup["jparams"]),
             "step": jnp.zeros((), jnp.int32), "sched": jnp.asarray((TOTAL, LR, 0.3))}
    with pytest.raises(ValueError, match="AdamW state"):
        train_state_from_jax(serialization.to_state_dict(jax.device_get(state)), device="cpu")
