"""Train/eval steps, on one device or data-parallel over processes.

One train step is: device-side preprocessing, the full T-step temporal
forward under a gradient (on the card every spiking block runs the
residual-saving LIF forward and the surrogate-BPTT backward kernels), the
detection loss, then the optimizer — zero the frozen leaves' gradients,
clip by the global norm (10.0), AdamW (weight decay 5e-4) at the OneCycle
learning rate of this step. With a data mesh (parallel/mesh.py) every
process computes the gradient of the GLOBAL-batch loss on its local batch
and the gradients are summed across processes before the optimizer, so
every process takes the step one device would take on the concatenated
batch (the JAX package's shard_map branch). With ``fsdp`` the parameters
and moments are sharded over the processes (parallel/mesh.py, part (c)):
the step gathers the full parameters once, reduce-scatters the summed
gradients and updates only the local chunks. With a spatial axis (part
(d)) each rank of a spatial group runs its rows of the same images and
gets the whole raw maps, so every rank computes the same loss; the
gradients of the parameters used on local rows are summed over the
spatial group first (those of the token LSTM, used the same way on whole
maps by every rank, are whole already), then over the data axis as above.

The train state is a plain dict::

    {"params": {name: fp32 tensor}, "opt_state": {"mu", "nu", "count"},
     "step": int, "sched": (total_steps, peak_lr, pct_start)}

The schedule constants ride in the state, so a resumed run continues the
schedule it was saved with. ``train_step`` updates the state's tensors IN
PLACE (the counterpart of the JAX step donating its buffers) and returns a
dict holding the same tensors; callers that need the old values clone
first (train/loop.py's best snapshot does).

Optimizer arithmetic follows optax so that a JAX train state converted by
``convert.train_state_from_jax`` continues identically: the clip scales by
``max_norm / norm`` only when ``norm >= max_norm`` (no epsilon), Adam is
``b1=0.9, b2=0.999, eps=1e-8`` outside the square root, bias-corrected, and
the decoupled weight decay is added to the update before the learning rate
multiplies it.
"""

from __future__ import annotations

import contextlib
from functools import partial
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
    set_checkpoint_early_stop,
)

from ..data.encoding import preprocess_video
from ..losses.detection import DetectionLoss, LossComponents
from ..models.layers import CONV_OUT, conv_name
from ..parallel.mesh import (
    DataMesh,
    all_reduce_grads,
    all_reduce_spatial,
    gather_params,
    gather_state,
    reduce_scatter_grads,
    refuse_unported_axes,
    shard_layout,
    shard_state,
    sharded_norm,
    spatial_rows,
)
from .schedule import onecycle_lr

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Schedule:
    """Host-side OneCycle callable (for logging) carrying ``.consts`` =
    (total_steps, peak_lr, pct_start)."""

    def __init__(self, total_steps: int, peak_lr: float, pct_start: float):
        self.consts = (float(max(total_steps, 1)), float(peak_lr), float(pct_start))

    def __call__(self, step) -> float:
        return onecycle_lr(step, *self.consts)


class Optimizer:
    """Frozen-gradient zeroing -> global-norm clip -> AdamW, on flat dicts
    of tensors.

    ``frozen_mask``: ``{name: bool}`` or ``params -> {name: bool}`` (True =
    frozen). Frozen leaves get exactly-zero updates: their gradients are
    zeroed BEFORE the clip (so the clip norm reflects only trainable
    gradients) and the weight decay is masked off them (zero gradients
    alone would still decay frozen weights toward 0).

    ``groups``: optional ``{name: (lr_mult, weight_decay)}``
    (train/param_groups.py); leaves not named use ``(1.0, weight_decay)``.
    """

    def __init__(self, weight_decay: float = 5e-4, grad_clip_norm: float = 10.0,
                 frozen_mask=None, groups=None):
        self.weight_decay = float(weight_decay)
        self.grad_clip_norm = float(grad_clip_norm)
        self.frozen_mask = frozen_mask
        self.groups = groups

    def init(self, params: dict) -> dict:
        return {
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
            "count": 0,
        }

    def _frozen(self, params: dict) -> dict:
        if self.frozen_mask is None:
            return {}
        mask = self.frozen_mask(params) if callable(self.frozen_mask) else self.frozen_mask
        return {k: bool(v) for k, v in mask.items()}

    @torch.no_grad()
    def update(self, grads: dict, opt_state: dict, params: dict, lr: float,
               norm_fn=None) -> dict:
        """Apply one step in place to ``params`` and ``opt_state``'s
        moments; returns the new opt_state dict (same tensors). The leaves
        may be whole or, under FSDP, this rank's flat chunks of them (keyed
        by the same names); ``norm_fn`` then takes the clip's global norm
        over every rank's chunks (default :func:`global_norm`)."""
        names = list(params)
        frozen = self._frozen(params)
        groups = self.groups or {}
        g = [torch.zeros_like(grads[k]) if frozen.get(k) else grads[k] for k in names]
        # Global-norm clip, decided on the device (no host round trip).
        norm = (norm_fn or global_norm)(g)
        scale = torch.where(norm < self.grad_clip_norm, torch.ones_like(norm),
                            self.grad_clip_norm / norm)
        g = torch._foreach_mul(g, scale)
        mu = [opt_state["mu"][k] for k in names]
        nu = [opt_state["nu"][k] for k in names]
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
        count = opt_state["count"] + 1
        c1, c2 = 1.0 - ADAM_B1 ** count, 1.0 - ADAM_B2 ** count
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        p = [params[k] for k in names]
        for k, u, pk in zip(names, upd, p):
            mult, wd = groups.get(k, (1.0, self.weight_decay))
            if wd and not frozen.get(k):
                u.add_(pk, alpha=wd)
            pk.add_(u, alpha=-lr * mult)
        return {"mu": opt_state["mu"], "nu": opt_state["nu"], "count": count}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over a list of tensors (0-d fp32): the
    norm of the per-tensor norms. Each tensor is read in its memory order,
    so the gradients reach it contiguous (``_grads_of``): a leaf and its
    flat FSDP chunk then sum in the same order."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def make_optimizer(
    peak_lr: float,
    total_steps: int,
    weight_decay: float = 5e-4,
    grad_clip_norm: float = 10.0,
    pct_start: float = 0.3,
    frozen_mask=None,
):
    """AdamW + OneCycle. Returns (tx, schedule): ``tx`` is an
    :class:`Optimizer`, ``schedule`` a host-side callable (for logging) that
    carries ``.consts`` for :func:`init_state`."""
    tx = Optimizer(weight_decay, grad_clip_norm, frozen_mask)
    return tx, Schedule(total_steps, peak_lr, pct_start)


def module_frozen_mask(subtree: str):
    """``params -> {name: bool}`` callable marking one top-level module
    (e.g. ``"backbone"``) frozen, for :func:`make_optimizer`'s
    ``frozen_mask``."""

    def mask(params: dict) -> dict:
        return {k: k.split(".")[0] == subtree for k in params}

    return mask


def init_state(params: dict, tx: Optimizer, schedule=None) -> dict:
    consts = getattr(schedule, "consts", (1000.0, 1e-4, 0.3))
    return {
        "params": params,
        "opt_state": tx.init(params),
        "step": 0,
        "sched": tuple(float(c) for c in consts),
    }


def save_conv_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy of ``remat_policy="save_conv"``: keep
    the output of every convolution dispatched under the name ``conv_out``
    (models/layers.py::CONV_OUT: the spiking blocks', the ConvBlocks' and
    the ConvLSTM's input half, the JAX package's
    ``save_only_these_names("conv_out")``) and recompute everything else:
    the other convs, GroupNorm, the LIF operators, the gate math."""
    if func is torch.ops.aten.convolution.default and conv_name() == CONV_OUT:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _identity(state):
    return state


class TrainStepFns(NamedTuple):
    train_step: Callable  # (state, batch) -> (state, metrics)
    eval_step: Callable  # (params, batch) -> metrics
    forward: Callable  # (params, frames_t, state?) -> (raw_maps, rec_state)
    grads: Callable  # (params, batch) -> ({name: gradient}, LossComponents)
    # FSDP: full train state -> this rank's sharded state, and back (every
    # rank together); the identity without FSDP.
    shard_state: Callable = _identity
    gather_state: Callable = _identity
    mesh: DataMesh | None = None  # the mesh the step functions run on


def make_step_fns(
    detector,
    tx: Optimizer,
    schedule=None,
    remat: bool = False,
    remat_chunk: int | None = None,
    grad_accum: int = 1,
    remat_policy: str | None = None,
    mesh: DataMesh | None = None,
    fsdp: bool = False,
) -> TrainStepFns:
    """Step functions bound to a Detector + optimizer; they run on the
    detector's device (batches may arrive as numpy arrays or tensors on any
    device).

    ``grad_accum``: the batch is split into this many sequential
    microbatches; activation memory scales with ONE microbatch. Each
    microbatch's loss is normalized over that microbatch; gradients and the
    batch-scaled loss total are summed, the logged components averaged — a
    batch of identical microbatches reproduces the unaccumulated step up to
    fp32 reassociation.

    ``remat_chunk``: long-T BPTT memory control — the T axis is split into
    chunks of this size and each chunk's forward is a checkpoint region
    whose boundary carry is the (small) recurrent state, so backward
    activation memory scales with ONE chunk. Same math as the unchunked
    forward; detection maps come from the last timestep only, so all but
    the final chunk only advance the state (decoder and head skipped).
    T must be a multiple of ``remat_chunk``. ``remat`` (bool) checkpoints
    the whole forward instead.

    ``remat_policy``: what a checkpoint region (``remat_chunk`` or
    ``remat``) keeps for the backward. ``"full"`` (default) keeps its
    inputs only and recomputes the whole region; ``"save_conv"`` also keeps
    the outputs of the convs named ``conv_out`` (:func:`save_conv_policy`)
    and recomputes the cheaper rest.

    ``mesh``: a data mesh (parallel/mesh.py::make_mesh). Each process feeds
    its local batch; the loss is the global-batch loss, gradients are summed
    across processes before the frozen-leaf zeroing, the clip and AdamW,
    and ``eval_step`` reports the global loss. With ``grad_accum`` each
    process splits its local batch into microbatches, and microbatch ``i``
    is normalised over the ``i``-th microbatches of all processes together.
    A mesh with a tensor axis raises ``ValueError``: tensor parallelism is
    inference-only. On a ``data x spatial`` mesh the ranks of a spatial
    group feed the same local batch; each keeps its rows of the images,
    the labels stay whole, and ``remat``, ``remat_chunk``, ``grad_accum``,
    ``remat_policy`` and ``fsdp`` compose (FSDP shards over the data axis;
    the spatial sum of the gradients comes before its reduce-scatter).
    Every geometry runs, ranks with no row of a small map included.

    ``fsdp``: shard the parameters and AdamW moments over the mesh's data
    axis (ZeRO, parallel/mesh.py part (c)); needs ``mesh``. ``train_step``
    then takes and returns the sharded state of ``fns.shard_state(full
    state)``: it gathers the full parameters once, runs forward and
    backward on the local batch as above, reduce-scatters the summed
    gradients and runs the optimizer on the local chunks, with the clip's
    norm (and the ``grad_norm`` metric) taken over all ranks' chunks.
    ``fns.gather_state`` makes a sharded state whole on every rank.
    ``eval_step``, ``forward`` and ``grads`` take full parameters.
    """
    if fsdp and mesh is None:
        raise ValueError(
            "fsdp=True requires a device mesh (mesh.fsdp shards the train state over the "
            "mesh's data axis); pass mesh= or disable fsdp")
    if mesh is not None and mesh.tensor > 1:
        raise ValueError(
            "mesh.tensor > 1 is inference-only (eval/serving latency); "
            "training supports data and fsdp parallelism")
    if remat_policy in (None, "", "full"):
        context_fn = noop_context_fn
    elif remat_policy == "save_conv":
        context_fn = partial(create_selective_checkpoint_contexts, save_conv_policy)
    else:
        raise ValueError(f"unknown remat_policy '{remat_policy}' (full|save_conv)")
    cfg = detector.cfg
    refuse_unported_axes(cfg.mesh, train=True)
    dev = detector.device
    loss_fn = DetectionLoss(cfg.model.num_classes, cfg.model.hyp)
    # Honor runtime.precision end-to-end: preprocessing emits the model's
    # compute dtype, so "f32" never quantizes inputs through bf16.
    in_dtype = detector.dtype

    spatial = mesh is not None and mesh.spatial > 1

    def _ckpt(fn, *args):
        # Spatial: a recompute runs the region's exchanges, so it runs the
        # whole region on every rank (early stop would end it wherever the
        # rank's last saved tensor falls).
        with set_checkpoint_early_stop(False) if spatial else contextlib.nullcontext():
            return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    def run(params, frames, height, state=None, state_only=False):
        return detector.apply_train(params, frames, state, state_only=state_only, mesh=mesh,
                                    height=height)

    if remat_chunk:

        def maps_of(params, frames, height):
            t, c = frames.shape[0], remat_chunk
            if t % c:
                raise ValueError(f"T={t} not a multiple of remat_chunk={c}")
            n = t // c
            state = None
            for i in range(n - 1):  # all but the last chunk only advance the state
                state = _ckpt(
                    lambda chunk, st: run(params, chunk, height, st, state_only=True)[1],
                    frames[i * c : (i + 1) * c], state,
                )
            # Final chunk: maps of its last timestep are the window's output.
            return _ckpt(
                lambda chunk, st: run(params, chunk, height, st)[0],
                frames[(n - 1) * c :], state,
            )

    elif remat:

        def maps_of(params, frames, height):
            return _ckpt(lambda fr: run(params, fr, height)[0], frames)

    else:

        def maps_of(params, frames, height):
            return run(params, frames, height)[0]

    def _to_device(batch: dict) -> dict:
        return {
            k: torch.as_tensor(v).to(dev, non_blocking=True)
            for k, v in batch.items() if k != "paths"
        }

    def _loss(params, batch) -> LossComponents:
        images = batch["images"]  # (B, T, H, W, 3): a spatial rank keeps its rows
        frames = preprocess_video(spatial_rows(images, mesh), dtype=in_dtype)
        return loss_fn(
            maps_of(params, frames, images.shape[2]), batch["labels"], batch["label_mask"],
            sample_mask=batch.get("sample_mask"), cross_replica_axis=mesh,
        )

    def _grads_of(params, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        lc = _loss(leaves, batch)
        names = list(leaves)
        got = torch.autograd.grad(lc.total, [leaves[k] for k in names], allow_unused=True)
        # contiguous: a conv weight's gradient may come back channels-last,
        # and the clip's norm sums each tensor in memory order (global_norm)
        grads = {
            k: torch.zeros_like(params[k]) if g is None else g.contiguous()
            for k, g in zip(names, got)
        }
        return grads, LossComponents(*(torch.as_tensor(x).detach() for x in lc))

    layout = (shard_layout(dict(detector.module.named_parameters()), mesh.size)
              if fsdp else None)
    whole_on_every_rank = detector.rows_replicated_params()

    def _reduce_spatial(grads):
        return all_reduce_spatial(grads, mesh, skip=whole_on_every_rank)

    def train_step(state: dict, batch: dict):
        batch = _to_device(batch)
        params = state["params"]
        full = gather_params(params, layout, mesh) if fsdp else params
        if grad_accum > 1:
            k = grad_accum
            b = batch["images"].shape[0]
            if b % k:
                raise ValueError(f"batch {b} not a multiple of grad_accum={k}")
            grads, lc = None, None
            for i in range(k):
                mb = {key: v[i * (b // k) : (i + 1) * (b // k)] for key, v in batch.items()}
                g, l = _grads_of(full, mb)
                if grads is None:
                    grads, lc = g, l
                else:
                    torch._foreach_add_(list(grads.values()), [g[n] for n in grads])
                    lc = LossComponents(*(x + y for x, y in zip(lc, l)))
            # lc.total scales with the (micro)batch size, so SUMMING the
            # microbatch grads/totals reproduces the full-batch scale; the
            # per-component logging values (already normalized) are averaged.
            lc = lc._replace(box=lc.box / k, cls=lc.cls / k, dfl=lc.dfl / k)
        else:
            grads, lc = _grads_of(full, batch)
        del full
        grads = _reduce_spatial(grads)
        sched = state["sched"]
        lr = onecycle_lr(state["step"], *sched)
        # Each process holds d(global loss)/d(params) over its own batch:
        # their sum is the whole gradient.
        if fsdp:
            grads = reduce_scatter_grads(grads, layout, mesh)
            norm_fn = partial(sharded_norm, mesh=mesh)
        else:
            grads = all_reduce_grads(grads, mesh)
            norm_fn = global_norm
        grad_norm = norm_fn(grads.values())
        opt_state = tx.update(grads, state["opt_state"], params, lr, norm_fn=norm_fn)
        new_state = {
            "params": params,
            "opt_state": opt_state,
            "step": state["step"] + 1,
            "sched": sched,
        }
        metrics = {
            "loss": lc.total, "box": lc.box, "cls": lc.cls, "dfl": lc.dfl, "fg": lc.fg,
            "lr": lr, "grad_norm": grad_norm,
        }
        return new_state, metrics

    @torch.no_grad()
    def eval_step(params: dict, batch: dict):
        lc = _loss(params, _to_device(batch))
        return {"loss": lc.total, "box": lc.box, "cls": lc.cls, "dfl": lc.dfl, "fg": lc.fg}

    def forward(params: dict, frames_t, rec_state=None):
        """Whole frames in, whole raw maps out; on a spatial mesh the
        recurrent state holds this rank's rows."""
        return detector.apply(params, spatial_rows(frames_t, mesh), rec_state, mesh=mesh,
                              height=frames_t.shape[-3])

    def grads(params: dict, batch: dict):
        g, lc = _grads_of(params, _to_device(batch))
        return all_reduce_grads(_reduce_spatial(g), mesh), lc

    if not fsdp:
        return TrainStepFns(train_step=train_step, eval_step=eval_step, forward=forward,
                            grads=grads, mesh=mesh)
    return TrainStepFns(
        train_step=train_step, eval_step=eval_step, forward=forward, grads=grads,
        shard_state=lambda state: shard_state(state, layout, mesh.rank),
        gather_state=lambda state: gather_state(state, layout, mesh),
        mesh=mesh,
    )
