"""FSDP training, tensor-parallel inference and spatial parallelism of
the port across processes: checked against one process, and timed.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        scripts/torch_parallel_cards.py [--cpu] [--quick] [--one-card] \
        [--only fsdp|tensor|spatial]

``--cpu``: gloo on CPU processes; ``--quick``: the checks only, no
timings, on 64x96 windows (full width); ``--only``: one of the three
axes; ``--one-card``: every process on card 0 over gloo (NCCL takes one
process a card), for the spatial checks on a host with one card.

One process per card (NCCL), or with ``--cpu`` per CPU process (gloo, the
tiny fp32 model of the tests at 64x64). Every process builds the model
from one seed and draws the same inputs.

Checks, in fp32 (TF32 off):

- FSDP (``make_step_fns(mesh=make_mesh(), fsdp=True)``): each process
  takes its rows of a global batch (``world x 2`` windows of T=5 moving
  rectangles) and one step; rank 0 then runs the library step on the whole
  batch from the same parameters, alone. Loss and components within
  ``LOSS_RTOL``, the first moments (gathered) per leaf within
  ``GRAD_RTOL`` of the leaf's norm plus ``GRAD_ATOL`` of the global norm
  (scripts/torch_dp_cards.py's tolerances); a batch on which a block's
  per-sample spike count differs between the rows and the whole batch is
  redrawn.
- Tensor parallelism on a ``1 x world`` mesh (``make_predict_fn(mesh=)``):
  a B=1 window of T=5 against the same window on one process: raw maps
  within ``RAW_TOL`` of their largest entry, valid mask and classes equal,
  scores within ``SCORE_ATOL``, boxes within ``BOX_ATOL`` pixels. A window
  on which a spike of the sharded forward differs is redrawn.

Timings on the card (``--quick`` skips them), the default model in bf16
at full width (yolo11m, 480x640), beside the card's name and power limit:

- FSDP: the bytes of parameters and moments a rank keeps against the
  data-parallel step's; FSDP and DP step host ms in turns (dp, fsdp, fsdp,
  dp; synchronised, ``N_TIMED`` steps a turn after a warm-up); device ms
  of the parameter all-gather and the gradient reduce-scatter (CUDA events
  over back-to-back calls) beside their bounds: the larger of the bytes a
  card receives (or sends) over NVLink at 450 GB/s and the bytes it reads
  and writes at the HBM rate.
- Tensor parallelism: the B=1 serving step (``DetectionService._predict``:
  forward, decode, NMS, host copy) host ms a frame at k=1 (rank 0 alone),
  k=2 (a ``world/2 x 2`` mesh, each row its own frame) and k=world, in
  turns (1, 2, world, world, 2, 1); the all-gathers a frame and their
  device ms from the profiler.
- ``serve()`` with ``mesh.tensor: world``: rank 0 answers three frames of
  two streams through the service it built while the other ranks follow,
  and every rank returns.

Spatial parallelism (``--only spatial``), for every spatial size s of 2
and 4 that divides the world, on a ``world/s x s`` ``data x spatial``
mesh:

- check, in fp32 on 64x96 windows on the card (with or without
  ``--quick``): the train step and the predict, each data row on its
  ``B_LOCAL`` windows of a global batch, against one process on the whole
  batch (the FSDP check's tolerances for the step; the tensor-parallel
  check's for the predict), a batch whose per-sample spike counts (summed
  over each spatial group) differ being redrawn. At 64 rows the stride-64
  map has one row, so a rank of each group owns none: the geometry JAX's
  spatial step refuses. On the card each rank's step launches A2 and A3
  once a block, but for the blocks where it owns no row, which it skips
  and counts (``skipped_empty``).
- timings (not ``--quick``), the default model in bf16 at full width: the
  T=5 step's host ms at s = 1 (data parallelism over the world), 2 and 4
  in turns (1, 2, 4, 4, 2, 1); the row exchanges (all-to-alls) and
  statistic sums (all-reduces) of one step with the bytes a card
  receives, and the device ms of the collectives a step from the profiler
  beside the NVLink byte bound; the peak memory per card of a T=5 and a
  T=10 step at each s with one train state resident, and of its forward
  and backward alone over what was allocated before.

Rank 0 prints one JSON line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from snn_object_detectionddp_tpu_torch.config import Config  # noqa: E402
from snn_object_detectionddp_tpu_torch.data.encoding import preprocess_video  # noqa: E402
from snn_object_detectionddp_tpu_torch.evals.validator import make_predict_fn  # noqa: E402
from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K  # noqa: E402
from snn_object_detectionddp_tpu_torch.models.detector import (  # noqa: E402
    Detector,
    set_tf32_policy,
)
from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock  # noqa: E402
from snn_object_detectionddp_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from snn_object_detectionddp_tpu_torch.serve import DetectionService, serve  # noqa: E402
from snn_object_detectionddp_tpu_torch.train.step import (  # noqa: E402
    init_state,
    make_optimizer,
    make_step_fns,
)

B_LOCAL, T = 2, 5
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
RAW_TOL, SCORE_ATOL, BOX_ATOL = 1e-4, 1e-4, 1e-2
ATTEMPTS = 6
# --quick checks the full-width model on small windows: at 480x640 a batch
# of 2 and one of 4 pick other cuDNN algorithms often enough that every one
# of 4 draws had a spike flip over two cards (chip_smoke.py's card-vs-CPU
# gradient check runs at 64x96 for the same reason).
QUICK_HW = (64, 96)
N_TIMED = 5  # train steps a turn
N_FRAMES = 30  # serving frames a turn
N_PROFILED = 10  # serving frames under the profiler
N_COLLECTIVE = 20  # back-to-back collective calls timed
NVLINK_BYTES_PER_S = 450e9  # H100 SXM NVLink, one direction a card
SEED = 0


def _spatial_sizes(world: int) -> list[int]:
    return [s for s in (2, 4) if world % s == 0]


def spatial_check(cpu: bool, dev, s: int, hw=None) -> dict:
    cfg = _cfg(cpu, "f32", hw)
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device=dev)
    params = det.init_params(torch.Generator().manual_seed(SEED))
    tx, sched = make_optimizer(1e-3, 10)
    mesh = pmesh.make_mesh(dist.get_world_size() // s, spatial=s)
    fns = make_step_fns(det, tx, sched, mesh=mesh)
    n = mesh.size
    rng = np.random.RandomState(SEED + 10 * s)
    for attempt in range(ATTEMPTS):
        batch = cs.moving_boxes_batch(rng, B_LOCAL * n, T, h, w, cfg.model.num_classes,
                                      **_boxes(cfg))
        mine = _rows(batch, mesh.rank * B_LOCAL, (mesh.rank + 1) * B_LOCAL)
        counts, _ = _spike_counts(det, lambda: fns.grads(params, mine))
        counts = counts.to(dev)
        dist.all_reduce(counts, group=mesh.spatial_group)  # whole-map counts
        K.reset_launch_counts()
        state, m_s = fns.train_step(init_state({k: v.clone() for k, v in params.items()}, tx,
                                               sched), mine)
        _sync(dev)
        # each rank's kernel launches in its step, and calls on a shard
        # with no row (no launch): together one a block and kernel
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, {k: (K.launch_counts[k], K.skipped_empty[k])
                                       for k in K.KERNELS[1:]})
        m_s = {k: float(v) for k, v in m_s.items()}
        got_p = make_predict_fn(det, mesh=mesh)(params, mine["images"])
        everyone = pmesh.gather_to_main([(counts.cpu(), {k: v.cpu() for k, v in got_p.items()})],
                                        mesh)
        ok = torch.zeros(1, device=dev)
        result = {}
        if dist.get_rank() == 0:
            library = make_step_fns(det, tx, sched)
            ref_counts, _ = _spike_counts(det, lambda: library.grads(params, batch))
            flips = int((torch.cat([c for c, _ in everyone], dim=1) != ref_counts).sum())
            ref, m_lib = library.train_step(init_state({k: v.clone() for k, v in params.items()},
                                                       tx, sched), batch)
            m_lib = {k: float(v) for k, v in m_lib.items()}
            mu_s, mu_lib = state["opt_state"]["mu"], ref["opt_state"]["mu"]
            total = float(torch.sqrt(sum(v.double().pow(2).sum() for v in mu_lib.values())))
            worst, worst_name = 0.0, ""
            for k, v in mu_lib.items():
                err = float((mu_s[k] - v).double().norm())
                allowed = GRAD_RTOL * float(v.double().norm()) + GRAD_ATOL * total
                if err / allowed > worst:
                    worst, worst_name = err / allowed, k
            rel = {k: abs(m_s[k] - m_lib[k]) / max(abs(m_lib[k]), 1e-30)
                   for k in ("loss", "box", "cls", "dfl", "grad_norm")}
            got = {k: torch.cat([o[k] for _, o in everyone]).numpy() for k in everyone[0][1]}
            want = {k: v.cpu().numpy() for k, v in make_predict_fn(det)(params,
                                                                        batch["images"]).items()}
            v = want["valid"]
            pred = dict(kept=int(v.sum()), valid_equal=bool((got["valid"] == v).all()))
            if pred["valid_equal"] and v.any():
                pred.update(
                    classes_equal=bool((got["classes"][v] == want["classes"][v]).all()),
                    score_err=float(np.abs(got["scores"][v] - want["scores"][v]).max()),
                    box_err=float(np.abs(got["boxes"][v] - want["boxes"][v]).max()))
            result = dict(s=s, data=n, attempt=attempt, spike_count_diffs=flips, spatial=m_s,
                          library=m_lib, rel_err=rel, worst_leaf=worst_name,
                          worst_of_allowance=worst, leaves=len(mu_lib), predict=pred,
                          launches_and_skipped=ranks)
            ok[0] = float(flips == 0)
        dist.broadcast(ok, 0)
        if ok.item():
            if dist.get_rank() == 0:
                if max(rel.values()) > LOSS_RTOL or worst > 1:
                    raise AssertionError(f"spatial step disagrees with one process: {result}")
                n_blocks = sum(isinstance(m, SpikingConvBlock) for m in det.module.modules())
                if dev.type == "cuda" and any(
                        sum(r[k]) != n_blocks or r[k][0] == 0 for r in ranks for k in r):
                    raise AssertionError(f"a spatial step's launches plus skipped calls are not "
                                         f"one a block ({n_blocks}): {ranks}")
                if m_s["fg"] != m_lib["fg"] or not m_s["fg"] > 0:
                    raise AssertionError(f"foreground anchors differ or none: {result}")
                if (not pred["valid_equal"] or not v.any() or not pred["classes_equal"]
                        or pred["score_err"] > SCORE_ATOL or pred["box_err"] > BOX_ATOL):
                    raise AssertionError(f"spatial predict disagrees with one process: {result}")
            return result
        if dist.get_rank() == 0:
            print(f"s={s} batch {attempt}: {result['spike_count_diffs']} per-sample spike counts "
                  "differ between the spatial and the whole forward; drawing another", flush=True)
    raise AssertionError(f"every one of {ATTEMPTS} batches had a spike flip")


def _exchange_tally(fn) -> dict:
    """The row exchanges (all-to-alls) and the GroupNorm sums (all-reduces,
    forward and backward) that ``fn`` runs over the spatial group, with
    the bytes this process receives in them."""
    tally = {"all_to_all": 0, "rows_bytes": 0, "spatial_sums": 0, "sum_bytes": 0}
    real_a2a = pmesh._alltoall
    real_sum, real_back = pmesh._SpatialSum.forward, pmesh._SpatialSum.backward

    def a2a(chunks, counts_in, counts_out, like, group):
        out = real_a2a(chunks, counts_in, counts_out, like, group)
        tally["all_to_all"] += 1
        tally["rows_bytes"] += out.numel() * out.element_size()
        return out

    def ssum(ctx, x, group):
        tally["spatial_sums"] += 1
        tally["sum_bytes"] += x.numel() * x.element_size()
        return real_sum(ctx, x, group)

    def sback(ctx, g):
        tally["spatial_sums"] += 1
        tally["sum_bytes"] += g.numel() * g.element_size()
        return real_back(ctx, g)

    pmesh._alltoall = a2a
    pmesh._SpatialSum.forward, pmesh._SpatialSum.backward = staticmethod(ssum), staticmethod(sback)
    try:
        fn()
    finally:
        pmesh._alltoall = real_a2a
        pmesh._SpatialSum.forward = staticmethod(real_sum)
        pmesh._SpatialSum.backward = staticmethod(real_back)
    return tally


def spatial_timing(dev) -> dict:
    world = dist.get_world_size()
    cfg = _cfg(False, "bf16")
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device=dev)
    params = det.init_params(torch.Generator().manual_seed(SEED))
    tx, sched = make_optimizer(1e-4, 100)
    sizes = [1] + _spatial_sizes(world)
    meshes = {s: pmesh.make_mesh(world // s, spatial=s) for s in sizes}
    fns = {s: make_step_fns(det, tx, sched, mesh=m) for s, m in meshes.items()}
    states = {s: init_state({k: v.clone() for k, v in params.items()}, tx, sched) for s in sizes}
    rng = np.random.RandomState(SEED + 5)
    batches = {t: cs.moving_boxes_batch(rng, B_LOCAL * world, t, h, w, cfg.model.num_classes)
               for t in (T, 2 * T)}

    def mine(s, t):
        m = meshes[s]
        return _rows(batches[t], m.rank * B_LOCAL, (m.rank + 1) * B_LOCAL)

    def step(s, t=T):
        states[s], _ = fns[s].train_step(states[s], mine(s, t))

    step_ms = {s: [] for s in sizes}
    for s in sizes + sizes[::-1]:
        dist.barrier()
        _timed(lambda: step(s), 1, dev)  # warm-up
        step_ms[s] += _timed(lambda: step(s), N_TIMED, dev)
    exchanges, prof_ms = {}, {}
    for s in sizes[1:]:
        dist.barrier()
        exchanges[s] = _exchange_tally(lambda: _timed(lambda: step(s), 1, dev))
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            step(s)
            _sync(dev)
        rows = cs.kernel_rows(prof)
        total = sum(e.self_device_time_total for e in rows) / 1e3
        a2a = sum(e.self_device_time_total for e in rows if "sendrecv" in e.key.lower()) / 1e3
        red = sum(e.self_device_time_total for e in rows
                  if "nccl" in e.key.lower() and "sendrecv" not in e.key.lower()) / 1e3
        bound = exchanges[s]["rows_bytes"] / NVLINK_BYTES_PER_S * 1e3
        prof_ms[s] = dict(device_ms=total, all_to_all_device_ms=a2a,
                          all_reduce_device_ms=red, rows_link_bound_ms=bound)
    # Peak memory a card with one train state resident: the whole step's,
    # and over what was allocated before it, the forward and backward's
    # (activations, gradients and their sums) alone.
    states.clear()
    peak = {}
    for t in (T, 2 * T):
        for s in sizes:
            state = init_state({k: v.clone() for k, v in params.items()}, tx, sched)
            dist.barrier()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _timed(lambda: fns[s].train_step(state, mine(s, t)), 1, dev)
            step_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            _timed(lambda: fns[s].grads(params, mine(s, t)), 1, dev)
            peak[f"s{s}_T{t}"] = dict(
                step_peak=step_peak, before=before,
                fwd_bwd_over_before=torch.cuda.max_memory_allocated(dev) - before)
            del state
    return dict(step_ms=step_ms, step_ms_median={s: float(np.median(v)) for s, v in step_ms.items()},
                peak_bytes=peak, exchanges=exchanges, profile=prof_ms,
                param_and_moment_bytes=3 * 4 * sum(v.numel() for v in params.values()))


def _cfg(cpu: bool, precision: str, hw: tuple | None = None) -> Config:
    cfg = Config()  # yolo11m, 480x640, s2d4, ConvLSTM
    cfg.runtime.precision = precision
    if cpu:
        cfg.model.num_classes, cfg.model.yolo_model_name = 3, "yolo11n.pt"
        cfg.model.width_mult, cfg.model.hyp.reg_max = 0.25, 8
        cfg.model.image_size = (64, 64)
    if hw is not None:
        cfg.model.image_size = hw
    return cfg


def _boxes(cfg) -> dict:
    """moving_boxes_batch's box sides and speed for the window size: a
    small window needs large boxes for the assigner to find anchors."""
    small = min(cfg.model.image_size) <= 96
    return dict(size=(1 / 2, 3 / 4), speed=2) if small else {}


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _spike_counts(det, fn):
    """((blocks, B) per-sample spike counts, fn's result); spikes are
    gathered whole under tensor parallelism."""
    counts = []
    hooks = [m.register_forward_hook(
        lambda mod, i, o: counts.append(pmesh.full_channels(o[0], mod.features)
                                        .detach().float().flatten(2).sum((0, 2))))
             for m in det.module.modules() if isinstance(m, SpikingConvBlock)]
    try:
        out = fn()
    finally:
        for h in hooks:
            h.remove()
    return torch.stack(counts).cpu(), out


def fsdp_check(cpu: bool, mesh, dev, hw=None) -> dict:
    cfg = _cfg(cpu, "f32", hw)
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device=dev)
    params = det.init_params(torch.Generator().manual_seed(SEED))
    tx, sched = make_optimizer(1e-3, 10)
    fsdp = make_step_fns(det, tx, sched, mesh=mesh, fsdp=True)
    n = mesh.size
    rng = np.random.RandomState(SEED)
    for attempt in range(ATTEMPTS):
        batch = cs.moving_boxes_batch(rng, B_LOCAL * n, T, h, w, cfg.model.num_classes,
                                      **_boxes(cfg))
        mine = _rows(batch, mesh.rank * B_LOCAL, (mesh.rank + 1) * B_LOCAL)
        counts, _ = _spike_counts(det, lambda: fsdp.grads(params, mine))
        state = fsdp.shard_state(init_state({k: v.clone() for k, v in params.items()}, tx, sched))
        state, m_f = fsdp.train_step(state, mine)
        m_f = {k: float(v) for k, v in m_f.items()}
        whole = fsdp.gather_state(state)
        everyone = pmesh.gather_to_main([counts], mesh)
        ok = torch.zeros(1, device=dev)
        result = {}
        if mesh.rank == 0:
            library = make_step_fns(det, tx, sched)
            ref_counts, _ = _spike_counts(det, lambda: library.grads(params, batch))
            flips = int((torch.cat(everyone, dim=1) != ref_counts).sum())
            ref, m_lib = library.train_step(init_state({k: v.clone() for k, v in params.items()},
                                                       tx, sched), batch)
            m_lib = {k: float(v) for k, v in m_lib.items()}
            mu_f, mu_lib = whole["opt_state"]["mu"], ref["opt_state"]["mu"]
            total = float(torch.sqrt(sum(v.double().pow(2).sum() for v in mu_lib.values())))
            worst, worst_name = 0.0, ""
            for k, v in mu_lib.items():
                err = float((mu_f[k] - v).double().norm())
                allowed = GRAD_RTOL * float(v.double().norm()) + GRAD_ATOL * total
                if err / allowed > worst:
                    worst, worst_name = err / allowed, k
            rel = {k: abs(m_f[k] - m_lib[k]) / max(abs(m_lib[k]), 1e-30)
                   for k in ("loss", "box", "cls", "dfl", "grad_norm")}
            result = dict(attempt=attempt, spike_count_diffs=flips, fsdp=m_f, library=m_lib,
                          rel_err=rel, worst_leaf=worst_name, worst_of_allowance=worst,
                          leaves=len(mu_lib))
            ok[0] = float(flips == 0)
        dist.broadcast(ok, 0)
        if ok.item():
            if mesh.rank == 0:
                if max(rel[k] for k in ("loss", "box", "cls", "dfl")) > LOSS_RTOL or worst > 1:
                    raise AssertionError(f"FSDP step disagrees with one process: {result}")
                if m_f["fg"] != m_lib["fg"] or not m_f["fg"] > 0:
                    raise AssertionError(f"foreground anchors differ or none: {result}")
            return result
        if mesh.rank == 0:
            print(f"batch {attempt}: {result['spike_count_diffs']} per-sample spike counts differ "
                  "between the processes' rows and the whole batch; drawing another", flush=True)
    raise AssertionError(f"every one of {ATTEMPTS} batches had a spike flip")


def tp_check(cpu: bool, dev, hw=None) -> dict:
    cfg = _cfg(cpu, "f32", hw)
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device=dev)
    params = det.init_params(torch.Generator().manual_seed(SEED))
    mesh = pmesh.make_mesh(1, tensor=dist.get_world_size())
    shards = pmesh.tp_shard_params(params, mesh)
    rng = np.random.RandomState(SEED + 1)
    for attempt in range(ATTEMPTS):
        images = cs.moving_boxes_batch(rng, 1, T, h, w, cfg.model.num_classes,
                                       **_boxes(cfg))["images"]
        frames = preprocess_video(torch.from_numpy(images).to(dev), dtype=det.dtype)
        c_tp, (raw_tp, _) = _spike_counts(det, lambda: det.apply(shards, frames, mesh=mesh))
        c_one, (raw_one, _) = _spike_counts(det, lambda: det.apply(params, frames))
        flips = torch.tensor([float((c_tp != c_one).sum())], device=dev)
        dist.all_reduce(flips)
        if flips.item():
            if mesh.tensor_rank == 0:
                print(f"window {attempt}: {int(flips.item())} per-block spike counts differ "
                      "between the sharded and the whole forward; drawing another", flush=True)
            continue
        raw_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(raw_tp, raw_one))
        got = make_predict_fn(det, mesh=mesh)(shards, images)
        want = make_predict_fn(det)(params, images)
        got, want = ({k: v.cpu().numpy() for k, v in o.items()} for o in (got, want))
        v = want["valid"]
        result = dict(attempt=attempt, raw_rel_err=raw_err, kept=int(v.sum()),
                      valid_equal=bool((got["valid"] == v).all()))
        if result["valid_equal"] and v.any():
            result.update(
                classes_equal=bool((got["classes"][v] == want["classes"][v]).all()),
                score_err=float(np.abs(got["scores"][v] - want["scores"][v]).max()),
                box_err=float(np.abs(got["boxes"][v] - want["boxes"][v]).max()))
        if (raw_err > RAW_TOL or not result["valid_equal"] or not v.any()
                or not result["classes_equal"] or result["score_err"] > SCORE_ATOL
                or result["box_err"] > BOX_ATOL):
            raise AssertionError(f"tensor-parallel predict disagrees with one process: {result}")
        return result
    raise AssertionError(f"every one of {ATTEMPTS} windows had a spike flip")


def _timed(fn, n: int, dev) -> list[float]:
    out = []
    for _ in range(n):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _collective_ms(fn, dev) -> float:
    """Device ms a call of a collective ``fn`` (every rank calls it the same
    number of times): CUDA events over ``N_COLLECTIVE`` back-to-back calls
    after two warm-up calls and a barrier."""
    fn(), fn()
    dist.barrier()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(N_COLLECTIVE):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / N_COLLECTIVE


def fsdp_timing(mesh, dev) -> dict:
    cfg = _cfg(False, "bf16")
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device=dev)
    params = det.init_params(torch.Generator().manual_seed(SEED))
    tx, sched = make_optimizer(1e-4, 100)
    fns = {"dp": make_step_fns(det, tx, sched, mesh=mesh),
           "fsdp": make_step_fns(det, tx, sched, mesh=mesh, fsdp=True)}
    states = {"dp": init_state({k: v.clone() for k, v in params.items()}, tx, sched)}
    states["fsdp"] = fns["fsdp"].shard_state(init_state(params, tx, sched))
    kept = {kind: sum(t.numel() * t.element_size() for part in (
        st["params"], st["opt_state"]["mu"], st["opt_state"]["nu"]) for t in part.values())
        for kind, st in states.items()}
    rng = np.random.RandomState(SEED + 2)
    batch = cs.moving_boxes_batch(rng, B_LOCAL * mesh.size, T, h, w, cfg.model.num_classes)
    mine = _rows(batch, mesh.rank * B_LOCAL, (mesh.rank + 1) * B_LOCAL)
    step_ms = {"dp": [], "fsdp": []}
    for kind in ("dp", "fsdp", "fsdp", "dp"):
        def step(kind=kind):
            states[kind], _ = fns[kind].train_step(states[kind], mine)
        _timed(step, 1, dev)  # warm-up
        step_ms[kind] += _timed(step, N_TIMED, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _timed(lambda: fns["fsdp"].train_step(states["fsdp"], mine), 1, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    del states["dp"]
    layout = pmesh.shard_layout(params, mesh.size)
    n_bytes = 4 * sum(v.numel() for v in params.values())
    grads = {k: torch.randn_like(v) for k, v in params.items()}
    gather_ms = _collective_ms(lambda: pmesh.gather_params(states["fsdp"]["params"], layout, mesh),
                               dev)
    rs_ms = _collective_ms(lambda: pmesh.reduce_scatter_grads(grads, layout, mesh), dev)
    link = (mesh.size - 1) / mesh.size * n_bytes
    # all-gather: read the chunks, write the whole; reduce-scatter: read
    # every gradient, write the chunk
    hbm = n_bytes / mesh.size + n_bytes
    bound_ms = max(link / NVLINK_BYTES_PER_S, hbm / cs.HBM_BYTES_PER_S) * 1e3
    return dict(world=mesh.size, kept_bytes=kept, full_state_bytes=3 * n_bytes,
                step_ms=step_ms,
                step_ms_median={k: float(np.median(v)) for k, v in step_ms.items()},
                fsdp_peak_bytes=peak, gather_ms=gather_ms, reduce_scatter_ms=rs_ms,
                link_bytes_per_card=link, hbm_bytes=hbm, collective_bound_ms=bound_ms)


def tp_timing(dev) -> dict:
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = _cfg(False, "bf16")
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device=dev)
    params = det.init_params(torch.Generator().manual_seed(SEED))
    meshes = {world: pmesh.make_mesh(1, tensor=world)}
    if world % 2 == 0 and world > 2:
        pairs = pmesh.make_mesh(world // 2, tensor=2)
        meshes[2] = dataclasses.replace(pairs, size=1, rank=0, group=None)  # this rank's row
    services = {k: DetectionService(det, params, conf=0.3, max_batch=1, max_clip=2, mesh=m)
                for k, m in sorted(meshes.items())}
    if rank == 0:
        services[1] = DetectionService(det, params, conf=0.3, max_batch=1, max_clip=2)
    frame = np.random.RandomState(SEED + 3).randint(0, 256, (1, h, w, 3), dtype=np.uint8)
    ks = sorted(services) if rank == 0 else sorted(meshes)
    order = sorted(set(ks) | {1})
    order = order + order[::-1]
    frame_ms = {k: [] for k in order}
    for k in order:
        dist.barrier()
        if k in services:
            svc = services[k]
            step = lambda svc=svc: svc._predict(frame, (svc._zero_state1,))  # noqa: E731
            _timed(step, 3, dev)
            frame_ms[k] += _timed(step, N_FRAMES, dev)
    gathers, prof_ms = {}, {}
    real = pmesh.all_gather_channels
    for k, svc in sorted(services.items()):
        if k == 1:
            continue
        calls = [0]

        def counting(x, tg):
            calls[0] += 1
            return real(x, tg)

        pmesh.all_gather_channels = counting
        try:
            svc._predict(frame, (svc._zero_state1,))
        finally:
            pmesh.all_gather_channels = real
        gathers[k] = calls[0]
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for _ in range(N_PROFILED):
                svc._predict(frame, (svc._zero_state1,))
            _sync(dev)
        rows = cs.kernel_rows(prof)
        total = sum(e.self_device_time_total for e in rows) / 1e3 / N_PROFILED
        nccl = sum(e.self_device_time_total for e in rows if "nccl" in e.key.lower()) / 1e3
        prof_ms[k] = dict(device_ms=total, all_gather_device_ms=nccl / N_PROFILED,
                          lif_ms=sum(e.self_device_time_total for e in rows
                                     if "affine_lif" in e.key) / 1e3 / N_PROFILED)
    return dict(frame_ms={k: v for k, v in frame_ms.items() if v},
                frame_ms_median={k: float(np.median(v)) for k, v in frame_ms.items() if v},
                all_gathers_a_frame=gathers, profile=prof_ms)


def serve_check(dev) -> dict:
    """``serve()`` with ``mesh.tensor`` = world: rank 0 takes three frames
    of two streams through the service it built, then shuts the server
    down; the others follow until it stops."""
    cfg = _cfg(dev.type == "cpu", "bf16" if dev.type == "cuda" else "f32")
    cfg.mesh.tensor = dist.get_world_size()
    h, w = cfg.model.image_size
    got = {}

    def on_ready(httpd, service):
        def drive():
            try:
                rng = np.random.RandomState(SEED + 4)
                for i in range(3):
                    for s in ("cam0", "cam1"):
                        got.setdefault(s, []).append(len(service.detect(
                            s, rng.randint(0, 256, (h, w, 3), dtype=np.uint8))["scores"]))
                got["streams"] = service.num_streams
            finally:
                httpd.shutdown()

        threading.Thread(target=drive, daemon=True).start()

    serve(cfg, None, port=0, max_batch=2, max_clip=2, device=str(dev), on_ready=on_ready)
    return got


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU, the tiny fp32 model")
    ap.add_argument("--quick", action="store_true", help="the checks only, no timings")
    ap.add_argument("--only", choices=("fsdp", "tensor", "spatial"), default=None)
    ap.add_argument("--one-card", action="store_true",
                    help="every process on card 0 over gloo (the spatial checks)")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_parallel_cards.py needs CUDA cards (or --cpu)")
    device = "cpu" if args.cpu else "cuda"
    if args.one_card:
        env = os.environ
        if args.cpu or args.only != "spatial" or "MASTER_PORT" not in env:
            sys.exit("--one-card runs the spatial checks (--only spatial) under torchrun")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        pmesh.init_distributed(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                               int(env["WORLD_SIZE"]), int(env["RANK"]), dev, backend="gloo")
        pmesh.collective_barrier(dev)
    elif not pmesh.maybe_init_distributed(Config(), device=device):
        sys.exit("launch with torch.distributed.run (torchrun)")
    else:
        dev = pmesh.process_device(device)
    mesh = pmesh.make_mesh()
    out = {"world": mesh.size}
    try:
        if not args.cpu:
            out["card"] = cs.card_line() if mesh.rank == 0 else ""
        set_tf32_policy("f32")
        hw = QUICK_HW if args.quick and not args.cpu else None
        if args.only in (None, "fsdp"):
            out["fsdp_check"] = fsdp_check(args.cpu, mesh, dev, hw)
        if args.only in (None, "tensor"):
            out["tp_check"] = tp_check(args.cpu, dev, hw)
        if args.only in (None, "spatial"):
            out["spatial_check"] = [spatial_check(args.cpu, dev, s,
                                                  None if args.cpu else QUICK_HW)
                                    for s in _spatial_sizes(mesh.size)]
        if not args.quick:
            set_tf32_policy("bf16")
            if args.only in (None, "tensor"):
                out["serve"] = serve_check(dev)
            if not args.cpu:
                if args.only in (None, "fsdp"):
                    out["fsdp_timing"] = pmesh.gather_to_main([fsdp_timing(mesh, dev)], mesh)
                    torch.cuda.empty_cache()
                if args.only in (None, "tensor"):
                    out["tp_timing"] = pmesh.gather_to_main([tp_timing(dev)], mesh)
                    torch.cuda.empty_cache()
                if args.only in (None, "spatial"):
                    out["spatial_timing"] = pmesh.gather_to_main([spatial_timing(dev)], mesh)
        if mesh.rank == 0:
            print(json.dumps(out, default=str), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
