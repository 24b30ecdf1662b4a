"""The port's data-parallel train step across processes: against one
process on the concatenated batch, and timed.

    python -m torch.distributed.run --standalone --nproc_per_node 4 scripts/torch_dp_cards.py
    python -m torch.distributed.run --standalone --nproc_per_node 4 scripts/torch_dp_cards.py --cpu

One process per card (NCCL), or with ``--cpu`` per CPU process (gloo, the
tiny fp32 model of the tests, 64x64). Every process builds the model from
one seed, draws the same global batch (``world x 2`` windows of T=5 moving
rectangles), takes its own rows and runs one DP step
(``make_step_fns(mesh=make_mesh())``). Rank 0 then runs the library step
on the whole batch from the same parameters, alone, and compares:

- the check runs in fp32 (TF32 off): loss and components within
  ``LOSS_RTOL``; the first moments after the step (0.1 x the clipped
  gradient) per leaf within ``GRAD_RTOL`` of the leaf's norm plus
  ``GRAD_ATOL`` of the global norm. The processes sum the batch in
  ``world`` parts and the convs of a batch of 2 and of ``2 x world`` may
  be blocked differently (~1e-6 relative), so the tolerances are those
  chip_smoke.py holds card-vs-CPU gradients to. A spike within rounding of
  the threshold can flip between the two and make them different
  functions: each block's spike count per sample is compared, and a batch
  with a flip is redrawn (up to ``ATTEMPTS``).
- on the card, the default model in bf16 at full width (yolo11m,
  480x640): the DP step's host ms (synchronised, median of ``N_TIMED``
  after a warm-up step) and the gradient all-reduce's device time
  (``all_reduce_grads``, host enqueue hidden) beside its bound, with the
  card's name and power limit.

Rank 0 prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from snn_object_detectionddp_tpu_torch.config import Config  # noqa: E402
from snn_object_detectionddp_tpu_torch.models.detector import Detector  # noqa: E402
from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock  # noqa: E402
from snn_object_detectionddp_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from snn_object_detectionddp_tpu_torch.train.step import (  # noqa: E402
    init_state,
    make_optimizer,
    make_step_fns,
)

B_LOCAL, T = 2, 5
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
ATTEMPTS = 4
N_TIMED = 5
SEED = 0


def _cfg(cpu: bool, precision: str) -> Config:
    cfg = Config()  # yolo11m, 480x640, s2d4, ConvLSTM
    cfg.runtime.precision = precision
    if cpu:
        cfg.model.num_classes, cfg.model.yolo_model_name = 3, "yolo11n.pt"
        cfg.model.width_mult, cfg.model.hyp.reg_max = 0.25, 8
        cfg.model.image_size = (64, 64)
    return cfg


def _rows(batch: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in batch.items()}


def _spike_counts(det, fns, params, batch):
    """((blocks, B) spike counts of each sample, gradients, loss) of one
    forward+backward."""
    counts = []
    hooks = [m.register_forward_hook(
        lambda mod, i, o: counts.append(  # spikes (T, B, H, W, C) -> (B,)
            o[0].detach().float().flatten(2).sum((0, 2))))
             for m in det.module.modules() if isinstance(m, SpikingConvBlock)]
    try:
        grads, lc = fns.grads(params, batch)
    finally:
        for h in hooks:
            h.remove()
    return torch.stack(counts).cpu(), grads, lc


def check(cpu: bool, mesh, dev) -> dict:
    cfg = _cfg(cpu, "f32")
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device=dev)
    params = det.init_params(torch.Generator().manual_seed(SEED))
    tx, sched = make_optimizer(1e-3, 10)
    dp = make_step_fns(det, tx, sched, mesh=mesh)
    n = mesh.size
    rng = np.random.RandomState(SEED)
    for attempt in range(ATTEMPTS):
        size = (1 / 2, 3 / 4) if cpu else (1 / 6, 1 / 3)
        batch = cs.moving_boxes_batch(rng, B_LOCAL * n, T, h, w, cfg.model.num_classes,
                                      size=size, speed=2 if cpu else 4)
        mine = _rows(batch, mesh.rank * B_LOCAL, (mesh.rank + 1) * B_LOCAL)
        counts, _, _ = _spike_counts(det, dp, params, mine)
        state, m_dp = dp.train_step(init_state({k: v.clone() for k, v in params.items()}, tx,
                                               sched), mine)
        m_dp = {k: float(v) for k, v in m_dp.items()}
        everyone = pmesh.gather_to_main([counts], mesh)
        ok = torch.zeros(1, device=dev)
        result = {}
        if mesh.rank == 0:
            library = make_step_fns(det, tx, sched)
            ref_counts, _, _ = _spike_counts(det, library, params, batch)
            flips = int((torch.cat(everyone, dim=1) != ref_counts).sum())
            ref, m_lib = library.train_step(init_state({k: v.clone() for k, v in params.items()},
                                                       tx, sched), batch)
            m_lib = {k: float(v) for k, v in m_lib.items()}
            mu_dp, mu_lib = state["opt_state"]["mu"], ref["opt_state"]["mu"]
            total = float(torch.sqrt(sum(v.double().pow(2).sum() for v in mu_lib.values())))
            worst, worst_name = 0.0, ""
            for k, v in mu_lib.items():
                err = float((mu_dp[k] - v).double().norm())
                allowed = GRAD_RTOL * float(v.double().norm()) + GRAD_ATOL * total
                if err / allowed > worst:
                    worst, worst_name = err / allowed, k
            loss_rel = {k: abs(m_dp[k] - m_lib[k]) / max(abs(m_lib[k]), 1e-30)
                        for k in ("loss", "box", "cls", "dfl", "grad_norm")}
            result = dict(attempt=attempt, spike_count_diffs=flips, dp=m_dp, library=m_lib,
                          rel_err=loss_rel, worst_leaf=worst_name, worst_of_allowance=worst,
                          leaves=len(mu_lib))
            ok[0] = float(flips == 0)
        torch.distributed.broadcast(ok, 0)
        if ok.item():
            if mesh.rank == 0:
                if max(loss_rel[k] for k in ("loss", "box", "cls", "dfl")) > LOSS_RTOL or worst > 1:
                    raise AssertionError(f"DP step disagrees with one process: {result}")
                if m_dp["fg"] != m_lib["fg"] or not m_dp["fg"] > 0:
                    raise AssertionError(f"foreground anchors differ or none: {result}")
            return result
        if mesh.rank == 0:
            print(f"batch {attempt}: {result['spike_count_diffs']} per-sample spike counts differ "
                  "between the processes' rows and the whole batch; drawing another", flush=True)
    raise AssertionError(f"every one of {ATTEMPTS} batches had a spike flip")


def timing(mesh, dev, card: str) -> dict:
    cfg = _cfg(False, "bf16")
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device=dev)
    params = det.init_params(torch.Generator().manual_seed(SEED))
    tx, sched = make_optimizer(1e-4, 100)
    dp = make_step_fns(det, tx, sched, mesh=mesh)
    state = init_state(params, tx, sched)
    rng = np.random.RandomState(SEED + 1)
    batch = cs.moving_boxes_batch(rng, B_LOCAL * mesh.size, T, h, w, cfg.model.num_classes)
    mine = _rows(batch, mesh.rank * B_LOCAL, (mesh.rank + 1) * B_LOCAL)
    step_ms = []
    for _ in range(N_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = dp.train_step(state, mine)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    grads = {k: torch.randn_like(v) for k, v in state["params"].items()}
    n_bytes = 4 * sum(g.numel() for g in grads.values())
    ar_ms = cs.time_cuda(lambda: pmesh.all_reduce_grads(grads, mesh), tuple,
                         bytes_per_call=2 * n_bytes, min_bytes=20 * 2 * n_bytes)
    # A ring all-reduce sends and receives 2 (n-1)/n of the buffer a card;
    # with the flatten's read and write of HBM.
    link = 2 * (mesh.size - 1) / mesh.size * n_bytes
    return dict(card=card, world=mesh.size, step_ms=step_ms[1:], step_ms_median=float(
        np.median(step_ms[1:])), allreduce_ms=ar_ms, grad_bytes=n_bytes,
        hbm_bound_ms=2 * n_bytes / cs.HBM_BYTES_PER_S * 1e3, ring_bytes_per_card=link)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU, the tiny fp32 model")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        sys.exit("torch_dp_cards.py needs CUDA cards (or --cpu)")
    if not args.cpu:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if args.cpu else "cuda"
    if not pmesh.maybe_init_distributed(Config(), device=device):
        sys.exit("launch with torch.distributed.run (torchrun)")
    dev = pmesh.process_device(device)
    mesh = pmesh.make_mesh()
    try:
        out = {"check": check(args.cpu, mesh, dev)}
        if not args.cpu:
            card = cs.card_line() if mesh.rank == 0 else ""
            t = timing(mesh, dev, card)
            out["timing"] = pmesh.gather_to_main([t], mesh)
        if mesh.rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
