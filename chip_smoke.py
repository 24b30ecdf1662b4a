"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Builds the hand-written kernels from their source in the checkout.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it: the inference forward (A1), the
   residual-saving forward (A2) and the surrogate-BPTT backward (A3), the
   last also launched twice for bitwise-equal affine gradients.
3. Drives the serving path — the streaming detection service at full width
   (default Config: yolo11m, 480x640, s2d4 stem, ConvLSTM, bf16, seeded
   random weights) — through DetectionService: 3 streams x 3 frames
   micro-batched from threads, one 4-frame clip, and 4 sequential frames
   the clip is compared against. Kernel launch counts are zeroed just
   before and read just after, and must be 20 A1 launches per forward.
4. Checks the full-width detector against the same weights run on the CPU
   (plain LIF) on a small input, in fp32: the forward, and the loss with
   every parameter's gradient.
5. Drives the training path at the same full width — T=5, B=2 windows of
   seeded moving rectangles through make_step_fns -> train_loop for one
   short epoch with a validation step and a checkpoint that is read back.
   Counts are zeroed just before and read just after; every train step
   must launch A2 and A3 20 times each, every eval step A1 20 times.
6. Times each kernel beside its byte bound and its plain version (device
   time only; host enqueue is hidden and checked to be hidden), the
   serving step at B=1 and B=4 over several windows of 100 dispatches
   with the spread and the dispatching thread's CPU time, detect()
   latency over 300 requests, the device (kernel) time of a B=1 step
   from the profiler, and the train step (host clock, profiler kernel
   time with the A2/A3 shares, peak memory).

Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Any failure raises (non-zero
exit, no result line). Needs a CUDA card; there is no CPU path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
SLEEP_CYCLES_PER_S = 1.98e9  # H100 SXM top SM clock: a lower clock only sleeps longer
SERVE_WINDOWS, SERVE_PER_WINDOW = 3, 100  # serving dispatches timed per batch size
N_LATENCY = 300  # detect() requests timed through the service
N_PROFILED = 50  # B=1 dispatches under the profiler
T_CLIP = 4
T_TRAIN, B_TRAIN = 5, 2  # the training window: default seq_len, two samples
N_TRAIN_STEPS = 4  # train steps of the one epoch driven through train_loop
N_TIMED_STEPS = 6  # further train steps timed one by one
N_PROFILED_STEPS = 3  # train steps under the profiler
MAX_BOXES = 8  # label rows per sample (padded)
# v_final / readouts: the kernel uses the same rounded fp32 ops as the
# plain version, so they should agree exactly; the tolerances only admit
# one ulp of fp32 (v_final) and of bf16 (readouts, relative).
V_ATOL = 1e-5
READ_RTOL = 2 ** -7
# Spikes may differ only where the membrane sits this close to threshold.
SPIKE_EPS = 1e-5
# Backward: g_x / g_v0 are per-element rounded fp32 ops with an IEEE
# division, so they should equal the plain version bit for bit; the
# tolerances admit one ulp of bf16 (g_x, v_pre; relative) and of fp32
# (g_v0). da/db are sums over pixels taken in another order than
# torch.sum's: held to 1e-5 of the sum of the absolute terms (fp32
# summation error grows with that sum, not with the cancelled result).
GV_RTOL = 1e-6
SUM_RTOL = 1e-5
# Card (A2/A3 kernels, cuDNN/cuBLAS fp32 without TF32) vs CPU (plain
# versions) on one small window: the convs sum in another order (~1e-6
# relative), which moves membranes, GroupNorm statistics and hence
# gradients by a few times that (measured ~1e-5 per leaf) as long as no
# spike flips. Per leaf,
# |g_card - g_cpu|_2 <= GRAD_RTOL * |g_cpu|_2 + GRAD_ATOL * |g|_2 over all leaves.
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_ATTEMPTS = 5  # windows drawn until one has no card/CPU spike flip


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def near_threshold(x4, a, b, p, v0) -> torch.Tensor:
    """Mask of elements whose pre-reset membrane is within SPIKE_EPS of
    the threshold at any step (where a Heaviside may legitimately flip)."""
    t_steps, bsz = a.shape[:2]
    v, near = v0, torch.zeros_like(v0, dtype=torch.bool)
    for t in range(t_steps):
        cur = x4[t * bsz : (t + 1) * bsz].float() * a[t, :, None, None, :] + b[t, :, None, None, :]
        v_pre = p.decay * v + cur
        near |= (v_pre - p.threshold).abs() < SPIKE_EPS
        s = (v_pre >= p.threshold).float()
        v = v_pre - s * p.threshold if p.reset == "soft" else v_pre * (1 - s)
    return near.repeat(t_steps, 1, 1, 1)


def lif_inputs(shape_bhwc, t_steps, gen):
    bsz, h, w, c = shape_bhwc
    dev = "cuda"
    x4 = (torch.randn(t_steps * bsz, h, w, c, device=dev, generator=gen) * 1.2).to(torch.bfloat16)
    a = 1.0 + 0.3 * torch.randn(t_steps, bsz, c, device=dev, generator=gen)
    b = 0.2 * torch.randn(t_steps, bsz, c, device=dev, generator=gen)
    v0 = 0.3 * torch.randn(bsz, h, w, c, device=dev, generator=gen)
    return x4, a, b, v0


def lif_bytes(n_elem: int, t_steps: int, c: int, bsz: int, readouts: bool, itemsize=2) -> int:
    """Bytes the normalize+LIF function must move: x and s per step, the
    readouts per step when asked, v0 and v_final once, a and b once."""
    per_elem = (2 + int(readouts)) * itemsize * t_steps + 8
    return n_elem * per_elem + 2 * t_steps * bsz * c * 4


def time_cuda(fn, make_args, bytes_per_call: int, min_bytes: int = 128 << 20,
              max_copies: int = 100) -> float:
    """Mean device ms of fn(*args) by CUDA events over back-to-back
    launches that rotate through enough input copies (up to 128 MB, at
    least twice the 50 MB L2) that each launch reads its inputs from HBM,
    as the byte bound assumes.

    Host launch overhead is kept out of the time: a device sleep, sized
    from the measured host enqueue time of the same calls, runs before
    the start event, and the start event must still be pending when the
    host has enqueued the last call (else the device may have waited on
    the host inside the timed window). If it is not, the window is
    retried with a longer sleep and half the calls; after four tries the
    function raises rather than report a host-bound time."""
    n = max(2, min(max_copies, -(-min_bytes // bytes_per_call)))
    copies = [make_args() for _ in range(n)]
    for args in copies[:3]:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in copies:
        fn(*args)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_s = 2 * enqueue_s + 1e-3
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        start.record()
        for args in copies:
            fn(*args)
        end.record()
        covered = not start.query()  # the device was still asleep
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / len(copies)
        sleep_s *= 4
        copies = copies[: max(2, len(copies) // 2)]
    raise RuntimeError("host enqueue outran the device sleep in every timing window")


def host_windows(fn, n_windows: int, per_window: int) -> list[tuple[float, float]]:
    """Run fn per_window times in each of n_windows windows; per window,
    (wall ms per call, ms per call that the calling thread spent on the
    CPU). Wall minus thread CPU is time the thread waited: on the device
    (each call ends in a device-to-host copy) or for a core."""
    out = []
    for _ in range(n_windows):
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(per_window):
            fn()
        out.append(((time.perf_counter() - t0) * 1e3 / per_window,
                    (time.thread_time() - c0) * 1e3 / per_window))
    return out


def spread(xs) -> str:
    xs = np.asarray(xs, dtype=np.float64)
    return (f"median {np.median(xs):.3f}, min {xs.min():.3f}, max {xs.max():.3f}")


def lif_bytes_res(n_elem: int, t_steps: int, c: int, bsz: int, itemsize=2) -> int:
    """Bytes of the residual-saving forward: x read, s and v_pre written
    per step, v0 and v_final once, a and b once."""
    return n_elem * (3 * itemsize * t_steps + 8) + 2 * t_steps * bsz * c * 4


def lif_bytes_bwd(n_elem: int, t_steps: int, c: int, bsz: int, itemsize=2) -> int:
    """Bytes of the backward: v_pre, x, g_s read and g_x written per step,
    g_vfinal and g_v0 once, a read and da, db written once."""
    return n_elem * (4 * itemsize * t_steps + 8) + 3 * t_steps * bsz * c * 4


def bwd_inputs(K, shape_bhwc, t_steps, p, gen):
    """Inputs of the backward at one shape: the forward's residual and
    seeded cotangents. Returns (vpre, x, a, g_s, g_vfin)."""
    x4, a, b, v0 = lif_inputs(shape_bhwc, t_steps, gen)
    _, vpre, _ = K.affine_lif_fwd_res(x4, a, b, p, v0)
    g_s = torch.randn(x4.shape, device="cuda", generator=gen).to(torch.bfloat16)
    g_v = torch.randn(v0.shape, device="cuda", generator=gen)
    return vpre, x4, a, g_s, g_v


def check_training_kernels(K, lif_mod, lif_shapes, gen) -> dict:
    """A2 and A3 against their plain versions at every main-path shape,
    B=2, T=5, bf16, soft and hard reset, seeded cotangents. Raises on a
    disagreement; returns the largest absolute errors per kernel."""
    LIFParams = lif_mod.LIFParams
    errs = {"affine_lif_fwd_res": 0.0, "affine_lif_bwd": 0.0}
    exact = {"spikes": True, "v_final": True, "v_pre": True, "g_x": True, "g_v0": True}
    sum_rel = 0.0
    for name, (_, hh, ww, cc) in lif_shapes:
        for p in (LIFParams(), LIFParams(reset="hard")):
            tag = f"{name} {p.reset}"
            x4, a, b, v0 = lif_inputs((B_TRAIN, hh, ww, cc), T_TRAIN, gen)
            s, vpre, vfin = K.affine_lif_fwd_res(x4, a, b, p, v0)
            s_r, vfin_r, _, vpre_r = lif_mod.affine_lif_forward_reference(
                x4, a, b, p, v0, with_vpre=True)
            torch.cuda.synchronize()
            flips = s != s_r
            if (flips & ~near_threshold(x4, a, b, p, v0)).any():
                raise AssertionError(f"A2 {tag}: spikes differ away from threshold")
            v_err = (vfin - vfin_r).abs().max().item()
            if v_err > V_ATOL:
                raise AssertionError(f"A2 {tag}: v_final error {v_err}")
            vp, vp_r = vpre.float(), vpre_r.float()
            if ((vp - vp_r).abs() / vp_r.abs().clamp(min=1.0)).max().item() > READ_RTOL:
                raise AssertionError(f"A2 {tag}: v_pre differs by more than a bf16 ulp")
            errs["affine_lif_fwd_res"] = max(errs["affine_lif_fwd_res"], v_err,
                                             (vp - vp_r).abs().max().item())
            exact["spikes"] &= not bool(flips.any())
            exact["v_final"] &= torch.equal(vfin, vfin_r)
            exact["v_pre"] &= torch.equal(vpre, vpre_r)

            g_s = torch.randn(x4.shape, device="cuda", generator=gen).to(torch.bfloat16)
            g_v = torch.randn(v0.shape, device="cuda", generator=gen)
            g_x, g_a, g_b, g_v0 = K.affine_lif_bwd(vpre, x4, a, g_s, g_v, p)
            r_x, r_a, r_b, r_v0 = lif_mod.affine_lif_backward_reference(vpre, x4, a, g_s, g_v, p)
            again = K.affine_lif_bwd(vpre, x4, a, g_s, g_v, p)
            torch.cuda.synchronize()
            if not (torch.equal(again[1], g_a) and torch.equal(again[2], g_b)):
                raise AssertionError(f"A3 {tag}: two launches gave different da/db")
            gx, rx = g_x.float(), r_x.float()
            if ((gx - rx).abs() / rx.abs().clamp(min=1.0)).max().item() > READ_RTOL:
                raise AssertionError(f"A3 {tag}: g_x differs by more than a bf16 ulp")
            if ((g_v0 - r_v0).abs() / r_v0.abs().clamp(min=1.0)).max().item() > GV_RTOL:
                raise AssertionError(f"A3 {tag}: g_v0 error above {GV_RTOL}")
            # |terms| of the da/db sums: g_cur is g_x of a plain pass with a = 1, in fp32.
            g_cur = lif_mod.affine_lif_backward_reference(
                vpre.float(), x4.float(), torch.ones_like(a), g_s.float(), g_v, p
            )[0].view(T_TRAIN, B_TRAIN, hh, ww, cc)
            abs_b = g_cur.abs().sum((2, 3))
            abs_a = (g_cur * x4.float().view_as(g_cur)).abs().sum((2, 3))
            for nm, got, ref, terms in (("da", g_a, r_a, abs_a), ("db", g_b, r_b, abs_b)):
                rel = ((got - ref).abs() / (terms + 1e-30)).max().item()
                sum_rel = max(sum_rel, rel)
                if rel > SUM_RTOL:
                    raise AssertionError(f"A3 {tag}: {nm} error {rel} of the summed |terms|")
            errs["affine_lif_bwd"] = max(
                errs["affine_lif_bwd"], (gx - rx).abs().max().item(),
                (g_v0 - r_v0).abs().max().item(), (g_a - r_a).abs().max().item(),
                (g_b - r_b).abs().max().item())
            exact["g_x"] &= torch.equal(g_x, r_x)
            exact["g_v0"] &= torch.equal(g_v0, r_v0)
    print(f"training kernels ok: affine_lif_fwd_res and affine_lif_bwd vs plain at "
          f"{len(lif_shapes)} shapes x soft/hard (B={B_TRAIN} T={T_TRAIN} bf16): bit-equal "
          f"{exact}; max_abs_err {errs}; da/db worst error {sum_rel:.3g} of the summed "
          f"|terms| (limit {SUM_RTOL}); da/db bitwise equal across two launches")
    return errs


def moving_boxes_batch(rng, bsz, t_steps, h, w, num_classes, n_boxes=3,
                       size=(1 / 6, 1 / 3), speed=4) -> dict:
    """A window batch of bright rectangles drifting over noise, with their
    labels at the last frame: images (B, T, H, W, 3) uint8, labels
    (B, MAX_BOXES, 5) [class, cx, cy, w, h] normalized, label_mask. Box
    sides are drawn from ``size`` (fractions of the image side): the
    assigner only takes anchors whose initial boxes (about 120 px at
    stride 8) overlap a box enough, so a small image needs large boxes."""
    images = rng.randint(0, 48, size=(bsz, t_steps, h, w, 3)).astype(np.uint8)
    labels = np.zeros((bsz, MAX_BOXES, 5), np.float32)
    mask = np.zeros((bsz, MAX_BOXES), bool)
    for b in range(bsz):
        for k in range(n_boxes):
            bw = rng.randint(int(w * size[0]), int(w * size[1]))
            bh = rng.randint(int(h * size[0]), int(h * size[1]))
            x0 = rng.randint(0, w - bw - speed * t_steps)
            y0 = rng.randint(0, h - bh - speed * t_steps)
            color = rng.randint(128, 256, size=3)
            for t in range(t_steps):
                xs, ys = x0 + speed * t, y0 + speed * t
                images[b, t, ys : ys + bh, xs : xs + bw] = color
            labels[b, k] = [rng.randint(num_classes), (xs + bw / 2) / w, (ys + bh / 2) / h,
                            bw / w, bh / h]
            mask[b, k] = True
    return {"images": images, "labels": labels, "label_mask": mask}


def kernel_rows(prof):
    """The profiler's kernel rows only (an aten op's own device time
    repeats its kernels' time)."""
    cuda_type = torch.autograd.DeviceType.CUDA
    return [e for e in prof.key_averages() if e.device_type == cuda_type]


def run_training_slice(card, K, det, cfg, n_blocks, rng) -> dict:
    """The full-width training path through make_step_fns -> train_loop,
    with its assertions and timings. Returns the launch counts of the
    train_loop run."""
    from snn_object_detectionddp_tpu_torch.train.checkpoint import load_checkpoint
    from snn_object_detectionddp_tpu_torch.train.loop import train_loop
    from snn_object_detectionddp_tpu_torch.train.step import (
        init_state, make_optimizer, make_step_fns,
    )

    h, w = cfg.model.image_size
    tr = cfg.training
    params = det.init_params(torch.Generator().manual_seed(SEED + 1))
    total_steps = N_TRAIN_STEPS + N_TIMED_STEPS + N_PROFILED_STEPS
    tx, sched = make_optimizer(tr.learning_rate, total_steps, tr.weight_decay,
                               tr.grad_clip_norm, tr.pct_start)
    state = init_state(params, tx, sched)
    fns = make_step_fns(det, tx, sched)
    batch = lambda: moving_boxes_batch(rng, B_TRAIN, T_TRAIN, h, w, cfg.model.num_classes)  # noqa: E731
    train_batches = [batch() for _ in range(N_TRAIN_STEPS)]
    val_batches = [batch()]

    # Every parameter gets a finite gradient (one forward+backward outside
    # the counted run).
    grads, lc = fns.grads(params, train_batches[0])
    torch.cuda.synchronize()
    bad = [k for k, g in grads.items() if not torch.isfinite(g).all()]
    # A box branch whose scale was assigned no foreground anchor gets an
    # all-zero (still finite) gradient; such leaves are counted, not refused.
    nonzero = {k for k, g in grads.items() if g.any()}
    if bad or set(grads) != set(params):
        raise AssertionError(f"non-finite or missing gradients: {bad[:5]}")
    if len(nonzero) < 0.75 * len(grads):
        raise AssertionError(f"only {len(nonzero)} of {len(grads)} leaves got a non-zero gradient")
    if not lc.fg.item() > 0:
        raise AssertionError("TAL assigned no foreground anchor (fg == 0)")
    del grads
    before = {k: v.clone() for k, v in params.items()}

    per_step = {"train": [], "eval": []}
    metrics_seen = []

    def counted(kind, fn):
        def step(*args):
            c0 = dict(K.launch_counts)
            out = fn(*args)
            per_step[kind].append({k: K.launch_counts[k] - c0[k] for k in c0})
            metrics_seen.append((kind, out[1] if kind == "train" else out))
            return out
        return step

    counted_fns = fns._replace(train_step=counted("train", fns.train_step),
                               eval_step=counted("eval", fns.eval_step))
    cfg.training.epochs = 1
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as save_dir:
        K.reset_launch_counts()
        state = train_loop(state, counted_fns, sched, train_batches, val_batches, cfg,
                           save_dir, detector=det)
        torch.cuda.synchronize()
        launches = dict(K.launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        packed = load_checkpoint(os.path.join(save_dir, "latest.pt"), state, device="cuda")
        if not os.path.exists(os.path.join(save_dir, "best.pt")):
            raise AssertionError("train_loop wrote no best.pt")
        scalars = os.path.join(save_dir, "runs", "scalars.jsonl")
        rates = ([json.loads(l) for l in open(scalars) if "SpikeRates/" in l]
                 if os.path.exists(scalars) else None)
    want_train = {"affine_lif_fwd": 0, "affine_lif_fwd_res": n_blocks, "affine_lif_bwd": n_blocks}
    want_eval = {"affine_lif_fwd": n_blocks, "affine_lif_fwd_res": 0, "affine_lif_bwd": 0}
    if len(per_step["train"]) != N_TRAIN_STEPS or any(c != want_train for c in per_step["train"]):
        raise AssertionError(f"train steps launched {per_step['train']}, want {want_train} each")
    if len(per_step["eval"]) != 1 or per_step["eval"][0] != want_eval:
        raise AssertionError(f"eval steps launched {per_step['eval']}, want {want_eval}")
    losses = []
    for kind, m in metrics_seen:
        vals = {k: float(v) for k, v in m.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"non-finite {kind} metrics: {vals}")
        if not vals["fg"] > 0:
            raise AssertionError(f"{kind} step with no foreground anchor")
        losses.append((kind, vals))
    still = [k for k, v in state["params"].items() if torch.equal(before[k], v)]
    moved = len(before) - len(still)
    if nonzero & set(still):
        raise AssertionError(f"leaves with a gradient that did not move: {sorted(nonzero & set(still))[:5]}")
    del before
    # The checkpoint read back equals the state that was saved.
    rs = packed["state"]
    same = (rs["step"] == state["step"] == N_TRAIN_STEPS and rs["sched"] == state["sched"]
            and rs["opt_state"]["count"] == state["opt_state"]["count"] and packed["epoch"] == 0
            and all(torch.equal(rs["params"][k], v) for k, v in state["params"].items())
            and all(torch.equal(rs["opt_state"][m][k], v)
                    for m in ("mu", "nu") for k, v in state["opt_state"][m].items()))
    if not same:
        raise AssertionError("the reloaded checkpoint differs from the saved state")
    if rates is not None and len(rates) != n_blocks:
        raise AssertionError(f"expected {n_blocks} spike rates logged, found {len(rates)}")
    print(f"training slice ok: {N_TRAIN_STEPS} train steps + 1 eval step through train_loop "
          f"(B={B_TRAIN} T={T_TRAIN}); launches {launches} (per train step "
          f"{per_step['train'][0]}, per eval step {per_step['eval'][0]}); every leaf finite, "
          f"{len(nonzero)} of {len(state['params'])} with a non-zero gradient, {moved} moved; checkpoint round trip equal; loss trajectory: "
          + "; ".join(f"{kind} loss {v['loss']:.4f} box {v['box']:.4f} cls {v['cls']:.4f} "
                      f"dfl {v['dfl']:.4f} fg {v['fg']:.0f}"
                      + (f" grad_norm {v['grad_norm']:.3f} lr {v['lr']:.3g}" if kind == "train" else "")
                      for kind, v in losses))
    if rates:
        vals = [r["value"] for r in rates]
        print(f"spike rates on the validation batch: min {min(vals):.4f}, max {max(vals):.4f}")

    # -- timings of a train step ---------------------------------------------
    step_ms = []
    for i in range(N_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = fns.train_step(state, train_batches[i % N_TRAIN_STEPS])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    )
    with prof:
        for i in range(N_PROFILED_STEPS):
            state, _ = fns.train_step(state, train_batches[i % N_TRAIN_STEPS])
        torch.cuda.synchronize()
    evs = kernel_rows(prof)
    n = N_PROFILED_STEPS
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3 / n
    if dev_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    a2 = sum(e.self_device_time_total for e in evs if "affine_lif_fwd_kernel" in e.key) / 1e3 / n
    a3 = sum(e.self_device_time_total for e in evs if "affine_lif_bwd_kernel" in e.key) / 1e3 / n
    if a2 <= 0 or a3 <= 0:
        raise AssertionError("the profiler saw no A2 or A3 kernel in a train step")
    med = float(np.median(step_ms[1:]))
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    print(f"[{card}] train step B={B_TRAIN} T={T_TRAIN} (host clock, synchronised, "
          f"{N_TIMED_STEPS} steps after the loop's {N_TRAIN_STEPS}): ms/step "
          f"{spread(step_ms[1:])} (first {step_ms[0]:.3f}); profiler x{n}: device (kernel) "
          f"time {dev_ms:.3f} ms/step, busy {dev_ms / med:.1%} of the median step; "
          f"affine_lif_fwd_res {a2:.4f} ms/step ({a2 / dev_ms:.2%}), affine_lif_bwd "
          f"{a3:.4f} ms/step ({a3 / dev_ms:.2%}); {sum(e.count for e in evs) / n:.0f} "
          f"kernels/step; peak memory through train_loop {peak_gb:.2f} GiB; top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / n:.3f} ms" for e in top))
    return launches


def gradient_check(det_gpu, det_cpu, params, rng) -> None:
    """Loss and every parameter's gradient of the full-width detector in
    fp32 on one small window: the card (A2/A3 kernels) against the CPU
    (plain versions). A spike that flips between the two (a membrane
    within conv rounding of the threshold) makes them different functions
    downstream, so a window with a flip is reported and another is drawn;
    the comparison is made on the first window without one."""
    from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock
    from snn_object_detectionddp_tpu_torch.train.step import make_optimizer, make_step_fns

    tx, sched = make_optimizer(1e-4, 10)
    fns_gpu, fns_cpu = make_step_fns(det_gpu, tx, sched), make_step_fns(det_cpu, tx, sched)
    params_cpu = {k: v.cpu() for k, v in params.items()}
    spikes = {}
    hooks = [
        m.register_forward_hook(
            lambda mod, inp, out, key=(tag, name): spikes.__setitem__(key, out[0].detach().cpu()))
        for tag, det in (("card", det_gpu), ("cpu", det_cpu))
        for name, m in det.module.named_modules() if isinstance(m, SpikingConvBlock)
    ]
    try:
        for attempt in range(GRAD_ATTEMPTS):
            batch = moving_boxes_batch(rng, 2, 2, 64, 96, det_gpu.cfg.model.num_classes,
                                       n_boxes=2, size=(1 / 2, 3 / 4), speed=2)
            g_gpu, lc_gpu = fns_gpu.grads(params, batch)
            g_cpu, lc_cpu = fns_cpu.grads(params_cpu, batch)
            flips = sum(int((spikes[("card", n)] != s).sum())
                        for (tag, n), s in spikes.items() if tag == "cpu")
            if flips == 0:
                break
            print(f"gradient check window {attempt}: {flips} spikes differ between card and "
                  f"CPU (loss {lc_gpu.total.item():.6f} vs {lc_cpu.total.item():.6f}); drawing another")
        else:
            raise AssertionError(f"every one of {GRAD_ATTEMPTS} windows had a spike flip")
    finally:
        for hk in hooks:
            hk.remove()
    loss_rel = abs(lc_gpu.total.item() - lc_cpu.total.item()) / abs(lc_cpu.total.item())
    total = float(torch.sqrt(sum(g.double().pow(2).sum() for g in g_cpu.values())))
    worst, worst_name, worst_rel = 0.0, "", 0.0
    for k, gc in g_cpu.items():
        gg = g_gpu[k].cpu()
        if not torch.isfinite(gg).all():
            raise AssertionError(f"non-finite gradient on the card: {k}")
        err, norm = float((gg - gc).double().norm()), float(gc.double().norm())
        worst_rel = max(worst_rel, err / max(norm, 1e-30))
        allowed = GRAD_RTOL * norm + GRAD_ATOL * total
        if err / allowed > worst:
            worst, worst_name = err / allowed, k
    print(f"card vs CPU gradients (fp32, 64x96, T=2, B=2, {len(g_cpu)} leaves, window "
          f"{attempt}, no spike flipped): loss {lc_gpu.total.item():.6f} vs "
          f"{lc_cpu.total.item():.6f} (rel {loss_rel:.3g}, fg {lc_gpu.fg.item():.0f}/"
          f"{lc_cpu.fg.item():.0f}); global grad norm {total:.4f}; worst leaf relative error "
          f"{worst_rel:.3g}; worst leaf at {worst:.3g} of its allowance (rtol {GRAD_RTOL}, atol "
          f"{GRAD_ATOL} of the global norm): {worst_name}")
    if loss_rel > LOSS_RTOL or worst > 1.0 or not lc_cpu.fg.item() > 0:
        raise AssertionError("card loss or gradients disagree with the CPU reference")


def time_training_kernels(card, K, lif_mod, lif_shapes, gen) -> dict:
    """A2 and A3 per launch at the 20 shapes (B=2, T=5, bf16) beside their
    byte bounds and plain versions; returns the sums per train step."""
    p = lif_mod.LIFParams()
    sums = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
            for k in ("affine_lif_fwd_res", "affine_lif_bwd")}
    for name, (_, hh, ww, cc) in lif_shapes:
        n = B_TRAIN * hh * ww * cc
        shp = (B_TRAIN, hh, ww, cc)
        fwd_bytes = lif_bytes_res(n, T_TRAIN, cc, B_TRAIN)
        bwd_bytes = lif_bytes_bwd(n, T_TRAIN, cc, B_TRAIN)
        make_f = lambda: lif_inputs(shp, T_TRAIN, gen)  # noqa: E731
        make_b = lambda: bwd_inputs(K, shp, T_TRAIN, p, gen)  # noqa: E731
        rows = (
            ("affine_lif_fwd_res", fwd_bytes, 10, make_f,
             lambda *t: K.affine_lif_fwd_res(*t[:3], p, t[3]),
             lambda *t: lif_mod.affine_lif_forward_reference(*t[:3], p, t[3], with_vpre=True)),
            ("affine_lif_bwd", bwd_bytes, 25, make_b,
             lambda *t: K.affine_lif_bwd(*t, p),
             lambda *t: lif_mod.affine_lif_backward_reference(*t, p)),
        )
        for kname, nbytes, flops, make, kern, plain in rows:
            km = time_cuda(kern, make, nbytes)
            pm = time_cuda(plain, make, nbytes)
            bm = max(nbytes / HBM_BYTES_PER_S, flops * n * T_TRAIN / FP32_FLOPS) * 1e3
            sums[kname]["ms"] += km
            sums[kname]["plain_ms"] += pm
            sums[kname]["bound_ms"] += bm
            print(f"[{card}] {kname} {name} B={B_TRAIN} T={T_TRAIN} {(hh, ww, cc)}: "
                  f"{km * 1e3:.2f} us (bound {bm * 1e3:.2f} us, {bm / km:.0%} of bound; "
                  f"plain {pm * 1e3:.2f} us)")
    for kname, v in sums.items():
        print(f"[{card}] {kname} one train step (20 blocks, B={B_TRAIN} T={T_TRAIN} bf16): "
              f"kernel {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms, plain {v['plain_ms']:.4f} ms")
    return sums


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is False)")
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock
    from snn_object_detectionddp_tpu_torch.models import lif as lif_mod
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams, affine_lif_tb_reference
    from snn_object_detectionddp_tpu_torch.serve import DetectionService

    # fp32 reference checks below need true fp32 convs and matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    dev_name = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")

    # -- build the kernel from its source ----------------------------------
    t0 = time.perf_counter()
    K.build()
    print(f"built {', '.join(K.KERNELS)} in {time.perf_counter() - t0:.1f} s")

    # -- the main path's model, and the LIF shapes it runs -----------------
    cfg = Config()  # yolo11m, 480x640, s2d4, ConvLSTM, bf16
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device="cuda")
    params = det.init_params(torch.Generator().manual_seed(SEED))
    n_params = sum(v.numel() for v in params.values())
    lif_shapes = []  # (name, (B, H, W, C)) of every spiking block, in order
    hooks = [
        m.register_forward_hook(
            lambda mod, inp, out, name=name: lif_shapes.append((name, tuple(out[1].shape)))
        )
        for name, m in det.module.named_modules() if isinstance(m, SpikingConvBlock)
    ]
    rng = np.random.RandomState(SEED)
    probe = torch.from_numpy(rng.rand(1, 1, h, w, 3).astype(np.float32)).to("cuda", torch.bfloat16)
    det.apply(params, probe)
    for hk in hooks:
        hk.remove()
    n_blocks = len(lif_shapes)
    lif_elems = sum(int(np.prod(s[1:])) for _, s in lif_shapes)
    print(f"model: {cfg.model.yolo_model_name} {h}x{w} stem {cfg.model.stem} "
          f"{cfg.model.bottleneck} {cfg.runtime.precision}, {n_params / 1e6:.1f}M params, "
          f"{n_blocks} spiking blocks, {lif_elems} LIF elements per frame per step")
    if n_blocks != 20:
        raise AssertionError(f"expected 20 spiking blocks on the main path, found {n_blocks}")

    # -- phase 1: kernel vs plain version at the 20 main-path shapes --------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err, n_flips, n_near, n_checked = 0.0, 0, 0, 0
    cases = [(1, False, LIFParams())] + [
        (T_CLIP, True, LIFParams(reset=r)) for r in ("soft", "hard")
    ]
    for name, (_, hh, ww, cc) in lif_shapes:
        for t_steps, readouts, p in cases:
            x4, a, b, v0 = lif_inputs((2, hh, ww, cc), t_steps, gen)
            got = K.affine_lif_fwd(x4, a, b, p, v0, readouts)
            ref = affine_lif_tb_reference(x4, a, b, p, v0, readouts)
            torch.cuda.synchronize()
            near = near_threshold(x4, a, b, p, v0)
            flips = got[0] != ref[0]
            if (flips & ~near).any():
                raise AssertionError(f"{name} T={t_steps} {p.reset}: spikes differ away from threshold")
            n_flips += int(flips.sum())
            n_near += int(near.sum())
            n_checked += flips.numel()
            v_err = (got[1] - ref[1]).abs().max().item()
            if v_err > V_ATOL:
                raise AssertionError(f"{name}: v_final error {v_err}")
            max_err = max(max_err, v_err)
            if readouts:
                r_err = ((got[2].float() - ref[2].float()).abs()
                         / ref[2].float().abs().clamp(min=1.0)).max().item()
                if r_err > READ_RTOL:
                    raise AssertionError(f"{name}: readout error {r_err}")
                max_err = max(max_err, (got[2].float() - ref[2].float()).abs().max().item())
    print(f"phase 1 ok: affine_lif_fwd vs plain at {n_blocks} shapes x {len(cases)} cases "
          f"(B=2 bf16; T=1, T={T_CLIP}+readouts soft/hard): max_abs_err {max_err}, "
          f"spike flips {n_flips} of {n_checked} (near-threshold |v_pre-theta|<{SPIKE_EPS}: {n_near})")

    train_errs = check_training_kernels(K, lif_mod, lif_shapes, gen)

    # -- phase 2: the full-width serving slice -----------------------------
    svc = DetectionService(det, params, conf=0.0, max_det=100, max_batch=4,
                           max_clip=T_CLIP).start()
    try:
        svc.warmup()
        torch.cuda.synchronize()
        forwards = [0]
        fwd_hook = det.module.register_forward_hook(
            lambda *a: forwards.__setitem__(0, forwards[0] + 1)
        )
        frame = lambda: rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
        streams = {f"cam{i}": [frame() for _ in range(3)] for i in range(3)}
        clip = np.stack([frame() for _ in range(T_CLIP)])
        replies: dict = {}

        def client(sid):
            replies[sid] = [svc.detect(sid, f) for f in streams[sid]]

        K.reset_launch_counts()
        threads = [threading.Thread(target=client, args=(sid,)) for sid in streams]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
            if th.is_alive():
                raise AssertionError("client thread hung")
        clip_out = svc.detect_clip("clip", clip)
        seq_out = [svc.detect("clip_seq", clip[i]) for i in range(T_CLIP)]
        torch.cuda.synchronize()
        launches = {"affine_lif_fwd": K.launch_counts["affine_lif_fwd"]}
        n_fwd = forwards[0]
        fwd_hook.remove()
        batches = sorted(r["batch"] for rs in replies.values() for r in rs)
        print(f"phase 2: {sum(len(v) for v in replies.values())} stream requests in batches "
              f"{batches}, clip chunks {clip_out['chunks']}; {n_fwd} forwards, "
              f"affine_lif_fwd launches {launches['affine_lif_fwd']}")
        if (launches["affine_lif_fwd"] != n_blocks * n_fwd or n_fwd == 0
                or K.launch_counts["affine_lif_fwd_res"] or K.launch_counts["affine_lif_bwd"]):
            raise AssertionError(f"expected {n_blocks} launches per forward, got "
                                 f"{launches['affine_lif_fwd']} over {n_fwd} forwards")
        for sid, rs in replies.items():
            for r in rs:
                if not (np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()):
                    raise AssertionError(f"{sid}: non-finite detections")
                if len(r["scores"]) == 0:
                    raise AssertionError(f"{sid}: no detections at conf 0")
        # Clip (4 frames in one all_steps forward) vs 4 sequential T=1
        # steps: same math, but bf16 convs over a different batch may round
        # differently and flip knife-edge spikes, so compare each frame's
        # sorted scores with a tolerance rather than bit-exactly.
        clip_diffs = []
        for i, (a_, b_) in enumerate(zip(clip_out["frames"], seq_out)):
            sa, sb = np.sort(a_["scores"]), np.sort(b_["scores"])
            if len(sa) != len(sb):
                raise AssertionError(f"clip frame {i}: {len(sa)} vs {len(sb)} detections")
            clip_diffs.append(float(np.abs(sa - sb).max()) if len(sa) else 0.0)
        print(f"clip vs sequential: per-frame max |sorted score diff| {clip_diffs}")
        if max(clip_diffs) > 1e-2:
            raise AssertionError("clip detections disagree with sequential frames")
        # reset drops the stream's state.
        n_before = svc.num_streams
        svc.reset("clip")
        if svc.num_streams != n_before - 1:
            raise AssertionError("reset did not drop the stream's state")

        # -- reference check: card vs CPU on a small input, fp32 -----------
        cfg32 = Config()
        cfg32.runtime.precision = "f32"
        det_gpu = Detector.from_config(cfg32, device="cuda")
        det_cpu = Detector.from_config(cfg32, device="cpu")
        params_cpu = {k: v.cpu() for k, v in params.items()}
        small = rng.rand(2, 1, 64, 96, 3).astype(np.float32)
        raw_g, st_g = det_gpu.apply(params, torch.from_numpy(small).cuda())
        raw_c, st_c = det_cpu.apply(params_cpu, torch.from_numpy(small))
        ref_errs = []
        for g_, c_ in zip(raw_g, raw_c):
            g_, c_ = g_.cpu(), c_
            if not torch.isfinite(g_).all():
                raise AssertionError("non-finite raw maps on the card")
            ref_errs.append(((g_ - c_).abs().max() / c_.abs().max()).item())
        v_g, v_c = st_g["backbone"]["stem2"].cpu(), st_c["backbone"]["stem2"]
        print(f"card vs CPU (fp32, 64x96, T=2): raw-map max rel err {ref_errs}, "
              f"stem2 v_final max err {(v_g - v_c).abs().max().item():.3g}")
        if max(ref_errs) > 1e-2:
            raise AssertionError("card output disagrees with the CPU reference")
        gradient_check(det_gpu, det_cpu, params, rng)

        # -- phase 3: timings ----------------------------------------------
        rows, k_ms, p_ms, bound_ms = [], 0.0, 0.0, 0.0
        p = LIFParams()
        for name, (_, hh, ww, cc) in lif_shapes:
            nbytes = lif_bytes(hh * ww * cc, 1, cc, 1, False)
            make = lambda: lif_inputs((1, hh, ww, cc), 1, gen)  # noqa: E731
            km = time_cuda(lambda *t: K.affine_lif_fwd(*t[:3], p, t[3]), make, nbytes)
            pm = time_cuda(lambda *t: affine_lif_tb_reference(*t[:3], p, t[3]), make, nbytes)
            bm = max(nbytes / HBM_BYTES_PER_S, 10 * hh * ww * cc / FP32_FLOPS) * 1e3
            rows.append((name, (hh, ww, cc), km, pm, bm))
            k_ms, p_ms, bound_ms = k_ms + km, p_ms + pm, bound_ms + bm
        for name, shp, km, pm, bm in rows:
            print(f"[{card}] affine_lif_fwd {name} B=1 T=1 {shp}: {km * 1e3:.2f} us "
                  f"(bound {bm * 1e3:.2f} us, {bm / km:.0%} of bound; plain {pm * 1e3:.2f} us)")
        print(f"[{card}] affine_lif_fwd one frame (20 blocks, B=1 T=1 bf16): kernel {k_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({lif_bytes(lif_elems, 1, 0, 0, False) / 1e6:.1f} MB), "
              f"plain {p_ms:.4f} ms")

        serve_ms = {}
        for k in (1, 4):
            imgs = np.stack([frame() for _ in range(k)])
            states = tuple([svc._zero_state1] * k)
            for _ in range(5):
                svc._predict(imgs, states)
            torch.cuda.synchronize()
            wins = host_windows(lambda: svc._predict(imgs, states), SERVE_WINDOWS, SERVE_PER_WINDOW)
            walls = [w_ for w_, _ in wins]
            serve_ms[k] = float(np.median(walls))
            print(f"[{card}] serving step B={k} ({SERVE_WINDOWS} windows x {SERVE_PER_WINDOW} "
                  f"dispatches, host clock, forward+decode+NMS): ms/dispatch {spread(walls)}; "
                  f"ms/frame median {serve_ms[k] / k:.3f}; dispatching thread on CPU "
                  f"{spread([c for _, c in wins])} ms/dispatch; per window (wall, cpu): "
                  + ", ".join(f"({w_:.3f}, {c:.3f})" for w_, c in wins))
        lat = []
        for _ in range(N_LATENCY):
            t0 = time.perf_counter()
            svc.detect("latency", frame())
            lat.append((time.perf_counter() - t0) * 1e3)
        lat = np.asarray(lat)
        print(f"[{card}] detect() latency B=1 through the service ({N_LATENCY} requests): "
              f"p50 {np.percentile(lat, 50):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms, "
              f"p99 {np.percentile(lat, 99):.3f} ms, min {lat.min():.3f} ms, max {lat.max():.3f} ms")
        print(f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} usable by this "
              f"process, load average {os.getloadavg()}")

        # Device time per B=1 step from the profiler's kernel events only
        # (an aten op's own device time repeats its kernels' time).
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        )
        imgs = np.stack([frame()])
        with prof:
            t0 = time.perf_counter()
            for _ in range(N_PROFILED):
                svc._predict(imgs, (svc._zero_state1,))
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / N_PROFILED
        evs = kernel_rows(prof)
        dev_ms = sum(e.self_device_time_total for e in evs) / 1e3 / N_PROFILED
        if dev_ms <= 0:
            raise AssertionError("the profiler recorded no device time")
        lif_ms = sum(e.self_device_time_total for e in evs if "affine_lif" in e.key) / 1e3 / N_PROFILED
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
        print(f"[{card}] profile B=1 x{N_PROFILED}: device (kernel) time {dev_ms:.3f} ms/step, "
              f"busy {dev_ms / serve_ms[1]:.1%} of the unprofiled median step "
              f"({serve_ms[1]:.3f} ms; {prof_wall:.3f} ms/step under the profiler), "
              f"affine_lif_fwd {lif_ms:.4f} ms/step ({lif_ms / dev_ms:.1%}); "
              f"{sum(e.count for e in evs) / N_PROFILED:.0f} kernels/step; top: " + "; ".join(
                  f"{e.key[:48]} {e.self_device_time_total / 1e3 / N_PROFILED:.3f} ms" for e in top))
    finally:
        svc.stop()
    del svc, params

    # -- phase 4: the full-width training slice ----------------------------
    launches.update({k: v for k, v in run_training_slice(card, K, det, cfg, n_blocks, rng).items()
                     if k != "affine_lif_fwd"})
    train_ms = time_training_kernels(card, K, lif_mod, lif_shapes, gen)

    pallas = "snn_object_detectionddp_tpu/kernels/affine_lif_pallas.py"
    measured = {
        "affine_lif_fwd": (93, max_err, {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms}),
        "affine_lif_fwd_res": (107, train_errs["affine_lif_fwd_res"], train_ms["affine_lif_fwd_res"]),
        "affine_lif_bwd": (198, train_errs["affine_lif_bwd"], train_ms["affine_lif_bwd"]),
    }
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "snn_object_detectionddp_tpu_torch/csrc/affine_lif.cu",
        "replaces": f"{pallas}:{line}",
        "launches": launches[name],
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    } for name, (line, err, t) in measured.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
