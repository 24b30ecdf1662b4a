"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Builds the hand-written kernels and the host PNG decoder from
   their sources in the checkout (one compiler process per source, nvcc
   or the host C++ compiler, started together).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it: the normalize+LIF inference forward
   (A1) at every (T, B) the paths launch it with (a served frame, a
   micro-batch of 4, a clip with readouts, the evaluation window, the
   visualization batch at T=seq_len B=8: its launch plan depends on B)
   and at the 20 shapes of the tracker's crop window (240x320, T=1 B=1),
   the last two bit for bit, residual-saving forward (A2) and
   surrogate-BPTT backward (A3), the last also launched twice for
   bitwise-equal affine gradients, the second time under an operator log
   that must show allocations only (the affine gradients are added up
   inside the one launch, with no fold in the wrapper); and the
   plain LIF scan's forward (B1), residual-saving forward (B2) and
   backward (B3) at the same 20 shapes taken as (T, B*H*W*C), plus odd
   sizes, every output bit for bit; and the token-LSTM scan's forward
   (C1), residual-saving forward (C2) and reverse scan (C3) at hidden 1024
   (the training window T=5 B=16 at 8x10, a served frame at B=1 and 16)
   and at two batch tiles of odd sizes, cell by cell against their plain
   versions within tests/test_torch_token_lstm_kernel.py's limits, with
   its planted faults outside them and two launches bit for bit.
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
6. Drives the run_lif path at full width: conv -> GroupNorm -> run_lif at
   the stem geometry (T=5, B=2, fp32) against the SpikingConvBlock with
   the same weights, forward and one backward, with the launch counts
   zeroed before and read after (one B1 without a gradient, one B2 and
   one B3 with).
7. Drives evaluation at full width: seeded T=5, B=2 batches through
   make_predict_fn (conf 0.001, pool 30000: the greedy NMS path) and
   evaluate_batches into DetMetrics; the greedy NMS on the card against
   the CPU on the same candidates; a small fp32 input card against CPU.
8. Serves the full-width token-LSTM-bottleneck model (hidden 1024, 80
   tokens) to two streams through DetectionService, against the same
   streams served alone: one C1 launch a forward and no plain scan; then
   trains it for 3 steps (T=5, B=2): one C2 and one C3 launch a step.
9. Times each kernel beside its byte bound and its plain version (device
   time only; host enqueue is hidden and checked to be hidden): A1 per
   served frame (T=1, B=1) beside the cost of 20 launches of a kernel that
   does nothing, and at T=5, B=2 as evaluation launches it; A2 and A3 per
   train step with the blocks each shape launches; B1-B3. Also the
   serving step at B=1 and B=4 over several windows of 100 dispatches
   with the spread and the dispatching thread's CPU time, detect()
   latency over 300 requests, the device (kernel) time of a B=1 step
   from the profiler, the train step (host clock, profiler kernel
   time with the A2/A3 shares, peak memory), an evaluation batch split
   into model and NMS, and a frame of the token-LSTM model; C1-C3 at the
   training window and the served shapes beside their bound and their
   plain versions' device time, and the token-LSTM bottleneck's device
   time a training window (forward and backward) with the kernels and with
   the plain loop.
10. Drives the data pipeline and the two command lines at the same full
   width: a DSEC-shaped tree written by the port's generator (3 sequences
   x 9 frames, 480x640), read_rgb (the C++ decoder, csrc/png_decode.cpp)
   against decode_png_reference (Python, zlib, numpy) on every frame and
   one frame in each of the 5 filter types; the loader alone in turns
   (pool, native, native, pool) at 1 and 4 threads, every native batch
   (the loader's one path: one decode_batch call for all B*T frames)
   byte-equal to those of the earlier loader, read_rgb mapped over the
   samples on a thread pool (here only, as the figure before);
   main.train_code for one epoch in turns with each (B=2, 4 decode
   threads), resumed for a second epoch and eval_2.evaluate on best.pt;
   counts zeroed before and read after each run: 20 A2 + 20 A3 a train
   step, 20 A1 a validation step and for the spike-rate pass, 20 A1 an
   evaluation batch, and the decode_batch calls of each path. Times
   read_rgb of one frame, the loader alone, the CLI's host ms per train
   step with each path beside phase 4's step, its device-busy share, and
   the train step alone and beside a decoding loader of each path.
11. Drives data parallelism over torch.distributed at the same full width:
   the DP step (make_step_fns(mesh=make_mesh())) over a one-rank NCCL
   group against the library step on the same batches from cloned states,
   bit for bit (losses, parameters, moments), with 20 A2 + 20 A3 launches
   a DP step, the gradient all-reduce's device time beside its byte bound
   and peak memory against the library step; then the training command
   line through torchrun (one process, NCCL) for an epoch on the data
   phase's tree with the config read without PyYAML (the child's import
   log names no yaml module), rank 0 writing the checkpoints; then serve()
   of that best.pt on a free port, whose HTTP replies to a PNG of the
   served size and one of another size must equal DetectionService.detect
   of the same decoded and resized frames.
12. Drives the hard synthetic fixture and its checkpoint: writes the nano
   tree (128x160, 86 sequences x 16 frames) with the port's generator
   (data/fixtures.py, cv2's primitives in csrc/raster.cpp) and flagship
   train/seq_00 (480x640, 24 frames), each held to its pinned digest,
   with frames per second and ms per frame; then runs eval_2 as a child
   process (its import log must name no jax, flax, msgpack, cv2 or yaml
   module) on fixtures/hard_nano_ckpt.pt, a flax file, over the nano tree
   in f32 (held within 5e-3 of the JAX package's pinned CPU metrics) and
   in bf16 (printed beside JAX's bf16 with the difference); then evaluates
   bf16 once in-process through eval_2.evaluate, counts zeroed before and
   read after: one A1 launch per spiking block an evaluation batch (17 for
   the nano model), its metrics equal to the bf16 child's. Last, the device time
   of the convs whose bf16 result now stays fp32 (conv2d_nhwc's
   f32_result: the ConvBlocks, the ConvLSTM's hidden half, the spiking
   blocks' statistics) at full width, as bf16 convs (before), as fp32
   convs of bf16 values with TF32 (after, the bf16 policy) and without.
13. Drives the side pipelines at the same full width on the data phase's
   best.pt and a 480x640 test split with tracks.npy (3 sequences x 9
   frames): prints whether OpenCV is importable; runs the tracker
   benchmark's command line (eval) as a child for the entire_model,
   cropped_model and optical_flow methods (the last with its default
   Farneback flow; exit 0, an import log naming no jax, flax, msgpack, cv2
   or yaml module, the aggregate printed); fits the learned
   flow (PWCLite) on the card and runs one sequence of detector + learned
   flow with the adaptive stride in-process, then the same sequence by the
   cropped_model method, counts zeroed before and read after each: one A1
   launch per spiking block a detector frame, no other kernel; holds
   Farneback flow (evals/farneback.py) on the card against the port's CPU
   run, and against cv2.calcOpticalFlowFarneback where OpenCV is
   importable (skipped and said so where it is not), on seq_00's frame
   pairs at 240x320 (at most 0.1% of pixels off by more than 1e-3 px, none
   by 0.1 px), runs one sequence of detector + Farneback flow with the
   adaptive stride (counts as above; boxes equal to the same run with the
   flow on the CPU) and times a 240x320 call (host ms in turns with
   OpenCV's, profiler device ms, kernel launches a call) (these three
   on best.pt's weights with the class-logit biases at 0, which keep boxes
   at conf 0.3 where the 10-step model keeps none: so the crop program runs
   and boxes are tracked); runs main in mode visualize as a child (with
   OpenCV it must write the overlays, without it exit non-zero naming
   cv2.putText before it loads best.pt) and the overlay's card part
   in-process for both weight sets (predict at B=8, scale, draw, write; 20
   A1 launches a batch; palette colours on every kept box's edge); stitches the video (or checks
   that it raises naming cv2.VideoWriter); and times a streamed detector
   frame (host and device), a PWCLite call at the 0.5 downsample, a
   visualization batch split into model and drawing, and the FLOP
   counts of the streamed and the crop step.
14. Drives the six kernels as torch.library operators (kernels/ops.py),
   the serving export and selective remat at the same full width: opcheck
   of each operator on the card at the stem's shape; exports the streaming
   pair (B=1, 480x640, conf 0.3, iou 0.45, max_det 100) and the batch
   program (B=1, T=seq_len) of the default model in bf16 with no kernel
   launched while tracing, with the wall time and the .pt2 sizes; loads
   and runs them in a child process (its import log must name no jax,
   flax, msgpack, cv2 or yaml module) that streams 3 frames, state
   carried, with one A1 launch per spiking block an exported frame; holds
   the child's detections and states to the in-process eager path bit for
   bit (else it names the first operator that differs and holds the
   detections to equal counts and classes, scores within 1e-2 relative);
   times an exported B=1 frame against the eager DetectionService step in
   turns; then remat_policy="save_conv": in f32 without TF32 (T=4, B=2,
   chunks of 2) the loss and gradients of "full" and "save_conv" against
   each other and against no remat (loss 1e-3, gradient norm 1e-2
   relative), and in bf16 (T=10, B=2, chunks of 5) the peak memory, ms
   and launches of a train step under no remat, "full" and "save_conv".

15. FSDP and tensor parallelism (parallel/mesh.py parts (c) and (e)): A1
   against its plain version bit for bit at every spiking block's C/2 and
   C/4 channel shard (B=1 T=1 and T=5 B=2), printing the shards that take
   the scalar path with their us beside the byte bound; the FSDP step over
   a one-rank NCCL group (default model, bf16, T=5 B=2) bit-equal to the
   library step (loss, grad_norm, parameters and moments) with 20 A2 + 20
   A3 launches and the state bytes it keeps; an epoch of main with
   mesh.fsdp: true through torchrun on the data phase's tree, whose
   latest.pt has the data-parallel run's leaves and shapes; make_predict_fn over a
   tensor axis of 1 bit-equal to the plain predict; and with two or more
   cards, scripts/torch_parallel_cards.py --quick under torchrun on two
   processes (the FSDP step and the tensor-parallel predict against one
   card); with one card it prints that it skipped them and why.
16. Spatial parallelism (parallel/mesh.py part (d)): A1, A2 and A3
   against their plain versions at the local rows every rank of a spatial
   group of 2, 4 or 8 gives each of the 20 spiking blocks at 480x640 (T=5
   B=2; spikes, v_final, v_pre, g_x and g_v0 bit for bit, da/db within
   SUM_RTOL of the summed |terms|), printing the shards of one or no row;
   a shard with no row (the stride-32 blocks of a 64-row input over 4
   ranks) launches nothing and is counted in skipped_empty, every other
   shard launches its kernel once; the train step and make_predict_fn over
   a one-rank NCCL group with mesh.spatial: 1 bit-equal to the library
   step and the plain predict (20 A2 + 20 A3 a step, 20 A1 a predict); and
   two spatial ranks of scripts/torch_parallel_cards.py --quick --only
   spatial under torchrun against one process, each rank's A2/A3 launches
   and skipped zero-row calls one a block: on two cards over NCCL, or
   with one card both on it over gloo when its gloo takes CUDA tensors
   for the all-to-all and the all-reduce (a two-process probe says), else
   it prints that it skipped them and why.

The bf16 phases run under set_tf32_policy("bf16"), as the command lines
set it for the default model; the fp32 checks (4, 6, 7's card against
CPU and 14's save_conv check) run inside tf32_policy("f32").

Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Any failure raises (non-zero
exit, no result line). Needs a CUDA card; there is no CPU path.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
SLEEP_CYCLES_PER_S = 1.98e9  # H100 SXM top SM clock: a lower clock only sleeps longer
SERVE_WINDOWS, SERVE_PER_WINDOW = 3, 100  # serving dispatches timed per batch size
N_LATENCY = 300  # detect() requests timed through the service
N_PROFILED = 50  # B=1 dispatches under the profiler
T_CLIP = 4
T_TRAIN, B_TRAIN = 5, 2  # the training window: default seq_len, two samples
B_VIZ = 8  # the visualization batch (viz/overlay.py's default)
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
# The plain LIF scan kernels (B1-B3) do only per-element rounded fp32 ops:
# every output must equal the plain version's bit for bit (tolerance 0).
ODD_SCAN_SHAPES = ((4, 3, 50, 70), (1, 3, 50, 71), (3, 7, 9, 5))  # vector tails, odd N
# conv -> GroupNorm -> run_lif against the fused SpikingConvBlock (fp32):
# the two normalize differently ((x - mean) * rstd * g + b against
# x * a + b'), ~1e-7 relative, so membranes agree to 1e-5 unless a spike
# flips, and a spike may flip only where the membrane is within 1e-5 of
# the threshold. Gradients per leaf: relative L2 error 1e-3 (measured
# ~1e-5; a flipped element changes its own later steps only).
COMP_ATOL = 1e-5
COMP_GRAD_RTOL = 1e-3
N_EVAL_BATCHES = 3  # full-width evaluation batches (T=5, B=2)
N_LSTM_FRAMES = 3  # frames per stream served by the token-LSTM model
N_LSTM_TIMED = 20  # B=1 dispatches of the token-LSTM model timed
DATA_SEQS, DATA_FRAMES = 3, 9  # the data phase's tree: 15 windows of 5 frames
DATA_THREADS = 4  # decode threads of the data phase's loaders
TURNS = ("pool", "native", "native", "pool")  # the data phase's decode paths, in turns
# Batched (B=2) against alone (B=1) in bf16: cuDNN may pick another
# algorithm for another batch and round differently, so sorted scores are
# compared to 1e-2, as the clip-vs-sequential check does.
LSTM_SCORE_ATOL = 1e-2
# The batched and alone post-NMS detection counts may differ by at most
# this. With conf 0 and a random-init model fewer than max_det boxes
# survive NMS, so a box at the IoU threshold decides the count, and the
# batched and alone convs sum in other orders. The exact form fails on the
# parent code too (scripts/torch_lstm_batch_counts.py, both trees under
# the bf16 TF32 policy).
LSTM_COUNT_SLACK = 5
LSTM_HIDDEN = 1024  # every preset's bottleneck at width 1
# (T, B, N): the training cell's window (8x10 tokens), a served frame alone
# and a full dispatch of 16.
LSTM_SHAPES = ((T_TRAIN, 16, 80), (1, 1, 80), (1, 16, 80))
BF16_FLOPS = 989e12  # H100 SXM dense bf16
N_LSTM_STEPS = 3  # train steps of the token-LSTM model counted
SPATIAL_SIZES = (2, 4, 8)  # spatial groups whose row shards phase 16 holds the kernels at
N_DP_STEPS = 3  # data-parallel steps held bit for bit against the library step
N_ALLREDUCE_REPS = 20  # gradient all-reduces timed


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


class OpLog(TorchDispatchMode):
    """Names of the PyTorch operators dispatched while it is entered."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def check_training_kernels(K, lif_mod, lif_shapes, gen) -> dict:
    """A2 and A3 against their plain versions at every main-path shape,
    B=2, T=5, bf16, soft and hard reset, seeded cotangents. Raises on a
    disagreement; returns the largest absolute errors per kernel.

    The backward's second call at a shape (its scratch is set up by then)
    runs under an operator log: the wrapper may allocate its outputs and
    launch its one kernel, and dispatch no other PyTorch operator (no
    ``sum``, no fill, no copy)."""
    LIFParams = lif_mod.LIFParams
    errs = {"affine_lif_fwd_res": 0.0, "affine_lif_bwd": 0.0}
    exact = {"spikes": True, "v_final": True, "v_pre": True, "g_x": True, "g_v0": True}
    sum_rel = 0.0
    wrapper_ops = set()  # every operator a steady-state backward call dispatched
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
            c0 = K.launch_counts["affine_lif_bwd"]
            with OpLog() as log:
                again = K.affine_lif_bwd(vpre, x4, a, g_s, g_v, p)
            torch.cuda.synchronize()
            wrapper_ops.update(log.ops)
            if (K.launch_counts["affine_lif_bwd"] != c0 + 1
                    or not all(op.startswith("aten.empty") for op in log.ops)):
                raise AssertionError(f"A3 {tag}: one backward call made "
                                     f"{K.launch_counts['affine_lif_bwd'] - c0} launches and "
                                     f"dispatched {log.ops}; want one launch and allocations only")
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
          f"|terms| (limit {SUM_RTOL}); da/db bitwise equal across two launches; a backward "
          f"call is one launch and dispatches only {sorted(wrapper_ops)} (no sum(0), no fill)")
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
    train_loop run and the timed step's median host ms, calling thread's
    CPU ms and profiler device ms."""
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
    step_ms, step_cpu = [], []
    for i in range(N_TIMED_STEPS):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        state, _ = fns.train_step(state, train_batches[i % N_TRAIN_STEPS])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_cpu.append((time.thread_time() - c0) * 1e3)
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
    n_a3 = sum(e.count for e in evs if "affine_lif_bwd_kernel" in e.key) / n
    if n_a3 != n_blocks:
        raise AssertionError(f"{n_a3} affine_lif_bwd_kernel launches per train step, want {n_blocks}")
    med = float(np.median(step_ms[1:]))
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    print(f"[{card}] train step B={B_TRAIN} T={T_TRAIN} (host clock, synchronised, "
          f"{N_TIMED_STEPS} steps after the loop's {N_TRAIN_STEPS}): ms/step "
          f"{spread(step_ms[1:])} (first {step_ms[0]:.3f}), calling thread on the CPU "
          f"{spread(step_cpu[1:])}; profiler x{n}: device (kernel) "
          f"time {dev_ms:.3f} ms/step, busy {dev_ms / med:.1%} of the median step; "
          f"affine_lif_fwd_res {a2:.4f} ms/step ({a2 / dev_ms:.2%}), affine_lif_bwd "
          f"{a3:.4f} ms/step ({a3 / dev_ms:.2%}) in {n_a3:.0f} launches/step, its sums "
          f"included; {sum(e.count for e in evs) / n:.0f} "
          f"kernels/step; peak memory through train_loop {peak_gb:.2f} GiB; top: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / n:.3f} ms" for e in top))
    return launches, {"step_ms": med, "thread_ms": float(np.median(step_cpu[1:])), "dev_ms": dev_ms}


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
    byte bounds, plain versions and the blocks each launches, and A1 at
    the same T and B (as the evaluation forward launches it); returns the
    sums over the 20 shapes."""
    p = lif_mod.LIFParams()
    t5 = f"affine_lif_fwd T={T_TRAIN} B={B_TRAIN}"
    sums = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
            for k in ("affine_lif_fwd_res", "affine_lif_bwd", t5)}
    for name, (_, hh, ww, cc) in lif_shapes:
        n = B_TRAIN * hh * ww * cc
        shp = (B_TRAIN, hh, ww, cc)
        make_f = lambda: lif_inputs(shp, T_TRAIN, gen)  # noqa: E731
        make_b = lambda: bwd_inputs(K, shp, T_TRAIN, p, gen)  # noqa: E731
        fwd_blocks = K.fwd_plan(B_TRAIN, hh * ww, cc, torch.bfloat16, True).blocks(B_TRAIN)
        bwd_blocks = K.bwd_plan(T_TRAIN, B_TRAIN, hh * ww, cc, torch.bfloat16, True).blocks(B_TRAIN)
        rows = (
            ("affine_lif_fwd_res", lif_bytes_res(n, T_TRAIN, cc, B_TRAIN), 10, fwd_blocks, make_f,
             lambda *t: K.affine_lif_fwd_res(*t[:3], p, t[3]),
             lambda *t: lif_mod.affine_lif_forward_reference(*t[:3], p, t[3], with_vpre=True)),
            ("affine_lif_bwd", lif_bytes_bwd(n, T_TRAIN, cc, B_TRAIN), 25, bwd_blocks, make_b,
             lambda *t: K.affine_lif_bwd(*t, p),
             lambda *t: lif_mod.affine_lif_backward_reference(*t, p)),
            (t5, lif_bytes(n, T_TRAIN, cc, B_TRAIN, False), 10, fwd_blocks, make_f,
             lambda *t: K.affine_lif_fwd(*t[:3], p, t[3]),
             lambda *t: lif_mod.affine_lif_tb_reference(*t[:3], p, t[3])),
        )
        for kname, nbytes, flops, blocks, make, kern, plain in rows:
            km = time_cuda(kern, make, nbytes)
            pm = time_cuda(plain, make, nbytes)
            bm = max(nbytes / HBM_BYTES_PER_S, flops * n * T_TRAIN / FP32_FLOPS) * 1e3
            sums[kname]["ms"] += km
            sums[kname]["plain_ms"] += pm
            sums[kname]["bound_ms"] += bm
            print(f"[{card}] {kname} {name} B={B_TRAIN} T={T_TRAIN} {(hh, ww, cc)}: "
                  f"{km * 1e3:.2f} us in {blocks} blocks (bound {bm * 1e3:.2f} us, {bm / km:.0%} "
                  f"of bound; plain {pm * 1e3:.2f} us)")
    for kname, v in sums.items():
        print(f"[{card}] {kname} summed over the 20 blocks (B={B_TRAIN} T={T_TRAIN} bf16): "
              f"kernel {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_ms'] / v['ms']:.0%} of bound), plain {v['plain_ms']:.4f} ms")
    return sums


def scan_inputs(shape, dtype, gen):
    """Seeded inputs of the plain LIF scan: currents x (T, ...), v0 (...)
    fp32, and cotangents g_s (as x), g_vfin (fp32)."""
    x = (torch.randn(shape, device="cuda", generator=gen) * 1.2).to(dtype)
    v0 = 0.3 * torch.randn(shape[1:], device="cuda", generator=gen)
    g_s = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    g_v = torch.randn(shape[1:], device="cuda", generator=gen)
    return x, v0, g_s, g_v


def scan_bytes(kernel: str, n: int, t_steps: int, itemsize: int = 2) -> int:
    """Bytes each plain-LIF-scan kernel must move for N elements over T
    steps: the forward reads x and writes s per step (plus v_pre in the
    residual variant), the backward reads v_pre and g_s and writes g_x;
    each reads and writes one fp32 state once."""
    per_step = 2 if kernel == "lif_scan_fwd" else 3
    return n * (per_step * itemsize * t_steps + 8)


SCAN_FLOPS = {"lif_scan_fwd": 6, "lif_scan_fwd_res": 6, "lif_scan_bwd": 15}  # per element-step


def check_scan_kernels(KL, lif_mod, lif_shapes, gen) -> dict:
    """B1, B2, B3 against their plain versions, bit for bit: the 20
    main-path shapes as (T, B*H*W*C) for (T=1, B=1) and (T=5, B=2) in bf16,
    soft and hard reset, plus odd sizes in fp32 and bf16. Raises on any
    difference; returns the largest absolute error per kernel (0.0)."""
    LIFParams = lif_mod.LIFParams
    cases = [((t, b * hh * ww * cc), torch.bfloat16, f"{name} T={t} B={b}")
             for name, (_, hh, ww, cc) in lif_shapes for t, b in ((1, 1), (T_TRAIN, B_TRAIN))]
    cases += [(shape, dt, f"odd {shape} {str(dt)[6:]}")
              for shape in ODD_SCAN_SHAPES for dt in (torch.float32, torch.bfloat16)]
    errs = dict.fromkeys(KL.KERNELS, 0.0)
    flips = checked = 0
    for shape, dtype, tag in cases:
        for p in (LIFParams(), LIFParams(reset="hard")):
            x, v0, g_s, g_v = scan_inputs(shape, dtype, gen)
            s1, vfin1 = KL.lif_scan_fwd(x, p, v0)
            s2, vpre, vfin2 = KL.lif_scan_fwd_res(x, p, v0)
            g_x, g_v0 = KL.lif_scan_bwd(vpre, g_s, g_v, p)
            s_r, vpre_r, vfin_r = lif_mod.lif_forward_reference(x, p, v0, with_residuals=True)
            r_x, r_v0 = lif_mod.lif_backward_reference(vpre, g_s, g_v, p)
            torch.cuda.synchronize()
            flips += int((s1 != s_r).sum()) + int((s2 != s_r).sum())
            checked += 2 * s_r.numel()
            pairs = {
                "lif_scan_fwd": (("spikes", s1, s_r), ("v_final", vfin1, vfin_r)),
                "lif_scan_fwd_res": (("spikes", s2, s_r), ("v_pre", vpre, vpre_r),
                                     ("v_final", vfin2, vfin_r)),
                "lif_scan_bwd": (("g_x", g_x, r_x), ("g_v0", g_v0, r_v0)),
            }
            for kname, outs in pairs.items():
                for oname, got, ref in outs:
                    if got.dtype != ref.dtype or got.shape != ref.shape:
                        raise AssertionError(f"{kname} {tag} {p.reset}: {oname} is "
                                             f"{got.dtype} {tuple(got.shape)}")
                    errs[kname] = max(errs[kname], (got.float() - ref.float()).abs().max().item())
                    if not torch.equal(got, ref):
                        raise AssertionError(
                            f"{kname} {tag} {p.reset}: {oname} differs from the plain version "
                            f"(max abs {(got.float() - ref.float()).abs().max().item()})")
    print(f"scan kernels ok: lif_scan_fwd, lif_scan_fwd_res, lif_scan_bwd vs plain at "
          f"{len(lif_shapes)} shapes x (T=1 B=1; T={T_TRAIN} B={B_TRAIN}) bf16 + "
          f"{len(ODD_SCAN_SHAPES)} odd sizes x f32/bf16, soft and hard: spikes, v_final, v_pre, "
          f"g_x, g_v0 bit-equal; spike flips {flips} of {checked}; max_abs_err {errs}")
    return errs


def time_scan_kernels(card, KL, lif_mod, lif_shapes, gen) -> dict:
    """B1, B2, B3 per launch at the 20 shapes as (T=5, B*H*W*C) with B=2 in
    bf16, and B1 also at (T=1, B=1), beside their byte bounds and plain
    versions; returns the sums over the 20 shapes at T=5, B=2."""
    p = lif_mod.LIFParams()
    sums = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0} for k in KL.KERNELS}
    small = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}

    def bwd_args(shape):
        x, v0, g_s, g_v = scan_inputs(shape, torch.bfloat16, gen)
        return KL.lif_scan_fwd_res(x, p, v0)[1], g_s, g_v

    for name, (_, hh, ww, cc) in lif_shapes:
        for t_steps, bsz in ((T_TRAIN, B_TRAIN), (1, 1)):
            n = bsz * hh * ww * cc
            shape = (t_steps, n)
            fwd_make = lambda: scan_inputs(shape, torch.bfloat16, gen)[:2]  # noqa: E731
            rows = [("lif_scan_fwd", fwd_make, lambda x, v0: KL.lif_scan_fwd(x, p, v0),
                     lambda x, v0: lif_mod.lif_forward_reference(x, p, v0))]
            if t_steps > 1:
                rows += [
                    ("lif_scan_fwd_res", fwd_make, lambda x, v0: KL.lif_scan_fwd_res(x, p, v0),
                     lambda x, v0: lif_mod.lif_forward_reference(x, p, v0, with_residuals=True)),
                    ("lif_scan_bwd", lambda: bwd_args(shape),
                     lambda *t: KL.lif_scan_bwd(*t, p),
                     lambda *t: lif_mod.lif_backward_reference(*t, p)),
                ]
            for kname, make, kern, plain in rows:
                nbytes = scan_bytes(kname, n, t_steps)
                km = time_cuda(kern, make, nbytes)
                pm = time_cuda(plain, make, nbytes)
                bm = max(nbytes / HBM_BYTES_PER_S,
                         SCAN_FLOPS[kname] * n * t_steps / FP32_FLOPS) * 1e3
                acc = sums[kname] if t_steps > 1 else small
                acc["ms"] += km
                acc["plain_ms"] += pm
                acc["bound_ms"] += bm
                print(f"[{card}] {kname} {name} T={t_steps} N={n} ({bsz}x{hh}x{ww}x{cc}): "
                      f"{km * 1e3:.2f} us (bound {bm * 1e3:.2f} us, {bm / km:.0%} of bound; "
                      f"plain {pm * 1e3:.2f} us)")
    for kname, v in sums.items():
        print(f"[{card}] {kname} summed over the 20 shapes (T={T_TRAIN} B={B_TRAIN} bf16): "
              f"kernel {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_ms'] / v['ms']:.0%} of bound), plain {v['plain_ms']:.4f} ms")
    print(f"[{card}] lif_scan_fwd summed over the 20 shapes (T=1 B=1 bf16): kernel "
          f"{small['ms']:.4f} ms, bound {small['bound_ms']:.4f} ms "
          f"({small['bound_ms'] / small['ms']:.0%} of bound), plain {small['plain_ms']:.4f} ms")
    return sums


def run_lif_path(KL, det, lif_shapes, gen) -> dict:
    """The run_lif entry point at full width: conv -> GroupNorm(eps 1e-6) ->
    run_lif against the SpikingConvBlock with the same weights, at the
    geometry of the model's widest 120x160 stem block, T=5, B=2, fp32:
    once without a gradient, once forward and backward. Returns the launch
    counts of the B kernels over exactly these two calls."""
    from snn_object_detectionddp_tpu_torch.models import layers as L
    from snn_object_detectionddp_tpu_torch.models.lif import (
        LIFParams, lif_forward_reference, run_lif,
    )

    p = LIFParams()
    blocks = dict(det.module.named_modules())
    name, (_, hh, ww, cc) = max(
        ((n, s) for n, s in lif_shapes if s[1:3] == lif_shapes[0][1][1:3]),
        key=lambda ns: ns[1][3])
    model_block = blocks[name]
    in_ch, stride = model_block.weight.shape[1], model_block.stride
    if stride != 1:
        raise AssertionError(f"{name}: expected a stride-1 stem block")
    with torch.device("meta"):
        block = L.SpikingConvBlock(in_ch, cc, p, dtype=torch.float32)
    cpu_gen = torch.Generator().manual_seed(SEED + 2)
    weights = {}
    for leaf, param in block.named_parameters():
        t = torch.empty(param.shape)
        block.init_param(leaf, t, cpu_gen)
        weights[leaf] = t
    weights["gn_scale"] += 0.2 * torch.randn(cc, generator=cpu_gen)
    weights["gn_bias"] += 0.2 * torch.randn(cc, generator=cpu_gen)
    weights = {k: v.cuda().requires_grad_() for k, v in weights.items()}
    x_t = (torch.rand((T_TRAIN, B_TRAIN, hh, ww, in_ch), device="cuda", generator=gen) < 0.3).float()
    x_t.requires_grad_()
    w_s = torch.randn((T_TRAIN, B_TRAIN, hh, ww, cc), device="cuda", generator=gen)

    def composition(x_t):
        y = L.conv2d_nhwc(x_t.reshape(T_TRAIN * B_TRAIN, hh, ww, in_ch), weights["weight"])
        y = L.group_norm_nhwc(y, L._num_groups(cc), weights["gn_scale"], weights["gn_bias"], y)
        return y, run_lif(y.view(T_TRAIN, B_TRAIN, hh, ww, cc), p)

    def fused(x_t):
        return torch.func.functional_call(block, weights, (x_t,))

    def loss_and_grads(s, v):
        loss = (s * w_s).sum() + v.square().sum()
        return loss, torch.autograd.grad(loss, [x_t, *weights.values()])

    # The fused block first (its A kernels are not what this path counts).
    s_f, v_f = fused(x_t)
    loss_f, grads_f = loss_and_grads(s_f, v_f)

    KL.reset_launch_counts()
    with torch.no_grad():
        y, (s_n, v_n) = composition(x_t)
    after_no_grad = dict(KL.launch_counts)
    _, (s_c, v_c) = composition(x_t)
    loss_c, grads_c = loss_and_grads(s_c, v_c)
    torch.cuda.synchronize()
    launches = dict(KL.launch_counts)
    if after_no_grad != {"lif_scan_fwd": 1, "lif_scan_fwd_res": 0, "lif_scan_bwd": 0}:
        raise AssertionError(f"run_lif without a gradient launched {after_no_grad}")
    if launches != {"lif_scan_fwd": 1, "lif_scan_fwd_res": 1, "lif_scan_bwd": 1}:
        raise AssertionError(f"run_lif with a gradient launched {launches} (after the no-grad call)")
    if not (torch.equal(s_n, s_c) and torch.equal(v_n, v_c)):
        raise AssertionError("run_lif gives other spikes with a gradient than without")

    # Spikes may differ only where the membrane is within COMP_ATOL of the
    # threshold; elsewhere the membranes agree to COMP_ATOL.
    with torch.no_grad():
        _, vpre, _ = lif_forward_reference(y.view(T_TRAIN, B_TRAIN, hh, ww, cc), p,
                                           torch.zeros_like(v_c), with_residuals=True)
        near = ((vpre - p.threshold).abs() < COMP_ATOL).any(0)
        flipped = (s_c != s_f).any(0)
        n_flips, n_elem = int((s_c != s_f).sum()), s_c.numel()
        if (flipped & ~near).any():
            raise AssertionError(f"{int((flipped & ~near).sum())} elements spike differently "
                                 "away from the threshold")
        v_err = (v_c - v_f).abs()[~flipped].max().item()
        if v_err > COMP_ATOL:
            raise AssertionError(f"v_final differs by {v_err} where no spike flipped")
    worst = 0.0
    for leaf, gc, gf in zip(["x", *weights], grads_c, grads_f):
        if not torch.isfinite(gc).all():
            raise AssertionError(f"non-finite gradient of {leaf} through run_lif")
        rel = ((gc - gf).double().norm() / gf.double().norm().clamp(min=1e-30)).item()
        worst = max(worst, rel)
        if rel > COMP_GRAD_RTOL:
            raise AssertionError(f"gradient of {leaf}: relative L2 error {rel} between the "
                                 "run_lif composition and the fused block")
    print(f"run_lif path ok: conv -> GroupNorm -> run_lif vs SpikingConvBlock at {name} "
          f"geometry ({T_TRAIN}x{B_TRAIN}x{hh}x{ww}x{in_ch} -> {cc}, fp32): spike flips "
          f"{n_flips} of {n_elem} (all within {COMP_ATOL} of the threshold), firing rate "
          f"{s_c.mean().item():.4f}, v_final max err {v_err:.3g} off the flipped elements, loss "
          f"{loss_c.item():.4f} vs {loss_f.item():.4f}, worst gradient leaf relative L2 error "
          f"{worst:.3g} (limit {COMP_GRAD_RTOL}); launches {launches} (no-grad call: "
          f"{after_no_grad})")
    return launches


def nms_outputs_close(got: dict, ref: dict, score_atol: float, tag: str) -> str:
    """Two NMS dicts of numpy arrays for the same images: the numbers of
    detections may differ by 2% (a score at the confidence threshold), the
    descending scores of the common slots by ``score_atol``."""
    notes = []
    for i in range(got["valid"].shape[0]):
        n_g, n_r = int(got["valid"][i].sum()), int(ref["valid"][i].sum())
        n = min(n_g, n_r)
        if n == 0 or abs(n_g - n_r) > max(2, 0.02 * n_r):
            raise AssertionError(f"{tag} image {i}: {n_g} vs {n_r} detections")
        diff = float(np.abs(got["scores"][i][:n] - ref["scores"][i][:n]).max())
        if diff > score_atol:
            raise AssertionError(f"{tag} image {i}: scores differ by {diff}")
        notes.append(f"{n_g}/{n_r} detections, max score diff {diff:.3g}")
    return "; ".join(notes)


def run_eval_slice(card, K, det, params, det_gpu, det_cpu, n_blocks, rng) -> None:
    """Evaluation at full width on the card: seeded batches through
    make_predict_fn at the evaluation thresholds (greedy NMS) and
    evaluate_batches into DetMetrics; the greedy NMS card against CPU on
    the same candidates; the whole predict function card against CPU on a
    small fp32 input; ms per batch split into model and NMS."""
    from snn_object_detectionddp_tpu_torch.data.encoding import preprocess_video
    from snn_object_detectionddp_tpu_torch.evals import validator
    from snn_object_detectionddp_tpu_torch.models.detect import decode_predictions
    from snn_object_detectionddp_tpu_torch.models.detector import tf32_policy
    from snn_object_detectionddp_tpu_torch.ops import nms

    cfg = det.cfg
    h, w = cfg.model.image_size
    batches = []
    for i in range(N_EVAL_BATCHES):
        batch = moving_boxes_batch(rng, B_TRAIN, T_TRAIN, h, w, cfg.model.num_classes)
        batch["paths"] = [f"window_{i}_{j}" for j in range(B_TRAIN)]
        batches.append(batch)
    predict = validator.make_predict_fn(det)
    greedy_calls, outs = [0], []
    greedy = nms._nms_greedy

    def counting_greedy(*args):
        greedy_calls[0] += 1
        return greedy(*args)

    def keeping_predict(p_, images):
        outs.append(predict(p_, images))
        return outs[-1]

    nms._nms_greedy = counting_greedy
    try:
        K.reset_launch_counts()
        results = validator.evaluate_batches(det, params, batches, predict=keeping_predict)
        torch.cuda.synchronize()
        launches = dict(K.launch_counts)
    finally:
        nms._nms_greedy = greedy
    want = {"affine_lif_fwd": n_blocks * N_EVAL_BATCHES, "affine_lif_fwd_res": 0,
            "affine_lif_bwd": 0}
    if launches != want or greedy_calls[0] != N_EVAL_BATCHES:
        raise AssertionError(f"evaluation launched {launches} (want {want}) and took the greedy "
                             f"NMS path {greedy_calls[0]} times of {N_EVAL_BATCHES}")
    keys = {"metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
            "metrics/mAP50-95(B)", "fitness"}
    if set(results) != keys or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in results.values()):
        raise AssertionError(f"bad results dict: {results}")
    n_valid = [int(o["valid"].sum()) for o in outs]
    for o in outs:
        if tuple(o["boxes"].shape) != (B_TRAIN, validator.EVAL_MAX_DET, 4):
            raise AssertionError(f"NMS output shape {tuple(o['boxes'].shape)}")
        if not (torch.isfinite(o["boxes"]).all() and torch.isfinite(o["scores"]).all()):
            raise AssertionError("non-finite detections in evaluation")
    if min(n_valid) == 0:
        raise AssertionError("an evaluation batch kept no detection at conf 0.001")
    print(f"evaluation slice ok: {N_EVAL_BATCHES} batches (T={T_TRAIN} B={B_TRAIN}, {h}x{w}) "
          f"through make_predict_fn (conf {validator.EVAL_CONF}, iou {validator.EVAL_IOU}, "
          f"max_det {validator.EVAL_MAX_DET}, pool {validator.EVAL_PRE_NMS_TOPK}) -> greedy NMS "
          f"x{greedy_calls[0]} -> DetMetrics; detections kept per batch {n_valid}; launches "
          f"{launches}; results (random weights) {results}")

    # The stages of one batch, for the greedy NMS check and the timing.
    images = torch.from_numpy(batches[0]["images"]).cuda()

    def model_stage():
        with torch.no_grad():
            raw, _ = det.apply(params, preprocess_video(images, dtype=det.dtype))
            return decode_predictions(raw, cfg.model.hyp.reg_max, cfg.model.num_classes,
                                      image_hw=(h, w))

    kw = dict(conf_thres=validator.EVAL_CONF, iou_thres=validator.EVAL_IOU,
              max_det=validator.EVAL_MAX_DET, pre_nms_topk=validator.EVAL_PRE_NMS_TOPK)
    boxes, scores = model_stage()
    if boxes.shape[1] <= nms._MATRIX_PATH_MAX_K:
        raise AssertionError(f"{boxes.shape[1]} anchors: evaluation would not take the greedy path")
    on_card = {k: v.cpu().numpy() for k, v in nms.batched_nms(boxes, scores, **kw).items()}
    on_cpu = {k: v.numpy() for k, v in nms.batched_nms(boxes.cpu(), scores.cpu(), **kw).items()}
    same = all(np.array_equal(on_card[k], on_cpu[k]) for k in on_cpu)
    note = nms_outputs_close(on_card, on_cpu, 1e-6, "greedy NMS card vs CPU")
    print(f"greedy NMS card vs CPU on one full-width batch ({boxes.shape[1]} candidates an "
          f"image): identical outputs {same}; {note}")

    small = rng.randint(0, 256, size=(2, 2, 64, 96, 3), dtype=np.uint8)
    with tf32_policy("f32"):
        g = {k: v.cpu().numpy() for k, v in validator.make_predict_fn(det_gpu)(params, small).items()}
    c = {k: v.numpy() for k, v in validator.make_predict_fn(det_cpu)(
        {k: v.cpu() for k, v in params.items()}, small).items()}
    print("evaluation predict card vs CPU (fp32, 64x96, T=2, B=2): "
          + nms_outputs_close(g, c, 1e-3, "predict card vs CPU"))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    model_ms, nms_ms, total_ms = [], [], []
    for batch in batches:
        images = torch.from_numpy(batch["images"]).cuda()
        (boxes, scores), m = timed(model_stage)
        _, n = timed(lambda: nms.batched_nms(boxes, scores, **kw))
        _, t = timed(lambda: {k: v.cpu() for k, v in predict(params, batch["images"]).items()})
        model_ms.append(m)
        nms_ms.append(n)
        total_ms.append(t)
    print(f"[{card}] evaluation batch T={T_TRAIN} B={B_TRAIN} (host clock, synchronised, "
          f"{len(batches)} batches): model (preprocess + forward + decode) ms {spread(model_ms)}; "
          f"greedy NMS ({validator.EVAL_MAX_DET} rounds over {boxes.shape[1]} candidates) ms "
          f"{spread(nms_ms)}; whole predict with the copy to the host ms {spread(total_ms)}")


def run_lstm_serving(card, K, n_blocks, rng) -> int:
    """The token-LSTM-bottleneck model at full width (hidden 1024, 80
    tokens at 8x10) through DetectionService: two streams micro-batched,
    against the same streams served alone; one token_lstm_fwd launch a
    forward and no plain scan. Returns the token_lstm_fwd launches."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.kernels import token_lstm as KT
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.serve import DetectionService, _Job
    from snn_object_detectionddp_tpu_torch.utils import profiling

    cfg = Config()
    cfg.model.bottleneck = "lstm"
    h, w = cfg.model.image_size
    det = Detector.from_config(cfg, device="cuda")
    params = det.init_params(torch.Generator().manual_seed(SEED + 3))
    lstm = det.module.unet.bottleneck
    n_params = sum(v.numel() for v in params.values())
    svc = DetectionService(det, params, conf=0.0, max_det=100, max_batch=2, max_clip=1)
    carry = svc._zero_state1["unet"]["bottleneck"]
    if [tuple(t.shape) for t in carry] != [(lstm.num_layers, 1, lstm.hidden)] * 2 or \
            svc._state_axes["unet"]["bottleneck"] != (1, 1):
        raise AssertionError("the token-LSTM carry is not (layers, B, hidden) with batch axis 1")
    svc.warmup()
    frames = {s: [rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
                  for _ in range(N_LSTM_FRAMES)] for s in ("lstm_a", "lstm_b")}
    # Queue both streams' frames before the worker starts, so that every
    # dispatch batches the two streams.
    jobs = {s: [_Job(s, f) for f in fs] for s, fs in frames.items()}
    for i in range(N_LSTM_FRAMES):
        for s in jobs:
            svc._q.put(jobs[s][i])
    K.reset_launch_counts()
    KT.reset_launch_counts()
    plain0 = profiling.counter("token_lstm.plain_scans")
    svc.start()
    try:
        batched = {s: [j.reply.get(timeout=600) for j in js] for s, js in jobs.items()}
        for rs in batched.values():
            for r in rs:
                if isinstance(r, Exception):
                    raise r
        alone = {s: [svc.detect(f"{s}_alone", f) for f in fs] for s, fs in frames.items()}
        torch.cuda.synchronize()
        launches = K.launch_counts["affine_lif_fwd"]
        n_fwd = N_LSTM_FRAMES + 2 * N_LSTM_FRAMES
        scans = dict(KT.launch_counts)
        plain = profiling.counter("token_lstm.plain_scans") - plain0
        if launches != n_blocks * n_fwd or any(r["batch"] != 2 for rs in batched.values() for r in rs):
            raise AssertionError(f"lstm serving: {launches} affine_lif_fwd launches over {n_fwd} "
                                 f"forwards, batches {[r['batch'] for rs in batched.values() for r in rs]}")
        if scans != {"token_lstm_fwd": n_fwd, "token_lstm_fwd_res": 0, "token_lstm_bwd": 0} \
                or plain:
            raise AssertionError(f"lstm serving: scan launches {scans}, {plain} plain scans "
                                 f"over {n_fwd} forwards")
        diffs, counts = [], []
        for s in frames:
            for a_, b_ in zip(batched[s], alone[s]):
                sa, sb = np.sort(a_["scores"])[::-1], np.sort(b_["scores"])[::-1]
                k = min(len(sa), len(sb))
                counts.append((len(sa), len(sb)))
                if (k == 0 or not np.isfinite(sa).all() or not np.isfinite(sb).all()
                        or abs(len(sa) - len(sb)) > LSTM_COUNT_SLACK):
                    raise AssertionError(f"{s}: {len(sa)} vs {len(sb)} detections")
                diffs.append(float(np.abs(sa[:k] - sb[:k]).max()))
            if batched[s][0]["scores"] == batched[s][1]["scores"]:
                raise AssertionError(f"{s}: the state did not advance between frames")
        if max(diffs) > LSTM_SCORE_ATOL:
            raise AssertionError(f"batched and alone lstm streams disagree: {diffs}")
        carry_err = max(
            (svc._states[s]["unet"]["bottleneck"][k] - svc._states[f"{s}_alone"]["unet"]["bottleneck"][k])
            .abs().max().item() for s in frames for k in (0, 1))
        print(f"lstm serving ok: {cfg.model.yolo_model_name} {h}x{w} bottleneck lstm (hidden "
              f"{lstm.hidden}, {lstm.num_layers} layers, {n_params / 1e6:.1f}M params), 2 streams x "
              f"{N_LSTM_FRAMES} frames in batches of 2 vs the same streams alone: detections "
              f"{counts} (limit +-{LSTM_COUNT_SLACK}), per-frame max |sorted score diff| over the "
              f"common top {diffs} (limit {LSTM_SCORE_ATOL}), carry (h, c) max diff "
              f"{carry_err:.3g}; affine_lif_fwd launches {launches}, token_lstm_fwd launches "
              f"{scans['token_lstm_fwd']} over {n_fwd} forwards, plain scans {plain}")
        img = np.stack([frames["lstm_a"][0]])
        state = (svc._zero_state1,)
        for _ in range(3):
            svc._predict(img, state)
        torch.cuda.synchronize()
        wins = host_windows(lambda: svc._predict(img, state), 1, N_LSTM_TIMED)
        print(f"[{card}] lstm-bottleneck serving step B=1 ({N_LSTM_TIMED} dispatches, host "
              f"clock, forward+decode+NMS): {wins[0][0]:.3f} ms/frame, dispatching thread on CPU "
              f"{wins[0][1]:.3f} ms")
    finally:
        svc.stop()
    return scans["token_lstm_fwd"]


def lstm_checks():
    """tests/test_torch_token_lstm_kernel.py as a module: the card phase
    applies its cell-by-cell checks, shapes and limits (CARD_RTOL)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_token_lstm_kernel.py")
    spec = importlib.util.spec_from_file_location("token_lstm_checks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_token_lstm_kernels(KT) -> dict:
    """C1-C3 against their plain versions cell by cell, and run free, at the
    main paths' shapes (hidden 1024: the training window, a served frame
    alone and a full dispatch) and at two batch tiles of odd sizes (hidden
    256); the planted faults at the training window; two launches of C2
    and C3 bitwise equal. Raises outside the limits; returns the largest
    cell-by-cell gap per kernel."""
    checks, dev = lstm_checks(), torch.device("cuda")
    worst = dict.fromkeys(checks.CARD_RTOL, 0.0)
    for i, shape in enumerate(checks.CARD_SHAPES):
        gaps = checks.card_gaps(shape, SEED + i, dev)
        print(f"token-LSTM kernels vs plain (T, B, N, H) = {shape}: "
              + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()))
        for k, v in gaps.items():
            if not v < checks.CARD_RTOL[k]:
                raise AssertionError(f"token-LSTM {shape}: {k} {v} over {checks.CARD_RTOL[k]}")
            worst[k] = max(worst[k], v)
    fault = checks.card_gaps(checks.CARD_SHAPES[0], SEED, dev, fault=True)
    print(f"token-LSTM planted faults (a gate product rounded to bf16; the recurrent gradients "
          f"unrounded) at {checks.CARD_SHAPES[0]}: "
          + ", ".join(f"{k} {v:.3g}" for k, v in fault.items()))
    for k in ("act", "dg", "g_state"):
        if not fault[k] > checks.CARD_RTOL[k]:
            raise AssertionError(f"token-LSTM fault inside the {k} limit: {fault[k]}")
    fwd, cot = checks._card_args(checks.CARD_SHAPES[0], SEED, dev)
    runs = []
    for _ in range(2):
        out = KT.token_lstm_fwd_res(*fwd)
        runs.append(out + KT.token_lstm_bwd(out[3], out[4], fwd[7], *fwd[1:4], *cot))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("two launches of token_lstm_fwd_res / token_lstm_bwd differ")
    print(f"token-LSTM kernels ok at {len(checks.CARD_SHAPES)} shapes: largest gaps {worst} "
          f"(limits {checks.CARD_RTOL}); two launches bit-equal")
    return {"token_lstm_fwd": max(worst["act"], worst["c"]),
            "token_lstm_fwd_res": max(worst["act"], worst["c"]),
            "token_lstm_bwd": max(worst["dg"], worst["g_state"])}


def lstm_cost(kernel: str, t_steps: int, bsz: int, n_tok: int, hidden: int):
    """(FLOPs, bytes) a scan kernel must spend: three gate products a token
    (W_hh0, W_ih1, W_hh1) of B x H x 4H, forward or reverse; bytes read and
    written once: the weights, the state, and per row xg0 and y (forward),
    the residuals (C2 writes, C3 reads), dy and dg (C3)."""
    rows, g = t_steps * bsz * n_tok, 4 * hidden
    flops = 2 * rows * hidden * g * 3
    fixed = 3 * hidden * g * 2 + 4 * 2 * bsz * hidden * 4
    res = rows * (2 * g * 4 + 2 * hidden * 4)
    per = {"token_lstm_fwd": rows * (g * 4 + hidden * 2),
           "token_lstm_fwd_res": rows * (g * 4 + hidden * 2 + 3 * hidden * 2) + res,
           "token_lstm_bwd": res + rows * (hidden * 2 + 2 * g * 4)}[kernel]
    return flops, fixed + per


def profiled_device_ms(fn, make, reps: int = 2) -> float:
    """Device (kernel) ms a call of a host-bound ``fn``, from the profiler:
    the sum of its kernels' times (time_cuda's sleep cannot hide a host
    whose launches fill the queue)."""
    args = [make() for _ in range(reps)]
    fn(*args[0])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for a in args:
            fn(*a)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in kernel_rows(prof)) / 1e3 / reps


def time_token_lstm_kernels(card, KT, tl, gen) -> dict:
    """C1-C3 per launch at the main paths' shapes beside their bound (the
    larger of FLOPs at the bf16 peak and bytes at 3.35 TB/s) and their
    plain versions' device time (profiler); then the whole bottleneck's
    device time a training
    window (TokenLSTM forward and backward: layer 0's input product, the
    scan, the weight-gradient products) with the kernels and with the
    plain loop. Returns the training window's row per kernel."""
    out, card_args = {}, lstm_checks()._card_args
    seeds = iter(range(SEED, SEED + 1000))
    for t_steps, bsz, n_tok in LSTM_SHAPES:
        shape = (t_steps, bsz, n_tok, LSTM_HIDDEN)

        def fwd_make(shape=shape):
            return card_args(shape, next(seeds), "cuda")[0]

        def bwd_make(shape=shape):
            fwd, cot = card_args(shape, next(seeds), "cuda")
            _, _, _, act, cseq, _ = KT.token_lstm_fwd_res(*fwd)
            return (act, cseq, fwd[7], *fwd[1:4], *cot)

        def plain_fwd(*a, res=False):
            return tl.token_lstm_forward_reference(a[0], [None, a[2]], [a[1], a[3]], list(a[4:6]),
                                                   *a[6:], with_residuals=res)

        rows = [("token_lstm_fwd", fwd_make, KT.token_lstm_fwd, plain_fwd)]
        if t_steps > 1:
            rows += [("token_lstm_fwd_res", fwd_make, KT.token_lstm_fwd_res,
                      lambda *a: plain_fwd(*a, res=True)),
                     ("token_lstm_bwd", bwd_make, KT.token_lstm_bwd,
                      tl.token_lstm_backward_reference)]
        for name, make, kern, plain in rows:
            flops, nbytes = lstm_cost(name, *shape)
            km = time_cuda(kern, make, nbytes, max_copies=8)
            pm = profiled_device_ms(plain, make)
            bm = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
            print(f"[{card}] {name} (T, B, N, H) = {shape}: {km:.4f} ms (bound {bm:.4f} ms, "
                  f"{bm / km:.1%} of bound; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
                  f"plain {pm:.3f} ms)")
            if t_steps > 1:
                out[name] = {"ms": km, "plain_ms": pm, "bound_ms": bm}
    mod = tl.TokenLSTM(LSTM_HIDDEN).cuda()
    g = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            t = torch.empty(p.shape)
            mod.init_param(name, t, g)
            p.copy_(t)
    shape = (T_TRAIN, 16, 8, 10, LSTM_HIDDEN)

    def window():
        x = torch.randn(shape, device="cuda", generator=gen).bfloat16().requires_grad_(True)
        return x, torch.randn(shape, device="cuda", generator=gen).bfloat16()

    def kernel_step(x, dy):
        y, _ = mod(x)
        y.backward(dy)

    def plain_step(x, dy):
        w_ih = [getattr(mod, f"l{n}_w_ih").bfloat16() for n in range(2)]
        w_hh = [getattr(mod, f"l{n}_w_hh").bfloat16() for n in range(2)]
        tokens = x.reshape(T_TRAIN, 16, 80, LSTM_HIDDEN).float()
        xg0 = torch.matmul(tokens.bfloat16().float(), w_ih[0].float())
        zeros = torch.zeros(2, 16, LSTM_HIDDEN, device="cuda")
        y = tl.token_lstm_forward_reference(xg0, w_ih, w_hh, [mod.l0_bias, mod.l1_bias],
                                            zeros, zeros)[0]
        y.backward(dy.reshape(y.shape))

    step_bytes = sum(lstm_cost(k, T_TRAIN, 16, 80, LSTM_HIDDEN)[1] for k in out)
    k_step = time_cuda(kernel_step, window, step_bytes, max_copies=4)
    p_step = profiled_device_ms(plain_step, window)
    print(f"[{card}] the token-LSTM bottleneck's device time a training window (T={T_TRAIN}, "
          f"B=16, 8x10, forward + backward with the weight gradients): kernels {k_step:.3f} ms, "
          f"plain loop {p_step:.3f} ms")
    out["step"] = {"ms": k_step, "plain_ms": p_step}
    return out


def lstm_train_launches(card, KT, rng) -> dict:
    """The token-LSTM model's train step at full width (T=5, B=2) through
    make_step_fns: each step one token_lstm_fwd_res and one token_lstm_bwd
    launch and no plain scan. Returns the launches counted."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.train.step import (
        init_state, make_optimizer, make_step_fns,
    )
    from snn_object_detectionddp_tpu_torch.utils import profiling

    cfg = Config()
    cfg.model.bottleneck = "lstm"
    h, w = cfg.model.image_size
    tr = cfg.training
    det = Detector.from_config(cfg, device="cuda")
    params = det.init_params(torch.Generator().manual_seed(SEED + 5))
    tx, sched = make_optimizer(tr.learning_rate, 100, tr.weight_decay, tr.grad_clip_norm,
                               tr.pct_start)
    state = init_state(params, tx, sched)
    fns = make_step_fns(det, tx, sched)
    batches = [moving_boxes_batch(rng, B_TRAIN, T_TRAIN, h, w, cfg.model.num_classes)
               for _ in range(N_LSTM_STEPS)]
    state, _ = fns.train_step(state, batches[0])  # warm
    torch.cuda.synchronize()
    before = profiling.counters()
    t0 = time.perf_counter()
    for batch in batches:
        state, metrics = fns.train_step(state, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / N_LSTM_STEPS
    after = profiling.counters()
    got = {k: after[f"{k}.launches"] - before[f"{k}.launches"] for k in KT.KERNELS}
    plain = after["token_lstm.plain_scans"] - before["token_lstm.plain_scans"]
    want = {"token_lstm_fwd": 0, "token_lstm_fwd_res": N_LSTM_STEPS,
            "token_lstm_bwd": N_LSTM_STEPS}
    if got != want or plain:
        raise AssertionError(f"token-LSTM train steps launched {got}, {plain} plain scans")
    loss = float(metrics["loss"]) if isinstance(metrics, dict) and "loss" in metrics else None
    print(f"[{card}] token-LSTM model train step (T={T_TRAIN}, B={B_TRAIN}, 480x640, bf16): "
          f"{host_ms:.1f} ms a step on the host clock, launches {got} over {N_LSTM_STEPS} "
          f"steps, plain scans {plain}, loss {loss}")
    return got


def check_png(frames, scratch) -> str:
    """read_rgb (the C++ decoder) against decode_png_reference (Python's
    chunk walk, zlib and the numpy row filters) on the written frames and
    on one frame re-encoded with each of the five filter types: every
    pixel equal."""
    import zlib

    from snn_object_detectionddp_tpu_torch.data import png

    inflate_ms = []

    def reference(path):
        data = open(path, "rb").read()
        idat = b"".join(bytes(v) for t, v in png._chunks(data, str(path)) if t == b"IDAT")
        t0 = time.perf_counter()
        zlib.decompress(idat)
        inflate_ms.append((time.perf_counter() - t0) * 1e3)
        return png.decode_png_reference(data, str(path))

    decode_ms = []
    for path in frames:
        t0 = time.perf_counter()
        got = png.read_rgb(path)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        if got.tobytes() != reference(path).tobytes():
            raise AssertionError(f"read_rgb differs from decode_png_reference on {path}")
    img = png.read_rgb(frames[0])
    for ft in range(5):
        path = os.path.join(scratch, f"filter{ft}.png")
        png.write_rgb(path, img, ft)
        got = png.read_rgb(path)
        if not (np.array_equal(got, img) and np.array_equal(reference(path), img)):
            raise AssertionError(f"filter type {ft}: read_rgb or decode_png_reference differs")
    return (f"{len(frames)} written frames and one re-encoded with each of the 5 filter types: "
            f"the C++ decoder byte-equal to decode_png_reference; read_rgb of one "
            f"{img.shape[0]}x{img.shape[1]} frame on one thread ms {spread(decode_ms)}, beside "
            f"Python's zlib inflate of its IDAT alone {spread(inflate_ms[: len(frames)])}")


@contextlib.contextmanager
def decode_path(path: str):
    """The loader's decode inside the block: "native" (its one path: one
    native.decode_batch call a batch) or "pool", the loader before the
    whole-batch decoder, kept here as the figure it is timed against:
    read_rgb of each sample's frames mapped over the samples on a thread
    pool of the loader's num_threads (at B=2 two of them decode)."""
    from concurrent.futures import ThreadPoolExecutor

    from snn_object_detectionddp_tpu_torch.data.pipeline import BatchLoader
    from snn_object_detectionddp_tpu_torch.data.png import read_rgb

    if path == "native":
        yield
        return
    pools, lock = {}, threading.Lock()  # two loaders' producers may decode at once

    def pool_decode(self, samples):
        with lock:
            pool = pools.get(self.num_threads)
            if pool is None:
                pool = pools[self.num_threads] = ThreadPoolExecutor(self.num_threads)
        fn = self.transform or (lambda f: f)
        return np.stack(list(pool.map(
            lambda s: np.stack([fn(read_rgb(p)) for p in s.frame_paths]), samples)))

    native_decode = BatchLoader._decode
    BatchLoader._decode = pool_decode
    try:
        yield
    finally:
        BatchLoader._decode = native_decode
        for pool in pools.values():
            pool.shutdown()


@contextlib.contextmanager
def counting_decode_batch(native):
    """native.decode_batch counted inside the block: yields [calls]."""
    real, calls = native.decode_batch, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    native.decode_batch = counted
    try:
        yield calls
    finally:
        native.decode_batch = real


def same_batches(a, b) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and x["paths"] == y["paths"]
        and all(x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                and x[k].tobytes() == y[k].tobytes() for k in x if k != "paths")
        for x, y in zip(a, b))


def loader_contention(det, state, batches, loader) -> str:
    """Synchronised train steps of ``det`` (library-driven, as phase 4
    times them) with the host otherwise idle and with ``loader`` decoding
    epoch after epoch in the background, in turns quiet, busy, busy, quiet:
    whether the loader's threads slow the dispatching thread."""
    from snn_object_detectionddp_tpu_torch.train.step import make_optimizer, make_step_fns

    fns = make_step_fns(det, *make_optimizer(1e-4, 100))
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            for _ in loader:
                if stop.is_set():
                    break

    def steps():
        wall, cpu = [], []
        for i in range(N_TIMED_STEPS):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.thread_time()
            fns.train_step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            cpu.append((time.thread_time() - c0) * 1e3)
        return f"({np.median(wall):.3f}, {np.median(cpu):.3f})"

    out = []
    for kind in ("alone", "loader", "loader", "alone"):
        if kind == "alone":
            out.append(f"alone {steps()}")
            continue
        stop.clear()
        thread = threading.Thread(target=churn, daemon=True)
        thread.start()
        try:
            time.sleep(0.5)  # the loader's pool is busy before the first step
            out.append(f"loader {steps()}")
        finally:
            stop.set()
            thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("the background loader did not stop")
    return ", ".join(out)


def run_data_cli_phase(card, K, n_blocks, library_step, scratch) -> dict:
    """The data pipeline and the two command lines at full width: a
    DSEC-shaped tree written by the port's generator (3 sequences x 9
    frames at 480x640, seq_len 5: 15 windows, 2 sequences / 10 windows /
    5 steps of B=2 for training, 1 sequence / 5 windows / a partial third
    batch for validation), read_rgb against decode_png_reference,
    main.train_code for one epoch with each decode path in turns and
    resumed for a second, eval_2.evaluate on best.pt, each with its launch
    counts; the loader alone with each path in turns (native batches
    byte-equal to the pool's), the CLI's host ms per train step with each
    path beside the library-driven step of phase 4 and its device-busy
    share. The native path's decode_batch calls are counted in every run.
    The tree stays under ``scratch`` (``dsec/``) for the data-parallel
    phase. Returns the launches of the runs."""
    import io

    from snn_object_detectionddp_tpu_torch import eval_2
    from snn_object_detectionddp_tpu_torch import main as cli
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.data import native
    from snn_object_detectionddp_tpu_torch.data.dsec import DSECIndex, train_val_split
    from snn_object_detectionddp_tpu_torch.data.pipeline import BatchLoader
    from snn_object_detectionddp_tpu_torch.data.synthetic import make_dataset
    from snn_object_detectionddp_tpu_torch.evals import validator
    from snn_object_detectionddp_tpu_torch.models.detector import Detector

    with counting_decode_batch(native) as native_calls:
        cfg = Config()  # yolo11m, 480x640, s2d4, ConvLSTM, bf16
        h, w = cfg.model.image_size
        t0 = time.perf_counter()
        root = make_dataset(os.path.join(scratch, "dsec"), num_sequences=DATA_SEQS,
                            splits=("train",), num_frames=DATA_FRAMES, height=h, width=w)
        write_s = time.perf_counter() - t0
        frames = sorted(str(p) for p in root.rglob("*.png"))
        print(f"data phase: wrote {len(frames)} {h}x{w} frames with data/synthetic.py in "
              f"{write_s:.2f} s; " + check_png(frames, scratch))

        for split in ("train", "val", "test"):
            cfg.dataset.split(split).path = str(root / "train")
        tr = cfg.training
        tr.batch_size, tr.num_workers, tr.epochs = B_TRAIN, DATA_THREADS, 1
        tr.save_dir = os.path.join(scratch, "run")
        tr.weights_path = os.path.join(tr.save_dir, "latest.pt")
        with contextlib.redirect_stdout(io.StringIO()):
            index = DSECIndex(cfg, "train")
            train_idx, val_idx = train_val_split(index, seed=tr.seed)
        n_train = len(train_idx) // B_TRAIN
        n_val = -(-len(val_idx) // B_TRAIN)
        if (len(index), len(train_idx), len(val_idx)) != (15, 10, 5):
            raise AssertionError(f"index/split {len(index)}/{len(train_idx)}/{len(val_idx)}, want 15/10/5")

        # The loader alone: two epochs of the shuffled train loader, with 1
        # and with DATA_THREADS decode threads, each decode path in turns
        # (pool, native, native, pool); every batch of every turn
        # byte-equal to the first turn's, one decode_batch call a native
        # batch and none a pool batch.
        def make_loader(threads):
            return BatchLoader(index, train_idx, batch_size=B_TRAIN, max_boxes=cfg.model.max_boxes,
                               shuffle=True, seed=tr.seed, num_threads=threads, drop_last=True)

        loader_ms = {}
        for threads in (1, DATA_THREADS):
            first = None
            for path in TURNS:
                calls0, batches = native_calls[0], []
                with decode_path(path):
                    t0 = time.perf_counter()
                    for _ in range(2):
                        batches += list(make_loader(threads))
                    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
                loader_ms.setdefault((threads, path), []).append(ms)
                n_calls = native_calls[0] - calls0
                if n_calls != (len(batches) if path == "native" else 0):
                    raise AssertionError(f"{path} loader: {n_calls} decode_batch calls for "
                                         f"{len(batches)} batches")
                first = first or batches
                if not same_batches(batches, first):
                    raise AssertionError(f"{path} batches at {threads} threads differ from the "
                                         f"pool's")
        if batches[0]["images"].shape != (B_TRAIN, T_TRAIN, h, w, 3):
            raise AssertionError(f"loader batch {batches[0]['images'].shape}")

        # Wrap the step functions train_code makes: per-step launch counts,
        # the host clock and the calling thread's CPU at each step's start,
        # and (when asked) a profiler window over the epoch's train steps.
        make_step_fns = cli.make_step_fns
        record = {}

        def instrumented(*args, **kwargs):
            fns = make_step_fns(*args, **kwargs)

            def counted(kind, fn):
                def step(*a):
                    prof = record.get("prof")
                    if kind == "train" and prof is not None and "t0" not in record:
                        prof.start()
                        record["t0"] = time.perf_counter()
                    if kind == "eval" and prof is not None and "t1" not in record:
                        torch.cuda.synchronize()
                        record["t1"] = time.perf_counter()
                        prof.stop()
                    record["starts"].setdefault(kind, []).append(
                        (time.perf_counter(), time.thread_time()))
                    c0 = dict(K.launch_counts)
                    out = fn(*a)
                    record["steps"].setdefault(kind, []).append(
                        {k: K.launch_counts[k] - c0[k] for k in c0})
                    return out
                return step

            return fns._replace(train_step=counted("train", fns.train_step),
                                eval_step=counted("eval", fns.eval_step))

        def run_cli(profile: bool):
            record.clear()
            record.update(steps={}, starts={})
            if profile:
                record["prof"] = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            det = Detector.from_config(cfg, device="cuda")
            out = io.StringIO()
            cli.make_step_fns = instrumented
            try:
                K.reset_launch_counts()
                with contextlib.redirect_stdout(out):
                    state = cli.train_code(cfg, det)
                torch.cuda.synchronize()
                launches = dict(K.launch_counts)
            finally:
                cli.make_step_fns = make_step_fns
            return state, launches, out.getvalue(), det

        want_train = {"affine_lif_fwd": 0, "affine_lif_fwd_res": n_blocks, "affine_lif_bwd": n_blocks}
        want_eval = {"affine_lif_fwd": n_blocks, "affine_lif_fwd_res": 0, "affine_lif_bwd": 0}
        # One epoch: 20 A2 + 20 A3 a train step, 20 A1 a validation step,
        # and 20 A1 for the spike-rate pass train_loop makes over the first
        # validation batch.
        want_epoch = {"affine_lif_fwd": n_blocks * (n_val + 1),
                      "affine_lif_fwd_res": n_blocks * n_train, "affine_lif_bwd": n_blocks * n_train}
        total = dict.fromkeys(want_epoch, 0)

        def check_epoch(tag, launches, log):
            steps = record["steps"]
            if (len(steps.get("train", [])) != n_train or any(c != want_train for c in steps["train"])
                    or len(steps.get("eval", [])) != n_val or any(c != want_eval for c in steps["eval"])
                    or launches != want_epoch):
                raise AssertionError(f"{tag}: launches {launches} (want {want_epoch}); per step "
                                     f"{steps}")
            for k in total:
                total[k] += launches[k]
            for name in ("latest.pt", "best.pt"):
                if not os.path.exists(os.path.join(tr.save_dir, name)):
                    raise AssertionError(f"{tag}: train_code wrote no {name}")
            print(f"{tag}: " + " | ".join(l for l in log.splitlines()
                                          if l.startswith(("---", "Total", "Resum", "Average"))))

        def run_decoded(tag, path, profile):
            """run_cli with the loader's decode path set, its decode_batch
            calls checked: at least one a train and a validation batch on
            the native path, none on the pool's."""
            calls0 = native_calls[0]
            with decode_path(path):
                state, launches, log, det = run_cli(profile)
            n_calls = native_calls[0] - calls0
            if not (n_calls >= n_train + n_val if path == "native" else n_calls == 0):
                raise AssertionError(f"{tag}: {n_calls} decode_batch calls with the {path} path")
            check_epoch(f"{tag}, {path} decode, {n_calls} decode_batch calls", launches, log)
            return state, log, det

        # One epoch with each decode path in turns: the host ms between
        # train-step starts and the calling thread's CPU time.
        cli_ms, cli_cpu = {}, {}
        for path in TURNS:
            state, log, _ = run_decoded("main.train_code epoch 1", path, profile=False)
            if state["step"] != n_train or "--- Epoch 1/1 ---" not in log:
                raise AssertionError(f"train_code took {state['step']} steps, want {n_train}")
            starts = record["starts"]["train"]
            cli_ms.setdefault(path, []).extend((b[0] - a[0]) * 1e3 for a, b in zip(starts, starts[1:]))
            cli_cpu.setdefault(path, []).extend((b[1] - a[1]) * 1e3 for a, b in zip(starts, starts[1:]))

        tr.resume_training, tr.epochs = True, 2
        state, log, det = run_decoded("main.train_code resumed", "native", profile=True)
        ckpt = torch.load(tr.weights_path, map_location="cpu", weights_only=True)
        if ("--- Epoch 2/2 ---" not in log or "--- Epoch 1/2 ---" in log
                or state["step"] != 2 * n_train or ckpt["epoch"] != 1
                or ckpt["state"]["step"] != 2 * n_train):
            raise AssertionError(f"resume did not start at epoch 2 and carry the step counter on "
                                 f"(step {state['step']}, checkpoint epoch {ckpt['epoch']})")
        del ckpt
        contention = {}
        for path in ("pool", "native"):
            calls0 = native_calls[0]
            with decode_path(path):
                contention[path] = loader_contention(det, state, batches, make_loader(DATA_THREADS))
            if (native_calls[0] == calls0) == (path == "native"):
                raise AssertionError(f"loader_contention did not run the {path} path")
        del state, det
        prof, window_ms = record["prof"], (record["t1"] - record["t0"]) * 1e3
        evs = kernel_rows(prof)
        dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
        if dev_ms <= 0:
            raise AssertionError("the profiler recorded no device time over the CLI's train steps")
        n_a3 = sum(e.count for e in evs if "affine_lif_bwd_kernel" in e.key)
        if n_a3 != n_blocks * n_train:
            raise AssertionError(f"profiler: {n_a3} affine_lif_bwd_kernel rows over {n_train} steps")

        # eval_2 on best.pt: the partial batch's padded row must not reach
        # the metrics (one update per real window).
        updates = [0]
        metrics_cls = validator.DetMetrics

        class CountingMetrics(metrics_cls):
            def update(self, **kw):
                updates[0] += 1
                return super().update(**kw)

        out = io.StringIO()
        validator.DetMetrics = CountingMetrics
        calls0 = native_calls[0]
        try:
            K.reset_launch_counts()
            with contextlib.redirect_stdout(out), decode_path("native"):
                results = eval_2.evaluate(cfg)
            torch.cuda.synchronize()
            eval_launches = dict(K.launch_counts)
        finally:
            validator.DetMetrics = metrics_cls
        eval_calls = native_calls[0] - calls0
        if eval_calls != n_val:
            raise AssertionError(f"eval_2: {eval_calls} decode_batch calls for {n_val} batches")
        keys = {"metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                "metrics/mAP50-95(B)", "fitness"}
        if set(results) != keys or not all(np.isfinite(v) for v in results.values()):
            raise AssertionError(f"eval_2 results {results}")
        want = {"affine_lif_fwd": n_blocks * n_val, "affine_lif_fwd_res": 0, "affine_lif_bwd": 0}
        if eval_launches != want or updates[0] != len(val_idx) or "Loaded checkpoint" not in out.getvalue():
            raise AssertionError(f"eval_2: launches {eval_launches} (want {want}), {updates[0]} "
                                 f"metric updates for {len(val_idx)} windows in {n_val} batches")
        for k in total:
            total[k] += eval_launches[k]
        print(f"eval_2.evaluate on best.pt ok (native decode, {eval_calls} decode_batch calls): "
              f"{n_val} batches of {B_TRAIN} for {len(val_idx)} windows, {updates[0]} metric "
              f"updates (the padded row never reached them), launches {eval_launches}; results "
              f"(2 epochs on 5 steps) {results}")

        turns = ", ".join(TURNS)
        loader = "; ".join(
            f"{threads} thread{'s' * (threads > 1)}: " + ", ".join(
                f"{path} {' / '.join(f'{ms:.3f}' for ms in loader_ms[(threads, path)])}"
                for path in ("pool", "native"))
            for threads in (1, DATA_THREADS))
        cli_line = "; ".join(f"{path} {spread(cli_ms[path])} ms between train-step starts, calling "
                             f"thread on the CPU {spread(cli_cpu[path])} ms"
                             for path in ("pool", "native"))
        busy = dev_ms / n_train / float(np.median(cli_ms["native"]))
        print(f"[{card}] data + command line (host clock): BatchLoader alone (B={B_TRAIN} "
              f"T={T_TRAIN} {h}x{w}, shuffled, {len(batches)} batches a turn, turns {turns}; "
              f"native batches byte-equal to the pool's) ms/batch: {loader}; main.train_code "
              f"epoch 1 in turns {turns}: {cli_line}; beside phase 4's library-driven step "
              f"{library_step['step_ms']:.3f} ms (thread on the CPU {library_step['thread_ms']:.3f} "
              f"ms); resumed epoch under the profiler (native decode): {window_ms / n_train:.3f} "
              f"ms per train step over the window, device (kernel) time {dev_ms / n_train:.3f} "
              f"ms/step (phase 4: {library_step['dev_ms']:.3f}), busy {busy:.1%} of the "
              f"unprofiled median native CLI step, {dev_ms / window_ms:.1%} of the profiled "
              f"window; the same train step synchronised, alone and with a {DATA_THREADS}-thread "
              f"BatchLoader decoding beside it, in turns (ms, thread on the CPU ms): "
              + "; ".join(f"{path} loader: {contention[path]}" for path in ("pool", "native")))
        return total


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_step_check(card, K, n_blocks, rng) -> dict:
    """(i) The data-parallel step over a one-rank NCCL group against the
    library step at full width, on the same batches from cloned states:
    an all-reduce over one rank is the identity and x + (x - x) is x, so
    losses, parameters and moments must be bit-equal. Also the launches per
    DP step, the gradient all-reduce's device time beside its byte bound,
    and peak memory against the library step. Returns the launches of the
    DP steps."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pmesh
    from snn_object_detectionddp_tpu_torch.train.step import init_state, make_optimizer, make_step_fns

    torch.cuda.set_device(0)
    pmesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    # Deterministic algorithms (cuDNN's, and the gather's backward): the
    # comparison is bit for bit, and a library step that differs from
    # itself would hide what DP does.
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        pmesh.collective_barrier("cuda")
        mesh = pmesh.make_mesh()
        if (mesh.size, mesh.rank, mesh.group is None) != (1, 0, False):
            raise AssertionError(f"one-rank NCCL mesh {mesh}")
        cfg = Config()  # yolo11m, 480x640, s2d4, ConvLSTM, bf16
        h, w = cfg.model.image_size
        det = Detector.from_config(cfg, device="cuda")
        params = det.init_params(torch.Generator().manual_seed(SEED + 2))
        n_params = sum(v.numel() for v in params.values())
        tr = cfg.training
        tx, sched = make_optimizer(tr.learning_rate, 10, tr.weight_decay, tr.grad_clip_norm,
                                   tr.pct_start)
        library, dp = make_step_fns(det, tx, sched), make_step_fns(det, tx, sched, mesh=mesh)
        clone = lambda: {k: v.clone() for k, v in params.items()}  # noqa: E731
        st_lib, st_dp = init_state(clone(), tx, sched), init_state(clone(), tx, sched)
        want = {"affine_lif_fwd": 0, "affine_lif_fwd_res": n_blocks, "affine_lif_bwd": n_blocks}
        launches = dict.fromkeys(want, 0)
        peak, step_ms, rows, metric_diffs = {}, {"dp": [], "library": []}, [], []
        batches = [moving_boxes_batch(rng, B_TRAIN, T_TRAIN, h, w, cfg.model.num_classes)
                   for _ in range(N_DP_STEPS)]
        for i, batch in enumerate(batches):
            for kind in ("dp", "library"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                c0, t0 = dict(K.launch_counts), time.perf_counter()
                if kind == "dp":
                    st_dp, m_dp = dp.train_step(st_dp, batch)
                else:
                    st_lib, m_lib = library.train_step(st_lib, batch)
                torch.cuda.synchronize()
                step_ms[kind].append((time.perf_counter() - t0) * 1e3)
                peak[kind] = max(peak.get(kind, 0), torch.cuda.max_memory_allocated())
                got = {k: K.launch_counts[k] - c0[k] for k in c0}
                if got != want:
                    raise AssertionError(f"{kind} step {i} launched {got}, want {want}")
                if kind == "dp":
                    for k in launches:
                        launches[k] += got[k]
            m_dp = {k: float(v) for k, v in m_dp.items()}
            m_lib = {k: float(v) for k, v in m_lib.items()}
            rows.append(f"loss {m_dp['loss']:.6f} grad_norm {m_dp['grad_norm']:.4f}")
            if m_dp != m_lib:
                metric_diffs.append((i, {k: (m_dp[k], m_lib[k]) for k in m_dp if m_dp[k] != m_lib[k]}))

        def state_diffs(a, b) -> dict:
            out = {}
            for part in ("params", "mu", "nu"):
                ta = a["params"] if part == "params" else a["opt_state"][part]
                tb = b["params"] if part == "params" else b["opt_state"][part]
                for k, v in ta.items():
                    if not torch.equal(tb[k], v):
                        out[f"{part} {k}"] = (tb[k] - v).abs().max().item()
            return out

        diffs = state_diffs(st_lib, st_dp)
        if diffs or metric_diffs:
            # The reason, on the first batch from the initial parameters:
            # does the library's gradient repeat itself bit for bit, does the
            # DP gradient equal it, and does the clip's norm differ?
            from snn_object_detectionddp_tpu_torch.train.step import global_norm

            g_a, _ = library.grads(params, batches[0])
            g_b, _ = library.grads(params, batches[0])
            g_dp, _ = dp.grads(params, batches[0])
            neq = lambda x, y: sum(not torch.equal(x[k], y[k]) for k in x)  # noqa: E731
            norms = [float(global_norm(g.values())) for g in (g_a, g_b, g_dp)]
            norm_copy = float(global_norm([v.clone() for v in g_dp.values()]))
            strided = sum(not g.is_contiguous() for g in g_a.values())
            reason = (f"library gradient vs itself: {neq(g_a, g_b)} leaves differ; DP vs library "
                      f"gradient: {neq(g_dp, g_a)} leaves differ ({strided} library leaves not "
                      f"contiguous); global norms library "
                      f"{norms[0]!r} / {norms[1]!r}, DP {norms[2]!r}, DP copied out of the flat "
                      f"buffer {norm_copy!r}")
            worst = max(diffs.items(), key=lambda kv: kv[1]) if diffs else None
            raise AssertionError(f"DP and library steps are not bit-equal over {N_DP_STEPS} "
                                 f"steps: metrics {metric_diffs}; {len(diffs)} state tensors "
                                 f"differ, largest {worst}; {reason}")
        print(f"[{card}] DP step (one-rank NCCL group, make_step_fns(mesh=make_mesh())) vs the "
              f"library step, full width {cfg.model.yolo_model_name} {h}x{w} bf16, T={T_TRAIN} "
              f"B={B_TRAIN}, {N_DP_STEPS} steps from cloned states on the same batches: bit-equal "
              f"losses and metrics ({'; '.join(rows)}), "
              f"bit-equal parameters, mu and nu ({n_params} each); launches per DP step {want}; "
              f"host ms per step DP {[round(x, 3) for x in step_ms['dp']]}, library "
              f"{[round(x, 3) for x in step_ms['library']]}; peak memory DP "
              f"{peak['dp'] / 2**30:.3f} GiB, library {peak['library'] / 2**30:.3f} GiB "
              f"(+{(peak['dp'] - peak['library']) / 2**20:.1f} MiB)")
        del st_lib, library

        # The gradient all-reduce alone: the copy into the flat buffer, one
        # SUM over it, views out. Device time with the host's enqueue hidden
        # behind a device sleep (time_cuda): ~150 small host ops a call
        # would otherwise show as device idle. Each call reads the same
        # 527.6 MB, beyond the L2.
        grads = {k: torch.randn_like(v) for k, v in params.items()}
        n_bytes = 4 * n_params
        flat = torch.empty(n_params, device="cuda")
        reps = dict(bytes_per_call=2 * n_bytes, min_bytes=N_ALLREDUCE_REPS * 2 * n_bytes)
        whole_ms = time_cuda(lambda: pmesh.all_reduce_grads(grads, mesh), tuple, **reps)
        ar_ms = time_cuda(lambda: torch.distributed.all_reduce(flat, group=mesh.group), tuple,
                          **reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_ALLREDUCE_REPS):
            pmesh.all_reduce_grads(grads, mesh)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / N_ALLREDUCE_REPS
        out = pmesh.all_reduce_grads(grads, mesh)
        if not all(torch.equal(out[k], g) for k, g in grads.items()):
            raise AssertionError("the all-reduce over one rank changed a gradient")
        bound_ms = 2 * n_bytes / HBM_BYTES_PER_S * 1e3  # read each gradient, write the sum
        print(f"[{card}] DP overhead: all_reduce_grads of {n_params} fp32 gradients "
              f"({n_bytes / 1e6:.1f} MB) {whole_ms:.4f} ms device time (CUDA events, host "
              f"enqueue hidden), of which the one-rank NCCL all-reduce of the flat buffer alone "
              f"{ar_ms:.4f} ms and the copy into it (segments aligned to "
              f"{pmesh.SEGMENT_ALIGN} elements) the rest; {host_ms:.4f} ms a call on the host "
              f"clock, synchronised, mean of {N_ALLREDUCE_REPS}; bound {bound_ms:.4f} ms (each "
              f"gradient read once and the sum written once, {2 * n_bytes / 1e9:.3f} GB at "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s), {bound_ms / whole_ms:.0%} of it; host time "
              f"{host_ms / float(np.median(step_ms['dp'][1:])):.2%} of the DP step's median "
              f"host ms")
        del grads, flat, out, st_dp, dp, det, params
        torch.cuda.empty_cache()
        return launches
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[:2]
        torch.use_deterministic_algorithms(flags[2])
        torch.distributed.destroy_process_group()


def run_parallel_axes_phase(card, K, n_blocks, lif_shapes, gen, rng, scratch) -> dict:
    """Item 15: FSDP and tensor parallelism (parallel/mesh.py parts (c)
    and (e)). Returns the launches of its main-path runs (the FSDP step and
    the tensor-mesh forwards)."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.evals.validator import make_predict_fn
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams, affine_lif_tb_reference
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pmesh
    from snn_object_detectionddp_tpu_torch.train.step import (
        init_state,
        make_optimizer,
        make_step_fns,
    )

    t_phase = time.perf_counter()
    launches = dict.fromkeys(K.KERNELS, 0)
    # (iii) A1 at every spiking block's C/2 and C/4 shard (a tensor group of
    # 2 or 4 runs each block on these widths), B=1 T=1 and T=5 B=2, bit for
    # bit against the plain version; the widths whose C is no multiple of
    # the 8-channel vector take the scalar path.
    p = LIFParams()
    scalar, n_shapes = [], 0
    for name, (_, hh, ww, cc) in lif_shapes:
        for k in (2, 4):
            c = cc // k
            for t_steps, bsz in ((1, 1), (T_TRAIN, B_TRAIN)):
                x4, a, b, v0 = lif_inputs((bsz, hh, ww, c), t_steps, gen)
                got = K.affine_lif_fwd(x4, a, b, p, v0, False)
                ref = affine_lif_tb_reference(x4, a, b, p, v0, False)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                    raise AssertionError(f"A1 at the C/{k} shard of {name} ({hh}x{ww}x{c}) T="
                                         f"{t_steps} B={bsz} is not bit-equal to the plain version")
                n_shapes += 1
                if t_steps == 1 and K.fwd_plan(bsz, hh * ww, c, x4.dtype, True).vec == 1:
                    nbytes = lif_bytes(hh * ww * c, 1, c, 1, False)
                    make = lambda s=(1, hh, ww, c): lif_inputs(s, 1, gen)  # noqa: E731
                    us = time_cuda(lambda *t: K.affine_lif_fwd(*t[:3], p, t[3]), make, nbytes) * 1e3
                    scalar.append(f"{name} C/{k}={c} ({hh}x{ww}): {us:.2f} us, bound "
                                  f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f} us")
    print(f"[{card}] phase 15: A1 at the C/2 and C/4 channel shards of the {n_blocks} blocks, "
          f"{n_shapes} shapes (B=1 T=1 and T={T_TRAIN} B={B_TRAIN}): bit-equal to the plain "
          f"version; scalar path (C not a multiple of 8) at B=1 T=1: "
          + ("; ".join(scalar) if scalar else "none"))

    torch.cuda.set_device(0)
    pmesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        pmesh.collective_barrier("cuda")
        mesh = pmesh.make_mesh()
        cfg = Config()  # yolo11m, 480x640, s2d4, ConvLSTM, bf16
        h, w = cfg.model.image_size
        det = Detector.from_config(cfg, device="cuda")
        params = det.init_params(torch.Generator().manual_seed(SEED + 5))
        tr = cfg.training
        tx, sched = make_optimizer(tr.learning_rate, 10, tr.weight_decay, tr.grad_clip_norm,
                                   tr.pct_start)
        # (i) FSDP over a one-rank NCCL group against the library step: the
        # all-gather and reduce-scatter over one rank are copies and every
        # leaf's chunk is the leaf flattened, so one step is bit-equal.
        library = make_step_fns(det, tx, sched)
        fsdp = make_step_fns(det, tx, sched, mesh=mesh, fsdp=True)
        clone = lambda: {k: v.clone() for k, v in params.items()}  # noqa: E731
        st_lib = init_state(clone(), tx, sched)
        st_f = fsdp.shard_state(init_state(clone(), tx, sched))
        kept = sum(t.numel() * t.element_size()
                   for part in (st_f["params"], st_f["opt_state"]["mu"], st_f["opt_state"]["nu"])
                   for t in part.values())
        batch = moving_boxes_batch(rng, B_TRAIN, T_TRAIN, h, w, cfg.model.num_classes)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_f, m_f = fsdp.train_step(st_f, batch)
        torch.cuda.synchronize()
        f_ms = (time.perf_counter() - t0) * 1e3
        got = dict(K.launch_counts)
        want = {"affine_lif_fwd": 0, "affine_lif_fwd_res": n_blocks, "affine_lif_bwd": n_blocks}
        if got != want:
            raise AssertionError(f"the FSDP step launched {got}, want {want}")
        for k_ in launches:
            launches[k_] += got[k_]
        st_lib, m_lib = library.train_step(st_lib, batch)
        m_f = {k_: float(v) for k_, v in m_f.items()}
        m_lib = {k_: float(v) for k_, v in m_lib.items()}
        whole = fsdp.gather_state(st_f)
        diffs = [f"{part} {k_}" for part in ("params", "mu", "nu") for k_, v in (
            st_lib["params"] if part == "params" else st_lib["opt_state"][part]).items()
            if not torch.equal(v, whole["params"][k_] if part == "params"
                               else whole["opt_state"][part][k_])]
        if m_f != m_lib or diffs:
            raise AssertionError(f"FSDP over one rank is not bit-equal to the library step: "
                                 f"metrics {m_f} vs {m_lib}; {len(diffs)} tensors differ "
                                 f"({diffs[:4]})")
        print(f"[{card}] phase 15: FSDP step (one-rank NCCL group, make_step_fns(mesh=make_mesh(), "
              f"fsdp=True)) vs the library step, full width {cfg.model.yolo_model_name} {h}x{w} "
              f"bf16, T={T_TRAIN} B={B_TRAIN}: bit-equal loss {m_f['loss']:.6f}, grad_norm "
              f"{m_f['grad_norm']:.4f}, parameters, mu and nu; launches {got}; state kept "
              f"{kept} bytes (parameters + moments, the whole at one rank); host {f_ms:.1f} ms")
        del st_lib, st_f, whole, library, fsdp
        torch.cuda.empty_cache()

        # (ii) The tensor-mesh entry points over a tensor axis of 1:
        # make_predict_fn(mesh=) and a DetectionService(mesh=) equal the
        # plain ones bit for bit.
        tmesh = pmesh.make_mesh(1, tensor=1)
        images = rng.randint(0, 256, size=(1, T_TRAIN, h, w, 3), dtype=np.uint8)
        K.reset_launch_counts()
        got_p = make_predict_fn(det, mesh=tmesh)(pmesh.tp_shard_params(params, tmesh), images)
        torch.cuda.synchronize()
        a1 = K.launch_counts["affine_lif_fwd"]
        launches["affine_lif_fwd"] += a1
        want_p = make_predict_fn(det)(params, images)
        if a1 != n_blocks or not all(torch.equal(got_p[k_], v) for k_, v in want_p.items()):
            raise AssertionError(f"predict over a tensor axis of 1: {a1} A1 launches, outputs "
                                 f"equal {[torch.equal(got_p[k_], v) for k_, v in want_p.items()]}")
        print(f"[{card}] phase 15: make_predict_fn(mesh=make_mesh(1, tensor=1)) T={T_TRAIN} B=1: "
              f"bit-equal to the plain predict ({int(want_p['valid'].sum())} kept), {a1} A1 "
              f"launches")
        del det, params
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[:2]
        torch.use_deterministic_algorithms(flags[2])
        torch.distributed.destroy_process_group()

    # (iii b) mesh.fsdp through torchrun and main on the data phase's tree:
    # its checkpoints hold the whole state, in the format of the
    # data-parallel run's (same leaves, same shapes).
    fsdp_latest = torch.load(os.path.join(os.path.dirname(torchrun_epoch(card, scratch, fsdp=True)),
                                          "latest.pt"), map_location="cpu", weights_only=True)
    dp_latest = torch.load(os.path.join(scratch, "dp_run", "latest.pt"), map_location="cpu",
                           weights_only=True)
    shapes = lambda c: {k: tuple(v.shape) for k, v in c["state"]["params"].items()}  # noqa: E731
    if shapes(fsdp_latest) != shapes(dp_latest) or shapes(fsdp_latest) != {
            k: tuple(v.shape) for k, v in fsdp_latest["state"]["opt_state"]["mu"].items()}:
        raise AssertionError("the FSDP run's latest.pt is not in the data-parallel run's format")
    print(f"[{card}] phase 15: the mesh.fsdp run's latest.pt holds the whole state: "
          f"{len(shapes(fsdp_latest))} leaves of the data-parallel run's shapes")
    del fsdp_latest, dp_latest

    # (iv) Two cards: the FSDP step and the tensor-parallel predict over two
    # processes against one card (scripts/torch_parallel_cards.py --quick).
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[{card}] phase 15: the two-card FSDP and tensor-parallel checks skipped: "
              f"torch.cuda.device_count() is {n_cards} (scripts/torch_parallel_cards.py runs "
              "them on a host with several cards)")
    else:
        script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                              "torch_parallel_cards.py")
        for only in ("fsdp", "tensor"):
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "2", script, "--quick", "--only", only],
                capture_output=True, text=True, timeout=600)
            if proc.returncode:
                raise AssertionError(f"two-card {only} check failed:\n{proc.stdout[-3000:]}\n"
                                     f"{proc.stderr[-3000:]}")
            print(f"[{card}] phase 15: two cards, {only}: {proc.stdout.strip().splitlines()[-1]}")
    print(f"phase 15 ok in {time.perf_counter() - t_phase:.1f} s")
    return launches


def check_row_shard_kernels(card, K, lif_mod, lif_shapes, gen) -> None:
    """(i) A1, A2 and A3 at the local rows of every spiking block for each
    spatial group size, plus a shard with no row; these launches compare
    the kernels with their plain versions and are not counted as the main
    path's."""
    from snn_object_detectionddp_tpu_torch.parallel.mesh import row_partition

    shapes, thin = {}, []
    for s in SPATIAL_SIZES:
        for name, (_, hh, ww, cc) in lif_shapes:
            rows = [hi - lo for lo, hi in (row_partition(hh, s, r) for r in range(s))]
            for r, n in enumerate(rows):
                shapes.setdefault((n, ww, cc), f"{name} s={s} rank {r}")
            if min(rows) <= 1:
                thin.append(f"{name} s={s} ({hh} rows): {rows}")
    # 64 input rows over 4 ranks: the stride-32 blocks have 2 rows, ranks 2 and 3 none
    _, (_, _, w32, c32) = next(x for x in lif_shapes if x[0] == "unet.enc3")
    shapes.setdefault((0, w32, c32), "unet.enc3 at a 64-row input, s=4 rank 2")
    p = lif_mod.LIFParams()
    sum_rel, launched = 0.0, 0
    for (hl, ww, cc), label in sorted(shapes.items()):
        tag = f"A1-A3 at {label} ({hl}x{ww}x{cc}, T={T_TRAIN} B={B_TRAIN})"
        x4, a, b, v0 = lif_inputs((B_TRAIN, hl, ww, cc), T_TRAIN, gen)
        c0, k0 = dict(K.launch_counts), dict(K.skipped_empty)
        s1, vf1 = K.affine_lif_fwd(x4, a, b, p, v0)
        s2, vpre, vf2 = K.affine_lif_fwd_res(x4, a, b, p, v0)
        g_s = torch.randn(x4.shape, device="cuda", generator=gen).to(torch.bfloat16)
        g_v = torch.randn(v0.shape, device="cuda", generator=gen)
        g_x, g_a, g_b, g_v0 = K.affine_lif_bwd(vpre, x4, a, g_s, g_v, p)
        torch.cuda.synchronize()
        dl = {k: K.launch_counts[k] - c0[k] for k in K.KERNELS}
        ds = {k: K.skipped_empty[k] - k0[k] for k in K.KERNELS}
        want = (0, 1) if hl == 0 else (1, 0)
        if any((dl[k], ds[k]) != want for k in K.KERNELS):
            raise AssertionError(f"{tag}: launches {dl}, skipped {ds}; want {want} each")
        launched += sum(dl.values())
        r1 = lif_mod.affine_lif_tb_reference(x4, a, b, p, v0)
        r2 = lif_mod.affine_lif_forward_reference(x4, a, b, p, v0, with_vpre=True)
        rg = lif_mod.affine_lif_backward_reference(vpre, x4, a, g_s, g_v, p)
        equal = {"A1 spikes": (s1, r1[0]), "A1 v_final": (vf1, r1[1]), "A2 spikes": (s2, r2[0]),
                 "A2 v_final": (vf2, r2[1]), "A2 v_pre": (vpre, r2[3]), "A3 g_x": (g_x, rg[0]),
                 "A3 g_v0": (g_v0, rg[3])}
        differ = [k for k, (u, v) in equal.items() if u.shape != v.shape or not torch.equal(u, v)]
        if differ:
            raise AssertionError(f"{tag}: not bit-equal to the plain version: {differ}")
        if hl:
            g_cur = lif_mod.affine_lif_backward_reference(
                vpre.float(), x4.float(), torch.ones_like(a), g_s.float(), g_v, p
            )[0].view(T_TRAIN, B_TRAIN, hl, ww, cc)
            abs_b = g_cur.abs().sum((2, 3))
            abs_a = (g_cur * x4.float().view_as(g_cur)).abs().sum((2, 3))
            for nm, got, ref, terms in (("da", g_a, rg[1], abs_a), ("db", g_b, rg[2], abs_b)):
                rel = ((got - ref).abs() / (terms + 1e-30)).max().item()
                sum_rel = max(sum_rel, rel)
                if rel > SUM_RTOL:
                    raise AssertionError(f"{tag}: {nm} error {rel} of the summed |terms|")
        elif g_a.abs().max() or g_b.abs().max():
            raise AssertionError(f"{tag}: a shard with no row has nonzero affine gradients")
    print(f"[{card}] phase 16: A1, A2 and A3 at the {len(shapes)} row-shard shapes of the "
          f"{len(lif_shapes)} blocks for s in {SPATIAL_SIZES} and one shard with no row: spikes, "
          f"v_final, v_pre, g_x and g_v0 bit-equal to the plain versions, da/db worst "
          f"{sum_rel:.3g} of the summed |terms| (limit {SUM_RTOL}); {launched} launches, the "
          f"shard with no row launched none (skipped_empty 1 each); shards of one or no row: "
          + "; ".join(thin))


def spatial_one_rank_check(card, K, n_blocks, rng) -> dict:
    """(ii) mesh.spatial: 1 over a one-rank NCCL group: the train step and
    the predict bit-equal to the library step and the plain predict.
    Returns their launches."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.evals.validator import make_predict_fn
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pmesh
    from snn_object_detectionddp_tpu_torch.train.step import init_state, make_optimizer, make_step_fns

    torch.cuda.set_device(0)
    pmesh.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        pmesh.collective_barrier("cuda")
        mesh = pmesh.make_mesh(1, spatial=1)
        cfg = Config()  # yolo11m, 480x640, s2d4, ConvLSTM, bf16
        h, w = cfg.model.image_size
        det = Detector.from_config(cfg, device="cuda")
        params = det.init_params(torch.Generator().manual_seed(SEED + 6))
        tr = cfg.training
        tx, sched = make_optimizer(tr.learning_rate, 10, tr.weight_decay, tr.grad_clip_norm,
                                   tr.pct_start)
        library, spatial = make_step_fns(det, tx, sched), make_step_fns(det, tx, sched, mesh=mesh)
        clone = lambda: {k: v.clone() for k, v in params.items()}  # noqa: E731
        st_lib, st_sp = init_state(clone(), tx, sched), init_state(clone(), tx, sched)
        batch = moving_boxes_batch(rng, B_TRAIN, T_TRAIN, h, w, cfg.model.num_classes)
        K.reset_launch_counts()
        st_sp, m_sp = spatial.train_step(st_sp, batch)
        torch.cuda.synchronize()
        got = dict(K.launch_counts)
        want = {"affine_lif_fwd": 0, "affine_lif_fwd_res": n_blocks, "affine_lif_bwd": n_blocks}
        if got != want:
            raise AssertionError(f"the spatial=1 step launched {got}, want {want}")
        st_lib, m_lib = library.train_step(st_lib, batch)
        m_sp = {k: float(v) for k, v in m_sp.items()}
        m_lib = {k: float(v) for k, v in m_lib.items()}
        diffs = [f"{part} {k}" for part in ("params", "mu", "nu") for k, v in (
            st_lib["params"] if part == "params" else st_lib["opt_state"][part]).items()
            if not torch.equal(v, st_sp["params"][k] if part == "params"
                               else st_sp["opt_state"][part][k])]
        if m_sp != m_lib or diffs:
            raise AssertionError(f"spatial=1 over one rank is not bit-equal to the library step: "
                                 f"metrics {m_sp} vs {m_lib}; {len(diffs)} tensors differ "
                                 f"({diffs[:4]})")
        images = rng.randint(0, 256, size=(B_TRAIN, T_TRAIN, h, w, 3), dtype=np.uint8)
        K.reset_launch_counts()
        got_p = make_predict_fn(det, mesh=mesh)(params, images)
        torch.cuda.synchronize()
        a1 = K.launch_counts["affine_lif_fwd"]
        want_p = make_predict_fn(det)(params, images)
        if a1 != n_blocks or not all(torch.equal(got_p[k], v) for k, v in want_p.items()):
            raise AssertionError(f"predict with spatial=1: {a1} A1 launches, outputs equal "
                                 f"{[torch.equal(got_p[k], v) for k, v in want_p.items()]}")
        print(f"[{card}] phase 16: train step and make_predict_fn over a one-rank NCCL group "
              f"with make_mesh(1, spatial=1), full width {h}x{w} bf16 T={T_TRAIN} B={B_TRAIN}: "
              f"bit-equal to the library step (loss {m_sp['loss']:.6f}, grad_norm "
              f"{m_sp['grad_norm']:.4f}, parameters, mu and nu) and to the plain predict "
              f"({int(want_p['valid'].sum())} kept); launches {got} a step, {a1} A1 a predict")
        got["affine_lif_fwd"] += a1
        return got
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[:2]
        torch.use_deterministic_algorithms(flags[2])
        torch.distributed.destroy_process_group()


def gloo_probe(rank: int, port: int) -> None:
    """Child of :func:`run_spatial_phase` (``--gloo-probe RANK PORT``): two
    processes on card 0 over gloo run the collectives of spatial
    parallelism on CUDA tensors (an uneven all-to-all and an all-reduce)
    and check the results; exits non-zero if gloo refuses them."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    x = torch.arange(6.0, device="cuda").view(3, 2) + 10 * rank
    ins, outs = ([1, 2], [1, 0]) if rank == 0 else ([0, 3], [2, 3])
    out = torch.empty(sum(outs), 2, device="cuda")
    dist.all_to_all_single(out, x, outs, ins)
    want = [[0, 1]] if rank == 0 else [[2, 3], [4, 5], [10, 11], [12, 13], [14, 15]]
    total = torch.ones(3, device="cuda")
    dist.all_reduce(total)
    if out.tolist() != want or total.tolist() != [2.0] * 3:
        raise SystemExit(f"gloo on CUDA tensors gave {out.tolist()} (want {want}) and "
                         f"{total.tolist()}")
    dist.destroy_process_group()


def run_spatial_phase(card, K, lif_mod, n_blocks, lif_shapes, gen, rng) -> dict:
    """Item 16: spatial parallelism. Returns the launches of its main-path
    runs (the spatial=1 step and predict)."""
    t_phase = time.perf_counter()
    check_row_shard_kernels(card, K, lif_mod, lif_shapes, gen)
    launches = spatial_one_rank_check(card, K, n_blocks, rng)
    torch.cuda.empty_cache()

    # (iii) Two spatial ranks against one process.
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                          "torch_parallel_cards.py")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           script, "--quick", "--only", "spatial"]
    n_cards = torch.cuda.device_count()
    route = "two cards over NCCL"
    if n_cards < 2:
        port = free_port()
        probes = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-probe",
                                    str(r), str(port)], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = [p_.communicate(timeout=300)[0] for p_ in probes]
        if any(p_.returncode for p_ in probes):
            print(f"[{card}] phase 16: two spatial ranks skipped: one card "
                  f"(torch.cuda.device_count() is {n_cards}) and its gloo refuses the spatial "
                  f"collectives on CUDA tensors: {logs[0].strip()[-400:]}")
            cmd = None
        else:
            cmd.append("--one-card")
            route = "both on card 0 over gloo (one card; NCCL takes one process a card)"
    if cmd is not None:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise AssertionError(f"two spatial ranks ({route}) failed:\n{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        print(f"[{card}] phase 16: two spatial ranks, {route}, against one process: "
              f"{proc.stdout.strip().splitlines()[-1]}")
    print(f"phase 16 ok in {time.perf_counter() - t_phase:.1f} s")
    return launches


def torchrun_epoch(card, scratch, fsdp: bool = False) -> str:
    """(ii) One epoch of the command line through torchrun (one process,
    NCCL) on the data phase's tree, the config read without PyYAML: the
    child's import log (PYTHONPROFILEIMPORTTIME) must name no yaml module.
    Rank 0 writes the checkpoints. With ``fsdp`` the config sets
    ``mesh.fsdp: true``. Returns the best.pt path."""
    root = os.path.join(scratch, "dsec", "train")
    run = "fsdp" if fsdp else "dp"
    save_dir = os.path.join(scratch, f"{run}_run")
    cfg_path = os.path.join(scratch, f"{run}_config.yaml")
    split = "\n".join(f"  {s}:\n    path: \"{root}\"\n    seq_len: {T_TRAIN}"
                      for s in ("train", "val", "test"))
    with open(cfg_path, "w") as f:
        f.write(f"# one epoch of the default model through torchrun\ndataset:\n{split}\n"
                f"mode: \"train\"\ntraining:\n  batch_size: {B_TRAIN}\n  num_workers: "
                f"{DATA_THREADS}\n  epochs: 1\n  save_dir: \"{save_dir}\"\n  weights_path: "
                f"\"{save_dir}/latest.pt\"\nmesh:\n  data: -1  # the whole process group\n"
                + ("  fsdp: true\n" if fsdp else ""))
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPROFILEIMPORTTIME="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "snn_object_detectionddp_tpu_torch.main", "--config", cfg_path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    imports = [l.rsplit("|", 1)[-1].strip() for l in proc.stderr.splitlines()
               if l.startswith("import time:")]
    errors = "\n".join(l for l in proc.stderr.splitlines() if not l.startswith("import time:"))
    if proc.returncode != 0:
        raise AssertionError(f"torchrun exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{errors[-4000:]}")
    yaml_mods = sorted({m for m in imports if m == "yaml" or m.startswith("yaml.")})
    if yaml_mods or not imports:
        raise AssertionError(f"the torchrun child imported {yaml_mods} (import log of "
                             f"{len(imports)} modules)")
    log = proc.stdout
    needed = ("torch.distributed initialized (nccl): process 0/1", "--- Epoch 1/1 ---",
              "Training finished!", "Best checkpoint written") + (
              ("FSDP over 1 process(es): this rank keeps",) if fsdp else ())
    if not all(n in log for n in needed):
        raise AssertionError(f"torchrun log lacks {[n for n in needed if n not in log]}:\n{log[-4000:]}")
    best = os.path.join(save_dir, "best.pt")
    ckpt = torch.load(os.path.join(save_dir, "latest.pt"), map_location="cpu", weights_only=True)
    if not os.path.exists(best) or ckpt["epoch"] != 0 or ckpt["state"]["step"] != 5:
        raise AssertionError(f"torchrun epoch: checkpoint epoch {ckpt['epoch']}, step "
                             f"{ckpt['state']['step']} (want 0, 5), best.pt {os.path.exists(best)}")
    del ckpt
    here = ("installed on this machine, not imported by the child"
            if importlib.util.find_spec("yaml") else "not installed on this machine")
    print(f"[{card}] torchrun --standalone --nproc_per_node 1 -m snn_object_detectionddp_tpu_torch.main "
          f"--config{' (mesh.fsdp: true)' if fsdp else ''} (YAML subset reader; PyYAML {here}; {len(imports)} modules imported, none "
          f"of yaml): one epoch on the 480x640 tree in {wall:.1f} s of wall time, child and "
          f"launcher start included; rank 0 wrote latest.pt (epoch 0, step 5) and best.pt; log: "
          + " | ".join(l for l in log.splitlines()
                       if l.startswith(("torch.distributed", "Total", "Average", "New best",
                                        "FSDP"))))
    return best


def serve_checkpoint(card, best) -> None:
    """(iii) serve() on the torchrun run's best.pt, on a free port: a PNG of
    the served size and one of another size, POSTed; each reply must equal
    DetectionService.detect of the same decoded and resized frame."""
    import base64
    import urllib.request

    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.data.png import decode_png, write_rgb
    from snn_object_detectionddp_tpu_torch.data.resize import resize_linear_u8
    from snn_object_detectionddp_tpu_torch.serve import serve
    from snn_object_detectionddp_tpu_torch.train.checkpoint import load_checkpoint

    cfg = Config()
    h, w = cfg.model.image_size
    ready, held = threading.Event(), {}

    def on_ready(httpd, service):
        held.update(httpd=httpd, service=service)
        ready.set()

    th = threading.Thread(target=serve, args=(cfg, best),
                          kwargs=dict(port=0, max_batch=1, max_clip=1, on_ready=on_ready),
                          daemon=True)
    th.start()
    try:
        if not ready.wait(timeout=600):
            raise AssertionError("serve() did not start listening")
        svc, port = held["service"], held["httpd"].server_address[1]
        packed = load_checkpoint(best, {"params": dict(svc.detector.module.named_parameters())},
                                 "cpu")
        if not all(torch.equal(svc.params[k].cpu(), v) for k, v in packed["state"]["params"].items()):
            raise AssertionError("serve() did not load best.pt's parameters")
        del packed
        svc.conf = 0.0  # every candidate, so that the comparison is not empty
        rng = np.random.RandomState(SEED + 3)
        lines = []
        with tempfile.TemporaryDirectory() as tmp:
            for size in ((h, w), (360, 500)):
                img = rng.randint(0, 256, (*size, 3), dtype=np.uint8)
                path = os.path.join(tmp, "upload.png")
                write_rgb(path, img)
                data = open(path, "rb").read()
                body = json.dumps({"stream": f"http{size}", "image": base64.b64encode(data).decode()})
                t0 = time.perf_counter()
                with urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{port}/detect", body.encode()), timeout=300) as r:
                    out = json.loads(r.read())
                post_ms = (time.perf_counter() - t0) * 1e3
                frame = decode_png(data)
                if frame.shape[:2] != (h, w):
                    frame = resize_linear_u8(frame, (h, w))
                ref = svc.detect(f"ref{size}", frame)
                keys = ("boxes", "scores", "classes")
                if {k: out[k] for k in keys} != {k: ref[k] for k in keys} or not out["scores"]:
                    raise AssertionError(f"HTTP reply for a {size} PNG differs from detect() "
                                         f"({len(out['scores'])} vs {len(ref['scores'])} detections)")
                lines.append(f"{size[0]}x{size[1]} PNG: {len(out['scores'])} detections equal to "
                             f"detect() of the decoded{' and resized' if size != (h, w) else ''} "
                             f"frame, {post_ms:.1f} ms for the POST")
        print(f"[{card}] serve() of the torchrun best.pt on port {port} (weights equal to the "
              f"file's, conf 0): " + "; ".join(lines))
    finally:
        if "httpd" in held:
            held["httpd"].shutdown()
        th.join(timeout=120)
    if th.is_alive():
        raise AssertionError("serve() did not return after shutdown")


def run_parallel_phase(card, K, n_blocks, scratch, rng) -> dict:
    """Data parallelism over torch.distributed at full width: (i) the DP
    step against the library step over a one-rank NCCL group, (ii) the
    command line through torchrun on the data phase's tree, (iii) serve()
    of its best.pt over HTTP. Returns the DP steps' launches."""
    launches = dp_step_check(card, K, n_blocks, rng)
    serve_checkpoint(card, torchrun_epoch(card, scratch))
    return launches


BANNED_IMPORTS = ("jax", "jaxlib", "flax", "msgpack", "cv2", "yaml")


def run_child(module: str, args: list[str], timeout: int = 900):
    """``python -m <module> <args>`` in a child process with its import
    log (PYTHONPROFILEIMPORTTIME); returns (the completed process, the
    modules it imported, wall seconds)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPROFILEIMPORTTIME="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    imports = [l.rsplit("|", 1)[-1].strip() for l in proc.stderr.splitlines()
               if l.startswith("import time:")]
    return proc, imports, wall


def child_errors(proc) -> str:
    return "\n".join(l for l in proc.stderr.splitlines() if not l.startswith("import time:"))


def banned_imports(imports: list[str]) -> list[str]:
    return sorted({m for m in imports if m.split(".")[0] in BANNED_IMPORTS})


METRIC_ATOL = 5e-3  # the card's fixture metrics against the JAX package's on the CPU
N_CONV_REPS = 20  # timed repetitions of each changed conv


def run_child_eval(card, cfg_path: str, weights: str) -> dict:
    """``python -m snn_object_detectionddp_tpu_torch.eval_2`` in a child
    process; its import log (PYTHONPROFILEIMPORTTIME) must name none of
    jax, flax, msgpack, cv2 or yaml. Returns the printed metrics."""
    proc, imports, wall = run_child("snn_object_detectionddp_tpu_torch.eval_2",
                                    ["--config", cfg_path, "--weights", weights])
    if proc.returncode != 0:
        raise AssertionError(f"eval_2 exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{child_errors(proc)[-4000:]}")
    banned = banned_imports(imports)
    if banned or not imports:
        raise AssertionError(f"the eval_2 child imported {banned[:10]} ({len(imports)} modules)")
    metrics = {}
    for line in proc.stdout.splitlines():
        key, _, value = line.partition(": ")
        if key.startswith(("metrics/", "fitness")) and value:
            metrics[key.strip()] = float(value)
    if "Loaded flax checkpoint" not in proc.stdout or len(metrics) != 5:
        raise AssertionError(f"eval_2 child output:\n{proc.stdout[-4000:]}")
    print(f"[{card}] eval_2 child ({len(imports)} modules imported, none of jax/flax/msgpack/cv2/"
          f"yaml): {wall:.1f} s of wall time, process start included")
    return metrics


def time_changed_convs(card) -> None:
    """Device time of the convs that keep an fp32 result in bf16
    (conv2d_nhwc(..., f32_result=True)), one full-width T=5 B=2 forward's
    worth, in three forms on the same inputs: a bf16 conv (before), an fp32
    conv of bf16 values with TF32 (after, set_tf32_policy("bf16")) and
    without TF32."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models import convlstm, layers
    from snn_object_detectionddp_tpu_torch.models.detector import Detector, tf32_policy

    det = Detector.from_config(Config(), device="cuda")
    params = det.init_params(torch.Generator().manual_seed(SEED))
    calls, plain = [], layers.conv2d_nhwc

    def record(x, weight, stride=1, f32_result=False, name=None, rows=None):
        if f32_result:
            calls.append((x.detach().clone(), weight.detach().clone(), stride))
        return plain(x, weight, stride, f32_result, name, rows)

    h, w = Config().model.image_size
    frames = torch.rand((T_TRAIN, B_TRAIN, h, w, 3), generator=torch.Generator().manual_seed(SEED))
    layers.conv2d_nhwc = convlstm.conv2d_nhwc = record
    try:
        with torch.no_grad():
            det.apply(params, frames.cuda())
    finally:
        layers.conv2d_nhwc = convlstm.conv2d_nhwc = plain
    del det, params

    def device_ms(f32_result: bool, policy: str) -> float:
        total = 0.0
        with tf32_policy(policy):
            for x, wt, stride in calls:
                plain(x, wt, stride, f32_result)  # algorithm choice, warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(N_CONV_REPS):
                    plain(x, wt, stride, f32_result)
                end.record()
                torch.cuda.synchronize()
                total += start.elapsed_time(end) / N_CONV_REPS
        return total

    before = device_ms(False, "bf16")
    after_tf32 = device_ms(True, "bf16")
    after_fp32 = device_ms(True, "f32")
    again = device_ms(False, "bf16")
    n_el = sum(x.numel() for x, _, _ in calls)
    print(f"[{card}] the {len(calls)} convs of a T={T_TRAIN} B={B_TRAIN} full-width bf16 forward "
          f"that keep an fp32 result ({n_el / 1e6:.1f}M input elements), device ms summed, "
          f"{N_CONV_REPS} back-to-back calls each: bf16 result (before) {before:.4f} / "
          f"{again:.4f}, fp32 result of bf16 values with TF32 (after) {after_tf32:.4f}, without "
          f"TF32 {after_fp32:.4f}")


def run_fixture_phase(card, K, scratch) -> dict:
    """Phase 12: the hard fixture written by the port, its checkpoint
    evaluated on the card by eval_2 (child processes) and in-process."""
    from snn_object_detectionddp_tpu_torch import eval_2
    from snn_object_detectionddp_tpu_torch.config import load_config
    from snn_object_detectionddp_tpu_torch.data import fixtures

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    nano = fixtures.make_hard_nano(os.path.join(scratch, "hard_nano"))
    gen_s = time.perf_counter() - t0
    n_frames = sum(len(s) for s in fixtures.NANO_SEEDS.values()) * fixtures.NANO["num_frames"]
    digest = fixtures.tree_digest(nano)
    if digest != fixtures.NANO_DIGEST:
        raise AssertionError(f"nano tree digest {digest} != pinned {fixtures.NANO_DIGEST}")
    print(f"[{card}] make_hard_nano: {n_frames} frames of 128x160 in {gen_s:.2f} s "
          f"({n_frames / gen_s:.1f} frames/s, PNG writes included); digest = pinned {digest[:16]}")
    t0 = time.perf_counter()
    flag = fixtures.write_tree(os.path.join(scratch, "flagship"), fixtures.FLAGSHIP,
                               {"train": fixtures.FLAGSHIP_SEEDS["train"][:1]})
    flag_s = time.perf_counter() - t0
    digest = fixtures.tree_digest(os.path.join(flag, "train", "seq_00"))
    if digest != fixtures.FLAGSHIP_SEQ00_DIGEST:
        raise AssertionError(f"flagship seq_00 digest {digest} != pinned {fixtures.FLAGSHIP_SEQ00_DIGEST}")
    n_flag = fixtures.FLAGSHIP["num_frames"]
    print(f"[{card}] flagship train/seq_00: {n_flag} frames of 480x640 in {flag_s:.2f} s "
          f"({1000 * flag_s / n_flag:.1f} ms per frame); digest = pinned {digest[:16]}")

    text = open(os.path.join(repo, "scripts", "hard_nano.yaml")).read()
    weights = os.path.join(repo, "fixtures", "hard_nano_ckpt.pt")
    card_metrics = {}
    for precision in ("f32", "bf16"):
        cfg_path = os.path.join(scratch, f"hard_nano_{precision}.yaml")
        with open(cfg_path, "w") as f:
            f.write(text.replace("fixtures/hard_nano", str(nano))
                    .replace('precision: "bf16"', f'precision: "{precision}"'))
        cfg = load_config(cfg_path)  # the YAML-subset reader
        if cfg.runtime.precision != precision or not cfg.dataset.train.path.startswith(str(nano)):
            raise AssertionError(f"{cfg_path}: precision {cfg.runtime.precision}, train path "
                                 f"{cfg.dataset.train.path}")
        card_metrics[precision] = got = run_child_eval(card, cfg_path, weights)
        want = fixtures.JAX_F32_METRICS if precision == "f32" else fixtures.JAX_BF16_METRICS
        gap = {k: round(got[k] - want[k], 5) for k in fixtures.METRIC_KEYS}
        print(f"[{card}] fixture checkpoint on the card, {precision}: {got}; JAX package on the "
              f"CPU {({k: round(v, 5) for k, v in want.items()})}; card - JAX {gap}")
        if precision == "f32" and any(abs(g) > METRIC_ATOL for g in gap.values()):
            raise AssertionError(f"f32 fixture metrics beyond {METRIC_ATOL} of JAX's: {gap}")

    # bf16 once in-process: 20 A1 launches an evaluation batch.
    cfg = load_config(os.path.join(scratch, "hard_nano_bf16.yaml"))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    results = eval_2.evaluate(cfg, weights)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = dict(K.launch_counts)
    from snn_object_detectionddp_tpu_torch.data.dsec import DSECIndex, train_val_split

    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock

    _, val_idx = train_val_split(DSECIndex(cfg, "train"), seed=cfg.training.seed)
    n_batches = -(-len(val_idx) // cfg.training.batch_size)
    # the nano model (yolo11n, width 0.25) has fewer spiking blocks than the default
    n_blocks = sum(isinstance(m, SpikingConvBlock)
                   for m in Detector.from_config(cfg, device="cuda").module.modules())
    want = {"affine_lif_fwd": n_blocks * n_batches, "affine_lif_fwd_res": 0, "affine_lif_bwd": 0}
    if launches != want:
        raise AssertionError(f"in-process bf16 evaluation: launches {launches}, want {want}")
    if any(abs(results[k] - card_metrics["bf16"][k]) > 1e-5 for k in fixtures.METRIC_KEYS):
        raise AssertionError(f"in-process bf16 evaluation {results} differs from the eval_2 "
                             f"child's {card_metrics['bf16']}")
    print(f"[{card}] eval_2.evaluate in-process, bf16: {n_batches} batches of "
          f"{cfg.training.batch_size} for {len(val_idx)} windows in {eval_s:.1f} s, "
          f"{launches['affine_lif_fwd']} A1 launches ({n_blocks} an evaluation batch); results "
          f"equal to the child's (to 1e-5)")
    time_changed_convs(card)
    return launches


N_FLOW_TIMED = 20  # PWCLite calls timed at the 0.5 downsample
def edge_colors(img_rgb: np.ndarray, box, colors_bgr) -> bool:
    """Whether a pixel within one pixel of the rounded box's outline has
    one of the colours (a thickness-2 rectangle covers such pixels)."""
    h, w = img_rgb.shape[:2]
    x1, y1, x2, y2 = (int(round(float(v))) for v in box)
    ys, xs = np.arange(min(y1, y2) - 1, max(y1, y2) + 2), np.arange(min(x1, x2) - 1, max(x1, x2) + 2)
    ys, xs = ys[(ys >= 0) & (ys < h)], xs[(xs >= 0) & (xs < w)]
    if not len(ys) or not len(xs):
        return False
    on_edge = ((np.abs(ys[:, None] - y1) <= 1) | (np.abs(ys[:, None] - y2) <= 1)
               | (np.abs(xs[None, :] - x1) <= 1) | (np.abs(xs[None, :] - x2) <= 1))
    patch = img_rgb[np.ix_(ys, xs)]
    hit = np.zeros(on_edge.shape, bool)
    for c in colors_bgr:
        hit |= np.all(patch == np.array(c[::-1], np.uint8), axis=-1)
    return bool((hit & on_edge).any())


def check_overlay(img_rgb: np.ndarray, boxes, classes, palette) -> None:
    """Every kept box's outline holds a palette colour (a box drawn later
    may cover it), the last one drawn its own class's."""
    for box in boxes:
        if not edge_colors(img_rgb, box, palette):
            raise AssertionError(f"no palette colour on the edge of box {box}")
    if len(boxes) and not edge_colors(img_rgb, boxes[-1], [palette[int(classes[-1]) % len(palette)]]):
        raise AssertionError(f"the last box {boxes[-1]} lacks its class's colour")


FLOW_PX_TOL, FLOW_FRAC_OFF, FLOW_MAX_TOL = 1e-3, 1e-3, 0.1  # px; share of pixels; px
N_FARNEBACK_ROUNDS, N_FARNEBACK_PER_ROUND = 4, 15  # 240x320 calls timed, in turns with OpenCV's
N_FARNEBACK_PROFILED = 20


def flow_gap(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(max |difference| in px, share of pixels off by more than
    FLOW_PX_TOL in either component) of two (H, W, 2) flows; raises beyond
    the tolerances."""
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"flow {got.shape} (finite: {np.isfinite(got).all()}) vs {want.shape}")
    diff = np.abs(got - want).max(-1)
    worst, off = float(diff.max()), float((diff > FLOW_PX_TOL).mean())
    if worst > FLOW_MAX_TOL or off > FLOW_FRAC_OFF:
        raise AssertionError(f"flow differs: max |d| {worst:.3e} px, {off:.3e} of pixels off by "
                             f"more than {FLOW_PX_TOL} px")
    return worst, off


def cv2_farneback(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's ``calcOpticalFlowFarneback`` at the tracker's parameters,
    the reference where this machine has OpenCV (the port never needs it)."""
    cv2 = importlib.import_module("cv2")
    return cv2.calcOpticalFlowFarneback(a, b, None, 0.5, 3, 15, 3, 5, 1.2, 0)


def run_farneback_checks(card, K, KL, n_blocks, det, lively, paths, has_cv2) -> dict:
    """Phase 13's Farneback flow (evals/farneback.py) on the card: against
    the port's CPU run (and OpenCV where importable) on seq_00's frame
    pairs at the 0.5 downsample (240x320), and through the tracker; one
    sequence of detector + Farneback flow with the adaptive stride, counts
    zeroed before and read after, whose boxes must equal those of the same
    run with the flow on the CPU; then times. Returns that run's launches."""
    from snn_object_detectionddp_tpu_torch.data.color import bgr_to_gray_u8
    from snn_object_detectionddp_tpu_torch.data.png import read_rgb
    from snn_object_detectionddp_tpu_torch.data.resize import rescale_u8
    from snn_object_detectionddp_tpu_torch.evals import flow as flow_mod
    from snn_object_detectionddp_tpu_torch.evals import legacy

    frames = [read_rgb(p_)[..., ::-1] for p_ in paths]  # BGR, as the tracker reads them
    small = [rescale_u8(bgr_to_gray_u8(f), 0.5) for f in frames]
    gaps = {"cpu": [], "cv2": []}
    for a, b in zip(small[:-1], small[1:]):
        got = flow_mod.farneback_flow(a, b, device="cuda")
        gaps["cpu"].append(flow_gap(got, flow_mod.farneback_flow(a, b, device="cpu")))
        if has_cv2:
            gaps["cv2"].append(flow_gap(got, cv2_farneback(a, b)))
    whole = [flow_gap(flow_mod.get_optical_flow(f0, f1, "farneback", 0.5, device="cuda"),
                      flow_mod.get_optical_flow(f0, f1, "farneback", 0.5, device="cpu"))
             for f0, f1 in zip(frames[:2], frames[1:3])]
    h2, w2 = small[0].shape

    def worst(rows):
        return (f"max |d| {max(r[0] for r in rows):.3e} px, at most {max(r[1] for r in rows):.2e} "
                f"of pixels off by more than {FLOW_PX_TOL} px")

    print(f"[{card}] Farneback on the card at {h2}x{w2} over {len(small) - 1} frame pairs of "
          f"seq_00 (gray, the 0.5 downsample): against the port's CPU run {worst(gaps['cpu'])}; "
          + (f"against cv2.calcOpticalFlowFarneback (OpenCV "
             f"{sys.modules['cv2'].__version__}) {worst(gaps['cv2'])}" if has_cv2 else
             "the comparison with cv2.calcOpticalFlowFarneback skipped (OpenCV not installed)")
          + f"; get_optical_flow(farneback, 0.5) of two BGR frames card vs CPU {worst(whole)}")

    torch.cuda.synchronize()
    K.reset_launch_counts()
    KL.reset_launch_counts()
    stats = legacy.process_sequence(det, lively, paths, method="optical_flow",
                                    flow_method="farneback",
                                    compute_stride=legacy.default_adaptive_stride)
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    want = {"affine_lif_fwd": n_blocks * stats["det_count"], "affine_lif_fwd_res": 0,
            "affine_lif_bwd": 0}
    if launches != want or any(KL.launch_counts.values()):
        raise AssertionError(f"Farneback sequence: launches {launches} {dict(KL.launch_counts)}, "
                             f"want {want} and no scan kernel")
    if stats["det_count"] + stats["flow_count"] != len(paths) or not stats["flow_count"]:
        raise AssertionError(f"Farneback sequence: {stats['det_count']} detector + "
                             f"{stats['flow_count']} flow frames of {len(paths)}")
    if not all(np.isfinite(d).all() for d in stats["detections"]):
        raise AssertionError("non-finite tracked boxes")
    card_flow = legacy.get_optical_flow

    def host_flow(prev, cur, method, downsample, device):
        return card_flow(prev, cur, method, downsample, device="cpu")

    legacy.get_optical_flow = host_flow
    try:
        host = legacy.process_sequence(det, lively, paths, method="optical_flow",
                                       flow_method="farneback",
                                       compute_stride=legacy.default_adaptive_stride)
    finally:
        legacy.get_optical_flow = card_flow
    same = (host["stride_list"] == stats["stride_list"]
            and len(host["detections"]) == len(stats["detections"])
            and all(np.array_equal(a, b) for a, b in zip(host["detections"], stats["detections"])))
    if not same:
        raise AssertionError(f"tracked boxes with the flow on the card differ from the CPU flow's: "
                             f"strides {stats['stride_list']} vs {host['stride_list']}")
    print(f"[{card}] process_sequence(optical_flow, flow 'farneback', default_adaptive_stride) "
          f"over {len(paths)} frames of seq_00: {stats['det_count']} detector + "
          f"{stats['flow_count']} flow frames, strides {stats['stride_list']}, "
          f"{sum(len(d) for d in stats['detections'])} tracked boxes (class biases at 0), equal to "
          f"the same run with the flow on the CPU; A1 launches {launches['affine_lif_fwd']} = "
          f"{n_blocks} x {stats['det_count']}, no other kernel")

    # times: one call at 240x320, in turns with OpenCV's where importable
    a, b = small[0], small[1]
    for _ in range(5):
        flow_mod.farneback_flow(a, b, device="cuda")
        if has_cv2:
            cv2_farneback(a, b)
    port_ms, cv2_ms = [], []
    for _ in range(N_FARNEBACK_ROUNDS):
        for _ in range(N_FARNEBACK_PER_ROUND):
            t0 = time.perf_counter()
            flow_mod.farneback_flow(a, b, device="cuda")
            port_ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(N_FARNEBACK_PER_ROUND if has_cv2 else 0):
            t0 = time.perf_counter()
            cv2_farneback(a, b)
            cv2_ms.append((time.perf_counter() - t0) * 1e3)
    tracker_ms = []
    for _ in range(N_FARNEBACK_PER_ROUND):
        t0 = time.perf_counter()
        flow_mod.get_optical_flow(frames[0], frames[1], "farneback", 0.5, device="cuda")
        tracker_ms.append((time.perf_counter() - t0) * 1e3)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(N_FARNEBACK_PROFILED):
            flow_mod.farneback_flow(a, b, device="cuda")
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    copies = [e for e in rows if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in rows if e not in copies]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / N_FARNEBACK_PROFILED
    n_kernels = sum(e.count for e in kernels) / N_FARNEBACK_PROFILED
    n_copies = sum(e.count for e in copies) / N_FARNEBACK_PROFILED
    if dev_ms <= 0 or not n_kernels:
        raise AssertionError("the profiler recorded no Farneback kernel")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:3]
    cv2_part = (f"cv2.calcOpticalFlowFarneback on this host ({os.cpu_count()} cores) ms "
                f"{spread(cv2_ms)}" if has_cv2 else "cv2 not installed: its time not measured")
    print(f"[{card}] Farneback times at {h2}x{w2}: farneback_flow on the card host ms "
          f"{spread(port_ms)} a call ({len(port_ms)} calls in {N_FARNEBACK_ROUNDS} rounds, in "
          f"turns with OpenCV's), device (kernel) ms {dev_ms:.3f} a call (profiler), "
          f"{n_kernels:.0f} kernel launches and {n_copies:.0f} copies a call; {cv2_part}; the "
          f"tracker's get_optical_flow(farneback, 0.5) of two {frames[0].shape[0]}x"
          f"{frames[0].shape[1]} BGR frames (gray, halving, flow, upsampling, copy) ms "
          f"{spread(tracker_ms)}; the longest kernels: "
          + ", ".join(f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top))
    return launches


def run_side_pipelines_phase(card, K, KL, n_blocks, scratch) -> dict:
    """Phase 13: the tracker benchmark, the learned flow, the overlays and
    the video at full width, on the data phase's best.pt and a test split
    with tracks.npy. Returns the launches of the in-process runs."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.convert import load_weights
    from snn_object_detectionddp_tpu_torch.data.color import bgr_to_gray_u8
    from snn_object_detectionddp_tpu_torch.data.dsec import DSECIndex
    from snn_object_detectionddp_tpu_torch.data.pipeline import BatchLoader
    from snn_object_detectionddp_tpu_torch.data.png import read_rgb, write_rgb
    from snn_object_detectionddp_tpu_torch.data.resize import rescale_u8
    from snn_object_detectionddp_tpu_torch.data.synthetic import make_dataset
    from snn_object_detectionddp_tpu_torch.evals import legacy
    from snn_object_detectionddp_tpu_torch.evals.flow import flow_flops_per_frame, get_model_flow
    from snn_object_detectionddp_tpu_torch.evals.validator import make_predict_fn
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.ops.boxes import scale_boxes
    from snn_object_detectionddp_tpu_torch.viz import overlay
    from snn_object_detectionddp_tpu_torch.viz.palette import _PALETTE
    from snn_object_detectionddp_tpu_torch.viz.video import stitch_video

    has_cv2 = importlib.util.find_spec("cv2") is not None
    print(f"[{card}] phase 13: OpenCV (cv2) is {'importable' if has_cv2 else 'not installed'} "
          "on this machine")
    cfg = Config()  # yolo11m, 480x640, s2d4, ConvLSTM, bf16
    h, w = cfg.model.image_size
    seq_len = cfg.dataset.test.seq_len
    t0 = time.perf_counter()
    root = make_dataset(os.path.join(scratch, "dsec_test"), num_sequences=DATA_SEQS,
                        splits=("test",), num_frames=DATA_FRAMES, height=h, width=w)
    print(f"phase 13: wrote a test split with tracks.npy, {DATA_SEQS} sequences x {DATA_FRAMES} "
          f"frames of {h}x{w}, in {time.perf_counter() - t0:.2f} s")
    cfg.dataset.test.path = str(root / "test")
    save_dir = os.path.join(scratch, "run")  # the data phase's save_dir
    best = os.path.join(save_dir, "best.pt")
    cfg_path = os.path.join(scratch, "side_config.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"# the tracker benchmark and the overlays of the default model\ndataset:\n"
                f"  test:\n    path: \"{root / 'test'}\"\n    seq_len: {seq_len}\n"
                f"mode: \"visualize\"\ntraining:\n  num_workers: {DATA_THREADS}\n"
                f"  save_dir: \"{save_dir}\"\n")

    # The data phase's model keeps no box at the pipelines' conf 0.3 (its
    # class-logit biases start near -8 and it trained for 10 steps); the same
    # weights with those biases at 0 keep boxes, so that the crop program,
    # the tracking and the drawing run on the card too (in-process).
    det = Detector.from_config(cfg, device="cuda")
    params = load_weights(det, best)
    lively = {k: torch.zeros_like(v) if k.startswith("head.cls") and k.endswith("_out.bias") else v
              for k, v in params.items()}

    # (3) the tracker benchmark's command line, in child processes
    for method in ("entire_model", "cropped_model", "optical_flow"):  # the last: Farneback
        proc, imports, wall = run_child("snn_object_detectionddp_tpu_torch.eval",
                                        ["--config", cfg_path, "--method", method, "--weights", best])
        if proc.returncode != 0:
            raise AssertionError(f"eval --method {method} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-4000:]}\n{child_errors(proc)[-4000:]}")
        if banned_imports(imports) or not imports:
            raise AssertionError(f"the eval child imported {banned_imports(imports)[:10]} "
                                 f"({len(imports)} modules)")
        out = proc.stdout
        agg = json.loads(out[out.rindex("\n{") + 1:])
        if set(agg) != {"fps_incl_retrieval", "fps_excl_retrieval", "blended_flops_per_frame",
                        "avg_iou", "precision", "num_detections"} or not agg["fps_excl_retrieval"] > 0:
            raise AssertionError(f"eval --method {method} aggregate: {agg}")
        seqs = [l for l in out.splitlines() if l.startswith("[seq_")]
        print(f"[{card}] eval --method {method} child on the data phase's best.pt ({len(imports)} "
              f"modules imported, none of {'/'.join(BANNED_IMPORTS)}; {wall:.1f} s of wall time, "
              f"process start included): FPS incl {agg['fps_incl_retrieval']:.3f} / excl "
              f"{agg['fps_excl_retrieval']:.3f}, blended {agg['blended_flops_per_frame'] / 1e9:.3f} "
              f"GFLOPs/frame, avg_iou {agg['avg_iou']:.4f}, precision@0.5 {agg['precision']:.4f}, "
              f"{agg['num_detections']} detections; " + " | ".join(seqs))

    # (4) the learned flow on the card, then one sequence of detector +
    # learned flow in-process with the launch counts
    mf = get_model_flow("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epe = mf.fit_translations()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    predict, predict_crop = legacy.make_track_fns(det, lively)
    ch, cw = legacy._crop_hw(h, w)
    zero = np.zeros((1, h, w, 3), np.uint8)
    # The FLOP counts of the two step programs (and of the flow at the 0.5
    # downsample): counted once per geometry, so the benchmark's own run
    # below finds them and launches nothing for them.
    stream_flops = legacy.model_flops(det, "stream", predict, zero, predict(zero, None)[1])
    crop_flops = legacy.model_flops(det, "crop", predict_crop, np.zeros((1, ch, cw, 3), np.uint8))
    flow_flops = flow_flops_per_frame("model", h, w, 0.5)
    paths = sorted(str(p) for p in (root / "test" / "seq_00" / "images/left/distorted").glob("*.png"))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    KL.reset_launch_counts()
    stats = legacy.process_sequence(det, lively, paths, method="optical_flow", flow_method="model",
                                    compute_stride=legacy.default_adaptive_stride)
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    want = {"affine_lif_fwd": n_blocks * stats["det_count"], "affine_lif_fwd_res": 0,
            "affine_lif_bwd": 0}
    if launches != want or any(KL.launch_counts.values()):
        raise AssertionError(f"learned-flow sequence: launches {launches} {dict(KL.launch_counts)}, "
                             f"want {want} and no scan kernel")
    if stats["det_count"] + stats["flow_count"] != len(paths) or not stats["flow_count"]:
        raise AssertionError(f"learned-flow sequence: {stats['det_count']} detector + "
                             f"{stats['flow_count']} flow frames of {len(paths)}")
    if not all(np.isfinite(d).all() for d in stats["detections"]):
        raise AssertionError("non-finite tracked boxes")
    print(f"[{card}] learned flow: fit_translations (600 steps at 64x64, Adam 1e-3) on the card in "
          f"{fit_s:.2f} s, final mean end-point error {epe:.4f} px; process_sequence(optical_flow, "
          f"flow 'model', default_adaptive_stride) over {len(paths)} frames of seq_00: "
          f"{stats['det_count']} detector + {stats['flow_count']} flow frames, strides "
          f"{stats['stride_list']}, {sum(len(d) for d in stats['detections'])} tracked boxes "
          f"(class biases at 0); A1 launches {launches['affine_lif_fwd']} = {n_blocks} x "
          f"{stats['det_count']}, no other kernel")

    K.reset_launch_counts()
    crop = legacy.process_sequence(det, lively, paths, method="cropped_model")
    torch.cuda.synchronize()
    crop_launches = dict(K.launch_counts)
    if (crop_launches != {**want, "affine_lif_fwd": n_blocks * crop["det_count"]}
            or not crop["crop_det_count"] or any(KL.launch_counts.values())):
        raise AssertionError(f"cropped sequence: {crop['crop_det_count']} crops, launches "
                             f"{crop_launches}")
    for k, v in crop_launches.items():
        launches[k] += v
    print(f"[{card}] process_sequence(cropped_model) over seq_00, class biases at 0: "
          f"{crop['det_count']} detector frames, {crop['crop_det_count']} of them in the "
          f"{ch}x{cw} window; blended {crop['blended_flops_per_frame'] / 1e9:.3f} GFLOPs a frame; "
          f"A1 launches {crop_launches['affine_lif_fwd']} = {n_blocks} x {crop['det_count']}")

    launches_fb = run_farneback_checks(card, K, KL, n_blocks, det, lively, paths, has_cv2)
    for k, v in launches_fb.items():
        launches[k] += v

    # (5) mode: visualize, as a child on the same best.pt and test split
    vis_dir = os.path.join(save_dir, "visualizations")
    proc, imports, wall = run_child("snn_object_detectionddp_tpu_torch.main", ["--config", cfg_path])
    index = DSECIndex(cfg, "test")
    last_names = {os.path.basename(s_.last_frame_path) for s_ in index.samples}
    if has_cv2:
        written = sorted(n for n in os.listdir(vis_dir) if n.endswith(".png")) if os.path.isdir(vis_dir) else []
        if proc.returncode != 0 or set(written) != last_names:
            raise AssertionError(f"visualize child exited {proc.returncode}, wrote {written}, want "
                                 f"{sorted(last_names)}:\n{proc.stdout[-3000:]}\n{child_errors(proc)[-3000:]}")
        branch = f"cv2 importable: the child exited 0 and wrote {len(written)} PNGs ({wall:.1f} s)"
    else:
        loaded = "Loaded checkpoint" in proc.stdout or "Model with val loss" in proc.stdout
        if proc.returncode == 0 or "cv2.putText" not in child_errors(proc) or loaded:
            raise AssertionError(f"visualize child without cv2: exit {proc.returncode}, loaded "
                                 f"{loaded}:\n{proc.stdout[-3000:]}\n{child_errors(proc)[-3000:]}")
        branch = (f"cv2 absent: the child exited {proc.returncode} before loading best.pt, naming "
                  f"cv2.putText ({wall:.1f} s): "
                  + child_errors(proc).strip().splitlines()[-1][:200])
    print(f"[{card}] main --config (mode: visualize) child: {branch}")

    # the overlay's card part in-process: predict at B=8, scale, draw without
    # text, write; for best.pt (whose boxes the child's PNGs must show) and
    # with the class biases at 0
    loader = BatchLoader(index, list(range(len(index))), batch_size=B_VIZ, shuffle=False,
                         num_threads=DATA_THREADS)
    batches = list(loader)
    predict_viz = make_predict_fn(det, conf=overlay.VIZ_CONF, iou=overlay.VIZ_IOU, multi_label=True)
    for label, prm in (("best.pt", params), ("class biases at 0", lively)):
        out_dir = os.path.join(scratch, "vis_inprocess", label.split()[0])
        os.makedirs(out_dir)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        model_ms, draw_ms, kept = [], [], {}
        for batch in batches:
            t0 = time.perf_counter()
            out = {k: v.cpu().numpy() for k, v in predict_viz(prm, batch["images"]).items()}
            t1 = time.perf_counter()
            for i, path in enumerate(batch["paths"]):
                orig = read_rgb(path)[..., ::-1]
                valid = out["valid"][i]
                boxes, classes = out["boxes"][i][valid], out["classes"][i][valid]
                if boxes.size:
                    boxes = scale_boxes(torch.from_numpy(boxes), batch["images"].shape[2:4],
                                        orig.shape[:2]).numpy()
                img = overlay.draw_bboxes(orig, boxes, None, classes)  # no text, as in JAX
                write_rgb(os.path.join(out_dir, os.path.basename(path)), img[..., ::-1])
                kept[os.path.basename(path)] = (boxes, classes)  # the window written last
            model_ms.append((t1 - t0) * 1e3)
            draw_ms.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        viz_launches = dict(K.launch_counts)
        if viz_launches != {"affine_lif_fwd": n_blocks * len(batches), "affine_lif_fwd_res": 0,
                            "affine_lif_bwd": 0}:
            raise AssertionError(f"visualization: launches {viz_launches} for {len(batches)} batches")
        for k, v in viz_launches.items():
            launches[k] += v
        checked_dirs = [out_dir] + ([vis_dir] if has_cv2 and label == "best.pt" else [])
        n_boxes = sum(len(b) for b, _ in kept.values())
        for d in checked_dirs:
            for name, (boxes, classes) in kept.items():
                img = read_rgb(os.path.join(d, name))
                if img.shape != (h, w, 3):
                    raise AssertionError(f"{d}/{name}: {img.shape}")
                check_overlay(img, boxes, classes, _PALETTE)
        if label != "best.pt" and not n_boxes:
            raise AssertionError("the overlays with the class biases at 0 kept no box")
        print(f"[{card}] overlays in-process, {label}: {len(index)} windows in {len(batches)} "
              f"batches of {B_VIZ} (T={seq_len}), {n_boxes} boxes of the {len(kept)} PNGs' windows "
              f"kept at conf {overlay.VIZ_CONF} and drawn without text, each PNG decoded at {h}x{w} "
              f"with palette colours on every box's edge, the last box's own"
              f"{' (the child' + chr(39) + 's PNGs too)' if len(checked_dirs) > 1 else ''}; A1 "
              f"launches {viz_launches['affine_lif_fwd']} = {n_blocks} x {len(batches)}; ms per "
              f"batch, model (predict + copy) {spread(model_ms)}, drawing and PNG writes "
              f"{spread(draw_ms)}")

    # (6) the video
    if has_cv2:
        mp4 = stitch_video(out_dir, os.path.join(scratch, "video", "output.mp4"))
        print(f"[{card}] stitch_video: {mp4}, {os.path.getsize(mp4)} bytes")
    else:
        try:
            stitch_video(out_dir, os.path.join(scratch, "video", "output.mp4"))
        except ImportError as e:
            if "cv2.VideoWriter" not in str(e):
                raise
            print(f"[{card}] stitch_video without cv2 raises ImportError: {e}")
        else:
            raise AssertionError("stitch_video ran without cv2")

    # (7) times
    frames = [read_rgb(p_) for p_ in paths]
    stream_ms, state = [], None
    for rgb in frames:
        t0 = time.perf_counter()
        out, state = predict(rgb[None], state)
        {k: v.cpu() for k, v in out.items()}
        stream_ms.append((time.perf_counter() - t0) * 1e3)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        state = None
        for rgb in frames:
            out, state = predict(rgb[None], state)
            {k: v.cpu() for k, v in out.items()}
        torch.cuda.synchronize()
    stream_dev = sum(e.self_device_time_total for e in kernel_rows(prof)) / 1e3 / len(frames)
    grays = [rescale_u8(bgr_to_gray_u8(f[..., ::-1]), 0.5) for f in frames[:2]]
    flow_ms = []
    for _ in range(N_FLOW_TIMED):
        t0 = time.perf_counter()
        mf.compute(*grays)
        flow_ms.append((time.perf_counter() - t0) * 1e3)
    prof_flow = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                   torch.profiler.ProfilerActivity.CUDA])
    with prof_flow:
        for _ in range(N_FLOW_TIMED):
            mf.compute(*grays)
        torch.cuda.synchronize()
    flow_dev = sum(e.self_device_time_total for e in kernel_rows(prof_flow)) / 1e3 / N_FLOW_TIMED
    if stream_dev <= 0 or flow_dev <= 0:
        raise AssertionError("the profiler recorded no device time")
    print(f"[{card}] tracker times: streamed detector frame (T=1 B=1 {h}x{w}, predict + copy) "
          f"host ms {spread(stream_ms)} over {len(frames)} frames, device (kernel) ms {stream_dev:.3f} "
          f"a frame (profiler); PWCLite at {grays[0].shape[0]}x{grays[0].shape[1]} (the 0.5 "
          f"downsample) host ms {spread(flow_ms)} a call, device ms {flow_dev:.3f}; flops_of: "
          f"streamed step {stream_flops / 1e9:.3f} GFLOPs, crop step ({ch}x{cw}) "
          f"{crop_flops / 1e9:.3f} GFLOPs, learned flow {flow_flops / 1e9:.3f} GFLOPs (convs and "
          f"matmuls only, no hand kernel)")
    return launches


N_EXPORT_FRAMES = 3  # frames streamed through the loaded programs
EXPORT_NMS = dict(conf=0.3, iou=0.45, max_det=100)
EXPORT_WINDOWS, EXPORT_PER_WINDOW = 3, 100  # B=1 frames timed, exported and eager in turns
# Where the reloaded program's detections differ from the eager path's (the
# same operators on the same card should give the same bits), the counts
# and classes must still be equal and the scores within this relative gap.
EXPORT_SCORE_RTOL = 1e-2
T_REMAT_F32, B_REMAT_F32, CHUNK_F32 = 4, 2, 2  # the f32 save_conv check: two chunks
N_HOST_PROFILED = 20  # B=1 frames of each path under cProfile
T_REMAT, B_REMAT, CHUNK = 10, 2, 5  # the bf16 remat cost window
N_REMAT_STEPS = 3  # timed bf16 train steps a variant and pass (two passes, reversed order)
# full and save_conv against no remat in f32: a chunk's convs run over
# fewer frames, for which cuDNN may sum in another order (~1e-7 relative);
# held at 1e-3 on the loss and 1e-2 on the gradient norm on a window where
# no spike flips between the chunked and the unchunked forward (a flipped
# spike makes them different functions downstream, as in gradient_check).
REMAT_LOSS_RTOL, REMAT_GNORM_RTOL = 1e-3, 1e-2
REMAT_VARIANTS = (("none", {}), ("full", {"remat_policy": "full"}),
                  ("save_conv", {"remat_policy": "save_conv"}))


def tree_tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class OpTrace(TorchDispatchMode):
    """Every operator dispatched while entered, with copies of its tensor
    outputs: the first one two runs disagree on is where they part."""

    def __init__(self):
        super().__init__()
        self.log = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.log.append((str(func), [t.detach().clone() for t in tree_tensors(out)]))
        return out


def first_difference(run_a, run_b) -> str:
    """Run two callables under OpTrace; name the first operator whose
    outputs differ between them (or where their operator sequences part)."""
    logs = []
    for run in (run_a, run_b):
        with torch.no_grad(), OpTrace() as trace:
            run()
        torch.cuda.synchronize()
        logs.append(trace.log)
    for i, ((fa, oa), (fb, ob)) in enumerate(zip(*logs)):
        if fa != fb:
            return f"operator {i}: the sequences part ({fa} vs {fb})"
        for a, b in zip(oa, ob):
            if a.shape != b.shape or not torch.equal(a, b):
                err = (a.float() - b.float()).abs().max().item() if a.shape == b.shape else "shape"
                return f"operator {i} {fa}: max |diff| {err}"
    return f"no operator differs ({len(logs[0])} and {len(logs[1])} operators)"


def host_profile(fn, n: int) -> str:
    """cProfile of n calls of fn: total ms a call and the six functions
    with the most own time, in ms a call."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn()
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(v[2] for v in stats.values()) * 1e3 / n
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:6]
    return f"{total:.2f} ms a call under the profiler; own time " + ", ".join(
        f"{func} ({os.path.basename(path)}) {v[2] * 1e3 / n:.2f} ms" for (path, _, func), v in top)


def exported_child(args: list[str]) -> None:
    """``python -m chip_smoke --exported-child INIT STEP BATCH FRAMES OUT``:
    load the three exported programs, stream the frames (init, then step
    carrying the state) and run the batch program on the first seq_len of
    them, counting A1 launches per call; save every output and state to
    OUT and print one JSON line."""
    init_path, step_path, batch_path, frames_path, out_path, seq_len = args
    from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
    from snn_object_detectionddp_tpu_torch.models.detector import set_tf32_policy
    from snn_object_detectionddp_tpu_torch.utils.export import load_serving

    set_tf32_policy("bf16")  # as the parent and the command lines run the default model
    t0 = time.perf_counter()
    init, step, batch = (load_serving(p) for p in (init_path, step_path, batch_path))
    load_s = time.perf_counter() - t0
    frames = np.load(frames_path)
    results, launches, state = [], [], None
    for i in range(N_EXPORT_FRAMES):
        K.reset_launch_counts()
        out, state = init.call(frames[i : i + 1]) if i == 0 else step.call(frames[i : i + 1], state)
        torch.cuda.synchronize()
        launches.append(dict(K.launch_counts))
        results.append((out, state))
    K.reset_launch_counts()
    clip_out = batch.call(frames[None, : int(seq_len)])
    torch.cuda.synchronize()
    launches.append(dict(K.launch_counts))
    from torch.utils._pytree import tree_map

    to_cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    torch.save({"frames": to_cpu(results), "clip": to_cpu(clip_out)}, out_path)
    print(json.dumps({"load_s": load_s, "launches": launches}))


def hold_detections(got: dict, want: dict, tag: str) -> str:
    """Equal valid counts and classes, scores within EXPORT_SCORE_RTOL."""
    n_got, n_want = int(got["valid"].sum()), int(want["valid"].sum())
    if n_got != n_want or not torch.equal(got["classes"], want["classes"]):
        raise AssertionError(f"{tag}: {n_got} vs {n_want} detections or other classes")
    rel = ((got["scores"] - want["scores"]).abs() / want["scores"].abs().clamp(min=1e-6)).max().item()
    if rel > EXPORT_SCORE_RTOL:
        raise AssertionError(f"{tag}: scores {rel:.3g} apart (relative)")
    return f"{tag}: {n_got} detections, classes equal, scores {rel:.3g} apart"


def opcheck_on_card(card, K, lif_shapes, gen) -> None:
    """torch.library.opcheck of the six operators on the card, at the
    stem's shape (T=1, B=1; the scan ops on its elements as (T, N))."""
    from snn_object_detectionddp_tpu_torch.kernels import ops
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams

    p = LIFParams()
    name, (_, hh, ww, cc) = lif_shapes[0]
    x4, a, b, v0 = lif_inputs((1, hh, ww, cc), 1, gen)
    vpre, _, _, g_s, g_v = bwd_inputs(K, (1, hh, ww, cc), 1, p, gen)
    flat = lambda t: t.reshape(1, -1)  # noqa: E731
    cases = {
        ops.affine_lif_fwd: (x4, a, b, v0, *p, True),
        ops.affine_lif_fwd_res: (x4, a, b, v0, *p),
        ops.affine_lif_bwd: (vpre, x4, a, g_s, g_v, *p),
        ops.lif_scan_fwd: (flat(x4), v0.reshape(-1), *p),
        ops.lif_scan_fwd_res: (flat(x4), v0.reshape(-1), *p),
        ops.lif_scan_bwd: (flat(vpre), flat(g_s), g_v.reshape(-1), *p),
    }
    t0 = time.perf_counter()
    for op, args in cases.items():
        torch.library.opcheck(op, args)
    print(f"[{card}] phase 14: opcheck of the six snn_torch operators on the card at {name}'s "
          f"shape (1, {hh}, {ww}, {cc}) bf16: all pass ({time.perf_counter() - t0:.1f} s)")


def export_and_reload(card, K, KL, n_blocks, det, params, seq_len, scratch, rng) -> dict:
    """Export the streaming pair and the batch program of the default
    model (no launch while tracing), run the saved files in a child
    process (no jax/flax/msgpack/cv2/yaml imported; one A1 launch per
    spiking block an exported frame), hold them to the eager path, and time an exported
    B=1 frame against the eager DetectionService step in turns. Returns
    the in-process launches."""
    from snn_object_detectionddp_tpu_torch.serve import DetectionService
    from snn_object_detectionddp_tpu_torch.utils import export as X

    h, w = det.cfg.model.image_size
    d = os.path.join(scratch, "export")
    os.makedirs(d, exist_ok=True)
    K.reset_launch_counts()
    KL.reset_launch_counts()
    t0 = time.perf_counter()
    init_p, step_p = X.export_streaming(det, params, os.path.join(d, "init.pt2"),
                                        os.path.join(d, "step.pt2"), batch=1, **EXPORT_NMS)
    t_stream = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch_p = X.export_serving(det, params, os.path.join(d, "batch.pt2"), batch=1,
                               timesteps=seq_len, **EXPORT_NMS)
    t_batch = time.perf_counter() - t0
    traced = sum(K.launch_counts.values()) + sum(KL.launch_counts.values())
    sizes = {os.path.basename(p): os.path.getsize(p) / 2**20 for p in (init_p, step_p, batch_p)}
    print(f"[{card}] phase 14: exported the streaming pair (B=1, {h}x{w}) in {t_stream:.1f} s and "
          f"the batch program (B=1, T={seq_len}) in {t_batch:.1f} s of wall time, "
          f"{traced} kernel launches while tracing; .pt2 sizes "
          + ", ".join(f"{k} {v:.1f} MiB" for k, v in sizes.items()))
    if traced:
        raise AssertionError(f"exporting launched {traced} kernels")

    frames = np.stack([rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
                       for _ in range(max(N_EXPORT_FRAMES, seq_len))])
    frames_p, out_p = os.path.join(d, "frames.npy"), os.path.join(d, "child.pt")
    np.save(frames_p, frames)
    proc, imports, wall = run_child("chip_smoke", ["--exported-child", init_p, step_p, batch_p,
                                                   frames_p, out_p, str(seq_len)])
    if proc.returncode != 0:
        raise AssertionError(f"the exported-program child exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}\n{child_errors(proc)[-4000:]}")
    banned = banned_imports(imports)
    if banned or not imports:
        raise AssertionError(f"the exported-program child imported {banned[:10]} "
                             f"({len(imports)} modules)")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    per_call = [c["affine_lif_fwd"] for c in report["launches"]]
    others = sum(v for c in report["launches"] for k, v in c.items() if k != "affine_lif_fwd")
    print(f"[{card}] phase 14: child ({len(imports)} modules, none of jax/flax/msgpack/cv2/yaml) "
          f"loaded the three programs in {report['load_s']:.1f} s ({wall:.1f} s of wall time, "
          f"process start included); A1 launches per exported frame {per_call[:-1]}, "
          f"per batch call {per_call[-1]}, other kernels {others}")
    if per_call != [n_blocks] * (N_EXPORT_FRAMES + 1) or others:
        raise AssertionError(f"expected {n_blocks} A1 launches per exported call, got {per_call}")

    child = torch.load(out_p, weights_only=True)
    e_init, e_step = X.build_streaming_fns(det, params, **EXPORT_NMS)
    e_batch = X.build_serving_fn(det, params, **EXPORT_NMS)
    dev = det.device
    inputs = [torch.from_numpy(frames[i : i + 1]).to(dev) for i in range(N_EXPORT_FRAMES)]
    clip = torch.from_numpy(frames[None, :seq_len]).to(dev)
    with torch.no_grad():
        eager, state = [], None
        for i, x in enumerate(inputs):
            out, state = e_init(x) if i == 0 else e_step(x, state)
            eager.append((out, state))
        eager_clip = e_batch(clip)
    pairs = [(f"frame {i}", child["frames"][i], eager[i]) for i in range(N_EXPORT_FRAMES)]
    pairs.append(("batch program", child["clip"], eager_clip))
    loaded_step = X.load_serving(step_p)
    for tag, got, want in pairs:
        got_t, want_t = tree_tensors(got), [t.cpu() for t in tree_tensors(want)]
        if all(torch.equal(g, e) for g, e in zip(got_t, want_t)) and len(got_t) == len(want_t):
            print(f"[{card}] phase 14: {tag} of the reloaded program in the child == eager, "
                  f"bit for bit ({len(got_t)} tensors, detections and carried state)")
            continue
        if tag == "frame 1":
            print(f"[{card}] phase 14: first difference, loaded step vs eager step on frame 1: "
                  + first_difference(lambda: loaded_step.call(inputs[1], eager[0][1]),
                                     lambda: e_step(inputs[1], eager[0][1])))
        dets = got[0] if isinstance(got, tuple) else got
        want_dets = want[0] if isinstance(want, tuple) else want
        print(f"[{card}] phase 14: " + hold_detections(
            dets, {k: v.cpu() for k, v in want_dets.items()}, f"{tag} (not bit-equal)"))

    svc = DetectionService(det, params, max_batch=1, **EXPORT_NMS)
    state1 = svc._zero_state1
    img = frames[:1]
    fns = {
        "eager": lambda: svc._predict(img, (state1,)),
        "exported": lambda: {k: v.cpu().numpy()
                             for k, v in loaded_step.call(img, state1)[0].items()},
    }
    for fn in fns.values():
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    K.reset_launch_counts()
    wins = {k: [] for k in fns}
    for r in range(EXPORT_WINDOWS):
        for k in (("eager", "exported") if r % 2 == 0 else ("exported", "eager")):
            wins[k] += host_windows(fns[k], 1, EXPORT_PER_WINDOW)
    torch.cuda.synchronize()
    launches = dict(K.launch_counts)
    calls = 2 * EXPORT_WINDOWS * EXPORT_PER_WINDOW
    print(f"[{card}] phase 14: host ms per B=1 frame, {EXPORT_WINDOWS} windows of "
          f"{EXPORT_PER_WINDOW} each in turns (numpy in, numpy detections out): eager "
          f"DetectionService step {spread([x for x, _ in wins['eager']])}, exported step program "
          f"{spread([x for x, _ in wins['exported']])}; per window (wall, thread cpu) eager "
          + ", ".join(f"({x:.3f}, {c:.3f})" for x, c in wins["eager"]) + "; exported "
          + ", ".join(f"({x:.3f}, {c:.3f})" for x, c in wins["exported"])
          + f"; A1 launches {launches['affine_lif_fwd']} over {calls} frames")
    if launches["affine_lif_fwd"] != n_blocks * calls:
        raise AssertionError(f"expected {n_blocks * calls} A1 launches, got {launches}")
    for k, fn in fns.items():
        print(f"[{card}] phase 14: host profile of the {k} B=1 frame, {N_HOST_PROFILED} calls: "
              + host_profile(fn, N_HOST_PROFILED))
    K.reset_launch_counts()  # the profiled calls are not in the count above
    return launches


def remat_flips(det, params, images, chunk: int) -> tuple[int, int]:
    """Spikes that differ between the unchunked forward of a window and
    the same window run in chunks of ``chunk`` steps with the state
    carried, over every spiking block; and the number of spikes compared."""
    from snn_object_detectionddp_tpu_torch.data.encoding import preprocess_video
    from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock

    frames = preprocess_video(torch.from_numpy(images).to(det.device), dtype=det.dtype)
    record: dict = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: record.setdefault(name, []).append(out[0]))
        for name, m in det.module.named_modules() if isinstance(m, SpikingConvBlock)]
    try:
        det.apply(params, frames)
        whole = {k: v[0] for k, v in record.items()}
        record.clear()
        state = None
        for i in range(0, frames.shape[0], chunk):
            _, state = det.apply(params, frames[i : i + chunk], state)
        parts = {k: torch.cat(v, 0) for k, v in record.items()}
    finally:
        for hk in hooks:
            hk.remove()
    return (sum(int((whole[k] != parts[k]).sum()) for k in whole),
            sum(v.numel() for v in whole.values()))


def remat_check(card, K, rng) -> dict:
    """save_conv at full width: in f32 without TF32 the gradients of full
    and save_conv remat (two chunks) against each other and against no
    remat, at the served size and on a small window with no spike flip
    between the chunked and the unchunked forward; in bf16 at T=10 B=2
    (chunks of 5) the peak memory and step ms of the three. Returns the
    launches of the timed bf16 steps."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector, tf32_policy
    from snn_object_detectionddp_tpu_torch.train.step import (
        global_norm, init_state, make_optimizer, make_step_fns,
    )

    with tf32_policy("f32"):
        cfg = Config()
        cfg.runtime.precision = "f32"
        h, w = cfg.model.image_size
        det = Detector.from_config(cfg, device="cuda")
        params = det.init_params(torch.Generator().manual_seed(SEED))
        tx, sched = make_optimizer(1e-3, 100)
        nc = cfg.model.num_classes
        # At the served size, then on small windows (the model at full
        # width, as gradient_check) until one has no spike flip.
        windows = [lambda: moving_boxes_batch(rng, B_REMAT_F32, T_REMAT_F32, h, w, nc)]
        windows += [lambda: moving_boxes_batch(rng, B_REMAT_F32, T_REMAT_F32, 64, 96, nc,
                                               n_boxes=2, size=(1 / 2, 3 / 4), speed=2)
                    ] * GRAD_ATTEMPTS
        held = False
        for attempt, make in enumerate(windows):
            batch = make()
            size = batch["images"].shape[2:4]
            got = {}
            for name, kw in REMAT_VARIANTS:
                chunk = {"remat_chunk": CHUNK_F32} if kw else {}
                grads, lc = make_step_fns(det, tx, sched, **chunk, **kw).grads(params, batch)
                got[name] = (float(lc.total), float(global_norm(grads.values())), grads)
            flips, n_spikes = remat_flips(det, params, batch["images"], CHUNK_F32)
            full, sc = got["full"][2], got["save_conv"][2]
            worst = max(((full[k] - sc[k]).abs().max().item(), k) for k in full)
            equal = all(torch.equal(full[k], sc[k]) for k in full)
            rel = {n: (abs(got[n][0] - got["none"][0]) / abs(got["none"][0]),
                       abs(got[n][1] - got["none"][1]) / got["none"][1]) for n in ("full", "save_conv")}
            print(f"[{card}] phase 14: save_conv check {attempt}, f32 without TF32, T={T_REMAT_F32} "
                  f"B={B_REMAT_F32} {size[0]}x{size[1]}, remat_chunk {CHUNK_F32}: (loss, grad norm) "
                  + ", ".join(f"{k} ({v[0]!r}, {v[1]!r})" for k, v in got.items())
                  + f"; full vs save_conv: gradients "
                  + ("bit-equal" if equal else f"largest difference {worst[0]:.3g} ({worst[1]})")
                  + "; against no remat (loss, grad norm relative): "
                  + ", ".join(f"{k} ({a:.3g}, {b:.3g})" for k, (a, b) in rel.items())
                  + f"; {flips} of {n_spikes} spikes differ between the chunked and the "
                  "unchunked forward")
            if got["full"][0] != got["save_conv"][0]:
                raise AssertionError("save_conv changed the loss of the full-remat step")
            if flips == 0:
                bad = {k: v for k, v in rel.items()
                       if v[0] > REMAT_LOSS_RTOL or v[1] > REMAT_GNORM_RTOL}
                if bad:
                    raise AssertionError(f"remat against no remat on a flip-free window: {bad}")
                held = True
                if attempt:
                    break
        if not held:
            raise AssertionError(f"every one of {GRAD_ATTEMPTS} small windows had a spike flip")
        del det, params, got, full, sc
        torch.cuda.empty_cache()

    cfg = Config()  # bf16
    det = Detector.from_config(cfg, device="cuda")
    params = det.init_params(torch.Generator().manual_seed(SEED))
    tx, sched = make_optimizer(1e-4, 1000)
    state = init_state(params, tx, sched)
    batch = moving_boxes_batch(rng, B_REMAT, T_REMAT, h, w, cfg.model.num_classes)
    fns = {name: make_step_fns(det, tx, sched, **({"remat_chunk": CHUNK} if kw else {}), **kw)
           for name, kw in REMAT_VARIANTS}
    ms = {k: [] for k in fns}
    peak, fb_peak = {}, {}
    per_step = {}
    launches = dict.fromkeys(K.KERNELS, 0)
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            if name not in fb_peak:  # forward and backward alone, above the resident state
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                fns[name].grads(state["params"], batch)
                torch.cuda.synchronize()
                fb_peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
            state, m = fns[name].train_step(state, batch)  # warm-up of this variant
            torch.cuda.synchronize()
            K.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(N_REMAT_STEPS):
                t0 = time.perf_counter()
                state, m = fns[name].train_step(state, batch)
                float(m["loss"])
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
            peak[name] = max(peak.get(name, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            per_step[name] = {k: v / N_REMAT_STEPS for k, v in K.launch_counts.items() if v}
            for k, v in K.launch_counts.items():
                launches[k] += v
    print(f"[{card}] phase 14: bf16 train step, T={T_REMAT} B={B_REMAT} {h}x{w}"
          f" (remat_chunk {CHUNK} for full and save_conv), {2 * N_REMAT_STEPS} steps a variant in "
          "two passes (order reversed): "
          + "; ".join(f"{k} peak {peak[k]:.3f} GiB (forward and backward alone "
                      f"{fb_peak[k]:.3f} GiB above the resident state), ms/step {spread(ms[k])}, "
                      f"launches/step {per_step[k]}" for k in fns))
    return launches



def run_export_phase(card, K, KL, lif_shapes, scratch, gen, rng) -> dict:
    """Phase 14: the six operators under opcheck on the card, the serving
    export of the default model reloaded in a child, and save_conv remat.
    Returns the launches of the in-process path runs."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector

    t0 = time.perf_counter()
    opcheck_on_card(card, K, lif_shapes, gen)
    cfg = Config()  # yolo11m, 480x640, s2d4, ConvLSTM, bf16
    det = Detector.from_config(cfg, device="cuda")
    params = det.init_params(torch.Generator().manual_seed(SEED))
    launches = export_and_reload(card, K, KL, len(lif_shapes), det, params,
                                 cfg.dataset.test.seq_len, scratch, rng)
    del det, params
    torch.cuda.empty_cache()
    for k, v in remat_check(card, K, rng).items():
        launches[k] = launches.get(k, 0) + v
    print(f"[{card}] phase 14 ok in {time.perf_counter() - t0:.1f} s")
    return launches

def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is False)")
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.evals.legacy import _crop_hw
    from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
    from snn_object_detectionddp_tpu_torch.kernels import build as kernel_build
    from snn_object_detectionddp_tpu_torch.kernels import lif as KL
    from snn_object_detectionddp_tpu_torch.kernels import token_lstm as KT
    from snn_object_detectionddp_tpu_torch.models import token_lstm as tl_mod
    from snn_object_detectionddp_tpu_torch.models.detector import (
        Detector, set_tf32_policy, tf32_policy,
    )
    from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock
    from snn_object_detectionddp_tpu_torch.models import lif as lif_mod
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams, affine_lif_tb_reference
    from snn_object_detectionddp_tpu_torch.serve import DetectionService

    # The main path runs the default bf16 model under the TF32 policy its
    # command lines set; the fp32 reference checks enter tf32_policy("f32").
    set_tf32_policy(Config().runtime.precision)
    card = card_line()
    dev_name = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}; card: {card}")

    # -- build the kernels and the PNG decoder from their sources, one
    # compiler process each, all started together ---------------------------
    t0 = time.perf_counter()
    each = kernel_build.build_all()
    print(f"built {', '.join(K.KERNELS + KL.KERNELS + KT.KERNELS)}, the PNG decoder and the raster primitives in "
          f"{time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{src} {sec:.1f} s" for src, sec in each.items()) + ")")

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
    # The tracker benchmark's cropped method runs the detector at the crop
    # window (half the frame, 32-aligned): another 20 shapes.
    crop_hw = _crop_hw(h, w)
    n_full = len(lif_shapes)
    det.apply(params, probe[:, :, : crop_hw[0], : crop_hw[1]].contiguous())
    crop_shapes = lif_shapes[n_full:]
    del lif_shapes[n_full:]
    for hk in hooks:
        hk.remove()
    n_blocks = len(lif_shapes)
    lif_elems = sum(int(np.prod(s[1:])) for _, s in lif_shapes)
    print(f"model: {cfg.model.yolo_model_name} {h}x{w} stem {cfg.model.stem} "
          f"{cfg.model.bottleneck} {cfg.runtime.precision}, {n_params / 1e6:.1f}M params, "
          f"{n_blocks} spiking blocks, {lif_elems} LIF elements per frame per step")
    if n_blocks != 20 or len(crop_shapes) != 20:
        raise AssertionError(f"expected 20 spiking blocks on the main path, found {n_blocks} "
                             f"(and {len(crop_shapes)} at the crop)")

    # -- phase 1: kernel vs plain version at the 20 main-path shapes --------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err, n_flips, n_near, n_checked = 0.0, 0, 0, 0
    exact = {"spikes": True, "v_final": True, "readouts": True}
    # (T, B, readouts, params): the launch plan and the kernel's instance
    # depend on B, so every (T, B) a main path launches A1 with is held
    # against the plain version: a served frame, micro-batches of 2 and 4,
    # a clip with readouts (alone and at B=2), the evaluation window, the
    # visualization batch (T=seq_len, B=8); and the tracker's crop window
    # (T=1, B=1) at its own 20 shapes.
    seq_len = cfg.dataset.test.seq_len
    cases = [(1, bsz, False, LIFParams()) for bsz in (1, 2, 4)] + [
        (T_CLIP, bsz, True, LIFParams(reset=r)) for bsz in (1, 2) for r in ("soft", "hard")
    ] + [(T_TRAIN, B_TRAIN, False, LIFParams()), (seq_len, B_VIZ, False, LIFParams())]
    crop_case = (1, 1, False, LIFParams())
    plans = set()
    walk = [(name, shp, c) for name, shp in lif_shapes for c in cases]
    walk += [(f"{name} (crop {crop_hw[0]}x{crop_hw[1]})", shp, crop_case) for name, shp in crop_shapes]
    for name, (_, hh, ww, cc), (t_steps, bsz, readouts, p) in walk:
        tag = f"{name} T={t_steps} B={bsz} {p.reset}"
        x4, a, b, v0 = lif_inputs((bsz, hh, ww, cc), t_steps, gen)
        plan = K.fwd_plan(bsz, hh * ww, cc, x4.dtype, True)
        plans.add((plan.vec, plan.ppt, plan.threads))
        got = K.affine_lif_fwd(x4, a, b, p, v0, readouts)
        ref = affine_lif_tb_reference(x4, a, b, p, v0, readouts)
        torch.cuda.synchronize()
        near = near_threshold(x4, a, b, p, v0)
        flips = got[0] != ref[0]
        if (flips & ~near).any():
            raise AssertionError(f"{tag}: spikes differ away from threshold")
        n_flips += int(flips.sum())
        n_near += int(near.sum())
        n_checked += flips.numel()
        v_err = (got[1] - ref[1]).abs().max().item()
        if v_err > V_ATOL:
            raise AssertionError(f"{tag}: v_final error {v_err}")
        max_err = max(max_err, v_err)
        exact["spikes"] &= not bool(flips.any())
        exact["v_final"] &= torch.equal(got[1], ref[1])
        if (bsz == B_VIZ or "crop" in name) and (flips.any() or not torch.equal(got[1], ref[1])):
            raise AssertionError(f"{tag}: not bit-equal to the plain version")
        if readouts:
            r_err = ((got[2].float() - ref[2].float()).abs()
                     / ref[2].float().abs().clamp(min=1.0)).max().item()
            if r_err > READ_RTOL:
                raise AssertionError(f"{tag}: readout error {r_err}")
            max_err = max(max_err, (got[2].float() - ref[2].float()).abs().max().item())
            exact["readouts"] &= torch.equal(got[2], ref[2])
    print(f"phase 1 ok: affine_lif_fwd vs plain at {n_blocks} shapes x {len(cases)} cases "
          f"and the {len(crop_shapes)} shapes of the {crop_hw[0]}x{crop_hw[1]} crop at T=1 B=1 "
          f"(bf16; (T, B, readouts, reset) "
          f"{[(t, bs, r, p.reset) for t, bs, r, p in cases]}; (vec, pixels a thread, threads) "
          f"of the plans {sorted(plans)}): bit-equal {exact}; max_abs_err {max_err}, "
          f"spike flips {n_flips} of {n_checked} (near-threshold |v_pre-theta|<{SPIKE_EPS}: {n_near})")

    train_errs = check_training_kernels(K, lif_mod, lif_shapes, gen)
    scan_errs = check_scan_kernels(KL, lif_mod, lif_shapes, gen)
    lstm_errs = check_token_lstm_kernels(KT)

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
        with tf32_policy("f32"):
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
        run_eval_slice(card, K, det, params, det_gpu, det_cpu, n_blocks, rng)
        del det_gpu, det_cpu, params_cpu

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
        # What 20 launches cost before any byte moves: a kernel that does
        # nothing, launched back to back the same way, at the smallest and
        # the largest grid of the frame.
        grids = [K.fwd_plan(1, hh * ww, cc, torch.bfloat16, True).blocks(1)
                 for _, (_, hh, ww, cc) in lif_shapes]
        floors = {g: time_cuda(lambda g=g: K.empty_launch(torch.device("cuda"), g), tuple, 1)
                  for g in sorted(set(grids))}
        floor_ms = sum(floors[g] for g in grids)
        print(f"[{card}] launch floor: an empty kernel of 128-thread blocks back to back takes "
              + ", ".join(f"{floors[g] * 1e3:.2f} us at {g} blocks" for g in (min(grids), max(grids)))
              + f"; at the frame's 20 grids {floor_ms:.4f} ms, so affine_lif_fwd streams for "
              f"{k_ms - floor_ms:.4f} ms of its {k_ms:.4f} ms per frame (bound {bound_ms:.4f} ms)")

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

    # -- the run_lif entry point and the token-LSTM model, at full width ----
    with tf32_policy("f32"):
        scan_launches = run_lif_path(KL, det, lif_shapes, gen)
    lstm_launches = {"token_lstm_fwd": run_lstm_serving(card, K, n_blocks, rng)}
    torch.cuda.empty_cache()
    lstm_launches.update({k: v for k, v in lstm_train_launches(card, KT, rng).items()
                          if k != "token_lstm_fwd"})
    torch.cuda.empty_cache()

    # -- phase 4: the full-width training slice ----------------------------
    train_launches, library_step = run_training_slice(card, K, det, cfg, n_blocks, rng)
    launches.update({k: v for k, v in train_launches.items() if k != "affine_lif_fwd"})
    train_ms = time_training_kernels(card, K, lif_mod, lif_shapes, gen)

    # -- phase 5: the data pipeline and the two command lines ---------------
    del det
    torch.cuda.empty_cache()
    scratch = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        for k, v in run_data_cli_phase(card, K, n_blocks, library_step, scratch).items():
            launches[k] += v
        torch.cuda.empty_cache()
        # -- phase 6: data parallelism over torch.distributed ---------------
        for k, v in run_parallel_phase(card, K, n_blocks, scratch, rng).items():
            launches[k] += v
        torch.cuda.empty_cache()
        # -- phase 7: the hard fixture and its checkpoint's metrics ---------
        for k, v in run_fixture_phase(card, K, scratch).items():
            launches[k] += v
        torch.cuda.empty_cache()
        # -- phase 8: tracker benchmark, learned flow, overlays (item 13) ---
        for k, v in run_side_pipelines_phase(card, K, KL, n_blocks, scratch).items():
            launches[k] += v
        torch.cuda.empty_cache()
        # -- phase 9: the operators, the serving export, save_conv (item 14)
        for k, v in run_export_phase(card, K, KL, lif_shapes, scratch, gen, rng).items():
            launches[k] += v
        torch.cuda.empty_cache()
        # -- phase 10: FSDP and tensor parallelism (item 15) ----------------
        for k, v in run_parallel_axes_phase(card, K, n_blocks, lif_shapes, gen, rng,
                                            scratch).items():
            launches[k] += v
        torch.cuda.empty_cache()
        # -- phase 11: spatial parallelism (item 16) ------------------------
        for k, v in run_spatial_phase(card, K, lif_mod, n_blocks, lif_shapes, gen, rng).items():
            launches[k] += v
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    scan_ms = time_scan_kernels(card, KL, lif_mod, lif_shapes, gen)
    lstm_ms = time_token_lstm_kernels(card, KT, tl_mod, gen)

    csrc = "snn_object_detectionddp_tpu_torch/csrc"
    affine = ("affine_lif.cu", "snn_object_detectionddp_tpu/kernels/affine_lif_pallas.py")
    scan = ("lif_scan.cu", "snn_object_detectionddp_tpu/kernels/lif_pallas.py")
    lstm = ("token_lstm.cu", "snn_object_detectionddp_tpu/models/token_lstm.py")
    measured = {
        "affine_lif_fwd": (affine, 93, launches, max_err,
                           {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms}),
        "affine_lif_fwd_res": (affine, 107, launches, train_errs["affine_lif_fwd_res"],
                               train_ms["affine_lif_fwd_res"]),
        "affine_lif_bwd": (affine, 198, launches, train_errs["affine_lif_bwd"],
                           train_ms["affine_lif_bwd"]),
        "lif_scan_fwd": (scan, 56, scan_launches, scan_errs["lif_scan_fwd"],
                         scan_ms["lif_scan_fwd"]),
        "lif_scan_fwd_res": (scan, 71, scan_launches, scan_errs["lif_scan_fwd_res"],
                             scan_ms["lif_scan_fwd_res"]),
        "lif_scan_bwd": (scan, 134, scan_launches, scan_errs["lif_scan_bwd"],
                         scan_ms["lif_scan_bwd"]),
        # no Pallas kernel: the JAX package's lax.scan over tokens
        **{name: (lstm, 111, lstm_launches, lstm_errs[name], lstm_ms[name])
           for name in KT.KERNELS},
    }
    for name, (_, _, counts, _, _) in measured.items():
        if counts[name] < 1:
            raise AssertionError(f"{name} was not launched on its main path")
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"{csrc}/{source}",
        "replaces": f"{pallas}:{line}",
        "launches": counts[name],
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "the chain of NT+1 grid barriers" if source == "token_lstm.cu" else "bytes",
        "library_ms": None,
    } for name, ((source, pallas), line, counts, err, t) in measured.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--exported-child"]:
        exported_child(sys.argv[2:])
    elif sys.argv[1:2] == ["--gloo-probe"]:
        gloo_probe(int(sys.argv[2]), int(sys.argv[3]))
    else:
        main()
