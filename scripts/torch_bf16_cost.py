"""Serving and training cost of the port's default bf16 model on one card,
under the bf16 TF32 policy (cuDNN TF32 on, matmul TF32 off), for comparing
two trees of the port in one call.

    python scripts/torch_bf16_cost.py [--root DIR]

``--root`` is the tree whose ``snn_object_detectionddp_tpu_torch`` is
imported and whose kernels are built (default: this script's repository),
so an unpacked older commit can be measured by the same code. Default
Config (yolo11m, 480x640, s2d4 stem, ConvLSTM, bf16), seeded random
weights. Measures, on the card:

- serving: ``DetectionService._predict`` at B=1 and B=4 (forward, decode,
  NMS): host ms a dispatch (synchronised, median), device (kernel) ms a
  dispatch from the profiler, peak allocated memory;
- training: the library train step (``make_step_fns``) at T=5, B=2 on
  seeded moving rectangles: host ms a step (synchronised, median), device
  (kernel) ms a step from the profiler, peak allocated memory.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
T_TRAIN, B_TRAIN = 5, 2
MAX_BOXES = 8  # label rows per sample (padded)
N_WARM, N_TIMED, N_PROFILED = 5, 30, 10


def moving_boxes_batch(rng, h, w, num_classes) -> dict:
    """A (B, T) window of bright rectangles drifting over noise with their
    labels at the last frame (chip_smoke.py's training batch)."""
    images = rng.randint(0, 48, size=(B_TRAIN, T_TRAIN, h, w, 3)).astype(np.uint8)
    labels = np.zeros((B_TRAIN, MAX_BOXES, 5), np.float32)
    mask = np.zeros((B_TRAIN, MAX_BOXES), bool)
    for b in range(B_TRAIN):
        for k in range(3):
            bw, bh = rng.randint(w // 6, w // 3), rng.randint(h // 6, h // 3)
            x0, y0 = rng.randint(0, w - bw - 4 * T_TRAIN), rng.randint(0, h - bh - 4 * T_TRAIN)
            color = rng.randint(128, 256, size=3)
            for t in range(T_TRAIN):
                xs, ys = x0 + 4 * t, y0 + 4 * t
                images[b, t, ys : ys + bh, xs : xs + bw] = color
            labels[b, k] = [rng.randint(num_classes), (xs + bw / 2) / w, (ys + bh / 2) / h,
                            bw / w, bh / h]
            mask[b, k] = True
    return {"images": images, "labels": labels, "label_mask": mask}


def measure(fn) -> dict:
    """Host ms (synchronised, median of N_TIMED), profiler kernel ms and
    peak allocated GiB of ``fn``, after N_WARM warm-up calls."""
    for _ in range(N_WARM):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(N_PROFILED):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == cuda) / 1e3 / N_PROFILED
    if dev <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"host_ms": float(np.median(host)), "host_ms_min": float(min(host)),
            "device_ms": dev, "peak_gib": peak}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_bf16_cost.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.kernels import build as kernel_build
    from snn_object_detectionddp_tpu_torch.models import detector as detector_mod
    from snn_object_detectionddp_tpu_torch.serve import DetectionService
    from snn_object_detectionddp_tpu_torch.train.step import init_state, make_optimizer, make_step_fns

    cfg = Config()
    if hasattr(detector_mod, "set_tf32_policy"):
        detector_mod.set_tf32_policy(cfg.runtime.precision)
    # A tree without the policy runs PyTorch's defaults, which are the bf16 policy.
    if not (torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("not the bf16 TF32 policy")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    kernel_build.build_all()
    h, w = cfg.model.image_size
    det = detector_mod.Detector.from_config(cfg, device="cuda")
    params = det.init_params(torch.Generator().manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    out = {"root": os.path.abspath(args.root), "card": card}

    svc = DetectionService(det, params, conf=0.0, max_det=100, max_batch=4, max_clip=4)
    svc.warmup()
    for k in (1, 4):
        imgs = rng.randint(0, 256, size=(k, h, w, 3), dtype=np.uint8)
        states = tuple([svc._zero_state1] * k)
        out[f"serve_b{k}"] = measure(lambda: svc._predict(imgs, states))
    del svc
    torch.cuda.empty_cache()

    tr = cfg.training
    steps = N_WARM + N_TIMED + N_PROFILED
    tx, sched = make_optimizer(tr.learning_rate, steps, tr.weight_decay, tr.grad_clip_norm,
                               tr.pct_start)
    box = {"state": init_state(params, tx, sched)}
    fns = make_step_fns(det, tx, sched)
    batches = [moving_boxes_batch(rng, h, w, cfg.model.num_classes) for _ in range(4)]
    n = [0]

    def step():
        box["state"], _ = fns.train_step(box["state"], batches[n[0] % len(batches)])
        n[0] += 1

    out["train_t5_b2"] = measure(step)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
