"""Batched against alone serving of the port's token-LSTM model on one card:
per frame, the post-NMS detection counts and the largest sorted-score
difference, under the TF32 policy of the default (bf16) model.

    python scripts/torch_lstm_batch_counts.py [--root DIR] [--frames N]

``--root`` is the tree whose ``snn_object_detectionddp_tpu_torch`` is
imported (default: this script's repository), so an unpacked older commit
runs the same check. The setting is chip_smoke.py's token-LSTM serving
check: the full-width token-LSTM-bottleneck model (seeded random weights),
a DetectionService with conf 0, max_det 100 and micro-batches of 2, two
streams of random frames queued before the worker starts (every dispatch
batches the two streams), then the same streams served alone. Prints the
card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

SEED = 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=12, help="frames per stream")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_lstm_batch_counts.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.kernels import build as kernel_build
    from snn_object_detectionddp_tpu_torch.models import detector as detector_mod
    from snn_object_detectionddp_tpu_torch.serve import DetectionService, _Job

    cfg = Config()
    cfg.model.bottleneck = "lstm"
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
    params = det.init_params(torch.Generator().manual_seed(SEED + 3))
    svc = DetectionService(det, params, conf=0.0, max_det=100, max_batch=2, max_clip=1)
    svc.warmup()
    rng = np.random.RandomState(SEED)
    frames = {s: [rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8) for _ in range(args.frames)]
              for s in ("a", "b")}
    jobs = {s: [_Job(s, f) for f in fs] for s, fs in frames.items()}
    for i in range(args.frames):
        for s in jobs:
            svc._q.put(jobs[s][i])
    svc.start()
    try:
        batched = {s: [j.reply.get(timeout=600) for j in js] for s, js in jobs.items()}
        alone = {s: [svc.detect(f"{s}_alone", f) for f in fs] for s, fs in frames.items()}
    finally:
        svc.stop()
    rows = []
    for s in frames:
        for a_, b_ in zip(batched[s], alone[s]):
            if isinstance(a_, Exception):
                raise a_
            sa, sb = np.sort(a_["scores"])[::-1], np.sort(b_["scores"])[::-1]
            k = min(len(sa), len(sb))
            rows.append({"stream": s, "batch": a_["batch"], "batched": len(sa), "alone": len(sb),
                         "top_k_score_diff": float(np.abs(sa[:k] - sb[:k]).max()) if k else None})
    differ = [r for r in rows if r["batched"] != r["alone"]]
    print(json.dumps({"root": os.path.abspath(args.root), "card": card, "frames": len(rows),
                      "count_differs": len(differ),
                      "max_count_gap": max((abs(r["batched"] - r["alone"]) for r in rows), default=0),
                      "rows": rows}))


if __name__ == "__main__":
    main()
