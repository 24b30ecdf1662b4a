"""Time the normalize+LIF CUDA kernels of several trees of this repository
in turns on one card (PyTorch/CUDA port; needs an NVIDIA GPU and nvcc).

Two runs on two machines may land on cards with other power limits, so
two versions of a kernel are compared only inside one run. Unpack the
other version beside this one, for example the parent commit:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python scripts/torch_kernel_ab.py --trees parent=build/parent change=. \
        --order parent,change,change,parent --out build/kernel_ab.json

Each pass is a process of its own started in that tree's root, so it
imports that tree's package, builds that tree's kernels and uses that
tree's chip_smoke.time_cuda (device time of back-to-back launches over
rotating inputs, host enqueue hidden). A pass times, at the 20 spiking
blocks of the default model (yolo11m, 480x640, s2d4 stem) in bf16:

  A1 affine_lif_fwd      at T=1 B=1 (a served frame) and at T=5 B=2
  A2 affine_lif_fwd_res  at T=5 B=2 (a train step's forward)
  A3 affine_lif_bwd      at T=5 B=2 (a train step's backward, wrapper included)

and, per case, what one wrapper call costs the host: the wall time per
call of 2,000 back-to-back calls at the smallest shape (8x10x1024), where
the card finishes a launch sooner than the host enqueues the next. To try
a variant of a kernel or of its launch plan, patch a copy of the tree and
give it as one more ``LABEL=DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CASES = (  # (key, kernel, T, B)
    ("A1_T1_B1", "affine_lif_fwd", 1, 1),
    ("A1_T5_B2", "affine_lif_fwd", 5, 2),
    ("A2_T5_B2", "affine_lif_fwd_res", 5, 2),
    ("A3_T5_B2", "affine_lif_bwd", 5, 2),
)
HOST_CALLS = 2000


def spiking_block_shapes(torch) -> list[tuple[int, int, int]]:
    """(H, W, C) of every spiking block of the default model, in order,
    read off one forward of the model itself."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock

    cfg = Config()
    det = Detector.from_config(cfg, device="cuda")
    params = det.init_params(torch.Generator().manual_seed(0))
    shapes = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: shapes.append(tuple(out[1].shape[1:])))
             for m in det.module.modules() if isinstance(m, SpikingConvBlock)]
    h, w = cfg.model.image_size
    det.apply(params, torch.zeros(1, 1, h, w, 3, device="cuda", dtype=torch.bfloat16))
    for hook in hooks:
        hook.remove()
    return shapes


def worker() -> None:
    import torch

    import chip_smoke as cs
    from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
    from snn_object_detectionddp_tpu_torch.kernels import build
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    build.build_all()
    shapes = spiking_block_shapes(torch)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = LIFParams()
    calls = {
        "affine_lif_fwd": lambda *t: K.affine_lif_fwd(*t[:3], p, t[3]),
        "affine_lif_fwd_res": lambda *t: K.affine_lif_fwd_res(*t[:3], p, t[3]),
        "affine_lif_bwd": lambda *t: K.affine_lif_bwd(*t, p),
    }
    out = {key: [] for key, *_ in CASES}
    host = {}
    for hh, ww, cc in shapes:
        for key, kernel, t_steps, bsz in CASES:
            n = bsz * hh * ww * cc
            shp = (bsz, hh, ww, cc)
            if kernel == "affine_lif_bwd":
                nbytes = cs.lif_bytes_bwd(n, t_steps, cc, bsz)
                make = lambda: cs.bwd_inputs(K, shp, t_steps, p, gen)  # noqa: E731
            else:
                nbytes = (cs.lif_bytes_res(n, t_steps, cc, bsz) if kernel.endswith("res")
                          else cs.lif_bytes(n, t_steps, cc, bsz, False))
                make = lambda: cs.lif_inputs(shp, t_steps, gen)  # noqa: E731
            out[key].append(cs.time_cuda(calls[kernel], make, nbytes) * 1e3)  # us
            if (hh, ww, cc) == shapes[-1] and key not in host:
                args = make()
                for _ in range(20):
                    calls[kernel](*args)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    calls[kernel](*args)
                host[key] = (time.perf_counter() - t0) * 1e6 / HOST_CALLS  # us
                torch.cuda.synchronize()
    print("RESULT " + json.dumps({"card": cs.card_line(), "shapes": shapes, "us": out,
                                  "host_us": host}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--trees", nargs="+", default=["change=."], metavar="LABEL=DIR")
    ap.add_argument("--order", default=None, help="comma-separated labels; default: as given")
    ap.add_argument("--out", default=None, help="write all passes as JSON here")
    args = ap.parse_args()
    if args.worker:
        worker()
        return
    trees = dict(item.split("=", 1) for item in args.trees)
    order = args.order.split(",") if args.order else list(trees)
    script = str(Path(__file__).resolve())
    passes = []
    for label in order:
        root = str(Path(trees[label]).resolve())
        cmd = [sys.executable, script, "--worker"]
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"pass '{label}' failed ({proc.returncode}):\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        result = json.loads(next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))[7:])
        passes.append({"label": label, **result})
        print(f"pass {len(passes)} '{label}' on [{result['card']}]: " + ", ".join(
            f"{key} {sum(v) / 1e3:.4f} ms" for key, v in result["us"].items())
            + "; host us per call " + ", ".join(
                f"{key} {v:.2f}" for key, v in result.get("host_us", {}).items()), flush=True)
    for key, *_ in CASES:
        print(f"-- {key}: us per launch at each of the shapes, one column per pass "
              f"({', '.join(p['label'] for p in passes)})")
        for i, shp in enumerate(passes[0]["shapes"]):
            print(f"{i:2d} {str(tuple(shp)):16s} " + " ".join(f"{p['us'][key][i]:8.2f}" for p in passes))
        print("   sum (ms)         " + " ".join(f"{sum(p['us'][key]) / 1e3:8.4f}" for p in passes))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(passes))


if __name__ == "__main__":
    main()
