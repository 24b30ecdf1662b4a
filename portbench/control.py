"""Readings of a cell's correctness numbers with the program replaced:
by the reference in float8 (the control: the nearest precision below the
configuration's bf16) or by a planted fault, each against the float32
reference, at the cell's own sizes. The benchmark's runs never run this;
its readings set the upper ends of the limits (PERF.md).

    python3 portbench/control.py --workload <name> --seeds 1 2 3 [--faults half_batch]

Training variants: ``fp8`` (the control: the three checked steps, the
layer check of the first step's forward and the backward's block check
(``grad_control``)), ``half_batch`` (half of each batch left out, the loss
the mean over the rest) and ``a3_scale`` (the program itself, with the
gradient that the LIF backward hands on scaled by ``A3_SCALE``: a short
run of the cell, ``--seconds`` long). Serving: ``fp8``, the layer check of
``--steps`` chained dispatches of ``max_batch`` streams. One JSON line a
seed and variant.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import bench, compare, inputs, layercheck  # noqa: E402
from portbench.reference import loss as ref_loss  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402

FP8 = ref_model.Numerics("fp8")
A3_SCALE = 1.25


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def a3_scaled(factor: float = A3_SCALE):
    """The program's normalize+LIF entry (``models.layers``' name for it)
    with the gradients that its backward (A3 on the card) hands to the conv
    and GroupNorm scaled by ``factor``: the fault, for
    ``layers.run_affine_lif_tb``."""
    from snn_object_detectionddp_tpu_torch.models import layers

    run = layers.run_affine_lif_tb

    def scaled(x4, a, b, p, v0=None, with_readouts=False):
        x4, a, b = (_ScaleGrad.apply(t, factor) if t.requires_grad else t for t in (x4, a, b))
        return run(x4, a, b, p, v0, with_readouts)

    return scaled


def grad_control(params, batch: dict, shape, gains, chunk: int) -> dict:
    """The backward's control: each spiking block (but the first, which
    reads the frames) of the float32 reference's forward over the first
    ``chunk`` windows of ``batch`` gives its input and the gradients of the
    loss at its outputs; its input gradient recomputed in float8 against
    float32 from those: ``{"grad_layer_gap"}``, the largest normwise
    relative gap."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    records = []

    def tap(name, kind, args, out):
        if kind == "spiking":
            records.append((name, kind, args, out))

    with ref_model.strict_fp32():
        images = torch.as_tensor(batch["images"][:chunk]).to(params[next(iter(params))].device)
        dev = images.device
        maps, _ = ref_model.forward(leaves, ref_model.preprocess(images), None, shape,
                                    ref_model.F32, tap)
        total, _ = ref_loss.loss_sums(maps, torch.as_tensor(batch["labels"][:chunk]).to(dev),
                                      torch.as_tensor(batch["label_mask"][:chunk]).to(dev),
                                      shape.num_classes, shape.reg_max, gains)
        outs = [o for r in records for o in r[3]]
        g = torch.autograd.grad(total, outs, allow_unused=True)
        del maps, total, leaves
        gap = 0.0
        for j, (name, kind, (x, v0), out) in enumerate(records):
            if not x.requires_grad or g[2 * j] is None:
                continue
            rec_ = (name, kind, (x.detach(), None if v0 is None else v0.detach()),
                    tuple(o.detach() for o in out))
            want = layercheck.block_vjp(params, rec_, (g[2 * j], g[2 * j + 1]), shape,
                                        ref_model.F32)
            got = layercheck.block_vjp(params, rec_, (g[2 * j], g[2 * j + 1]), shape, FP8)
            gap = max(gap, layercheck.rel_gap(got, want))
    return {"grad_layer_gap": gap}


def tapped_layers(params, frames, state, shape, num):
    """The reference's forward in ``num`` with every layer recorded, and
    the layer check of those records against float32: (numbers, maps,
    state)."""
    records = []
    tap = lambda name, kind, args, out: records.append((name, kind, args, out))  # noqa: E731
    with ref_model.strict_fp32(), torch.no_grad():
        maps, state = ref_model.forward(params, frames, state, shape, num, tap)
    return layercheck.numbers(records, params, shape, frames.device), maps, state


def train_readings(cell, seed: int, variants, device, seconds: float = 8.0) -> list[dict]:
    drv = bench.runner("train")
    rec = bench.Record(kind="train", cell=cell, device=device)
    pool = drv.make_pool(rec, seed)[: cell.traffic["check_steps"]]
    ref = drv.reference(rec, seed, pool)
    out = []
    for v in variants:
        row = {"seed": seed, "variant": v}
        if v == "fp8":
            got = drv.reference(rec, seed, pool, FP8)
            params = inputs.make_weights(cell.shape, seed, device)
            images = torch.as_tensor(pool[0]["images"]).to(device)
            row.update(tapped_layers(params, ref_model.preprocess(images), None, cell.shape,
                                     FP8)[0])
            hyp = cell.config["model"]["hyp"]
            row.update(grad_control(params, pool[0], cell.shape,
                                    (hyp["box"], hyp["cls"], hyp["dfl"]),
                                    cell.traffic["reference_chunk"]))
        elif v == "a3_scale":
            from snn_object_detectionddp_tpu_torch.models import layers

            run = layers.run_affine_lif_tb
            layers.run_affine_lif_tb = a3_scaled()
            try:
                line = bench.run_cell(cell.name, seed, seconds, False, device=device.type)
            finally:
                layers.run_affine_lif_tb = run
            out.append({"seed": seed, "variant": v, **{k: c["value"]
                                                       for k, c in line["checks"].items()}})
            continue
        elif v == "half_batch":
            got = drv.reference(rec, seed, [{k: x[: len(x) // 2] for k, x in b.items()}
                                            for b in pool])
        else:
            raise SystemExit(f"unknown variant {v!r}")
        row.update(compare.train_numbers(got, ref))
        row.update(compare.grad_readings(got, ref))
        out.append(row)
    return out


def serve_readings(cell, seed: int, steps: int, device) -> list[dict]:
    """The float8 reference serving ``max_batch`` of the streams for
    ``steps`` chained T=1 dispatches; the layer check of each."""
    tr, shape = cell.traffic, cell.shape
    hw = tuple(shape.image_size)
    streams = [inputs.stream_frames(seed, s, tr["frames_per_stream"], hw, tr, shape.num_classes,
                                    device) for s in range(tr["max_batch"])]
    params = inputs.make_weights(shape, seed, device, tr.get("weights"))
    worst, state = {"spike_flips": 0.0, "layer_gap": 0.0}, None
    for j in range(steps):
        x = torch.from_numpy(np.stack([f[j % len(f)] for f in streams])).to(device)[:, None]
        got, _, state = tapped_layers(params, ref_model.preprocess(x), state, shape, FP8)
        worst = {k: max(worst[k], got[k]) for k in worst}
    return [{"seed": seed, "variant": "fp8", **worst}]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = bench.find_cell(args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        if cell.traffic["kind"] == "train":
            rows = train_readings(cell, seed, ["fp8"] + args.faults, device, args.seconds)
        else:
            rows = serve_readings(cell, seed, args.steps, device)
        for row in rows:
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
