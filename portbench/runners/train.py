"""Runner of the ``train`` traffic kind: the program's train step at the
configured batch, in a loop as its training loop drives it.

Set-up builds one train step (``make_step_fns(detector, make_optimizer(...))``)
and its state from the seed's weights, and drives it through the checked
start (``check_steps`` steps on the first batches of the pool); the same
object then runs the window, cycling the pool of host batches (numpy
uint8, uploaded inside the step) with the loop's one-step-delayed metric
fetch. From the first step that starts after a time in the window drawn
from the seed, ``check_steps`` more steps are checked: before them the
parameters and AdamW's moments are copied on the card, the first one's
layers and spiking blocks' gradients are recorded (hooks registered for
that step alone), and the parameters after the last are copied. The
device's memory peak is read before those copies. After the window the
program is freed and the frozen reference, in float32, follows the start
from the seed's weights and the window's steps from the copied state.

Traffic keys: ``pool`` host batches, ``boxes`` [lo, hi] a frame,
``box_size`` [lo, hi] of the image side, ``speed`` px a frame,
``total_steps`` of the OneCycle schedule, ``check_steps``, ``check_at``
([lo, hi] share of the window), ``profile_steps`` (traced run),
``reference_chunk`` windows a reference chunk.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import compare, inputs, layercheck
from portbench.bench import Record, driving_core, free_device_memory
from portbench.reference import loss as ref_loss
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train


def _port_config(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("model", "training", "runtime", "dataset") if k in cfg}


def build_program(rec: Record, seed: int):
    """(detector, train step functions, state) of the cell's configuration
    on the run's device."""
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector, set_tf32_policy
    from snn_object_detectionddp_tpu_torch.train.step import (
        init_state,
        make_optimizer,
        make_step_fns,
    )

    cfg = Config.from_dict(_port_config(rec.cell.config))
    if rec.device.type == "cuda":
        set_tf32_policy(cfg.runtime.precision)
    det = Detector.from_config(cfg, device=rec.device)
    params = inputs.make_weights(rec.cell.shape, seed, rec.device)
    mine = {k: tuple(v.shape) for k, v in det.module.named_parameters()}
    if mine != {k: tuple(v.shape) for k, v in params.items()}:
        raise RuntimeError("the program's parameters differ from the reference's in names or shapes")
    tr = cfg.training
    tx, sched = make_optimizer(tr.learning_rate, rec.cell.traffic["total_steps"], tr.weight_decay,
                               tr.grad_clip_norm, tr.pct_start)
    return det, make_step_fns(det, tx, sched), init_state(params, tx, sched)


def make_pool(rec: Record, seed: int) -> list:
    cfg, tr = rec.cell.config, rec.cell.traffic
    m = cfg["model"]
    return [inputs.train_batch(seed, i, cfg["training"]["batch_size"],
                               cfg["dataset"]["train"]["seq_len"], m["image_size"], tr,
                               m["num_classes"], m["max_boxes"], rec.device)
            for i in range(tr["pool"])]


def leaf_norms(tensors) -> torch.Tensor:
    return torch.stack([t.double().norm() for t in tensors])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Host seconds of each ``train_step`` call (no sync) and of each
    forward of the U-Net's bottleneck module, from hooks the benchmark
    registers on it."""

    def __init__(self, det):
        self.steps, self.bottleneck, self._t, self._acc = [], [], 0.0, 0.0
        mod = det.module.unet.bottleneck
        self._hooks = [mod.register_forward_pre_hook(self._pre),
                       mod.register_forward_hook(self._post)]

    def _pre(self, mod, args):
        self._t = time.perf_counter()

    def _post(self, mod, args, out):
        self._acc += time.perf_counter() - self._t

    def step(self, fn):
        self._acc = 0.0
        t = time.perf_counter()
        out = fn()
        self.steps.append(time.perf_counter() - t)
        self.bottleneck.append(self._acc)
        return out

    def remove(self):
        for h in self._hooks:
            h.remove()


def run(rec: Record, seed: int, seconds: float, trace: bool, t_start: float) -> None:
    tr = rec.cell.traffic
    det, fns, state = build_program(rec, seed)
    pool = make_pool(rec, seed)
    names = list(state["params"])
    n_check = tr["check_steps"]

    # The start: the first steps from the seed's weights, through the
    # window's own call and feed, on rows all different.
    p0 = [state["params"][k].clone() for k in names]
    losses = []
    for i in range(n_check):
        state, m = fns.train_step(state, pool[i % len(pool)])
        losses.append(m["loss"])
        if i == 0:
            first_grad = leaf_norms(state["opt_state"]["mu"][k] / (1 - ref_train.B1) for k in names)
    change = leaf_norms(state["params"][k] - p for k, p in zip(names, p0))
    del p0
    start = {"losses": [float(x) for x in losses], "first_grad": first_grad.cpu(),
             "change": change.cpu()}
    _sync(rec.device)
    rec.setup_s = time.perf_counter() - t_start

    timer = StepTimer(det) if trace else None
    pending, steps, i = None, 0, n_check
    traced_steps = traced_s = 0.0
    checked, peak = None, None

    def one_step():
        nonlocal state, pending, i
        state, m = fns.train_step(state, pool[i % len(pool)])
        i += 1
        if pending is not None:  # the previous step's metrics, one step late
            torch.stack([pending["loss"], pending["grad_norm"]]).tolist()
        pending = m

    def checked_steps() -> dict:
        nonlocal peak
        if rec.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(rec.device)
        params, opt = state["params"], state["opt_state"]
        snap = {"step": i, "params": {k: params[k].clone() for k in names},
                "mu": {k: opt["mu"][k].clone() for k in names},
                "nu": {k: opt["nu"][k].clone() for k in names}, "losses": []}
        capture = layercheck.Capture(det.module, params, rec.cell.shape.bottleneck,
                                     backward=True)
        capture.armed = True
        for j in range(n_check):
            one_step()
            snap["losses"].append(pending["loss"])
            if j == 0:
                capture.armed = False
                capture.remove()
        snap["end"] = {k: state["params"][k].clone() for k in names}
        snap["records"], snap["grads"] = capture.records, capture.grads
        return snap

    lo, hi = tr["check_at"]
    t0 = time.perf_counter()
    trigger = t0 + seconds * float(inputs.host_rng(seed, 30_000).uniform(lo, hi))
    with driving_core(rec.device):
        while time.perf_counter() - t0 < seconds or checked is None:
            now = time.perf_counter()
            if (trace and rec.device.type == "cuda" and rec.trace is None
                    and now - t0 >= seconds / 3):
                from portbench.trace import profile

                k = tr["profile_steps"]
                rec.trace = profile(lambda: [one_step() for _ in range(k)])
                traced_steps += k
                traced_s += time.perf_counter() - now
                steps += k
            elif checked is None and now >= trigger:
                checked = checked_steps()
                steps += n_check
            elif timer is not None:
                timer.step(one_step)
                steps += 1
            else:
                one_step()
                steps += 1
        _sync(rec.device)
        t1 = time.perf_counter()
    last = torch.stack([pending["loss"], pending["grad_norm"]]).tolist()
    if timer is not None:
        timer.remove()
        rec.spans = {"train_step": timer.steps, "bottleneck_forward": timer.bottleneck}
    b, t = rec.cell.config["training"]["batch_size"], rec.cell.config["dataset"]["train"]["seq_len"]
    rec.window_s = t1 - t0
    rec.attempted = steps
    rec.failed = 0 if all(map(torch.isfinite, torch.tensor(last))) else 1
    rec.counters = {"steps": steps, "frames": steps * b * t, "batch": b, "seq_len": t,
                    "untraced_steps": steps - traced_steps,
                    "untraced_s": rec.window_s - traced_s}
    if rec.device.type == "cuda":
        rec.memory_peak_bytes = peak
    window = {"losses": [float(x) for x in checked["losses"]],
              "change": leaf_norms(checked["end"][k] - checked["params"][k] for k in names).cpu()}
    del state, fns, det, pending, checked["end"]
    free_device_memory()

    ref = reference(rec, seed, pool[:n_check])
    numbers = {"start": compare.train_numbers(start, ref)}
    print("read, not compared:", compare.grad_readings(start, ref), file=sys.stderr)
    i0 = checked["step"]
    batch0 = pool[i0 % len(pool)]
    rec.numbers = checked_layers(rec, checked["params"], checked["records"], checked["grads"],
                                 batch0, window["losses"][0])
    del checked["records"], checked["grads"]
    free_device_memory()
    ref = reference(rec, seed, [pool[(i0 + j) % len(pool)] for j in range(n_check)],
                    start=(checked["params"], checked["mu"], checked["nu"], i0))
    numbers["window"] = compare.train_numbers(window, ref)
    print(f"train check: start {numbers['start']}, window from step {i0} {numbers['window']}",
          file=sys.stderr)
    for k in numbers["start"]:
        rec.numbers[k] = max(numbers["start"][k], numbers["window"][k])


def checked_layers(rec: Record, params: dict, records: list, grads: dict, batch: dict,
                   loss: float, num=ref_model.F32) -> dict:
    """The layer check of a checked step from the parameters it started
    from: its forward's layers, its spiking blocks' input gradients
    (``grad_layer_gap``), and its loss recomputed by the reference from the
    step's own raw maps (``loss_tf_gap``)."""
    shape, hyp = rec.cell.shape, rec.cell.config["model"]["hyp"]
    params = {k: v.float() for k, v in params.items()}
    out = layercheck.numbers(records, params, shape, rec.device, num)
    out.update(layercheck.grad_numbers(records, grads, params, shape, rec.device, num))
    head = next(r for r in records if r[0] == "head")
    maps = [m.to(rec.device).float() for m in head[3]]
    with ref_model.strict_fp32(), torch.no_grad():
        s, t = ref_loss.loss_sums(maps, torch.as_tensor(batch["labels"]).to(rec.device),
                                  torch.as_tensor(batch["label_mask"]).to(rec.device),
                                  shape.num_classes, shape.reg_max,
                                  (hyp["box"], hyp["cls"], hyp["dfl"]))
        want = float(s) / max(float(t), 1.0) * maps[0].shape[0]
    out["loss_tf_gap"] = abs(loss - want) / abs(want)
    return out


def reference(rec: Record, seed: int, batches: list, num=ref_model.F32,
              start: tuple | None = None) -> dict:
    """The frozen reference's steps on ``batches``: {"losses",
    "first_grad", "change"}. From the seed's weights and zero moments, or
    from ``start`` = (params, mu, nu, steps taken) of the program's state."""
    cfg, tr = rec.cell.config, rec.cell.traffic
    train_cfg = dict(cfg["training"], **cfg["model"]["hyp"], total_steps=tr["total_steps"])
    with ref_model.strict_fp32():
        if start is None:
            params, opt_state = inputs.make_weights(rec.cell.shape, seed, rec.device), None
        else:
            params = {k: v.float().clone() for k, v in start[0].items()}
            opt_state = start[1:]
        p0 = {k: v.clone() for k, v in params.items()}
        dev_batches = [{k: torch.as_tensor(v).to(rec.device) for k, v in bt.items()}
                       for bt in batches]
        losses, first_grad, _ = ref_train.run_steps(
            params, dev_batches, rec.cell.shape, train_cfg, len(batches), num,
            tr.get("reference_chunk"), opt_state)
        change = leaf_norms(params[k] - p0[k] for k in params)
    return {"losses": losses, "first_grad": first_grad.cpu(), "change": change.cpu()}
