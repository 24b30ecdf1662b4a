"""Runner of the ``serve`` traffic kind: many camera streams on one
``DetectionService``, in process, closed loop.

Each stream's client thread sends its next frame when its previous reply
arrives; each stream plays its own seeded moving-box sequence, looped.
Every request sent in the window is timed on the client's clock from
submit to reply.

The check: hooks record ``check_dispatches`` consecutive dispatches from a
time in the window drawn from the seed (held on the card, nothing copied
inside the window): each one's frames, the states it read and wrote and
its raw maps, and every layer of the first one. After the window the
program is freed and the frozen reference checks them: the first
dispatch's layers (layercheck.py), every checked reply against the
reference's decode and NMS of its row's raw maps, and the state each
checked dispatch read for a stream against what the stream's previous
checked dispatch wrote.

Traffic keys: ``streams``, ``frames_per_stream``, ``max_batch``,
``conf``, ``iou``, ``max_det``, ``max_streams``, ``boxes`` / ``box_size``
/ ``speed`` (as the train kind), ``check_dispatches``, ``check_at``
([lo, hi] share of the window), ``profile_seconds`` (traced run),
``weights`` (constants that replace the configuration's initial ones, by
parameter-name suffix).
"""

from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np
import torch

from portbench import compare, inputs, layercheck
from portbench.bench import Record, driving_core, free_device_memory
from portbench.reference import detect as ref_detect
from portbench.reference import model as ref_model


def build_service(rec: Record, seed: int):
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector, set_tf32_policy
    from snn_object_detectionddp_tpu_torch.serve import DetectionService

    tr = rec.cell.traffic
    cfg = Config.from_dict({k: rec.cell.config[k] for k in ("model", "runtime")})
    if rec.device.type == "cuda":
        set_tf32_policy(cfg.runtime.precision)
    det = Detector.from_config(cfg, device=rec.device)
    params = inputs.make_weights(rec.cell.shape, seed, rec.device, tr.get("weights"))
    service = DetectionService(det, params, conf=tr["conf"], iou=tr["iou"],
                               max_det=tr["max_det"], max_streams=tr["max_streams"],
                               max_batch=tr["max_batch"])
    return det, service


class Client(threading.Thread):
    """One camera: detect() on its frames in order while the window is
    open; records (submit, reply time, reply or the exception)."""

    def __init__(self, service, name: str, frames: np.ndarray, start: threading.Event,
                 until: list):
        super().__init__(daemon=True)
        self.service, self.name, self.frames = service, name, frames
        self.start_evt, self.until = start, until
        self.log = []

    def run(self):
        self.start_evt.wait()
        i = 0
        while time.perf_counter() < self.until[0]:
            t = time.perf_counter()
            try:
                out = self.service.detect(self.name, self.frames[i % len(self.frames)])
            except Exception as e:  # a failed request is recorded, the camera goes on
                out = e
            self.log.append((t, time.perf_counter(), out))
            i += 1


class Dispatches:
    """Hooks on the detector's top module that record ``n`` consecutive
    forwards from the first that starts after ``trigger`` (host clock):
    (start time, frames, state read, raw maps, state written). The layers
    of the first are recorded by ``capture``."""

    def __init__(self, module, n: int, capture: layercheck.Capture):
        self.n, self.capture, self.trigger = n, capture, math.inf
        self.items, self._on = [], None
        self._hooks = [module.register_forward_pre_hook(self._pre),
                       module.register_forward_hook(self._post)]

    def _pre(self, mod, args):
        if time.perf_counter() >= self.trigger and len(self.items) < self.n:
            self._on = [time.perf_counter(), args[0], args[1]]
            self.capture.armed = not self.items

    def _post(self, mod, args, out):
        if self._on is not None:
            self.items.append(self._on + [out[0], out[1]])
            self._on, self.capture.armed = None, False

    def remove(self):
        for h in self._hooks:
            h.remove()
        self.capture.remove()


def run(rec: Record, seed: int, seconds: float, trace: bool, t_start: float) -> None:
    tr, m = rec.cell.traffic, rec.cell.config["model"]
    det, service = build_service(rec, seed)
    hw = tuple(m["image_size"])
    streams = [inputs.stream_frames(seed, s, tr["frames_per_stream"], hw, tr, m["num_classes"],
                                    rec.device) for s in range(tr["streams"])]
    service.warmup()
    checked = Dispatches(det.module, tr["check_dispatches"],
                         layercheck.Capture(det.module, service.params, rec.cell.shape.bottleneck))
    with driving_core(rec.device):  # the worker thread drives the card
        service.start()
    if rec.device.type == "cuda":
        torch.cuda.synchronize(rec.device)
    go, until = threading.Event(), [math.inf]
    clients = [Client(service, f"cam{s}", streams[s], go, until) for s in range(tr["streams"])]
    for c in clients:
        c.start()
    rec.setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    until[0] = t0 + seconds
    lo, hi = tr["check_at"]
    checked.trigger = t0 + seconds * float(inputs.host_rng(seed, 30_000).uniform(lo, hi))
    go.set()
    traced = None
    if trace and rec.device.type == "cuda":  # the device trace needs the card
        from portbench.trace import profile

        time.sleep(max(0.0, seconds / 3 - (time.perf_counter() - t0)))
        tp = time.perf_counter()
        rec.trace = profile(lambda: time.sleep(tr["profile_seconds"]))
        traced = (tp, time.perf_counter())
    for c in clients:
        c.join()
    t1 = t0 + seconds
    service.stop()
    checked.remove()
    if rec.device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(rec.device)

    logs = [c.log for c in clients]
    reqs = [r for log in logs for r in log]
    ok = [r for r in reqs if isinstance(r[2], dict)]
    rec.attempted, rec.failed = len(reqs), len(reqs) - len(ok)
    rec.window_s = seconds
    rec.latencies_s = [b - a if isinstance(out, dict) else math.inf for a, b, out in reqs]
    untraced = [r for r in ok if traced is None or not (traced[0] <= r[1] <= traced[1])]
    rec.counters = {
        "replies_in_window": sum(1 for r in ok if r[1] <= t1),
        "batch_fill": float(np.mean([r[2]["batch"] for r in ok])) / tr["max_batch"] if ok else 0.0,
        "untraced_frames": sum(1 for r in untraced if r[1] <= t1),
        "untraced_s": seconds - (0.0 if traced is None else traced[1] - traced[0]),
        "dispatch_sizes": [r[2]["batch"] for r in ok if traced and traced[0] <= r[1] <= traced[1]],
        "max_batch": tr["max_batch"],
    }
    del service, det
    free_device_memory()
    rec.numbers = check(rec, seed, streams, logs, checked.items, checked.capture.records)


def frame_keys(frames: torch.Tensor) -> list[int]:
    """An exact key of each frame of (N, H, W, 3) bf16 or fp32 frames: a
    position-weighted integer sum of its bit patterns (integer sums do
    not depend on their order)."""
    bits = frames.contiguous().view(torch.int16 if frames.dtype == torch.bfloat16 else torch.int32)
    bits = bits.reshape(bits.shape[0], -1).to(torch.int64)
    weights = torch.arange(bits.shape[1], device=bits.device) % 65521 + 1
    return (bits * weights).sum(1).tolist()


def _row(state, r: int):
    """Row ``r`` of a batched recurrent state: the batch axis is the first,
    but the token LSTM's carry (layers, B, C), whose batch axis is the
    second."""
    if isinstance(state, dict):
        return {k: _row(v, r) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(_row(v, r) for v in state)
    return state[:, r] if state.ndim == 3 else state[r]


def check(rec: Record, seed: int, streams: list, logs: list, items: list, records: list,
          num=ref_model.F32) -> dict:
    """The serving check's numbers: {"spike_flips", "layer_gap",
    "state_gap", "reply_mismatch"}; a check with nothing to compare reads
    infinite."""
    tr, shape = rec.cell.traffic, rec.cell.shape
    params = inputs.make_weights(shape, seed, rec.device, tr.get("weights"))
    out = layercheck.numbers(records, params, shape, rec.device, num) if records else \
        {"spike_flips": math.inf, "layer_gap": math.inf}
    # which stream and frame each checked row carries, by its frame's bits
    keys = {}
    dtype = torch.bfloat16 if rec.cell.config["runtime"]["precision"] == "bf16" else torch.float32
    for s, frames in enumerate(streams):
        x = torch.from_numpy(frames).to(rec.device).float() * (1.0 / 255.0)
        for f, v in enumerate(frame_keys(x.to(dtype))):
            keys[v] = (s, f)
    rows, mismatch = {}, 0  # stream -> [(request, dispatch, row)]
    for i, (t, frames, _, maps, _) in enumerate(items):
        found, batch = 0, 0
        for r, v in enumerate(frame_keys(frames[0])):
            if v not in keys:
                continue  # a padded slot
            found += 1
            s, f = keys[v]
            j = next(j for j, (a, b, _) in enumerate(logs[s])
                     if j % len(streams[s]) == f and a <= t <= b)
            reply = logs[s][j][2]
            boxes, scores = ref_detect.decode([mp[r:r + 1].float() for mp in maps],
                                              shape.reg_max, shape.image_size)
            want = ref_detect.nms(boxes[0], scores[0], tr["conf"], tr["iou"], tr["max_det"])
            mismatch += compare.unmatched(reply, *want) if isinstance(reply, dict) else 1
            batch = max(batch, reply["batch"] if isinstance(reply, dict) else 0)
            rows.setdefault(s, []).append((j, i, r))
        mismatch += batch - found  # requests of the dispatch whose frames it did not run
    gaps = []
    for seq in rows.values():
        for j1, i1, r1 in seq:
            for j2, i2, r2 in seq:
                if j2 == j1 + 1:
                    gaps.append(compare.state_gap(_row(items[i1][4], r1), _row(items[i2][2], r2)))
    out["state_gap"] = max(gaps) if gaps else math.inf
    print(f"serve check: {sum(map(len, rows.values()))} replies of {len(items)} dispatches, "
          f"{len(gaps)} state hand-overs", file=sys.stderr)
    out["reply_mismatch"] = float(mismatch) if rows else math.inf
    return out
