"""Streaming detection service: per-stream recurrent state over HTTP.

- ONE device worker thread owns the card and runs the T=1 streaming step
  (detector forward with carried recurrent state, then decode and NMS on
  the device). HTTP handler threads enqueue requests; the worker drains
  the queue in arrival order.
- **Cross-stream micro-batching**: the worker drains up to ``max_batch``
  queued jobs from *distinct* streams, stacks their images and recurrent
  states along each state leaf's batch axis, and runs ONE forward at the
  next power-of-two batch size (padded with zero images/states). Jobs of a
  stream already in the batch are deferred to the next round (state must
  chain), and a stream with a deferred job is blocked for the round
  (per-stream FIFO).
- Per-stream recurrent state lives on the device between requests, keyed
  by the client's ``stream`` id, with an LRU bound (``max_streams``) and a
  per-stream generation counter so a reset landing mid-flight discards the
  stale result instead of overwriting the reset.
- **Clips**: T consecutive frames of one stream run in chained chunks of
  {max_clip, ..., 4, 2, 1} frames, the decoder/head folded over the whole
  chunk (``all_steps``) — per-frame detections with the math of T
  sequential calls. The LIF readouts this needs come from the same CUDA
  kernel as the streaming step.

- **Tensor parallelism** (``mesh.tensor: k``, a ``1 x k`` mesh under
  torchrun): every process holds its channel shards of the weights and of
  each stream's state. Rank 0 runs the HTTP server and the batching
  thread; before each dispatch it broadcasts the command (the frames,
  which stream's stored state each slot reads, which streams keep the
  results, which streams are still live) and every rank runs the same
  step in lockstep. The other ranks loop in :meth:`DetectionService.follow`
  until rank 0 stops. A data or spatial axis raises ``ValueError``:
  serving runs on one device or a ``1 x tensor`` mesh, as the JAX
  package's does.

Endpoints (JSON):
  POST /detect  {"stream": "cam0", "image": <base64 png/jpg>}
      -> {"boxes": [[x1,y1,x2,y2],...], "scores": [...], "classes": [...],
          "latency_ms": float, "batch": int}
  POST /detect  {"stream": "cam0", "images": [<base64>, ...]}   (clip)
      -> {"frames": [{boxes,scores,classes}, ...], "latency_ms", "chunks"}
  POST /reset   {"stream": "cam0"}   -> {"ok": true}
  GET  /healthz -> {"ok": true, "streams": N, "backend": "cuda"}

Run: python -m snn_object_detectionddp_tpu_torch.serve --config scripts/hard_nano.yaml \
        --weights fixtures/hard_nano_ckpt.pt --port 8000
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np
import torch

from .convert import load_weights
from .data.encoding import preprocess_video
from .data.png import SIGNATURE as PNG_SIGNATURE
from .data.png import decode_png
from .data.resize import resize_linear_u8
from .models.detect import decode_predictions
from .ops.nms import batched_nms
from .parallel.mesh import (
    broadcast_object,
    make_mesh,
    maybe_init_distributed,
    process_device,
    tp_shard_params,
)


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts/tuples/lists of equal
    structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


@dataclass
class _Job:
    stream: str
    image_u8: Any  # (H, W, 3) uint8 numpy — or (T, H, W, 3) when clip=True
    reply: queue.Queue = field(default_factory=lambda: queue.Queue(maxsize=1))
    t0: float = field(default_factory=time.perf_counter)  # enqueue time
    clip: bool = False
    # Set by _submit when the caller gave up (reply timeout): the worker
    # drops the job at admission instead of advancing the stream's state
    # with a result nobody reads.
    cancelled: threading.Event = field(default_factory=threading.Event)


# Serving runs on one device or a 1 x tensor mesh, as the JAX package's does.
_SERVE_MESH = ("serve mesh must be a 1 x tensor latency mesh (parallel.mesh.make_mesh(1, "
               "tensor=k)); mesh.data and mesh.spatial are training and evaluation axes")


class DetectionService:
    """Device worker + per-stream state registry (transport-agnostic).
    Runs on ``detector.device``.

    ``mesh``: a ``1 x k`` tensor mesh (``make_mesh(1, tensor=k)``); every
    rank of it builds the service with the whole ``params`` and keeps its
    shards. Rank 0 (``lead``) takes the requests; the others call
    :meth:`follow` (after :meth:`warmup`, as rank 0 does)."""

    def __init__(self, detector, params, conf: float = 0.3, iou: float = 0.45,
                 max_det: int = 100, max_streams: int = 64,
                 max_batch: int = 8, reply_timeout_s: float = 120.0,
                 max_clip: int = 8, mesh=None):
        if mesh is not None and (mesh.size != 1 or mesh.spatial != 1):
            raise ValueError(_SERVE_MESH)
        self.detector = detector
        self.device = detector.device
        self.mesh = mesh if mesh is not None and mesh.tensor > 1 else None
        self.lead = self.mesh is None or self.mesh.tensor_rank == 0
        self.params = tp_shard_params({k: v.to(self.device) for k, v in params.items()},
                                      self.mesh)
        self.conf, self.iou, self.max_det = conf, iou, max_det
        self.max_streams = max_streams
        self.reply_timeout_s = reply_timeout_s
        h, w = detector.cfg.model.image_size
        self.image_hw = (h, w)
        # Padded batch sizes: 1, 2, 4, ... max_batch.
        self.batch_sizes = []
        k = 1
        while k < max_batch:
            self.batch_sizes.append(k)
            k *= 2
        self.batch_sizes.append(max_batch)
        self.max_batch = max_batch
        # Clip chunk sizes {2, 4, ..., max_clip}; a remainder of 1 runs as
        # a streaming step. A clip occupies the serial worker for
        # ceil(T / max_clip) chunks, so its length is bounded.
        self.clip_sizes = []
        k = 2
        while k <= max_clip:
            self.clip_sizes.append(k)
            k *= 2
        self.max_clip = max_clip
        self.max_clip_frames = max(8 * max_clip, 8)

        # Recurrent-state structure from the model itself: a B=1 forward
        # gives the per-stream layout (and, zeroed, the exact first-frame
        # state), and diffing a B=1 and a B=2 probe gives each leaf's
        # batch axis.
        struct1 = self._probe_state(1, h, w)
        self._zero_state1 = tree_map(torch.zeros_like, struct1)
        ph, pw = min(h, 64), min(w, 64)
        self._state_axes = tree_map(
            self._batch_axis, self._probe_state(1, ph, pw), self._probe_state(2, ph, pw)
        )

        self._states: dict[str, Any] = {}
        self._lru: list[str] = []
        self._max_deferred_per_stream = 8
        self._gen: dict[str, int] = {}
        # Guards _states/_lru/_gen: mutated by the worker AND by reset().
        self._state_lock = threading.Lock()
        self._q: queue.Queue[_Job | None] = queue.Queue(maxsize=256)
        self._deferred: list[_Job] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._started = False

    # -- model programs ----------------------------------------------------
    def _probe_state(self, b: int, h: int, w: int):
        frames = torch.zeros((1, b, h, w, 3), dtype=self.detector.dtype,
                             device=self.device)
        return self.detector.apply(self.params, frames, None, mesh=self.mesh)[1]

    @staticmethod
    def _batch_axis(s1: torch.Tensor, s2: torch.Tensor) -> int:
        diffs = [i for i, (a, b) in enumerate(zip(s1.shape, s2.shape)) if a != b]
        if len(diffs) != 1:
            raise ValueError(
                "cannot infer the batch axis of a recurrent-state leaf "
                f"(B=1 shape {tuple(s1.shape)} vs B=2 shape {tuple(s2.shape)})"
            )
        return diffs[0]

    def _detections(self, raw) -> dict[str, np.ndarray]:
        boxes, scores = decode_predictions(
            raw, self.detector.cfg.model.hyp.reg_max,
            self.detector.cfg.model.num_classes, image_hw=self.image_hw,
        )
        out = batched_nms(boxes, scores, conf_thres=self.conf,
                          iou_thres=self.iou, max_det=self.max_det)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _predict(self, images_u8: np.ndarray, rec_states: tuple, decode: bool = True):
        """(K, H, W, 3) images of K streams + their K B=1 states ->
        (host detections, or None without ``decode``, K new B=1 states)."""
        if len(rec_states) == 1:
            rec_state = rec_states[0]
        else:
            rec_state = tree_map(
                lambda ax, *xs: torch.cat(xs, ax), self._state_axes, *rec_states
            )
        imgs = torch.from_numpy(images_u8).to(self.device)
        frames = preprocess_video(imgs[:, None], dtype=self.detector.dtype)
        raw, new_state = self.detector.apply(self.params, frames, rec_state, mesh=self.mesh)
        out = self._detections(raw) if decode else None
        if len(rec_states) == 1:
            return out, (new_state,)
        # clone: a per-stream slice must not pin the whole batch's buffer.
        return out, tuple(
            tree_map(lambda ax, x, i=i: x.narrow(ax, i, 1).clone(),
                     self._state_axes, new_state)
            for i in range(len(rec_states))
        )

    def _predict_clip(self, images_u8: np.ndarray, rec_state, decode: bool = True):
        """(T, H, W, 3) frames of one stream -> (host detections with one
        row per frame, or None without ``decode``, new state)."""
        imgs = torch.from_numpy(images_u8).to(self.device)
        frames = preprocess_video(imgs[None], dtype=self.detector.dtype)
        raw, new_state = self.detector.apply(self.params, frames, rec_state,
                                             all_steps=True, mesh=self.mesh)
        return (self._detections(raw) if decode else None), new_state

    def _clip_chain(self, images_u8: np.ndarray, state, decode: bool = True):
        """A clip as a greedy chain of chunks (largest first), the state
        carried across chunks on the device: (per-chunk host detections,
        final state)."""
        hosts = []
        i, t_total = 0, images_u8.shape[0]
        while i < t_total:
            rem = t_total - i
            size = next((s for s in reversed(self.clip_sizes) if s <= rem), 1)
            seg = np.ascontiguousarray(images_u8[i : i + size])
            if size == 1:
                host, (state,) = self._predict(seg, (state,), decode)
            else:
                host, state = self._predict_clip(seg, state, decode)
            hosts.append(host)
            i += size
        return hosts, state

    # -- tensor-parallel lockstep -------------------------------------------
    def _broadcast(self, command):
        """Rank 0's ``command`` on every rank of the tensor group."""
        if self.mesh is None:
            return command
        return broadcast_object(command, self.mesh.tensor_group)

    def _tell(self, kind: str, **fields) -> None:
        """Rank 0: send the next dispatch to the other ranks, with the
        streams whose state is live (theirs drop the rest)."""
        if self.mesh is not None:
            with self._state_lock:
                live = set(self._states)
            self._broadcast({"kind": kind, "live": live, **fields})

    def follow(self) -> None:
        """A non-lead rank: run every dispatch rank 0 sends, in lockstep,
        until it stops. Each stream's state here is this rank's channel
        shard of it."""
        if self.lead:
            raise RuntimeError("follow() runs on the ranks other than the tensor group's first")
        while True:
            cmd = self._broadcast(None)
            if cmd["kind"] == "stop":
                return
            if cmd["kind"] == "batch":
                states = tuple(self._zero_state1 if s is None else self._states[s]
                               for s in cmd["slots"])
                _, new_states = self._predict(cmd["images"], states, decode=False)
                kept = dict(zip(cmd["commit"], new_states))
            else:  # clip
                s = cmd["stream"]
                state = self._states[s] if cmd["stored"] else self._zero_state1
                kept = {s: self._clip_chain(cmd["images"], state, decode=False)[1]}
            self._states = {s: st for s, st in self._states.items() if s in cmd["live"]}
            self._states.update(kept)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        if not self.lead:
            raise RuntimeError("only the tensor group's first rank takes requests; "
                               "the others call follow()")
        if not self._started:
            self._worker.start()
            self._started = True
        return self

    def stop(self):
        if self._started:
            self._q.put(None)
            self._worker.join(timeout=10)
            self._started = False

    def warmup(self):
        """Run every batch and clip size once before taking traffic (first
        launches load the kernel library and pick conv algorithms)."""
        h, w = self.image_hw
        for k in self.batch_sizes:
            self._predict(np.zeros((k, h, w, 3), np.uint8),
                          tuple([self._zero_state1] * k))
        for t in self.clip_sizes:
            self._predict_clip(np.zeros((t, h, w, 3), np.uint8), self._zero_state1)

    # -- API ---------------------------------------------------------------
    def detect(self, stream: str, image_u8) -> dict:
        h, w = self.image_hw
        if image_u8.shape != (h, w, 3):
            raise ValueError(
                f"expected {(h, w, 3)} uint8 image, got {image_u8.shape} "
                "(the service runs at the configured model.image_size; "
                "resize client-side)"
            )
        return self._submit(_Job(stream, image_u8))

    def detect_clip(self, stream: str, clip_u8) -> dict:
        """Run T consecutive frames of one stream in chained chunks;
        returns {"frames": [per-frame dicts], "latency_ms", "chunks"}. Same
        math as T sequential :meth:`detect` calls; state advances by all T
        frames."""
        h, w = self.image_hw
        if clip_u8.ndim != 4 or clip_u8.shape[1:] != (h, w, 3):
            raise ValueError(
                f"expected (T, {h}, {w}, 3) uint8 clip, got {clip_u8.shape}"
            )
        if clip_u8.shape[0] > self.max_clip_frames:
            raise ValueError(
                f"clip too long ({clip_u8.shape[0]} > {self.max_clip_frames} "
                "frames); split it across requests (state carries over)"
            )
        if clip_u8.shape[0] == 1:
            out = self.detect(stream, clip_u8[0])
            return {
                "frames": [{k: out[k] for k in ("boxes", "scores", "classes")}],
                "latency_ms": out["latency_ms"],
                "chunks": 1,
            }
        return self._submit(_Job(stream, clip_u8, clip=True))

    def _submit(self, job: _Job) -> dict:
        if not (self._started and self._worker.is_alive()):
            raise RuntimeError("detection worker is not running")
        self._q.put(job)
        # Bounded wait + liveness check: a crashed worker surfaces as an
        # error to the caller, never a forever-blocked handler.
        deadline = time.perf_counter() + self.reply_timeout_s
        while True:
            try:
                out = job.reply.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._worker.is_alive():
                    raise RuntimeError("detection worker died while processing") from None
                if time.perf_counter() > deadline:
                    job.cancelled.set()
                    raise TimeoutError(f"no result within {self.reply_timeout_s}s") from None
        if isinstance(out, Exception):
            raise out
        return out

    def reset(self, stream: str) -> None:
        with self._state_lock:
            self._drop_stream_locked(stream)

    def _drop_stream_locked(self, stream: str) -> None:
        self._states.pop(stream, None)
        if stream in self._lru:
            self._lru.remove(stream)
        self._gen[stream] = self._gen.get(stream, 0) + 1  # invalidate in-flight

    @property
    def num_streams(self) -> int:
        return len(self._states)

    # -- device worker -----------------------------------------------------
    def _next_jobs(self) -> list | None:
        """Blocking take of one job, then a non-blocking drain of up to
        max_batch jobs from *distinct* streams. Same-stream jobs defer to
        the next round and block their stream for this one (per-stream
        FIFO). Returns None on the stop sentinel."""
        first = None
        while first is None:
            if self._deferred:
                first = self._deferred.pop(0)
            else:
                first = self._q.get()
                if first is None:
                    return None
            if first.cancelled.is_set():
                first = None
        if first.clip:
            return [first]  # a clip occupies the whole dispatch
        jobs = [first]
        streams = {first.stream}
        i = 0
        while i < len(self._deferred):
            d = self._deferred[i]
            if d.cancelled.is_set():
                self._deferred.pop(i)
                continue
            if d.clip or d.stream in streams or len(jobs) >= self.max_batch:
                streams.add(d.stream)
                i += 1
                continue
            self._deferred.pop(i)
            jobs.append(d)
            streams.add(d.stream)
        while len(jobs) < self.max_batch:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post: stop after this batch
                break
            if nxt.cancelled.is_set():
                continue
            if nxt.clip or nxt.stream in streams:
                # Backpressure: _deferred is outside the bounded queue, so
                # cap it per stream and fail fast beyond the cap.
                if (
                    sum(1 for d in self._deferred if d.stream == nxt.stream)
                    >= self._max_deferred_per_stream
                ):
                    nxt.reply.put(RuntimeError(
                        f"stream '{nxt.stream}' overloaded: requests chain "
                        "serially through its recurrent state; slow down or "
                        "use distinct streams"
                    ))
                else:
                    self._deferred.append(nxt)
                    streams.add(nxt.stream)
            else:
                jobs.append(nxt)
                streams.add(nxt.stream)
        return jobs

    def _prune_gen_locked(self, keep: set) -> None:
        """Drop generation counters of dead streams (safe between
        dispatches: the worker is serial, nothing is in flight)."""
        for s in [s for s in self._gen if s not in self._states and s not in keep]:
            del self._gen[s]

    def _commit_locked(self, stream: str, gen0: int, state) -> None:
        if self._gen.get(stream, 0) != gen0:
            return  # reset landed mid-flight: discard
        self._states[stream] = state
        if stream in self._lru:
            self._lru.remove(stream)
        self._lru.append(stream)
        while len(self._lru) > self.max_streams:
            self._drop_stream_locked(self._lru[0])

    def _run(self):
        if self.device.index is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # this thread's card: a rank's collectives
        while True:
            jobs = self._next_jobs()
            if jobs is None:
                self._tell("stop")
                # Answer anything still queued so no caller blocks on a
                # retired worker.
                leftovers = list(self._deferred)
                self._deferred.clear()
                while True:
                    try:
                        j = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if j is not None:
                        leftovers.append(j)
                for j in leftovers:
                    j.reply.put(RuntimeError("service stopped"))
                return
            try:
                if jobs[0].clip:
                    self._run_clip(jobs[0])
                    continue
                n = len(jobs)
                k = next(s for s in self.batch_sizes if s >= n)
                with self._state_lock:
                    self._prune_gen_locked({j.stream for j in jobs})
                    entries = [(self._states.get(j.stream), self._gen.get(j.stream, 0))
                               for j in jobs]
                states = [s if s is not None else self._zero_state1 for s, _ in entries]
                states += [self._zero_state1] * (k - n)  # padded slots
                images = np.zeros((k, *self.image_hw, 3), np.uint8)
                for i, j in enumerate(jobs):
                    images[i] = j.image_u8
                self._tell("batch", images=images,
                           slots=[j.stream if s is not None else None
                                  for j, (s, _) in zip(jobs, entries)] + [None] * (k - n),
                           commit=[j.stream for j in jobs])
                host, new_states = self._predict(images, tuple(states))
                with self._state_lock:
                    for j, st, (_, gen0) in zip(jobs, new_states[:n], entries):
                        self._commit_locked(j.stream, gen0, st)
                now = time.perf_counter()
                for i, j in enumerate(jobs):
                    reply = self._frame_reply(host, i)
                    reply["latency_ms"] = round((now - j.t0) * 1e3, 2)
                    reply["batch"] = n
                    j.reply.put(reply)
            except Exception as e:  # surface to the callers, keep serving
                for j in jobs:
                    j.reply.put(e)

    @staticmethod
    def _frame_reply(host: dict, r: int) -> dict:
        valid = host["valid"][r]
        return {
            "boxes": host["boxes"][r][valid].round(2).tolist(),
            "scores": host["scores"][r][valid].round(4).tolist(),
            "classes": host["classes"][r][valid].tolist(),
        }

    def _run_clip(self, job: _Job) -> None:
        """One clip job: greedy chain of chunks (largest first), state
        carried across chunks on the device."""
        with self._state_lock:
            self._prune_gen_locked({job.stream})
            st = self._states.get(job.stream)
            gen0 = self._gen.get(job.stream, 0)
        state = st if st is not None else self._zero_state1
        self._tell("clip", images=job.image_u8, stream=job.stream, stored=st is not None)
        hosts, state = self._clip_chain(job.image_u8, state)
        with self._state_lock:
            self._commit_locked(job.stream, gen0, state)
        now = time.perf_counter()
        frames = [self._frame_reply(h, r) for h in hosts for r in range(h["valid"].shape[0])]
        job.reply.put({
            "frames": frames,
            "latency_ms": round((now - job.t0) * 1e3, 2),
            "chunks": len(hosts),
        })


class _BadUpload(ValueError):
    """An upload the handler answers with 400."""


def decode_upload(data: bytes, image_hw: tuple[int, int]) -> np.ndarray:
    """One uploaded image -> (H, W, 3) uint8 RGB at the served size.

    PNG (told by its 8-byte signature) goes through the port's decoder
    (data/png.py) and OpenCV's INTER_LINEAR arithmetic (data/resize.py): no
    OpenCV needed. Any other format is decoded by ``cv2.imdecode``, imported
    here only; without OpenCV it is refused with a message naming it."""
    if data[:8] == PNG_SIGNATURE:
        try:
            rgb = decode_png(data, "uploaded PNG")
        except ValueError as e:
            raise _BadUpload(f"undecodable image: {e}") from None
    else:
        try:
            import cv2
        except ImportError:
            raise _BadUpload("non-PNG upload: its decoder is OpenCV (cv2), which is not "
                             "installed here; send PNG") from None
        bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise _BadUpload("undecodable image")
        rgb = bgr[:, :, ::-1]
    if rgb.shape[:2] != tuple(image_hw):
        rgb = resize_linear_u8(rgb, image_hw)
    return np.ascontiguousarray(rgb)


def make_handler(service: DetectionService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "streams": service.num_streams,
                                 "backend": service.device.type})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                stream = str(req.get("stream", "default"))
                if self.path == "/reset":
                    service.reset(stream)
                    self._json(200, {"ok": True})
                    return
                if self.path != "/detect":
                    self._json(404, {"error": "unknown path"})
                    return

                def decode_one(b64):
                    return decode_upload(base64.b64decode(b64), service.image_hw)

                try:
                    if "images" in req:  # clip: consecutive frames, one call
                        if not req["images"]:
                            raise _BadUpload("empty clip")
                        clip = np.stack([decode_one(b) for b in req["images"]])
                    else:
                        rgb = decode_one(req["image"])
                except _BadUpload as e:
                    self._json(400, {"error": str(e)})
                    return
                if "images" in req:
                    out = service.detect_clip(stream, clip)
                else:
                    out = service.detect(stream, rgb)
                self._json(200, out)
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(cfg, weights: str | None, port: int = 8000, max_batch: int = 8,
          max_clip: int = 8, device: str = "cuda", on_ready=None):
    """Load the detector (a checkpoint of this package or a flax msgpack
    file, :func:`load_weights`; else a seeded random init) and serve it over
    HTTP until interrupted. ``on_ready(httpd, service)``, when given, is
    called once the server listens (``port=0`` picks a free port, which
    ``httpd.server_address`` names); ``httpd.shutdown()`` from another
    thread ends the call.

    ``mesh.tensor: k`` serves channel-sharded over a ``1 x k`` mesh of the
    process group (launched by torchrun, ``mesh.coordinator`` or an
    initialised group): rank 0 listens, the other ranks follow it and
    return when it stops. Without k processes it raises; nothing falls
    back to one device."""
    from .models.detector import Detector

    if cfg.mesh.spatial > 1:
        raise ValueError(_SERVE_MESH)
    mesh = None
    if cfg.mesh.tensor > 1:
        if not torch.distributed.is_initialized():
            maybe_init_distributed(cfg, device)
        mesh = make_mesh(1, tensor=cfg.mesh.tensor)
        device = process_device(device)
    detector = Detector.from_config(cfg, device=device)
    if weights:
        params = load_weights(detector, weights)
    else:
        params = detector.init_params(torch.Generator().manual_seed(0))
        print("WARNING: serving a fresh random init (no --weights)", flush=True)
    service = DetectionService(detector, params, max_batch=max_batch,
                               max_clip=max_clip, mesh=mesh)
    if not service.lead:
        service.warmup()
        print(f"tensor rank {mesh.tensor_rank}/{mesh.tensor}: following rank 0", flush=True)
        service.follow()
        return
    service.start()
    try:
        print("warming up serving shapes...", flush=True)
        service.warmup()
        httpd = ThreadingHTTPServer(("0.0.0.0", port), make_handler(service))
        tp = f", tensor-parallel over {mesh.tensor} processes" if mesh is not None else ""
        print(f"serving on :{httpd.server_address[1]} (device={detector.device}{tp})", flush=True)
        if on_ready is not None:
            on_ready(httpd, service)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    finally:
        service.stop()


if __name__ == "__main__":
    import argparse

    from .config import load_config

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="config.yaml")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="cross-stream micro-batch cap (power of two)")
    ap.add_argument("--max-clip", type=int, default=8,
                    help="largest clip chunk size (power of two); 1 disables clip chunks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = load_config(args.config)
    from .models.detector import set_tf32_policy

    set_tf32_policy(cfg.runtime.precision)
    serve(cfg, args.weights, args.port, args.max_batch, args.max_clip, args.device)
