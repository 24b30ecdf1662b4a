"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

1. Builds the hand-written kernel from its source in the checkout.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it.
3. Drives the main path — the streaming detection service at full width
   (default Config: yolo11m, 480x640, s2d4 stem, ConvLSTM, bf16, seeded
   random weights) — through DetectionService: 3 streams x 3 frames
   micro-batched from threads, one 4-frame clip, and 4 sequential frames
   the clip is compared against. Kernel launch counts are zeroed just
   before and read just after, and must be 20 per forward.
4. Checks the full-width detector against the same weights run on the CPU
   (plain LIF) on a small input, in fp32.
5. Times each kernel beside its byte bound and its plain version (device
   time only; host enqueue is hidden and checked to be hidden), the
   serving step at B=1 and B=4 over several windows of 100 dispatches
   with the spread and the dispatching thread's CPU time, detect()
   latency over 300 requests, and the device (kernel) time of a B=1 step
   from the profiler.

Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Any failure raises (non-zero
exit, no result line). Needs a CUDA card; there is no CPU path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
SLEEP_CYCLES_PER_S = 1.98e9  # H100 SXM top SM clock: a lower clock only sleeps longer
SERVE_WINDOWS, SERVE_PER_WINDOW = 5, 100  # serving dispatches timed per batch size
N_LATENCY = 300  # detect() requests timed through the service
N_PROFILED = 50  # B=1 dispatches under the profiler
T_CLIP = 4
# v_final / readouts: the kernel uses the same rounded fp32 ops as the
# plain version, so they should agree exactly; the tolerances only admit
# one ulp of fp32 (v_final) and of bf16 (readouts, relative).
V_ATOL = 1e-5
READ_RTOL = 2 ** -7
# Spikes may differ only where the membrane sits this close to threshold.
SPIKE_EPS = 1e-5


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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is False)")
    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock
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
    print(f"built affine_lif_fwd in {time.perf_counter() - t0:.1f} s")

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

        K.reset_launch_count()
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
        launches = {"affine_lif_fwd": K.launch_count}
        n_fwd = forwards[0]
        fwd_hook.remove()
        batches = sorted(r["batch"] for rs in replies.values() for r in rs)
        print(f"phase 2: {sum(len(v) for v in replies.values())} stream requests in batches "
              f"{batches}, clip chunks {clip_out['chunks']}; {n_fwd} forwards, "
              f"affine_lif_fwd launches {launches['affine_lif_fwd']}")
        if launches["affine_lif_fwd"] != n_blocks * n_fwd or n_fwd == 0:
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
        cuda_type = torch.autograd.DeviceType.CUDA
        evs = [e for e in prof.key_averages() if e.device_type == cuda_type]
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

    print(json.dumps({"kernels": [{
        "name": "affine_lif_fwd",
        "route": "cuda",
        "source": "snn_object_detectionddp_tpu_torch/csrc/affine_lif.cu",
        "replaces": "snn_object_detectionddp_tpu/kernels/affine_lif_pallas.py:93",
        "launches": launches["affine_lif_fwd"],
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
