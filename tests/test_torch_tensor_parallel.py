"""Tensor-parallel inference of the port (parallel/mesh.py part (e)) on the
CPU over gloo.

One module-scoped run of 4 worker processes (this file is also the worker:
``python tests/test_torch_tensor_parallel.py rank world port outfile``)
forming a ``2 x 2`` ``data x tensor`` mesh; each data row of it is a ``1 x
2`` latency mesh. At the tiny fp32 size of tests/test_torch_parallel.py
(yolo11n, width 0.25, 64x64), with the ConvLSTM and with the token-LSTM
bottleneck:

- ``tp_shard_params`` shards the leaves JAX's ``tp_spec`` shards (and no
  others), most of the parameter volume;
- ``make_predict_fn(mesh=)`` on the 1x2 row (B=1) and on the 2x2 mesh (B=4,
  two windows a row): valid mask and classes equal, scores rtol 1e-5,
  boxes rtol 1e-4 / atol 1e-3 against the port's and the JAX package's
  one-process predict (JAX tests/test_tensor_parallel.py's tolerances);
- the raw maps (within 1e-4) and the recurrent state gathered whole (rtol
  and atol 1e-5) of a 1x2 forward and of a second call carrying its
  sharded state, against one process;
- GroupNorm whose groups straddle the shards (48 channels over 3 ranks:
  16 groups of 3), in a spiking and in a plain block;
- a 1x2 ``DetectionService`` (rank 0 takes the requests, rank 1 follows)
  answering three frames of two streams, a reset and a clip as the
  one-process service does;
- ``eval_2.evaluate`` with ``mesh.tensor: 2`` over the 2x2 mesh against one
  process (results within 5e-3, tests/test_torch_cli.py's RESULT_ATOL);
- a train step on a tensor mesh raising ``ValueError``.

The inputs are windows on which the channel-sharded forward fires every
spike the one-process forward fires (a membrane within rounding of the
threshold would make the two different functions): the workers try seeds
until they find one, together.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD, DATA, TENSOR = 4, 2, 2
BOTTLENECKS = ("convlstm", "lstm")
MAX_SEEDS = 5
RESULT_ATOL = 5e-3


def _tiny(mod, bottleneck="convlstm", root=None):
    cfg = mod.Config()
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.model.bottleneck = bottleneck
    cfg.runtime.precision = "f32"
    if root is not None:  # the evaluation tree
        cfg.model.image_size = (48, 64)
        cfg.model.max_boxes = 8
        for split in ("train", "val", "test"):
            sc = cfg.dataset.split(split)
            sc.path, sc.seq_len = str(root / "train"), 3
        cfg.training.num_workers = 1
        cfg.training.batch_size = 4
    return cfg


def _images(seed: int, b: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 255, size=(b, 2, 64, 64, 3), dtype=np.uint8)


def _frames(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(2, 1, 64, 64, 3).astype(np.float32)


def _serve_frames() -> dict:
    rng = np.random.RandomState(7)
    return {f"cam{i}": [rng.randint(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(3)]
            for i in range(2)}


def _drive_service(svc, frames: dict) -> dict:
    """Three frames of two streams, in turns, a reset of the first stream
    and a 3-frame clip on it: the replies without their latencies."""
    keep = ("boxes", "scores", "classes")
    out = {s: [] for s in frames}
    for i in range(3):
        for s, fs in frames.items():
            out[s].append({k: svc.detect(s, fs[i])[k] for k in keep})
    svc.reset("cam0")
    clip = svc.detect_clip("cam0", np.stack(frames["cam1"]))
    out["clip"] = clip["frames"]
    out["streams"] = svc.num_streams
    return out


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _spike_hooks(det):
    """Forward hooks gathering every spiking block's spikes whole."""
    from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock
    from snn_object_detectionddp_tpu_torch.parallel.mesh import full_channels

    got = []
    hooks = [m.register_forward_hook(
        lambda mod, i, o: got.append(full_channels(o[0], mod.features).clone()))
        for m in det.module.modules() if isinstance(m, SpikingConvBlock)]
    return got, hooks


def _flips(det, params, shards, mesh, images, rows) -> int:
    """Spikes that the sharded forward of windows ``rows`` of ``images``
    (B, T, H, W, 3) fires differently from the whole forward of all of
    them."""
    from snn_object_detectionddp_tpu_torch.data.encoding import preprocess_video

    frames = preprocess_video(torch.from_numpy(images), dtype=torch.float32)
    got, hooks = _spike_hooks(det)
    try:
        det.apply(params, frames)
        n = len(got)
        det.apply(shards, frames[:, rows].contiguous(), mesh=mesh)
    finally:
        for h in hooks:
            h.remove()
    return sum(int((a[:, rows] != b).sum()) for a, b in zip(got[:n], got[n:]))


def _gn_straddling(rank: int, group) -> dict:
    """Blocks of 48 channels over 3 ranks (16 groups of 3 channels: a
    group straddles two shards): the sharded outputs gathered against the
    whole block on this rank."""
    from snn_object_detectionddp_tpu_torch.models.layers import ConvBlock, SpikingConvBlock
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.DataMesh(1, 0, None, tensor=3, tensor_rank=rank, tensor_group=group)
    gen = torch.Generator().manual_seed(3)
    out = {}
    for kind in ("spiking", "plain"):
        with torch.device("meta"):
            mod = (SpikingConvBlock(8, 48, LIFParams(), dtype=torch.float32) if kind == "spiking"
                   else ConvBlock(8, 48, dtype=torch.float32))
        params = {"weight": torch.randn(48, 8, 3, 3, generator=gen) * 0.3,
                  "gn_scale": 1.0 + 0.1 * torch.randn(48, generator=gen),
                  "gn_bias": 0.1 * torch.randn(48, generator=gen)}
        shards = {k: pmesh.tp_shard_leaf(k, v, 3, rank) for k, v in params.items()}
        x = torch.randn(2, 1, 8, 8, 8, generator=gen) if kind == "spiking" else torch.randn(
            2, 8, 8, 8, generator=gen)
        call = lambda p: torch.func.functional_call(mod, p, (x,))  # noqa: E731
        whole = call(params)
        with pmesh.tensor_parallel(mesh):
            part = call(shards)
            if kind == "spiking":
                got = [pmesh.full_channels(t, 48) for t in part[:2]]
            else:
                got = [pmesh.full_channels(part, 48)]
        want = list(whole[:2]) if kind == "spiking" else [whole]
        out[kind] = {"shard_width": int((part[0] if kind == "spiking" else part).shape[-1]),
                     "max_err": max(float((a - b).abs().max()) for a, b in zip(got, want)),
                     "spikes_equal": kind != "spiking" or torch.equal(got[0], want[0])}
    return out


def worker(rank: int, world: int, port: int, outfile: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from snn_object_detectionddp_tpu_torch import config as tconfig
    from snn_object_detectionddp_tpu_torch import eval_2
    from snn_object_detectionddp_tpu_torch.convert import params_from_jax
    from snn_object_detectionddp_tpu_torch.evals.validator import make_predict_fn
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pmesh
    from snn_object_detectionddp_tpu_torch.serve import DetectionService
    from snn_object_detectionddp_tpu_torch.train import step as tstep

    tmp = Path(outfile).parent
    inputs = pickle.loads((tmp / "inputs.pkl").read_bytes())
    pmesh.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = pmesh.make_mesh(DATA, tensor=TENSOR)
    row = dataclasses.replace(mesh, size=1, rank=0, group=None)  # this data row: 1 x 2
    out = {"rank": rank, "coords": (mesh.rank, mesh.tensor_rank)}
    for bott in BOTTLENECKS:
        det = Detector.from_config(_tiny(tconfig, bott), device="cpu")
        params = params_from_jax(inputs["jparams"][bott], "cpu")
        shards = pmesh.tp_shard_params(params, mesh)
        # The first seed on which no spike flips, agreed by every rank.
        seed = None
        mine = slice(mesh.rank * 2, (mesh.rank + 1) * 2)
        for s in range(MAX_SEEDS):
            flips = torch.tensor([float(
                _flips(det, params, shards, row, _images(s, 1), slice(0, 1))
                + _flips(det, params, shards, row, _images(s, 4), mine))])
            dist.all_reduce(flips)
            if float(flips) == 0.0:
                seed = s
                break
        res = {"seed": seed}
        if seed is not None:
            res["predict_1x2"] = make_predict_fn(det, mesh=row)(shards, _images(seed, 1))
            res["predict_2x2"] = make_predict_fn(det, mesh=mesh)(shards, _images(seed, 4)[mine])
            raw, state = det.apply(shards, torch.from_numpy(_frames(seed)), mesh=row)
            raw2, state2 = det.apply(shards, torch.from_numpy(_frames(seed + 100)), state,
                                     mesh=row)
            res["raw"], res["state"] = raw, det.gather_state(state, row)
            res["raw2"], res["state2"] = raw2, det.gather_state(state2, row)
            res["state_width"] = {k: int(v.shape[-1]) for k, v in state["backbone"].items()
                                  if isinstance(v, torch.Tensor)}
        out[bott] = res

    group3 = dist.new_group([0, 1, 2])
    if rank < 3:
        out["gn3"] = _gn_straddling(rank, group3)

    # Serving on the first data row: rank 0 takes the requests, rank 1
    # follows it; the second row's ranks take no part.
    det = Detector.from_config(_tiny(tconfig), device="cpu")
    det.cfg.model.image_size = (64, 64)
    params = params_from_jax(inputs["jparams"]["convlstm"], "cpu")
    if mesh.rank == 0:
        svc = DetectionService(det, params, conf=0.0, max_det=20, max_batch=2, max_clip=2,
                               mesh=row)
        svc.warmup()
        if svc.lead:
            svc.start()
            try:
                out["serve"] = _drive_service(svc, _serve_frames())
            finally:
                svc.stop()
        else:
            svc.follow()
    dist.barrier()

    cfg = _tiny(tconfig, root=Path(inputs["eval_root"]))
    cfg.mesh.tensor = TENSOR
    out["eval"] = eval_2.evaluate(cfg, weights=str(tmp / "eval_weights.pt"), device="cpu")

    tx, sched = tstep.make_optimizer(1e-3, 10)
    try:
        tstep.make_step_fns(det, tx, sched, mesh=mesh)
        out["train_raises"] = None
    except ValueError as e:
        out["train_raises"] = str(e)
    torch.save(out, outfile)
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The tests (JAX on the CPU; imported only here, never by the worker)
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from snn_object_detectionddp_tpu import config as jconfig  # noqa: E402
from snn_object_detectionddp_tpu.evals.validator import make_predict_fn as jmake_predict_fn  # noqa: E402
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector  # noqa: E402
from snn_object_detectionddp_tpu.parallel import mesh as jmesh  # noqa: E402
from snn_object_detectionddp_tpu_torch import config as tconfig  # noqa: E402
from snn_object_detectionddp_tpu_torch.convert import params_from_jax  # noqa: E402
from snn_object_detectionddp_tpu_torch.evals.validator import evaluate_model, make_predict_fn  # noqa: E402
from snn_object_detectionddp_tpu_torch.models.detector import Detector  # noqa: E402
from snn_object_detectionddp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from snn_object_detectionddp_tpu_torch.serve import DetectionService  # noqa: E402
from snn_object_detectionddp_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from tests.test_torch_parallel import _eval_tree, _free_port, _one_thread  # noqa: E402


def _np(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Spawn the workers, compute the references while they run, collect."""
    tmp = tmp_path_factory.mktemp("tp")
    jdets, jparams, np_params = {}, {}, {}
    for i, bott in enumerate(BOTTLENECKS):
        jdets[bott] = JDetector.from_config(_tiny(jconfig, bott))
        jparams[bott] = jdets[bott].init_params(jax.random.PRNGKey(17 + i))
        np_params[bott] = jax.tree.map(np.asarray, jparams[bott])
    eval_root = _eval_tree(tmp / "dsec")
    ecfg = _tiny(tconfig, root=eval_root)
    edet = Detector.from_config(ecfg, device="cpu")
    eparams = edet.init_params(torch.Generator().manual_seed(0))
    save_checkpoint(tmp / "eval_weights.pt", {"params": eparams}, 0, 1.0)
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(
        {"jparams": np_params, "eval_root": str(eval_root)}))

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(port), str(o)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r, o in enumerate(outs)]
    try:
        ref = {"np_params": np_params}
        with _one_thread():
            ref["eval"] = evaluate_model(ecfg, edet, eparams, batch_size=4)
            det = Detector.from_config(_tiny(tconfig), device="cpu")
            det.cfg.model.image_size = (64, 64)
            svc = DetectionService(det, params_from_jax(np_params["convlstm"], "cpu"), conf=0.0,
                                   max_det=20, max_batch=2, max_clip=2).start()
            try:
                svc.warmup()
                ref["serve"] = _drive_service(svc, _serve_frames())
            finally:
                svc.stop()
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log}"
    outs = [torch.load(o, weights_only=False) for o in outs]
    ref["jdets"], ref["jparams"] = jdets, jparams
    return outs, ref


@pytest.fixture(scope="module")
def singles(tp):
    """One-process port and JAX predictions and forwards on the seeds the
    workers chose."""
    outs, ref = tp
    got = {}
    for bott in BOTTLENECKS:
        seed = outs[0][bott]["seed"]
        assert seed is not None, f"{bott}: a spike flipped on every one of {MAX_SEEDS} seeds"
        det = Detector.from_config(_tiny(tconfig, bott), device="cpu")
        params = params_from_jax(ref["np_params"][bott], "cpu")
        with _one_thread():
            predict = make_predict_fn(det)
            raw, state = det.apply(params, torch.from_numpy(_frames(seed)))
            raw2, state2 = det.apply(params, torch.from_numpy(_frames(seed + 100)), state)
            got[bott] = {"predict_1x2": predict(params, _images(seed, 1)),
                         "predict_2x2": predict(params, _images(seed, 4)),
                         "raw": raw, "state": state, "raw2": raw2, "state2": state2}
        jpredict = jmake_predict_fn(ref["jdets"][bott])
        got[bott]["jax_1x2"] = jax.device_get(jpredict(ref["jparams"][bott], _images(seed, 1)))
        got[bott]["jax_2x2"] = jax.device_get(jpredict(ref["jparams"][bott], _images(seed, 4)))
    return got


def _predict_close(got: dict, want: dict):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.any()
    np.testing.assert_array_equal(got["classes"][v], want["classes"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-5)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=1e-4, atol=1e-3)


def _rows_2x2(outs, bott):
    """The 2x2 mesh's predictions: data row 0's two windows, then row 1's."""
    rows = {o["coords"]: o[bott]["predict_2x2"] for o in outs}
    return {k: torch.cat([rows[(0, 0)][k], rows[(1, 0)][k]]) for k in rows[(0, 0)]}


def test_mesh_layout_and_workers_agree(tp):
    outs, _ = tp
    assert [o["coords"] for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for bott in BOTTLENECKS:
        for o in outs[1:]:
            for k, v in outs[0][bott]["predict_1x2"].items():
                assert torch.equal(o[bott]["predict_1x2"][k], v), (bott, k)
        # the carried state stays channel-sharded: half of each membrane
        assert all(w % 2 == 0 for w in outs[0][bott]["state_width"].values())


@pytest.mark.parametrize("bott", BOTTLENECKS)
@pytest.mark.parametrize("geom", ["1x2", "2x2"])
def test_tp_predict_matches_one_process(tp, singles, bott, geom):
    outs, _ = tp
    got = outs[0][bott]["predict_1x2"] if geom == "1x2" else _rows_2x2(outs, bott)
    _predict_close(got, singles[bott][f"predict_{geom}"])


@pytest.mark.parametrize("bott", BOTTLENECKS)
@pytest.mark.parametrize("geom", ["1x2", "2x2"])
def test_tp_predict_matches_the_jax_predict(tp, singles, bott, geom):
    outs, _ = tp
    got = outs[0][bott]["predict_1x2"] if geom == "1x2" else _rows_2x2(outs, bott)
    _predict_close(got, singles[bott][f"jax_{geom}"])


@pytest.mark.parametrize("bott", BOTTLENECKS)
@pytest.mark.parametrize("call", ["first", "carried"])
def test_tp_raw_maps_and_gathered_state_match_one_process(tp, singles, bott, call):
    outs, _ = tp
    sfx = "" if call == "first" else "2"
    got, want = outs[0][bott], singles[bott]
    for a, b in zip(got[f"raw{sfx}"], want[f"raw{sfx}"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    leaves_a, leaves_b = jax.tree.leaves(got[f"state{sfx}"]), jax.tree.leaves(want[f"state{sfx}"])
    assert len(leaves_a) == len(leaves_b) > 0
    for a, b in zip(leaves_a, leaves_b):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_tp_shard_params_covers_the_model_as_jax_does(tp):
    """The port shards exactly the leaves whose JAX counterpart JAX's
    ``tp_spec`` shards (k=2 and 4), and more than 90% of the volume."""
    _, ref = tp
    for bott in BOTTLENECKS:
        np_params = ref["np_params"][bott]
        for k in (2, 4):
            flags = jax.tree.map(lambda x: np.full(
                x.shape, float("tensor" in tuple(jmesh.tp_spec(x.shape, k))), np.float32),
                np_params)
            jax_sharded = {n for n, v in params_from_jax(flags, "cpu").items() if bool(v.all())}
            params = params_from_jax(np_params, "cpu")
            port_sharded = {n for n, v in params.items() if tmesh.tp_spec(n, v.shape, k)}
            assert port_sharded == jax_sharded, (bott, k, port_sharded ^ jax_sharded)
            volume = sum(params[n].numel() for n in port_sharded)
            assert volume / sum(v.numel() for v in params.values()) > 0.9
            mesh = tmesh.DataMesh(1, 0, None, tensor=k, tensor_rank=k - 1)
            shards = tmesh.tp_shard_params(params, mesh)
            for n, v in params.items():
                want = v.numel() // k if n in port_sharded else v.numel()
                assert shards[n].numel() == want and shards[n].is_contiguous(), n


def test_gated_leaves_keep_each_gate_of_a_hidden_slice():
    """A ConvLSTM gate kernel's shard holds i, f, g and o of one slice of
    the hidden channels (not a contiguous quarter of the gates)."""
    hidden, k = 8, 2
    w = torch.arange(4 * hidden, dtype=torch.float32).view(4 * hidden, 1, 1, 1)
    for t in range(k):
        got = tmesh.tp_shard_leaf("unet.bottleneck.gates_kernel", w, k, t).view(4, hidden // k)
        for g in range(4):
            lo = g * hidden + t * hidden // k
            assert got[g].tolist() == list(range(lo, lo + hidden // k))
    w_ih = torch.arange(3 * 4 * hidden, dtype=torch.float32).view(3, 4 * hidden)
    got = tmesh.tp_shard_leaf("unet.bottleneck.l1_w_ih", w_ih, k, 1)
    assert got.shape == (3, 4 * hidden // k)
    assert torch.equal(got[:, : hidden // k], w_ih[:, hidden // k: hidden])


@pytest.mark.parametrize("kind", ["spiking", "plain"])
def test_groupnorm_with_groups_straddling_the_shards(tp, kind):
    outs, _ = tp
    for o in outs[:3]:
        res = o["gn3"][kind]
        assert res["shard_width"] == 16 and res["spikes_equal"], res
        assert res["max_err"] <= 1e-5, res


def test_tp_service_answers_as_one_process(tp):
    outs, ref = tp
    got, want = outs[0]["serve"], ref["serve"]
    assert got["streams"] == want["streams"] == 2
    for key in ("cam0", "cam1", "clip"):
        assert len(got[key]) == len(want[key]) == 3
        for a, b in zip(got[key], want[key]):
            assert a["classes"] == b["classes"] and len(b["scores"]) > 0
            np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
            np.testing.assert_allclose(a["boxes"], b["boxes"], atol=2e-2)
    assert all("serve" not in o for o in outs[1:])


def test_eval_2_over_the_2x2_mesh_matches_one_process(tp):
    outs, ref = tp
    for o in outs:
        assert set(o["eval"]) == set(ref["eval"])
        for k, v in ref["eval"].items():
            assert abs(o["eval"][k] - v) <= RESULT_ATOL, (k, o["eval"][k], v)


def test_training_on_a_tensor_mesh_raises(tp):
    outs, _ = tp
    assert all("inference-only" in (o["train_raises"] or "") for o in outs)


def test_make_mesh_refuses_what_the_world_cannot_hold():
    with pytest.raises(ValueError, match="must divide the world size of 1"):
        tmesh.make_mesh(-1, tensor=2)
    assert tmesh.make_mesh(-1, tensor=1) == tmesh.DataMesh(1, 0, None)
    with pytest.raises(ValueError, match="1 x tensor"):
        DetectionService(Detector.from_config(_tiny(tconfig), device="cpu"), {},
                         mesh=tmesh.DataMesh(2, 0, None, tensor=2))
