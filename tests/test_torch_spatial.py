"""Spatial parallelism of the port (parallel/mesh.py part (d)) on the CPU
over gloo.

One module-scoped run of 4 worker processes (this file is also the worker:
``python tests/test_torch_spatial.py rank world port outfile``). They form
a ``2 x 2`` ``data x spatial`` mesh, then a ``1 x 4`` one, and run the tiny
fp32 model of tests/test_torch_tensor_parallel.py (yolo11n, width 0.25,
reg_max 8) at 64, 96 and 128 rows, on the port's seeded weights (for the
JAX package, the same weights as its flax tree). The references (the
port's one process, and the JAX package's GSPMD predict and step on 4
virtual CPU devices) run in this process while the workers do:

- ``fetch_rows`` / ``gather_rows`` forward and backward against slices of a
  whole tensor, on an even, an odd and a zero-row geometry;
- each layer against one process: a 3x3 conv at stride 1 and at stride 2
  on even and odd heights, the transposed conv with the skip resize
  (15->16 and 3->4), GroupNorm, the ConvLSTM and the token LSTM, outputs
  and gradients;
- ``make_predict_fn(mesh=)`` on the 2x2 mesh at 64x64 against the port's
  one-process predict and the JAX package's spatial predict: valid mask and
  classes equal, scores rtol 1e-5 (tests/test_spatial.py's tolerances);
- the train step at 96 rows on the 2x2 mesh with ``remat_chunk=1`` against
  one process (loss and ``grad_norm`` rtol 1e-5, first moments as
  tests/test_torch_fsdp.py holds them) and against the JAX package's
  spatial step (loss rtol 2e-4, ``grad_norm`` rtol 2e-2, its own
  tolerances); with ``mesh.fsdp`` on the same mesh; ``remat_chunk`` with
  ``grad_accum`` and ``save_conv`` on the 1x4 mesh;
- the three bottlenecks, and the geometries the JAX package refuses to
  train (64 rows at s=2 and s=4: single-row blocks, ranks with no row of
  the stride-64 map), against one process;
- ``eval_2`` with ``mesh.spatial: 2`` against one process (results within
  5e-3), the spike rates and the gathered recurrent state;
- ``make_mesh``'s layouts and refusals, and ``serve()`` /
  ``DetectionService`` refusing a spatial axis.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu_torch.parallel.mesh import row_partition

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
RESULT_ATOL = 5e-3
BOTTLENECKS = ("convlstm", "lstm", "lif")


def _tiny(mod, bottleneck="convlstm", root=None):
    cfg = mod.Config()
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.model.max_boxes = 8
    cfg.model.bottleneck = bottleneck
    cfg.model.use_conv_lstm = bottleneck == "convlstm"
    cfg.runtime.precision = "f32"
    cfg.training.batch_size = 2
    cfg.training.learning_rate = 1e-3
    if root is not None:  # the evaluation tree
        cfg.model.image_size = (48, 64)
        for split in ("train", "val", "test"):
            sc = cfg.dataset.split(split)
            sc.path, sc.seq_len = str(root / "train"), 3
        cfg.training.num_workers = 1
        cfg.training.batch_size = 4
    return cfg


def _batch(seed: int, b: int, h: int, t: int = 2) -> dict:
    """tests/test_train.py's batch: random frames, one box a sample."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, size=(b, t, h, 64, 3), dtype=np.uint8)
    labels = np.zeros((b, 8, 5), np.float32)
    mask = np.zeros((b, 8), bool)
    labels[:, 0] = [1.0, 0.5, 0.5, 0.4, 0.4]
    mask[:, 0] = True
    return {"images": images, "labels": labels, "label_mask": mask,
            "sample_mask": np.ones((b,), bool)}


def _cli_cfg(mod, root: Path, save_dir: Path, spatial: int = 1, fsdp: bool = False):
    """An epoch of ``main.train_code`` on the evaluation tree (48x64: the
    stride-64 map has one row), a global batch of 2."""
    cfg = _tiny(mod, root=root)
    cfg.training.batch_size, cfg.training.epochs = 2, 1
    cfg.training.save_dir = str(save_dir)
    cfg.mesh.spatial, cfg.mesh.fsdp = spatial, fsdp
    return cfg


def _predict_images() -> np.ndarray:
    return np.random.RandomState(6).randint(0, 255, size=(4, 2, 64, 64, 3), dtype=np.uint8)


# The train steps the workers run: (name, mesh "2x2" or "1x4", bottleneck,
# rows, seed of the batch, step options). On the 2x2 mesh the global batch
# is 4 windows (2 a data rank), on the 1x4 mesh 2.
STEPS = (
    ("remat1_h96", "2x2", "convlstm", 96, 3, {"remat_chunk": 1}),
    ("fsdp_h96", "2x2", "convlstm", 96, 3, {"fsdp": True}),
    ("s2_h64", "2x2", "convlstm", 64, 5, {}),
    ("s4_h64", "1x4", "convlstm", 64, 5, {}),
    ("lstm_h64", "1x4", "lstm", 64, 8, {}),
    ("lif_h64", "1x4", "lif", 64, 8, {}),
    ("accum_h96", "1x4", "convlstm", 96, 9, {"remat_chunk": 1, "grad_accum": 2}),
    ("save_conv_h128", "1x4", "convlstm", 128, 9, {"remat": True, "remat_policy": "save_conv"}),
)


def _one_process_kwargs(opts: dict) -> dict:
    return {k: v for k, v in opts.items() if k != "fsdp"}


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out.float()]


def _rows_of(t: torch.Tensor, s: int, r: int) -> torch.Tensor:
    """Rank r's rows (axis -3) of a whole output; a 3-D output (the token
    LSTM's carry) is whole on every rank."""
    if t.ndim < 4:
        return t
    a, b = row_partition(t.shape[-3], s, r)
    return t.narrow(-3, a, b - a)


def _exchange_cases(sg_mesh) -> dict:
    """fetch_rows and gather_rows on the 1x4 spatial group against slices
    of a whole tensor: outputs, and the gradients of a seeded weighting of
    every rank's output summed into the whole tensor."""
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pm

    s, r = sg_mesh.spatial, sg_mesh.spatial_rank
    out = {}
    for n in (8, 7, 2):  # even, odd, and ranks 2 and 3 with no row
        gen = torch.Generator().manual_seed(n)
        whole = torch.randn(2, n, 3, 4, generator=gen, dtype=torch.float64)
        # rank j asks for its rows with a halo of 2 above and 1 below
        parts = [pm.row_partition(n, s, j) for j in range(s)]
        lo = [a - 2 if b > a else 0 for a, b in parts]
        hi = [b + 1 if b > a else 0 for a, b in parts]
        weights = [torch.randn(2, hi[j] - lo[j], 3, 4, generator=gen, dtype=torch.float64)
                   for j in range(s)]
        w_gather = torch.randn(2, n, 3, 4, generator=gen, dtype=torch.float64)
        a, b = parts[r]
        x = whole[:, a:b].clone().requires_grad_(True)
        with pm.spatial_parallel(sg_mesh):
            fetched = pm.fetch_rows(x, n, lo, hi)
            gathered = pm.gather_rows(x, n)
        zeros = torch.zeros(2, 2, 3, 4, dtype=whole.dtype)
        padded = torch.cat([zeros, whole, zeros[:, :1]], 1)  # rows -2 .. n
        want = padded[:, lo[r] + 2: hi[r] + 2]
        (g_fetch,) = torch.autograd.grad((fetched * weights[r]).sum(), [x], retain_graph=True)
        (g_gather,) = torch.autograd.grad((gathered * w_gather).sum(), [x])
        # the whole tensor's gradient: every rank's weights added at its rows
        g_whole = torch.zeros(2, n + 3, 3, 4, dtype=whole.dtype)
        for j in range(s):
            g_whole[:, lo[j] + 2: hi[j] + 2] += weights[j]
        out[n] = {
            "rows": b - a,
            "fetch_shape_ok": fetched.shape == want.shape,
            "fetch_err": float((fetched - want).detach().abs().max()) if want.numel() else 0.0,
            "gather_err": float((gathered - whole).detach().abs().max()),
            "fetch_grad_err": float((g_fetch - g_whole[:, 2 + a: 2 + b]).abs().max())
            if b > a else 0.0,
            "gather_grad_err": float((g_gather - w_gather[:, a:b]).abs().max()) if b > a else 0.0,
        }
    return out


def _layer_cases(sg_mesh) -> dict:
    """Each layer on the 1x4 group against itself on the whole map: the
    largest output and input-gradient errors and the largest relative
    error of a parameter gradient (summed over the group, but for the
    token LSTM's, whole on every rank)."""
    import torch.distributed as dist

    from snn_object_detectionddp_tpu_torch.models.convlstm import ConvLSTM2d
    from snn_object_detectionddp_tpu_torch.models.layers import ConvBlock, SpikingConvBlock, UpBlock
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams
    from snn_object_detectionddp_tpu_torch.models.token_lstm import TokenLSTM
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pm

    f32 = torch.float32
    with torch.device("meta"):  # (module, input rows, input shape, skip rows and width)
        cases = {
            "conv3x3_s1_h7": (ConvBlock(4, 8, dtype=f32), 7, (2, 7, 6, 4), None),
            "conv3x3_s2_h8": (ConvBlock(4, 8, stride=2, dtype=f32), 8, (2, 8, 6, 4), None),
            "conv3x3_s2_h15": (ConvBlock(4, 8, stride=2, dtype=f32), 15, (2, 15, 6, 4), None),
            "spiking_s2_h15": (SpikingConvBlock(4, 8, LIFParams(threshold=0.2), stride=2,
                                                dtype=f32), 15, (2, 1, 15, 6, 4), None),
            "up_8_skip15": (UpBlock(8, 4, 8, dtype=f32), 8, (2, 8, 3, 8), (15, 5)),
            "up_2_skip3": (UpBlock(8, 4, 8, dtype=f32), 2, (2, 2, 3, 8), (3, 5)),
            "convlstm_h6": (ConvLSTM2d(4, 4, dtype=f32), 6, (2, 1, 6, 3, 4), None),
            "token_lstm_h3": (TokenLSTM(4, dtype=f32), 3, (2, 1, 3, 3, 4), None),
        }
    s, r = sg_mesh.spatial, sg_mesh.spatial_rank
    out = {}
    for i, (name, (mod, n, shape, skip_geom)) in enumerate(cases.items()):
        gen = torch.Generator().manual_seed(100 + i)
        params = {}
        for pname, p in mod.named_parameters():
            owner, _, leaf = pname.rpartition(".")
            t = torch.empty(p.shape)
            (mod.get_submodule(owner) if owner else mod).init_param(leaf, t, gen)
            params[pname] = (t + 0.05 * torch.randn(p.shape, generator=gen)).requires_grad_(True)
        x = torch.randn(shape, generator=gen)
        skip = None if skip_geom is None else torch.randn(2, skip_geom[0], skip_geom[1], 4,
                                                          generator=gen)

        def call(xx, sk, rows=None):
            args = (xx,) if sk is None else (xx, sk)
            kw = {} if rows is None else {"rows": rows}
            if rows is not None and sk is not None:
                kw["skip_rows"] = skip_geom[0]
            return _flat(torch.func.functional_call(mod, params, args, kw))

        xw = x.clone().requires_grad_(True)
        whole = call(xw, skip)
        weights = [torch.randn(o.shape, generator=gen) for o in whole]
        want_g = torch.autograd.grad(sum((o * w).sum() for o, w in zip(whole, weights)),
                                     [xw, *params.values()])
        xl = _rows_of(x, s, r).clone().requires_grad_(True)
        with pm.spatial_parallel(sg_mesh):
            got = call(xl, None if skip is None else _rows_of(skip, s, r), rows=n)
            got_g = torch.autograd.grad(
                sum((o * _rows_of(w, s, r)).sum() for o, w in zip(got, weights)),
                [xl, *params.values()], allow_unused=True)  # a rank with no row
            got_g = [torch.zeros_like(v) if g is None else g
                     for g, v in zip(got_g, [xl, *params.values()])]
        res = {"out_err": max(float((o - _rows_of(w, s, r)).detach().abs().max()) if o.numel() else 0.0
                              for o, w in zip(got, whole)),
               "x_grad_err": float((got_g[0] - _rows_of(want_g[0], s, r)).abs().max())
               if xl.numel() else 0.0}
        p_err = 0.0
        for g, w in zip(got_g[1:], want_g[1:]):
            g = g.clone()
            if not getattr(mod, "rows_replicated", False):
                dist.all_reduce(g, group=sg_mesh.spatial_group)
            p_err = max(p_err, float((g - w).abs().max()) / (float(w.abs().max()) or 1.0))
        res["param_grad_rel_err"] = p_err
        out[name] = res
    return out


def _step(det, params, batch, mesh, opts):
    from snn_object_detectionddp_tpu_torch.train import step as tstep

    tx, sched = tstep.make_optimizer(1e-3, 100)
    fns = tstep.make_step_fns(det, tx, sched, mesh=mesh, **opts)
    state = fns.shard_state(tstep.init_state({k: v.clone() for k, v in params.items()}, tx,
                                             sched))
    state, metrics = fns.train_step(state, batch)
    whole = fns.gather_state(state)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "mu": whole["opt_state"]["mu"]}


def worker(rank: int, world: int, port: int, outfile: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from snn_object_detectionddp_tpu_torch import config as tconfig
    from snn_object_detectionddp_tpu_torch import eval_2
    from snn_object_detectionddp_tpu_torch.data.encoding import preprocess_video
    from snn_object_detectionddp_tpu_torch.evals.validator import make_predict_fn
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pm

    tmp = Path(outfile).parent
    inputs = pickle.loads((tmp / "inputs.pkl").read_bytes())
    pm.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    meshes = {"2x2": pm.make_mesh(2, spatial=2), "1x4": pm.make_mesh(1, spatial=4)}
    out = {"rank": rank, "coords": {k: (m.size, m.rank, m.spatial, m.spatial_rank)
                                    for k, m in meshes.items()}}
    refusals = {}
    for args in ((-1, 3), (4, 2), (-1, 2, 2)):
        try:
            pm.make_mesh(*args[:2], **({"tensor": args[2]} if len(args) > 2 else {}))
            refusals[args] = None
        except ValueError as e:
            refusals[args] = str(e)
    out["refusals"] = refusals

    out["exchange"] = _exchange_cases(meshes["1x4"])
    out["layers"] = _layer_cases(meshes["1x4"])

    dets = {b: Detector.from_config(_tiny(tconfig, b), device="cpu") for b in BOTTLENECKS}
    params = {b: {k: torch.from_numpy(v) for k, v in inputs["params"][b].items()}
              for b in BOTTLENECKS}
    steps = {}
    for name, mesh_name, bott, h, seed, opts in STEPS:
        mesh = meshes[mesh_name]
        b = 4 if mesh_name == "2x2" else 2
        batch = _batch(seed, b, h)
        mine = {k: v[mesh.rank * (b // mesh.size): (mesh.rank + 1) * (b // mesh.size)]
                for k, v in batch.items()}
        steps[name] = _step(dets[bott], params[bott], mine, mesh, opts)
    out["steps"] = steps

    mesh = meshes["2x2"]
    det, p = dets["convlstm"], params["convlstm"]
    images = _predict_images()[mesh.rank * 2: (mesh.rank + 1) * 2]
    out["predict"] = make_predict_fn(det, mesh=mesh)(p, images)
    frames = preprocess_video(torch.from_numpy(images), dtype=torch.float32)
    out["rates"] = det.spike_rates(p, frames, mesh=mesh)
    raw, state = det.apply(p, pm.spatial_rows(frames, mesh), mesh=mesh, height=64)
    out["raw"], out["state"] = raw, det.gather_state(state, mesh)

    cfg = _tiny(tconfig, root=Path(inputs["eval_root"]))
    cfg.mesh.spatial = 2
    out["eval"] = eval_2.evaluate(cfg, weights=str(tmp / "eval_weights.pt"), device="cpu")

    from snn_object_detectionddp_tpu_torch import main

    out["cli"] = {}
    for name, spatial, fsdp in (("1x4", 4, False), ("2x2_fsdp", 2, True)):
        cli = _cli_cfg(tconfig, Path(inputs["eval_root"]), tmp / f"cli_{name}", spatial, fsdp)
        state = main.train_code(cli, Detector.from_config(cli, device="cpu"))
        out["cli"][name] = {"step": state["step"],
                            "flat": all(v.ndim == 1 for v in state["params"].values())}
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
from snn_object_detectionddp_tpu.train import step as jstep  # noqa: E402
from snn_object_detectionddp_tpu_torch import config as tconfig  # noqa: E402
from snn_object_detectionddp_tpu_torch import main as tmain  # noqa: E402
from snn_object_detectionddp_tpu_torch import serve as tserve  # noqa: E402
from snn_object_detectionddp_tpu_torch.convert import params_from_jax  # noqa: E402
from snn_object_detectionddp_tpu_torch.data.encoding import preprocess_video  # noqa: E402
from snn_object_detectionddp_tpu_torch.evals.validator import evaluate_model, make_predict_fn  # noqa: E402
from snn_object_detectionddp_tpu_torch.models.detector import Detector  # noqa: E402
from snn_object_detectionddp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from snn_object_detectionddp_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from tests.test_torch_parallel import _eval_tree, _free_port, _one_thread  # noqa: E402


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """Spawn the workers, compute the references while they run, collect."""
    tmp = tmp_path_factory.mktemp("sp")
    # The port's seeded init (the flax initializers), and the same weights
    # as a flax tree for the JAX package's spatial step and predict.
    dets = {b: Detector.from_config(_tiny(tconfig, b), device="cpu") for b in BOTTLENECKS}
    params = {b: dets[b].init_params(torch.Generator().manual_seed(7 + i))
              for i, b in enumerate(BOTTLENECKS)}
    jdet = JDetector.from_config(_tiny(jconfig))
    jparams = _as_flax_tree(params["convlstm"], jdet)
    eval_root = _eval_tree(tmp / "dsec")
    ecfg = _tiny(tconfig, root=eval_root)
    edet = Detector.from_config(ecfg, device="cpu")
    eparams = edet.init_params(torch.Generator().manual_seed(0))
    save_checkpoint(tmp / "eval_weights.pt", {"params": eparams}, 0, 1.0)
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(
        {"params": {b: {k: v.numpy() for k, v in p.items()} for b, p in params.items()},
         "eval_root": str(eval_root)}))

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(port), str(o)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r, o in enumerate(outs)]
    try:
        ref = {"eval": None, "steps": {}}
        with _one_thread():
            ref["eval"] = evaluate_model(ecfg, edet, eparams, batch_size=4)
            cli = _cli_cfg(tconfig, eval_root, tmp / "cli_one")
            ref["cli_before"] = Detector.from_config(cli, device="cpu").init_params(
                torch.Generator().manual_seed(cli.training.seed))
            ref["cli"] = tmain.train_code(cli, Detector.from_config(cli, device="cpu"))
            for name, mesh_name, bott, h, seed, opts in STEPS:
                b = 4 if mesh_name == "2x2" else 2
                ref["steps"][name] = _step(dets[bott], params[bott], _batch(seed, b, h), None,
                                           _one_process_kwargs(opts))
            det, p = dets["convlstm"], params["convlstm"]
            ref["predict"] = make_predict_fn(det)(p, _predict_images())
            frames = preprocess_video(torch.from_numpy(_predict_images()), dtype=torch.float32)
            ref["rates"] = {k: det.spike_rates(p, frames[:, r * 2:(r + 1) * 2])
                            for k, r in (("row0", 0), ("row1", 1))}
            ref["raw"], ref["state"] = det.apply(p, frames)
        # JAX's GSPMD spatial predict and step on a 2 x 2 mesh of virtual CPU devices
        jm = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
        ref["jax_predict"] = jax.device_get(
            jmake_predict_fn(jdet, mesh=jm)(jparams, _predict_images()))
        jtx, jsched = jstep.make_optimizer(1e-3, total_steps=100)
        jfns = jstep.make_step_fns(jdet, jtx, jsched, mesh=jm, remat_chunk=1)
        jstate = jstep.init_state(jax.tree.map(lambda x: x.copy(), jparams), jtx, jsched)
        _, jm_metrics = jfns.train_step(jstate, jmesh.shard_batch(_batch(3, 4, 96), jm))
        ref["jax_step"] = {k: float(v) for k, v in jax.device_get(jm_metrics).items()}
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log}"
    ref["cli_latest"] = {name: torch.load(tmp / f"cli_{name}" / "latest.pt", weights_only=True)
                         for name in ("1x4", "2x2_fsdp")}
    return [torch.load(o, weights_only=False) for o in outs], ref


def _as_flax_tree(params: dict, jdet) -> dict:
    """The port's parameters as the JAX detector's flax tree: each flax
    leaf is filled with element ids, ``params_from_jax`` shows where each
    id lands in the port's layout, and the port's values go back there
    (no flax init, whose eager run on the CPU takes tens of seconds)."""
    leaves, treedef = jax.tree.flatten(jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0)))
    id_leaves, start = [], 0
    for x in leaves:
        n = int(np.prod(x.shape))
        id_leaves.append(np.arange(start, start + n, dtype=np.float64).reshape(x.shape))
        start += n
    assert start < 2**24  # ids exact in the converter's fp32
    where = params_from_jax(jax.tree.unflatten(treedef, id_leaves), "cpu")
    flat = np.full(start, np.nan, np.float32)
    for k, pos in where.items():
        flat[pos.numpy().astype(np.int64).ravel()] = params[k].numpy().ravel()
    assert set(where) == set(params) and not np.isnan(flat).any()
    tree = jax.tree.unflatten(treedef, [jax.numpy.asarray(flat[a.astype(np.int64)])
                                        for a in id_leaves])
    back = params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    assert all(torch.equal(back[k], v) for k, v in params.items())
    return tree


@pytest.fixture(autouse=True)
def _one_thread_per_test():
    """The comparisons on one thread: beside the suite's other workers a
    thread pool per small op oversubscribes the host's cores."""
    with _one_thread():
        yield


def _np(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


def _predict_close(got: dict, want: dict):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.any()
    np.testing.assert_array_equal(got["classes"][v], want["classes"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-5)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=1e-4, atol=1e-3)


def _by_coords(outs, mesh_name):
    return {o["coords"][mesh_name][1:]: o for o in outs}  # (data rank, spatial size, rank)


def _rows_2x2(outs, key):
    """The 2x2 mesh's predictions: data row 0's two windows, then row 1's
    (each as its spatial rank 0 holds it)."""
    rows = {o["coords"]["2x2"][1]: o[key] for o in outs if o["coords"]["2x2"][3] == 0}
    return {k: torch.cat([rows[0][k], rows[1][k]]) for k in rows[0]}


def test_mesh_layouts_and_refusals(sp):
    outs, _ = sp
    for r, o in enumerate(outs):
        assert o["coords"]["2x2"] == (2, r // 2, 2, r % 2)
        assert o["coords"]["1x4"] == (1, 0, 4, r)
        assert "must divide the world size of 4" in o["refusals"][(-1, 3)]
        assert "exceeds the world size of 4" in o["refusals"][(4, 2)]
        assert "cannot both exceed 1" in o["refusals"][(-1, 2, 2)]
    with pytest.raises(ValueError, match="mesh.spatial=2 must divide the world size of 1"):
        tmesh.make_mesh(-1, spatial=2)
    assert tmesh.make_mesh(-1, spatial=1) == tmesh.DataMesh(1, 0, None)


def test_row_partition_is_gspmds_ceil_blocks():
    assert [tmesh.row_partition(15, 2, r) for r in range(2)] == [(0, 8), (8, 15)]
    assert [tmesh.row_partition(120, 4, r) for r in range(4)] == [
        (0, 30), (30, 60), (60, 90), (90, 120)]
    assert [tmesh.row_partition(1, 2, r) for r in range(2)] == [(0, 1), (1, 1)]
    assert [tmesh.row_partition(2, 4, r) for r in range(4)] == [(0, 1), (1, 2), (2, 2), (2, 2)]
    # 480 input rows over the spatial sizes JAX accepts: each rank's input
    # rows are a multiple of 4 (the s2d4 stem takes them as they are)
    for s in (2, 3, 4, 5, 8):
        for r in range(s):
            lo, hi = tmesh.row_partition(480, s, r)
            assert lo % 4 == 0 and hi % 4 == 0 and (lo, hi) == tuple(
                4 * v for v in tmesh.row_partition(120, s, r))


@pytest.mark.parametrize("n", [8, 7, 2])
def test_fetch_and_gather_rows_match_slices_of_the_whole(sp, n):
    outs, _ = sp
    rows = [o["exchange"][n]["rows"] for o in outs]
    assert sum(rows) == n
    if n == 2:
        assert rows == [1, 1, 0, 0]
    for o in outs:
        res = o["exchange"][n]
        assert res["fetch_shape_ok"], res
        for k in ("fetch_err", "gather_err", "fetch_grad_err", "gather_grad_err"):
            assert res[k] <= 1e-12, (k, res)


LAYERS = ("conv3x3_s1_h7", "conv3x3_s2_h8", "conv3x3_s2_h15", "spiking_s2_h15", "up_8_skip15",
          "up_2_skip3", "convlstm_h6", "token_lstm_h3")


@pytest.mark.parametrize("layer", LAYERS)
def test_each_layer_matches_the_whole_map(sp, layer):
    outs, _ = sp
    for o in outs:
        res = o["layers"][layer]
        assert res["out_err"] <= 1e-5, res
        assert res["x_grad_err"] <= 1e-5, res
        assert res["param_grad_rel_err"] <= 1e-5, res


def test_predict_on_the_2x2_mesh_matches_one_process(sp):
    outs, ref = sp
    _predict_close(_rows_2x2(outs, "predict"), ref["predict"])
    for o in outs:  # both ranks of a spatial group return the same result
        mate = _by_coords(outs, "2x2")[(o["coords"]["2x2"][1], 2, 0)]
        for k, v in o["predict"].items():
            assert torch.equal(v, mate["predict"][k]), k


def test_predict_on_the_2x2_mesh_matches_the_jax_spatial_predict(sp):
    outs, ref = sp
    _predict_close(_rows_2x2(outs, "predict"), ref["jax_predict"])


def _close_mu(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        atol = 1e-5 * float(w.abs().max())
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=atol,
                                   msg=lambda m: f"{what} {k}: {m}")


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_train_step_matches_one_process(sp, name):
    outs, ref = sp
    want = ref["steps"][name]
    for o in outs:
        got = o["steps"][name]
        for k in ("loss", "box", "cls", "dfl", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5,
                                       err_msg=f"{name} {k}")
        assert got["metrics"]["fg"] == want["metrics"]["fg"] > 0
        _close_mu(got["mu"], want["mu"], name)


def test_train_step_matches_the_jax_spatial_step(sp):
    """The port's 2x2 step with remat_chunk=1 against the JAX package's
    GSPMD step on the same mesh shape, parameters and batch, with
    tests/test_spatial.py's tolerances."""
    outs, ref = sp
    got, want = outs[0]["steps"]["remat1_h96"]["metrics"], ref["jax_step"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-2)


def test_spike_rates_and_gathered_state_match_one_process(sp):
    outs, ref = sp
    for o in outs:
        row = o["coords"]["2x2"][1]
        want = ref["rates"][f"row{row}"]
        assert set(o["rates"]) == set(want) and len(want) > 10
        for k, v in want.items():
            assert abs(o["rates"][k] - v) <= 1e-6, k
    o = _by_coords(outs, "2x2")[(0, 2, 0)]
    for a, b in zip(o["raw"], ref["raw"]):
        torch.testing.assert_close(a, b[:2], rtol=1e-4, atol=1e-4)
    leaves_a, leaves_b = jax.tree.leaves(o["state"]), jax.tree.leaves(ref["state"])
    assert len(leaves_a) == len(leaves_b) > 0
    for a, b in zip(leaves_a, leaves_b):
        torch.testing.assert_close(a, b[:2], rtol=1e-5, atol=1e-5)


def test_eval_2_over_the_2x2_mesh_matches_one_process(sp):
    outs, ref = sp
    for o in outs:
        assert set(o["eval"]) == set(ref["eval"])
        for k, v in ref["eval"].items():
            assert abs(o["eval"][k] - v) <= RESULT_ATOL, (k, o["eval"][k], v)


def test_main_trains_an_epoch_on_a_spatial_mesh(sp):
    """``main.train_code`` with ``mesh.spatial: 4`` (1x4: the same batches
    as one process) ends within 5e-3 of each leaf's update of the
    one-process run; with ``mesh.spatial: 2`` and ``mesh.fsdp`` (2x2) it
    takes its steps on flat chunks. Rank 0 writes whole leaves."""
    outs, ref = sp
    steps = ref["cli"]["step"]
    assert steps > 0
    assert [o["cli"]["1x4"] for o in outs] == [{"step": steps, "flat": False}] * WORLD
    assert [o["cli"]["2x2_fsdp"] for o in outs] == [{"step": steps, "flat": True}] * WORLD
    got = ref["cli_latest"]["1x4"]["state"]["params"]
    for k, w in ref["cli"]["params"].items():
        err = float((got[k] - w).double().norm())
        step = float((w - ref["cli_before"][k]).double().norm())
        assert err <= 5e-3 * step or err == 0.0, (k, err, step)
    fsdp = ref["cli_latest"]["2x2_fsdp"]["state"]
    assert fsdp["step"] == steps
    for part in (fsdp["params"], fsdp["opt_state"]["mu"]):
        assert {k: tuple(v.shape) for k, v in part.items()} == {
            k: tuple(v.shape) for k, v in ref["cli_before"].items()}
        assert all(torch.isfinite(v).all() for v in part.values())


def test_serving_refuses_a_spatial_axis(tmp_path):
    """Serving is one device or a 1 x tensor mesh, as the JAX package's
    DetectionService: a spatial axis raises ValueError before anything is
    built."""
    cfg = _tiny(tconfig)
    cfg.mesh.spatial = 2
    with pytest.raises(ValueError, match="1 x tensor"):
        tserve.serve(cfg, None, port=0, device="cpu")
    det = Detector.from_config(_tiny(tconfig), device="cpu")
    with pytest.raises(ValueError, match="1 x tensor"):
        tserve.DetectionService(det, {}, mesh=tmesh.DataMesh(1, 0, None, spatial=2))
