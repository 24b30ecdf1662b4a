"""FSDP of the port (parallel/mesh.py part (c), ``make_step_fns(...,
fsdp=True)``) on the CPU over gloo.

One module-scoped run of 2 worker processes (this file is also the worker:
``python tests/test_torch_fsdp.py rank world port outfile``) at the tiny
fp32 size of tests/test_torch_parallel.py (yolo11n, width 0.25, 64x64,
T=2, a global batch of 4: 2 a process), each keeping half of every
parameter and moment. Held against:

- the port's one-process step on the concatenated batch: loss, components
  and ``grad_norm`` rtol 1e-6; first moments rtol 1e-5 with an atol of
  1e-5 of the leaf's largest entry, and parameters per leaf within 5e-3 of
  the step in L2 norm, as tests/test_torch_parallel.py holds the
  data-parallel step (the processes sum the batch in two halves: fp32
  reassociation, and Adam's first step is sign-like where a gradient sits
  at the rounding floor: a single element then moves by up to 3e-4 of
  itself, which no elementwise tolerance of 1e-6 admits). The same for
  ``grad_accum=2``, a frozen backbone
  (its leaves bit-equal to where they started) and the parameter groups;
- the JAX package's ``make_step_fns(mesh=make_mesh(2), fsdp=True)`` on 2
  of the 8 virtual CPU devices: loss rtol 2e-4, grad_norm rtol 2e-2,
  parameters atol 3e-3 (tests/test_fsdp.py's tolerances);
- the state a rank keeps: at most half of the parameters and moments plus
  the padding of each leaf to an even length;
- a checkpoint round trip: the gathered state written as ``latest.pt``,
  read by every rank into its chunks (equal to the chunks it had), a
  second FSDP step from there against one process resuming the same file;
- ``main.train_code`` with ``mesh.fsdp: true`` over the two processes on
  a DSEC-shaped tree: an epoch of sharded steps, and rank 0's
  ``latest.pt`` / ``best.pt`` in the unsharded format; and on one process
  (no group: the collectives are copies), bit for bit the plain run.

A knife-edge spike between a batch of 4 and its halves is avoided by
redrawing the batch (tests/test_torch_parallel.py::_flip_free_batch).
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

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
LR, TOTAL = 1e-3, 100
B_LOCAL = 2


def _tiny(mod):
    cfg = mod.Config()
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.runtime.precision = "f32"
    return cfg


def _rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def _cat(*batches):
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def _accum_order(batch):
    """The one-process batch whose ``grad_accum=2`` microbatches are the
    processes' microbatches side by side."""
    half = B_LOCAL // 2
    local = [_rows(batch, r * B_LOCAL, (r + 1) * B_LOCAL) for r in range(WORLD)]
    return _cat(*[_rows(local[r], i * half, (i + 1) * half) for i in range(2) for r in range(WORLD)])


def _optimizer(tstep, kind, det):
    """(tx, schedule) of one optimizer case."""
    if kind == "frozen":
        return tstep.make_optimizer(LR, TOTAL, frozen_mask=tstep.module_frozen_mask("backbone"))
    if kind == "groups":
        from snn_object_detectionddp_tpu_torch.train.param_groups import make_grouped_optimizer

        return make_grouped_optimizer(dict(det.module.named_parameters()), LR, TOTAL)
    return tstep.make_optimizer(LR, TOTAL)


CASES = ("step", "accum", "frozen", "groups")


def _cli_cfg(mod, root: Path, save_dir: Path):
    """tests/test_torch_cli.py's tiny command-line config (48x64, T=2, a
    global batch of 2) with ``mesh.fsdp: true``."""
    cfg = _tiny(mod)
    cfg.model.image_size, cfg.model.max_boxes = (48, 64), 8
    for split in ("train", "val", "test"):
        sc = cfg.dataset.split(split)
        sc.path, sc.seq_len = str(root / "train"), 2
    cfg.training.batch_size, cfg.training.num_workers, cfg.training.epochs = 2, 1, 1
    cfg.training.save_dir = str(save_dir)
    cfg.mesh.fsdp = True
    return cfg


def _summary(metrics, whole) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": whole["params"], "mu": whole["opt_state"]["mu"]}


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def worker(rank: int, world: int, port: int, outfile: str) -> None:
    torch.set_num_threads(1)
    from snn_object_detectionddp_tpu_torch import config as tconfig
    from snn_object_detectionddp_tpu_torch.convert import params_from_jax
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pmesh
    from snn_object_detectionddp_tpu_torch.train import step as tstep
    from snn_object_detectionddp_tpu_torch.train.checkpoint import resume_or_init, save_checkpoint

    tmp = Path(outfile).parent
    inputs = pickle.loads((tmp / "inputs.pkl").read_bytes())
    pmesh.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    mesh = pmesh.make_mesh()
    cfg = _tiny(tconfig)
    det = Detector.from_config(cfg, device="cpu")
    params = params_from_jax(inputs["jparams"], "cpu")
    mine = lambda batch: _rows(batch, rank * B_LOCAL, (rank + 1) * B_LOCAL)  # noqa: E731
    fresh = lambda tx, sched: tstep.init_state({k: v.clone() for k, v in params.items()},  # noqa: E731
                                               tx, sched)
    out = {"rank": rank}
    for kind in CASES:
        tx, sched = _optimizer(tstep, kind, det)
        fns = tstep.make_step_fns(det, tx, sched, mesh=mesh, fsdp=True,
                                  grad_accum=2 if kind == "accum" else 1)
        state = fns.shard_state(fresh(tx, sched))
        if kind == "step":
            out["kept"] = sum(t.numel() * t.element_size() for part in (
                state["params"], state["opt_state"]["mu"], state["opt_state"]["nu"])
                for t in part.values())
            out["chunk_shapes"] = {k: tuple(v.shape) for k, v in state["params"].items()}
        state, metrics = fns.train_step(state, mine(inputs["batch"]))
        whole = fns.gather_state(state)
        out[kind] = _summary(metrics, whole)
        if kind != "step":
            continue
        # The checkpoint round trip: rank 0 writes the whole state, every
        # rank reads it back into its chunks and takes a second step.
        if rank == 0:
            save_checkpoint(tmp / "latest.pt", whole, 0, 1.0)
        torch.distributed.barrier()
        cfg.training.resume_training, cfg.training.weights_path = True, str(tmp / "latest.pt")
        template = tstep.init_state(dict(det.module.named_parameters()), tx, sched)
        resumed, epoch, _ = resume_or_init(cfg, template, device="cpu", place=fns.shard_state)
        out["resumed_equal"] = epoch == 1 and resumed["step"] == 1 and all(
            torch.equal(resumed[part][k] if part == "params" else resumed["opt_state"][part][k],
                        state[part][k] if part == "params" else state["opt_state"][part][k])
            for part in ("params", "mu", "nu") for k in state["params"])
        resumed, metrics = fns.train_step(resumed, mine(inputs["batch2"]))
        out["resume"] = _summary(metrics, fns.gather_state(resumed))

    from snn_object_detectionddp_tpu_torch import main

    cli = _cli_cfg(tconfig, Path(inputs["tree"]), tmp / "cli_run")
    state = main.train_code(cli, Detector.from_config(cli, device="cpu"))
    out["cli"] = {"step": state["step"],
                  "flat": all(v.ndim == 1 for v in state["params"].values())}
    torch.save(out, outfile)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The tests (JAX on the CPU; imported only here, never by the worker)
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from snn_object_detectionddp_tpu import config as jconfig  # noqa: E402
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector  # noqa: E402
from snn_object_detectionddp_tpu.parallel import mesh as jmesh  # noqa: E402
from snn_object_detectionddp_tpu.train import step as jstep  # noqa: E402
from snn_object_detectionddp_tpu_torch import config as tconfig  # noqa: E402
from snn_object_detectionddp_tpu_torch.convert import params_from_jax  # noqa: E402
from snn_object_detectionddp_tpu_torch.models.detector import Detector  # noqa: E402
from snn_object_detectionddp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from snn_object_detectionddp_tpu_torch.train import step as tstep  # noqa: E402
from snn_object_detectionddp_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402
from tests.test_torch_parallel import (  # noqa: E402
    MAX_BATCH_DRAWS,
    _batch,
    _free_port,
    _one_thread,
    _spikes,
)


def _flip_free_batch(det, params, first_seed: int):
    """The first batch from ``first_seed`` on whose spikes at B=4 equal
    those of its halves (tests/test_torch_parallel.py::_flip_free_batch)."""
    for seed in range(first_seed, first_seed + MAX_BATCH_DRAWS):
        batch = _batch(seed)
        whole = _spikes(det, params, batch["images"])
        halves = [_spikes(det, params, batch["images"][r * B_LOCAL:(r + 1) * B_LOCAL])
                  for r in range(WORLD)]
        if all(torch.equal(w, torch.cat([h[i] for h in halves], dim=1))
               for i, w in enumerate(whole)):
            return batch
    raise AssertionError(f"every one of {MAX_BATCH_DRAWS} batches had a spike flip")


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    """Spawn the workers, compute the references while they run, collect."""
    tmp = tmp_path_factory.mktemp("fsdp")
    jdet = JDetector.from_config(_tiny(jconfig))
    jparams = jdet.init_params(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tdet = Detector.from_config(_tiny(tconfig), device="cpu")
    tparams = params_from_jax(np_params, "cpu")
    with _one_thread():
        batch = _flip_free_batch(tdet, tparams, 0)
        batch2 = _flip_free_batch(tdet, tparams, 10)
    from snn_object_detectionddp_tpu_torch.data.synthetic import make_dataset

    # 3 sequences x 5 frames, seq_len 2: 8 training windows, 4 a process
    tree = make_dataset(tmp / "dsec", num_sequences=3, splits=("train",), num_frames=5,
                        height=48, width=64)
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(
        {"jparams": np_params, "batch": batch, "batch2": batch2, "tree": str(tree)}))

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(port), str(o)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r, o in enumerate(outs)]
    try:
        ref = {"before": tparams}
        with _one_thread():
            for kind in CASES:
                tx, sched = _optimizer(tstep, kind, tdet)
                fns = tstep.make_step_fns(tdet, tx, sched, grad_accum=2 if kind == "accum" else 1)
                state = tstep.init_state({k: v.clone() for k, v in tparams.items()}, tx, sched)
                state, metrics = fns.train_step(state, _accum_order(batch) if kind == "accum"
                                                else batch)
                ref[kind] = _summary(metrics, state)
        jtx, jsched = jstep.make_optimizer(LR, TOTAL)
        jm = jmesh.make_mesh(WORLD, devices=jax.devices()[:WORLD])
        jfns = jstep.make_step_fns(jdet, jtx, jsched, mesh=jm, fsdp=True)
        jstate = jstep.init_state(jparams, jtx, jsched)
        jstate = jmesh.place_state(jstate, jmesh.state_shardings(jm, jstate, fsdp=True))
        jstate, jmetrics = jfns.train_step(jstate, jmesh.shard_batch(batch, jm))
        ref["jax"] = {"metrics": {k: float(v) for k, v in jmetrics.items()},
                      "params": params_from_jax(jax.tree.map(np.asarray,
                                                             jax.device_get(jstate["params"])),
                                                "cpu")}
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log}"
    outs = [torch.load(o, weights_only=False) for o in outs]
    # One process resumes the FSDP checkpoint and takes the second step.
    tx, sched = tstep.make_optimizer(LR, TOTAL)
    template = tstep.init_state(dict(tdet.module.named_parameters()), tx, sched)
    packed = load_checkpoint(tmp / "latest.pt", template, device="cpu")
    with _one_thread():
        state, metrics = tstep.make_step_fns(tdet, tx, sched).train_step(packed["state"], batch2)
    ref["resume"] = _summary(metrics, state)
    ref["latest"] = torch.load(tmp / "latest.pt", weights_only=True)["state"]
    ref["cli"] = {name: torch.load(tmp / "cli_run" / name, weights_only=True)
                  for name in ("latest.pt", "best.pt")}
    ref["tree"] = tree
    return outs, ref


def _close_step(got: dict, want: dict, before: dict, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        err, step = float((got[k] - w).double().norm()), float((w - before[k]).double().norm())
        assert err <= 5e-3 * step or err == 0.0, (
            f"{what} {k}: L2 error {err:.3g} > 5e-3 of its step {step:.3g}")


def _close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        atol = 1e-5 * float(w.abs().max())
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=atol, msg=lambda m: f"{what} {k}: {m}")


def test_workers_agree(fsdp):
    outs, _ = fsdp
    a, b = outs
    for kind in CASES + ("resume",):
        assert a[kind]["metrics"] == b[kind]["metrics"], kind
        for part in ("params", "mu"):
            assert all(torch.equal(a[kind][part][k], v) for k, v in b[kind][part].items()), (
                kind, part)


@pytest.mark.parametrize("kind", CASES)
def test_fsdp_step_matches_one_process_on_the_concatenated_batch(fsdp, kind):
    outs, ref = fsdp
    got, want = outs[0][kind], ref[kind]
    for k in ("loss", "box", "cls", "dfl", "fg", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-6, err_msg=k)
    assert got["metrics"]["lr"] == want["metrics"]["lr"] and want["metrics"]["fg"] > 0
    _close(got["mu"], want["mu"], f"{kind} first moment")
    _close_step(got["params"], want["params"], ref["before"], f"{kind} parameter")
    if kind == "frozen":
        for k, v in ref["before"].items():
            if k.startswith("backbone."):
                assert torch.equal(got["params"][k], v), k
                assert not got["mu"][k].any(), k


def test_fsdp_step_matches_the_jax_fsdp_step(fsdp):
    outs, ref = fsdp
    got, want = outs[0]["step"], ref["jax"]
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=2e-4)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                               rtol=2e-2)
    assert set(got["params"]) == set(want["params"])
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(), atol=3e-3, err_msg=k)


def test_each_rank_keeps_half_of_the_state(fsdp):
    """Parameters, mu and nu: every leaf flattened into chunks of
    ceil(n / 2), so a rank keeps at most half of the state plus one
    padding element per leaf and tree."""
    outs, ref = fsdp
    total = 3 * 4 * sum(v.numel() for v in ref["before"].values())
    n_leaves = len(ref["before"])
    for o in outs:
        assert o["kept"] <= total / 2 + 3 * 4 * n_leaves, (o["kept"], total)
        assert o["kept"] >= total / 2
        assert o["chunk_shapes"] == {k: (-(-v.numel() // WORLD),)
                                     for k, v in ref["before"].items()}
    layout = tmesh.shard_layout(ref["before"], WORLD)
    assert 3 * 4 * sum(layout.chunks) == outs[0]["kept"]


def test_checkpoint_round_trip(fsdp):
    """The FSDP run's ``latest.pt`` is the whole state (the format of an
    unsharded run); the ranks read it back into the chunks they had; a
    second FSDP step from it matches one process resuming the file."""
    outs, ref = fsdp
    latest = ref["latest"]
    for k, v in outs[0]["step"]["params"].items():
        assert torch.equal(latest["params"][k], v), k
        assert tuple(latest["params"][k].shape) == tuple(ref["before"][k].shape)
    assert latest["step"] == 1 and latest["opt_state"]["count"] == 1
    assert all(o["resumed_equal"] for o in outs)
    got, want = outs[0]["resume"], ref["resume"]
    for k in ("loss", "box", "cls", "dfl", "fg", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-6, err_msg=k)
    _close(got["mu"], want["mu"], "resumed first moment")
    _close_step(got["params"], want["params"], latest["params"], "resumed parameter")


def test_main_trains_an_fsdp_epoch_over_two_processes(fsdp):
    """``main.train_code`` with ``mesh.fsdp: true``: each process takes 4
    steps of its half of the 8 windows on flat chunks, and rank 0 writes
    checkpoints with every leaf whole."""
    outs, ref = fsdp
    assert [o["cli"] for o in outs] == [{"step": 4, "flat": True}] * WORLD
    for name, ckpt in ref["cli"].items():
        state = ckpt["state"]
        assert ckpt["epoch"] == 0 and state["step"] == 4, name
        for part in (state["params"], state["opt_state"]["mu"], state["opt_state"]["nu"]):
            assert {k: tuple(v.shape) for k, v in part.items()} == {
                k: tuple(v.shape) for k, v in ref["before"].items()}, name
        assert all(torch.isfinite(v).all() for v in state["params"].values())


def test_fsdp_trains_through_the_command_line_on_one_process(fsdp, tmp_path):
    """``mesh.fsdp: true`` on one process: a mesh of one whose collectives
    are copies. The state is kept as flat chunks, the checkpoints hold the
    whole state, and the epoch ends where the plain one does, bit for
    bit."""
    from snn_object_detectionddp_tpu_torch import main

    _, ref = fsdp
    runs = {}
    for name, on in (("plain", False), ("fsdp", True)):
        cfg = _cli_cfg(tconfig, Path(ref["tree"]), tmp_path / name)
        cfg.mesh.fsdp = on
        runs[name] = main.train_code(cfg, Detector.from_config(cfg, device="cpu"))
    assert runs["fsdp"]["step"] == 4
    assert all(v.ndim == 1 for v in runs["fsdp"]["params"].values())
    latest = torch.load(tmp_path / "fsdp" / "latest.pt", weights_only=True)["state"]
    plain = runs["plain"]
    for part in ("params", "mu", "nu"):
        want = plain["params"] if part == "params" else plain["opt_state"][part]
        got = latest["params"] if part == "params" else latest["opt_state"][part]
        for k, v in want.items():
            assert torch.equal(got[k], v), (part, k)


def test_shard_and_gather_in_one_process():
    """Without a process group the layout's collectives are copies: a
    state sharded over a world of 1 gathers back bit for bit, and the
    reduce-scatter of a gradient is the gradient."""
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, 3, 3, generator=gen), "b": torch.randn(5, generator=gen),
              "s": torch.randn(7, 1, generator=gen)}
    tx = tstep.Optimizer()
    state = tstep.init_state(params, tx)
    layout = tmesh.shard_layout(params, 1)
    mesh = tmesh.make_mesh()
    sharded = tmesh.shard_state(state, layout, 0)
    assert all(v.ndim == 1 for v in sharded["params"].values())
    base = sharded["params"]["w"].data_ptr()
    assert all((v.data_ptr() - base) % (4 * tmesh.SEGMENT_ALIGN) == 0
               for v in sharded["params"].values())
    whole = tmesh.gather_state(sharded, layout, mesh)
    for k, v in params.items():
        assert torch.equal(whole["params"][k], v)
    grads = tmesh.reduce_scatter_grads(params, layout, mesh)
    for k, v in params.items():
        assert torch.equal(grads[k], v.reshape(-1))


@pytest.mark.parametrize("world", [2, 3, 5])
def test_layout_pads_every_leaf_to_a_multiple_of_the_world(world):
    """Rank r's chunks concatenated over the ranks are each leaf, padded
    with zeros; the segments of a local buffer start at multiples of
    SEGMENT_ALIGN."""
    gen = torch.Generator().manual_seed(world)
    params = {"a": torch.randn(4, 3, 3, 3, generator=gen), "b": torch.randn(5, generator=gen),
              "c": torch.randn(1, generator=gen)}
    layout = tmesh.shard_layout(params, world)
    chunks = [tmesh.shard_tree(params, layout, r) for r in range(world)]
    for i, (k, v) in enumerate(params.items()):
        assert layout.offsets[i] % tmesh.SEGMENT_ALIGN == 0
        joined = torch.cat([c[k] for c in chunks])
        assert joined.numel() == world * -(-v.numel() // world)
        assert torch.equal(joined[: v.numel()], v.reshape(-1))
        assert not joined[v.numel():].any()
