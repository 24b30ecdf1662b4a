"""Data parallelism of the port (parallel/mesh.py) on the CPU over gloo.

The shard helpers against the JAX package's over many (n, world, rank),
then one module-scoped run of 2 worker processes (this file is also the
worker: ``python tests/test_torch_parallel.py rank world port outfile``)
at the tiny fp32 size of tests/test_torch_train.py (yolo11n, width 0.25,
64x64, T=2, a global batch of 4: 2 a process), held against:

- the port's one-process step on the concatenated batch: loss and
  components rtol 1e-6; gradients and first moments rtol 1e-5 with an
  atol of 1e-5 of the leaf's largest entry (the processes sum the batch
  in two halves, one process in one go: fp32 reassociation, whose
  absolute error follows the leaf's scale, not a cancelled element's:
  measured up to 2.2e-6 of it with accumulation); parameters after the
  step per leaf within 5e-3 of the step in L2 norm (the parameters before
  are equal; Adam's first step g / (|g| + eps) is sign-like, so an element
  whose gradient sits at the rounding floor carries its relative error
  into the step: measured up to 1.4e-5 of a leaf's step, 1.1e-3 with
  accumulation). The same for ``grad_accum=2`` (microbatch ``i`` is the
  ``i``-th local microbatch of both processes)
  and for the validation loss of a padded batch;
- the JAX package's shard_map step on a 2-device CPU mesh: loss and
  components rtol 1e-4, first moments by tests/test_torch_train.py's
  per-leaf gradient criterion (XLA and PyTorch sum convs in another
  order), and its pre-clip gradient norm, which reads WORLD times the
  port's (see the test);
- one-process ``evaluate_model``, EXACTLY, on an odd number of validation
  windows (the second process's share is partial).

A knife-edge spike (a membrane within rounding of the threshold) that
flips between a batch of 4 and its halves would make the two runs
different functions: such a batch is redrawn before the workers start.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
LR, TOTAL = 1e-3, 100
B_LOCAL = 2
MAX_BATCH_DRAWS = 5


def _tiny(mod, root=None):
    cfg = mod.Config()
    cfg.model.num_classes = 3
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.runtime.precision = "f32"
    if root is not None:  # the evaluation tree
        cfg.model.image_size = (48, 64)
        cfg.model.max_boxes = 8
        for split in ("train", "val", "test"):
            sc = cfg.dataset.split(split)
            sc.path, sc.seq_len = str(root / "train"), 3
        cfg.training.num_workers = 1
    return cfg


def _batch(seed, b=WORLD * B_LOCAL, t=2, h=64, w=64, m=4):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, size=(b, t, h, w, 3), dtype=np.uint8)
    labels = np.zeros((b, m, 5), np.float32)
    mask = np.zeros((b, m), bool)
    for i in range(b):
        cx, cy = rng.uniform(0.3, 0.7, 2)
        labels[i, 0] = [i % 3, cx, cy, 0.4, 0.4]
        labels[i, 1] = [(i + 1) % 3, 1 - cx, 1 - cy, 0.3, 0.5]
    mask[:, :2] = True
    return {"images": images, "labels": labels, "label_mask": mask,
            "sample_mask": np.ones((b,), bool)}


def _rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def _cat(*batches):
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


def _val_batch():
    """A padded validation batch: the last row is padding."""
    batch = _batch(99)
    batch["sample_mask"][-1] = False
    batch["label_mask"][-1] = False
    return batch


def _accum_order(batch):
    """The one-process batch whose ``grad_accum=2`` microbatches are the
    processes' microbatches side by side: micro i = (rank 0's i-th,
    rank 1's i-th)."""
    half = B_LOCAL // 2
    local = [_rows(batch, r * B_LOCAL, (r + 1) * B_LOCAL) for r in range(WORLD)]
    return _cat(*[_rows(local[r], i * half, (i + 1) * half) for i in range(2) for r in range(WORLD)])


def _eval_tree(root: Path) -> Path:
    """5 sequences x 5 frames at 48x64, seq_len 3: the split keeps one
    sequence (3 windows) for validation, split 2 + 1 over two processes."""
    from snn_object_detectionddp_tpu_torch.data.synthetic import make_dataset

    return make_dataset(root, num_sequences=5, splits=("train",), num_frames=5, height=48,
                        width=64)


@contextmanager
def _one_thread():
    """The workers run on one thread each; so do the references, so that
    no conv is blocked differently."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


def _step_outputs(fns, tstep, params, batch, tx, sched, with_grads=True):
    out = {}
    if with_grads:
        grads, lc = fns.grads(params, batch)
        out["grads"] = {k: v.clone() for k, v in grads.items()}
        out["grad_loss"] = {k: float(getattr(lc, k)) for k in ("total", "box", "cls", "dfl", "fg")}
    state = tstep.init_state({k: v.clone() for k, v in params.items()}, tx, sched)
    state, metrics = fns.train_step(state, batch)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["params"] = state["params"]
    out["mu"] = state["opt_state"]["mu"]
    return out


def worker(rank: int, world: int, port: int, outfile: str) -> None:
    torch.set_num_threads(1)
    from snn_object_detectionddp_tpu_torch import config as tconfig
    from snn_object_detectionddp_tpu_torch.convert import params_from_jax
    from snn_object_detectionddp_tpu_torch.evals.validator import evaluate_model
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.parallel import mesh as pmesh
    from snn_object_detectionddp_tpu_torch.train import step as tstep

    inputs = pickle.loads((Path(outfile).parent / "inputs.pkl").read_bytes())
    pmesh.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    pmesh.collective_barrier("cpu")
    mesh = pmesh.make_mesh()
    assert (mesh.size, mesh.rank) == (world, rank)
    out = {"rank": rank, "main": pmesh.is_main_process()}
    gen = torch.Generator().manual_seed(0)  # the same gradients on every process
    grads = {"w": torch.randn(4, 3, 2, 2, generator=gen).to(memory_format=torch.channels_last),
             "b": torch.randn(5, generator=gen), "t": torch.randn(3, 6, generator=gen).t()}
    summed = pmesh.all_reduce_grads(grads, mesh)
    out["layout"] = {k: (summed[k].stride() == g.stride(), torch.equal(summed[k], world * g))
                     for k, g in grads.items()}

    det = Detector.from_config(_tiny(tconfig), device="cpu")
    params = params_from_jax(inputs["jparams"], "cpu")
    tx, sched = tstep.make_optimizer(LR, TOTAL)
    fns = tstep.make_step_fns(det, tx, sched, mesh=mesh)
    mine = lambda batch: _rows(batch, rank * B_LOCAL, (rank + 1) * B_LOCAL)  # noqa: E731
    out["step"] = _step_outputs(fns, tstep, params, mine(inputs["batch"]), tx, sched)
    accum = tstep.make_step_fns(det, tx, sched, grad_accum=2, mesh=mesh)
    out["accum"] = _step_outputs(accum, tstep, params, mine(inputs["batch"]), tx, sched,
                                 with_grads=False)
    out["val"] = {k: float(v) for k, v in fns.eval_step(params, mine(_val_batch())).items()}

    root = Path(inputs["eval_root"])
    cfg = _tiny(tconfig, root)
    edet = Detector.from_config(cfg, device="cpu")
    eparams = edet.init_params(torch.Generator().manual_seed(0))
    out["eval"] = evaluate_model(cfg, edet, eparams, batch_size=WORLD * B_LOCAL, mesh=mesh)
    torch.save(out, outfile)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The tests (JAX on the CPU; imported only here, never by the worker)
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snn_object_detectionddp_tpu import config as jconfig  # noqa: E402
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector  # noqa: E402
from snn_object_detectionddp_tpu.parallel import mesh as jmesh  # noqa: E402
from snn_object_detectionddp_tpu.train import step as jstep  # noqa: E402
from snn_object_detectionddp_tpu_torch import config as tconfig  # noqa: E402
from snn_object_detectionddp_tpu_torch.convert import params_from_jax  # noqa: E402
from snn_object_detectionddp_tpu_torch.evals.validator import evaluate_model  # noqa: E402
from snn_object_detectionddp_tpu_torch.models.detector import Detector  # noqa: E402
from snn_object_detectionddp_tpu_torch.models.layers import SpikingConvBlock  # noqa: E402
from snn_object_detectionddp_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from snn_object_detectionddp_tpu_torch.train import step as tstep  # noqa: E402


@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
def test_shard_helpers_match_jax(world, monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: world)
    for n in (0, 1, 2, 3, 5, 8, 9, 10, 16, 17):
        indices = [3 * i + 1 for i in range(n)]
        for rank in range(world):
            monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
            assert tmesh.host_shard_indices(indices, world, rank) == jmesh.host_shard_indices(
                indices), (n, world, rank)
        # The unpadded evaluation shares cover the list once, in order.
        shares = [tmesh.eval_shard(indices, tmesh.DataMesh(world, r, None))
                  for r in range(world)]
        assert [i for s in shares for i in s] == indices
    for bs in (1, 2, 3, 8, 12):
        assert tmesh.pad_batch_to_devices(bs, world) == jmesh.pad_batch_to_devices(bs, world)
        if bs % world:
            with pytest.raises(ValueError, match="not divisible"):
                tmesh.local_batch_size(bs, world)
            with pytest.raises(ValueError, match="not divisible"):
                jmesh.local_batch_size(bs)
        else:
            assert tmesh.local_batch_size(bs, world) == jmesh.local_batch_size(bs)


def test_one_process_mesh():
    """Without a process group: a mesh of one, every collective the
    identity, rank 0 the main process; a data axis beyond the world or
    short of it raises."""
    mesh = tmesh.make_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None) and tmesh.is_main_process()
    assert tmesh.host_shard_indices([4, 5]) == [4, 5]
    g = {"a": torch.randn(3, 2)}
    assert tmesh.all_reduce_grads(g, mesh) is g
    x = torch.tensor(2.0, requires_grad=True)
    (y,) = tmesh.global_sum([x], mesh)
    assert y is x
    with pytest.raises(ValueError, match="world size of 1"):
        tmesh.make_mesh(2)
    assert not tmesh.maybe_init_distributed(_tiny(tconfig), device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spikes(det, params, images):
    got = []
    hooks = [m.register_forward_hook(lambda mod, i, o: got.append(o[0].detach().clone()))
             for m in det.module.modules() if isinstance(m, SpikingConvBlock)]
    try:
        from snn_object_detectionddp_tpu_torch.data.encoding import preprocess_video

        det.apply(params, preprocess_video(torch.as_tensor(images), dtype=det.dtype))
    finally:
        for h in hooks:
            h.remove()
    return got


def _flip_free_batch(det, params):
    """The first batch whose spikes at B=4 equal those of its halves."""
    for seed in range(MAX_BATCH_DRAWS):
        batch = _batch(seed)
        whole = _spikes(det, params, batch["images"])
        halves = [_spikes(det, params, batch["images"][r * B_LOCAL:(r + 1) * B_LOCAL])
                  for r in range(WORLD)]
        flips = sum(int((w != torch.cat([h[i] for h in halves], dim=1)).sum())
                    for i, w in enumerate(whole))
        if flips == 0:
            return batch
        print(f"batch seed {seed}: {flips} spikes flip between B=4 and its halves; redrawing")
    raise AssertionError(f"every one of {MAX_BATCH_DRAWS} batches had a spike flip")


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Spawn the workers, compute the references while they run, collect."""
    tmp = tmp_path_factory.mktemp("dp")
    jcfg = _tiny(jconfig)
    jdet = JDetector.from_config(jcfg)
    jparams = jdet.init_params(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    tdet = Detector.from_config(_tiny(tconfig), device="cpu")
    tparams = params_from_jax(np_params, "cpu")
    with _one_thread():
        batch = _flip_free_batch(tdet, tparams)
    eval_root = _eval_tree(tmp / "dsec")
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(
        {"jparams": np_params, "batch": batch, "eval_root": str(eval_root)}))

    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(WORLD), str(port), str(o)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r, o in enumerate(outs)]
    try:
        # The references, while the workers run.
        ref = {"before": tparams}
        tx, sched = tstep.make_optimizer(LR, TOTAL)
        with _one_thread():
            fns = tstep.make_step_fns(tdet, tx, sched)
            ref["step"] = _step_outputs(fns, tstep, tparams, batch, tx, sched)
            accum = tstep.make_step_fns(tdet, tx, sched, grad_accum=2)
            ref["accum"] = _step_outputs(accum, tstep, tparams, _accum_order(batch), tx, sched,
                                         with_grads=False)
            ref["val"] = {k: float(v) for k, v in fns.eval_step(tparams, _val_batch()).items()}
            ecfg = _tiny(tconfig, eval_root)
            edet = Detector.from_config(ecfg, device="cpu")
            ref["eval"] = evaluate_model(ecfg, edet, edet.init_params(torch.Generator().manual_seed(0)),
                                         batch_size=B_LOCAL)
        jtx, jsched = jstep.make_optimizer(LR, TOTAL)
        jfns = jstep.make_step_fns(jdet, jtx, jsched,
                                   mesh=jmesh.make_mesh(WORLD, devices=jax.devices()[:WORLD]))
        jstate, jmetrics = jfns.train_step(jstep.init_state(jparams, jtx, jsched), batch)
        adam = [s for s in jax.tree.leaves(jstate["opt_state"], is_leaf=lambda n: hasattr(n, "mu"))
                if hasattr(s, "mu")][0]
        ref["jax"] = {"metrics": {k: float(v) for k, v in jmetrics.items()},
                      "mu": params_from_jax(jax.tree.map(np.asarray, adam.mu), "cpu")}
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log}"
    return [torch.load(o, weights_only=False) for o in outs], ref


def _close(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        atol = 1e-5 * float(w.abs().max())
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=atol, msg=lambda m: f"{what} {k}: {m}")


def _close_step(got: dict, want: dict, before: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        err, step = float((got[k] - w).double().norm()), float((w - before[k]).double().norm())
        assert err <= 5e-3 * step, f"parameter {k}: L2 error {err:.3g} > 5e-3 of its step {step:.3g}"


def test_workers_agree_and_only_rank_0_is_main(dp):
    outs, _ = dp
    assert [o["main"] for o in outs] == [True, False]
    a, b = outs
    assert a["step"]["metrics"] == b["step"]["metrics"] and a["val"] == b["val"]
    for part in ("grads", "params", "mu"):
        assert all(torch.equal(a["step"][part][k], v) for k, v in b["step"][part].items()), part
    assert a["eval"] == b["eval"]


def test_all_reduce_grads_sums_and_keeps_each_gradients_layout(dp):
    """The flat buffer's views keep each gradient's strides (a
    channels-last conv weight, a transposed matrix), so the clip's norm
    reads the memory it reads without a mesh."""
    outs, _ = dp
    for o in outs:
        assert o["layout"] == {"w": (True, True), "b": (True, True), "t": (True, True)}


@pytest.mark.parametrize("kind", ["step", "accum"])
def test_dp_step_matches_one_process_on_the_concatenated_batch(dp, kind):
    outs, ref = dp
    got, want = outs[0][kind], ref[kind]
    for k in ("loss", "box", "cls", "dfl", "fg", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-6, err_msg=k)
    assert got["metrics"]["lr"] == want["metrics"]["lr"] and want["metrics"]["fg"] > 0
    if kind == "step":
        for k, v in want["grad_loss"].items():
            np.testing.assert_allclose(got["grad_loss"][k], v, rtol=1e-6, err_msg=k)
        _close(got["grads"], want["grads"], "gradient")
    _close(got["mu"], want["mu"], "first moment")
    _close_step(got["params"], want["params"], ref["before"])


def test_dp_validation_loss_of_a_padded_batch(dp):
    outs, ref = dp
    for k in ("loss", "box", "cls", "dfl", "fg"):
        np.testing.assert_allclose(outs[0]["val"][k], ref["val"][k], rtol=1e-6, err_msg=k)


def test_dp_step_matches_the_jax_shard_map_step(dp):
    """Two gloo processes against the JAX package's data-parallel step on
    a 2-device mesh: loss rtol 1e-4; first moments (linear in the clipped
    gradient) per leaf within 2e-3 of the leaf's norm plus 1e-4 of the
    global norm, as tests/test_torch_train.py holds gradients.

    The JAX step's gradient is WORLD times the global one before its clip:
    it differentiates through the psum of its loss normalisers under
    ``check_vma=False``, whose transpose all-reduces the cotangent, then
    psums the gradients again. Its ``grad_norm`` reads WORLD times the
    port's, and the clip to norm 10 removes the factor when the norm
    exceeds 10, as it does here, so the moments agree."""
    outs, ref = dp
    got, want = outs[0]["step"], ref["jax"]
    for k in ("loss", "box", "cls", "dfl"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-4, err_msg=k)
    assert got["metrics"]["fg"] == want["metrics"]["fg"] > 0
    assert got["metrics"]["grad_norm"] > 10.0  # the clip is active on both sides
    np.testing.assert_allclose(WORLD * got["metrics"]["grad_norm"], want["metrics"]["grad_norm"],
                               rtol=1e-3)
    total = float(torch.sqrt(sum(m.double().pow(2).sum() for m in want["mu"].values())))
    for k, w in want["mu"].items():
        err = float((got["mu"][k] - w).double().norm())
        allowed = 2e-3 * float(w.double().norm()) + 1e-4 * total
        assert err <= allowed, f"mu {k}: err {err:.3g} > {allowed:.3g}"


def test_two_process_evaluation_equals_one_process_exactly(dp):
    outs, ref = dp
    assert outs[0]["eval"] == ref["eval"]
    assert set(ref["eval"]) == {"metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                                "metrics/mAP50-95(B)", "fitness"}
