"""The port's serving export (utils/export.py) against the JAX package's
direct programs, at the tiny size of tests/test_export.py (yolo11n, width
0.25, reg_max 8, T=2, 64x64, 2 classes, fp32, CPU), weights moved by
``convert.params_from_jax``.

- ``export_serving`` -> ``load_serving(...).call`` and ``export_streaming``
  (init, then step, then step, the state carried) against the JAX
  package's jitted ``build_serving_fn`` / ``build_streaming_fns`` on the
  same seeded frames: scores within 1e-5 and boxes within 1e-3 absolute,
  as tests/test_export.py holds JAX's own round trip. Both sides run the
  same fp32 math; XLA and PyTorch sum convs in another order.
- the loaded programs against the port's eager modules: bit for bit (the
  program runs the same operators on the same inputs).
- NMS's export-time form (a ``while_loop``) against the eager matrix path
  on seeded pools, one a chain of suppressions that takes many sweeps to
  its fixed point: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from snn_object_detectionddp_tpu import config as jconfig
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector
from snn_object_detectionddp_tpu.utils import export as jexport
from snn_object_detectionddp_tpu_torch import config as tconfig
from snn_object_detectionddp_tpu_torch.convert import params_from_jax
from snn_object_detectionddp_tpu_torch.models.detector import Detector as TDetector
from snn_object_detectionddp_tpu_torch.ops import nms as tnms
from snn_object_detectionddp_tpu_torch.utils import export as texport
from snn_object_detectionddp_tpu_torch.utils import profiling

SCORE_ATOL, BOX_ATOL = 1e-5, 1e-3
STATE_ATOL = 1e-4  # membranes and the ConvLSTM's (h, c), fp32
STREAM_MAX_DET = 8


def _tiny(mod):
    cfg = mod.Config()
    cfg.model.num_classes = 2
    cfg.model.yolo_model_name = "yolo11n.pt"
    cfg.model.width_mult = 0.25
    cfg.model.hyp.reg_max = 8
    cfg.model.timesteps = 2
    cfg.model.image_size = (64, 64)
    cfg.runtime.precision = "f32"
    return cfg


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """Both detectors on the JAX package's initial weights, the port's three
    programs exported, saved and loaded back, and seeded frames."""
    jdet = JDetector.from_config(_tiny(jconfig))
    # jdet.init_params(PRNGKey(0)), jitted: the same values in a quarter of the eager time
    sample = jnp.zeros((1, 1, 64, 64, 3), jnp.float32)
    jparams = jax.jit(lambda r: jdet.module.init(r, sample)["params"])(jax.random.PRNGKey(0))
    tdet = TDetector.from_config(_tiny(tconfig), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    out = tmp_path_factory.mktemp("export")
    profiling.reset()
    profiling.enable()  # spans on: export must trace none of them
    try:
        batch_path = texport.export_serving(tdet, tparams, out / "model.pt2", batch=1, conf=0.0)
        init_path, step_path = texport.export_streaming(
            tdet, tparams, out / "init.pt2", out / "step.pt2", batch=1, conf=0.0,
            max_det=STREAM_MAX_DET)
    finally:
        profiling.disable()
    spans_while_exporting = profiling.spans()
    profiling.reset()
    rng = np.random.RandomState(0)
    return dict(
        jdet=jdet, jparams=jparams, tdet=tdet, tparams=tparams,
        batch=texport.load_serving(batch_path), init=texport.load_serving(init_path),
        step=texport.load_serving(step_path), spans_while_exporting=spans_while_exporting,
        clip=rng.randint(0, 255, size=(1, 2, 64, 64, 3), dtype=np.uint8),
        frames=[rng.randint(0, 255, size=(1, 64, 64, 3), dtype=np.uint8) for _ in range(3)],
    )


def _close_to_jax(got: dict, ref: dict, what: str):
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(ref["scores"]),
                               atol=SCORE_ATOL, err_msg=f"{what} scores")
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(ref["boxes"]),
                               atol=BOX_ATOL, err_msg=f"{what} boxes")
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(ref["classes"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))


def _bitwise(got, ref, what: str):
    got_leaves, got_spec = tree_flatten(got)
    ref_leaves, ref_spec = tree_flatten(ref)
    assert got_spec == ref_spec, what
    for i, (g, r) in enumerate(zip(got_leaves, ref_leaves)):
        assert g.dtype == r.dtype and torch.equal(g, r), f"{what}: leaf {i} differs"


def test_serving_program_round_trip_matches_jax_and_the_eager_program(programs):
    p = programs
    got = p["batch"].call(p["clip"])
    ref = jexport.build_serving_fn(p["jdet"], p["jparams"], conf=0.0)(jnp.asarray(p["clip"]))
    _close_to_jax(got, ref, "serving")
    eager = texport.build_serving_fn(p["tdet"], p["tparams"], conf=0.0)
    with torch.no_grad():
        _bitwise(got, eager(torch.from_numpy(p["clip"])), "serving vs eager")
    assert got["valid"].any()


def test_streaming_pair_round_trip_carries_the_state(programs):
    """init, step, step through the loaded programs, the state each
    returns fed to the next, against JAX's jitted pair and the port's
    eager pair on the same frames (detections and carried state)."""
    p = programs
    j_init, j_step = jexport.build_streaming_fns(p["jdet"], p["jparams"], conf=0.0,
                                                 max_det=STREAM_MAX_DET)
    e_init, e_step = texport.build_streaming_fns(p["tdet"], p["tparams"], conf=0.0,
                                                 max_det=STREAM_MAX_DET)
    got_state = j_state = e_state = None
    for i, frame in enumerate(p["frames"]):
        if i == 0:
            got, got_state = p["init"].call(frame)
            ref, j_state = j_init(jnp.asarray(frame))
            with torch.no_grad():
                eager, e_state_new = e_init(torch.from_numpy(frame))
        else:
            got, got_state = p["step"].call(frame, got_state)
            ref, j_state = j_step(jnp.asarray(frame), j_state)
            with torch.no_grad():
                eager, e_state_new = e_step(torch.from_numpy(frame), e_state)
        e_state = e_state_new
        _close_to_jax(got, ref, f"frame {i}")
        _bitwise((got, got_state), (eager, e_state), f"frame {i} vs eager")
    # the carried state itself against JAX's, leaf by leaf (same tree)
    leaves_j = jax.tree.leaves(j_state)
    leaves_t = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), got_state))
    assert len(leaves_j) == len(leaves_t)
    for lj, lt in zip(leaves_j, leaves_t):
        np.testing.assert_allclose(lt, np.asarray(lj), atol=STATE_ATOL)


def _chain_pool(k):
    """Boxes 10 px wide, each 4 px right of the last, scores falling: each
    suppresses its neighbour (IoU 0.43) but not the next one (0.11), so
    keep alternates along the chain and the fixed point takes about k / 2
    sweeps."""
    x0 = 4.0 * np.arange(k, dtype=np.float32)
    boxes = np.stack([x0, np.zeros(k), x0 + 10.0, np.full(k, 10.0)], -1).astype(np.float32)
    scores = np.linspace(0.9, 0.5, k, dtype=np.float32)[:, None]
    return boxes, np.concatenate([scores, 0.1 * scores], -1)


class _NMS(torch.nn.Module):
    def forward(self, boxes, scores):
        return tnms.batched_nms(boxes, scores, conf_thres=0.2, iou_thres=0.4, max_det=40)


def test_spans_are_no_ops_while_exporting(programs):
    """The three exports ran with tracing on: no span was recorded while
    ``torch.export`` traced, and no program holds a profiler operator."""
    assert programs["spans_while_exporting"] == []
    for name in ("batch", "init", "step"):
        graph = str(programs[name].exported.graph)
        assert "record_function" not in graph and "profiler" not in graph, name


def test_nms_export_form_equals_the_eager_fixed_point():
    rng = np.random.RandomState(3)
    k = 60
    centers = rng.uniform(10, 90, size=(6, 2))
    c = centers[rng.randint(0, 6, size=k)] + rng.randn(k, 2) * 4
    wh = rng.uniform(6, 30, size=(k, 2))
    clustered = (np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32),
                 rng.uniform(0, 1, size=(k, 2)).astype(np.float32))
    chain = _chain_pool(k)
    boxes = torch.from_numpy(np.stack([clustered[0], chain[0]]))
    scores = torch.from_numpy(np.stack([clustered[1], chain[1]]))
    program = torch.export.export(_NMS(), (boxes, scores), strict=False)
    assert any("while_loop" in str(n.target) for n in program.graph.nodes)
    got = program.module()(boxes, scores)
    ref = _NMS()(boxes, scores)
    _bitwise(got, ref, "nms")
    # the chain keeps every other box: the loop ran to the true fixed point
    kept = got["valid"][1].sum().item()
    assert kept == k // 2 and got["scores"][1, :kept].tolist() == chain[1][::2, 0].tolist()
