"""The fixture gate: the committed nano checkpoint (fixtures/hard_nano_ckpt.pt,
trained by scripts/hard_nano.yaml) evaluated on its regenerated hard
fixture through the port's ``evaluate_model`` (the DSEC index, the seeded
split, the loader and the PNG reader of the port), against the JAX
package's ``evaluate_model`` on the same tree.

The comparison runs both sides in fp32, where they compute the same
function up to conv summation order (~1e-6 relative, which can swap
detections of nearly equal score): mAP50, mAP50-95, precision, recall and
fitness within ``RESULT_ATOL`` = 5e-3. The yaml's own bf16 runs on both
sides too, and the port's numbers are printed beside JAX's with their
difference, not held: the port rounds where the jitted JAX package rounds
(models/layers.py), and mAP50, mAP50-95, recall and fitness land within
5e-3, but precision (read at the max-F1 threshold) is ~1.1e-2 apart. The
residual starts at the U-Net's ConvLSTM, whose fp32 gate math uses XLA's
tanh/logistic on one side and PyTorch's on the other; bf16 roundings after
it amplify those ulps.
"""

import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
from flax import serialization

from snn_object_detectionddp_tpu.config import load_config as jax_load_config
from snn_object_detectionddp_tpu.evals import validator as jval
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector
from snn_object_detectionddp_tpu_torch.config import load_config
from snn_object_detectionddp_tpu_torch.convert import load_flax_params, params_from_jax
from snn_object_detectionddp_tpu_torch.evals import validator as tval
from snn_object_detectionddp_tpu_torch.models.detector import Detector

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "fixtures/hard_nano_ckpt.pt"
RECORDED = {"metrics/mAP50(B)": 0.4144, "metrics/mAP50-95(B)": 0.1987}  # BENCH_r05.json
RESULT_ATOL = 5e-3


def _cfg(load, root, precision):
    cfg = load(REPO / "scripts/hard_nano.yaml")
    cfg.runtime.precision = precision
    for split in ("train", "val", "test"):
        sc = cfg.dataset.split(split)
        sc.path = sc.path.replace("fixtures/hard_nano", str(root))
    return cfg


def test_fixture_gate(tmp_path):
    t0 = time.perf_counter()
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from make_hard_fixture import make_hard_nano
    finally:
        sys.path.remove(str(REPO / "scripts"))
    root = make_hard_nano(tmp_path / "hard_nano")

    tparams = params_from_jax(load_flax_params(CKPT), "cpu")
    port = {}
    for precision in ("f32", "bf16"):
        cfg = _cfg(load_config, root, precision)
        port[precision] = tval.evaluate_model(cfg, Detector.from_config(cfg, device="cpu"),
                                              tparams, batch_size=16)

    raw = serialization.msgpack_restore(CKPT.read_bytes())
    want = {}
    for precision in ("f32", "bf16"):
        jcfg = _cfg(jax_load_config, root, precision)
        jdet = JDetector.from_config(jcfg)
        template = jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0))
        jparams = jax.tree.map(lambda t, r: np.asarray(r, t.dtype), template,
                               serialization.from_state_dict(template, raw["params"]))
        want[precision] = jval.evaluate_model(jcfg, jdet, jparams, batch_size=16)

    gap = {k: round(port["bf16"][k] - want["bf16"][k], 5) for k in want["bf16"]}
    print(f"\nfixture gate ({time.perf_counter() - t0:.1f} s): recorded (JAX package, TPU, bf16) "
          f"{RECORDED}; JAX f32 {want['f32']}; port f32 {port['f32']}; JAX bf16 {want['bf16']}; "
          f"port bf16 {port['bf16']}; port - JAX in bf16 {gap}")
    assert set(port["f32"]) == set(want["f32"])
    for k in want["f32"]:
        assert port["f32"][k] == pytest.approx(want["f32"][k], abs=RESULT_ATOL), k
    # The trained checkpoint detects its fixture in either precision.
    assert port["f32"]["metrics/mAP50(B)"] > 0.3 and port["bf16"]["metrics/mAP50(B)"] > 0.3
