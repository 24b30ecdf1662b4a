"""The fixture checkpoint's mAP on the CPU host, JAX package and port side
by side, in fp32 and in the yaml's bf16.

    JAX_PLATFORMS=cpu python scripts/fixture_map_cpu.py

Regenerates ``fixtures/hard_nano/`` with the JAX generator into a temporary
directory, evaluates ``fixtures/hard_nano_ckpt.pt`` on its seeded
validation split (``scripts/hard_nano.yaml``, batch 16) with the JAX
package's ``evaluate_model`` and the port's, each in fp32 and in bf16, and
prints one JSON line. The JAX numbers recorded for the checkpoint (0.4144 /
0.1987 in ``BENCH_r05.json``) came from a TPU; this tells whether a gap
between them and the port's bf16 numbers belongs to the device or to the
port. Runs on the CPU only (a few minutes); it is not a test.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from flax import serialization  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from make_hard_fixture import make_hard_nano  # noqa: E402

from snn_object_detectionddp_tpu.config import load_config as jax_load_config  # noqa: E402
from snn_object_detectionddp_tpu.evals import validator as jval  # noqa: E402
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector  # noqa: E402
from snn_object_detectionddp_tpu_torch.config import load_config  # noqa: E402
from snn_object_detectionddp_tpu_torch.convert import load_flax_params, params_from_jax  # noqa: E402
from snn_object_detectionddp_tpu_torch.evals import validator as tval  # noqa: E402
from snn_object_detectionddp_tpu_torch.models.detector import Detector  # noqa: E402

CKPT = REPO / "fixtures/hard_nano_ckpt.pt"
KEYS = ("metrics/mAP50(B)", "metrics/mAP50-95(B)", "metrics/precision(B)", "metrics/recall(B)")


def _cfg(load, root, precision):
    cfg = load(REPO / "scripts/hard_nano.yaml")
    cfg.runtime.precision = precision
    for split in ("train", "val", "test"):
        sc = cfg.dataset.split(split)
        sc.path = sc.path.replace("fixtures/hard_nano", str(root))
    return cfg


def main() -> None:
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = make_hard_nano(Path(tmp) / "hard_nano")
        tparams = params_from_jax(load_flax_params(CKPT), "cpu")
        raw = serialization.msgpack_restore(CKPT.read_bytes())
        for precision in ("f32", "bf16"):
            t0 = time.perf_counter()
            jcfg = _cfg(jax_load_config, root, precision)
            jdet = JDetector.from_config(jcfg)
            template = jax.eval_shape(jdet.init_params, jax.random.PRNGKey(0))
            jparams = jax.tree.map(lambda t, r: np.asarray(r, t.dtype), template,
                                   serialization.from_state_dict(template, raw["params"]))
            res = jval.evaluate_model(jcfg, jdet, jparams, batch_size=16)
            out[f"jax_{precision}"] = {k: round(float(res[k]), 5) for k in KEYS}
            out[f"jax_{precision}_s"] = round(time.perf_counter() - t0, 1)
            t0 = time.perf_counter()
            cfg = _cfg(load_config, root, precision)
            res = tval.evaluate_model(cfg, Detector.from_config(cfg, device="cpu"), tparams,
                                      batch_size=16)
            out[f"port_{precision}"] = {k: round(float(res[k]), 5) for k in KEYS}
            out[f"port_{precision}_s"] = round(time.perf_counter() - t0, 1)
    out["recorded_jax_tpu_bf16"] = {"metrics/mAP50(B)": 0.4144, "metrics/mAP50-95(B)": 0.1987}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
