"""The pinned constants of ``snn_object_detectionddp_tpu_torch/data/fixtures.py``.

    JAX_PLATFORMS=cpu python scripts/torch_fixture_pins.py [--skip-metrics]

With JAX on the CPU, in a temporary directory:

1. writes the nano tree and flagship ``train/seq_00`` with the port's
   generator and with the JAX package's (cv2 as it comes: the reference is
   OpenCV 5.0.0 with Intel IPP);
2. prints each tree's ``tree_digest`` (port and JAX must agree);
3. unless ``--skip-metrics``, evaluates ``fixtures/hard_nano_ckpt.pt`` with
   the JAX package's ``evaluate_model`` (``scripts/hard_nano.yaml``, batch 16)
   on the nano tree in fp32 and bf16.

One JSON line, last. About a minute and a half on the CPU; it is not a test.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import cv2  # noqa: E402
import numpy as np  # noqa: E402
from flax import serialization  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from snn_object_detectionddp_tpu.config import load_config as jax_load_config  # noqa: E402
from snn_object_detectionddp_tpu.data.synthetic import make_sequence_hard as jax_hard  # noqa: E402
from snn_object_detectionddp_tpu.evals import validator as jval  # noqa: E402
from snn_object_detectionddp_tpu.models.detector import Detector as JDetector  # noqa: E402
from snn_object_detectionddp_tpu_torch.data import fixtures  # noqa: E402

CKPT = REPO / "fixtures/hard_nano_ckpt.pt"


def jax_tree(root: Path, params: dict, seeds: dict) -> Path:
    for split, split_seeds in seeds.items():
        for i, seed in enumerate(split_seeds):
            jax_hard(root / split / f"seq_{i:02d}", seed=seed, **params)
    return root


def jax_metrics(root: Path, precision: str) -> dict[str, float]:
    cfg = jax_load_config(REPO / "scripts/hard_nano.yaml")
    cfg.runtime.precision = precision
    for split in ("train", "val", "test"):
        sc = cfg.dataset.split(split)
        sc.path = sc.path.replace("fixtures/hard_nano", str(root))
    det = JDetector.from_config(cfg)
    template = jax.eval_shape(det.init_params, jax.random.PRNGKey(0))
    raw = serialization.msgpack_restore(CKPT.read_bytes())
    params = jax.tree.map(lambda t, r: np.asarray(r, t.dtype), template,
                          serialization.from_state_dict(template, raw["params"]))
    res = jval.evaluate_model(cfg, det, params, batch_size=16)
    return {k: float(res[k]) for k in fixtures.METRIC_KEYS}


def main() -> None:
    out = {"cv2": cv2.__version__, "cv2_ipp": cv2.ipp.useIPP(), "jax": jax.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        port_nano = fixtures.make_hard_nano(tmp / "port_nano")
        out["port_nano_s"] = time.perf_counter() - t0
        jax_nano = jax_tree(tmp / "jax_nano", fixtures.NANO, fixtures.NANO_SEEDS)
        one = {"train": fixtures.FLAGSHIP_SEEDS["train"][:1]}
        port_flag = fixtures.write_tree(tmp / "port_flag", fixtures.FLAGSHIP, one)
        jax_flag = jax_tree(tmp / "jax_flag", fixtures.FLAGSHIP, one)
        out["nano_digest"] = {"port": fixtures.tree_digest(port_nano),
                              "jax": fixtures.tree_digest(jax_nano)}
        out["flagship_seq00_digest"] = {"port": fixtures.tree_digest(port_flag / "train/seq_00"),
                                        "jax": fixtures.tree_digest(jax_flag / "train/seq_00")}
        if "--skip-metrics" not in sys.argv:
            out["jax_f32"] = jax_metrics(port_nano, "f32")
            out["jax_bf16"] = jax_metrics(port_nano, "bf16")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
