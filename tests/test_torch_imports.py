"""The port stands alone: no module of snn_object_detectionddp_tpu_torch,
and not chip_smoke.py, imports jax, flax or the JAX package (checked on
the source, so lazy imports inside functions count too), and its entry
points default to the CUDA device."""

import ast
import inspect
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "snn_object_detectionddp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "snn_object_detectionddp_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_found():
    names = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert "snn_object_detectionddp_tpu_torch/serve.py" in names
    assert "chip_smoke.py" in names
    assert len(names) >= 15


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_entry_points_default_to_cuda():
    from snn_object_detectionddp_tpu_torch import serve
    from snn_object_detectionddp_tpu_torch.convert import params_from_jax
    from snn_object_detectionddp_tpu_torch.models.detector import Detector

    assert inspect.signature(Detector.from_config).parameters["device"].default == "cuda"
    assert inspect.signature(serve.serve).parameters["device"].default == "cuda"
    assert inspect.signature(params_from_jax).parameters["device"].default == "cuda"
