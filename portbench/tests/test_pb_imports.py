"""The import guard: no loaded module whose top-level name (before the
first dot, compared whole) is jax, jaxlib, flax or the JAX package, in a
benchmark run or in the reference; the port's own package is allowed."""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

from conftest import ROOT

from portbench import bench

BANNED = {"jax", "jaxlib", "flax", "snn_object_detectionddp_tpu"}


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "snn_object_detectionddp_tpu_torch_fake", types.ModuleType("x"))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "jax" not in bench.banned_modules()
    assert not set(bench.banned_modules()) & {"snn_object_detectionddp_tpu_torch"}
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in bench.banned_modules()


def test_a_dry_run_loads_nothing_banned():
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'portbench' / 'tests')!r}]\n"
        "from conftest import tiny\n"
        "from portbench import bench\n"
        "w = 'train-yolo11m-convlstm-b16'\n"
        "bench.run_cell(w, 5, 0.5, False, device='cpu', overrides=tiny(w))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "snn_object_detectionddp_tpu_torch" in loaded
    assert not loaded & BANNED


def test_reference_imports_nothing_of_the_port():
    ref = ROOT / "portbench" / "reference"
    for path in ref.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert not name.split(".")[0].startswith("snn_object_detectionddp_tpu"), (path, name)
                assert name.split(".")[0] not in BANNED, (path, name)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.model, portbench.reference.loss\n"
            "import portbench.reference.train, portbench.reference.detect\n"
            "print(sorted(m for m in sys.modules if m.startswith('snn_')))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_no_harness_file_imports_jax():
    for path in Path(ROOT / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & BANNED, (path, names)
