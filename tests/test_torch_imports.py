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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sklearn", "snn_object_detectionddp_tpu")
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
    assert "snn_object_detectionddp_tpu_torch/train/step.py" in names
    assert "snn_object_detectionddp_tpu_torch/losses/detection.py" in names
    for new in ("kernels/lif.py", "kernels/build.py", "models/token_lstm.py", "evals/map.py",
                "evals/validator.py", "evals/__init__.py", "data/dsec.py", "data/png.py",
                "data/native.py", "data/pipeline.py", "data/synthetic.py", "data/classes.py",
                "main.py", "eval_2.py", "data/resize.py", "utils/yaml_subset.py",
                "parallel/__init__.py", "parallel/mesh.py"):
        assert f"snn_object_detectionddp_tpu_torch/{new}" in names
    assert len(names) >= 46


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


OPTIONAL = ("yaml", "cv2", "msgpack", "tqdm", "tensorboardX")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_optional_packages_are_imported_lazily(path):
    """The card machine may lack these: a module may import them only
    inside the function that needs them, never when it is imported."""
    tree = ast.parse(path.read_text(), str(path))
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            top.add(node.module.split(".")[0])
    assert not top & set(OPTIONAL), f"{path.name} imports {sorted(top & set(OPTIONAL))} at import"


# The data pipeline and the command lines run on the card machine, which
# has no OpenCV, scikit-learn or tqdm: they may not import them at all.
DATA_PATH = sorted((PORT / "data").glob("*.py")) + [
    PORT / "main.py", PORT / "eval_2.py", PORT / "evals" / "validator.py", REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", DATA_PATH, ids=lambda p: p.relative_to(REPO).as_posix())
def test_data_path_imports_no_opencv_sklearn_or_tqdm(path):
    bad = _imported_roots(path) & {"cv2", "sklearn", "tqdm"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def _imports_by_function(path: Path) -> dict[str, set[str]]:
    """{enclosing function name (or "<module>"): imported root names}."""
    found: dict[str, set[str]] = {}

    def visit(node, where):
        for child in ast.iter_child_nodes(node):
            here = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else where
            if isinstance(child, ast.Import):
                found.setdefault(where, set()).update(a.name.split(".")[0] for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                found.setdefault(where, set()).add(child.module.split(".")[0])
            visit(child, here)

    visit(ast.parse(path.read_text(), str(path)), "<module>")
    return found


def test_no_yaml_anywhere_and_cv2_only_for_non_png_uploads():
    """The configs are read by utils/yaml_subset.py: nothing of the port
    imports PyYAML, even lazily. OpenCV is reached only by the HTTP
    endpoint's branch for non-PNG uploads (serve.decode_upload)."""
    cv2_sites = []
    for path in SOURCES:
        for where, roots in _imports_by_function(path).items():
            assert "yaml" not in roots, f"{path.name}:{where} imports yaml"
            if "cv2" in roots:
                cv2_sites.append((path.relative_to(REPO).as_posix(), where))
    assert cv2_sites == [("snn_object_detectionddp_tpu_torch/serve.py", "decode_upload")]


def test_training_entry_points_default_to_cuda():
    from snn_object_detectionddp_tpu_torch.convert import train_state_from_jax
    from snn_object_detectionddp_tpu_torch.train import checkpoint

    assert inspect.signature(train_state_from_jax).parameters["device"].default == "cuda"
    assert inspect.signature(checkpoint.load_checkpoint).parameters["device"].default == "cuda"
    assert inspect.signature(checkpoint.resume_or_init).parameters["device"].default == "cuda"


def test_step_fns_run_on_the_detectors_device():
    """make_step_fns takes no device: batches go to the detector's, which
    defaults to the card (Detector.from_config) and raises without one."""
    import numpy as np
    import torch

    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.train import step

    assert "device" not in inspect.signature(step.make_step_fns).parameters
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Detector.from_config(Config())
    cfg = Config()
    cfg.model.yolo_model_name, cfg.model.width_mult = "yolo11n.pt", 0.25
    cfg.runtime.precision = "f32"
    det = Detector.from_config(cfg, device="cpu")
    tx, sched = step.make_optimizer(1e-3, 4)
    batch = {"images": np.zeros((1, 1, 64, 64, 3), np.uint8),
             "labels": np.zeros((1, 2, 5), np.float32), "label_mask": np.zeros((1, 2), bool)}
    out = step.make_step_fns(det, tx, sched).eval_step(det.init_params(), batch)
    assert out["loss"].device.type == "cpu"


def test_entry_points_default_to_cuda():
    from snn_object_detectionddp_tpu_torch import serve
    from snn_object_detectionddp_tpu_torch.convert import params_from_jax
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.ops.anchors import make_anchors

    assert inspect.signature(Detector.from_config).parameters["device"].default == "cuda"
    assert inspect.signature(make_anchors).parameters["device"].default == "cuda"
    assert inspect.signature(serve.serve).parameters["device"].default == "cuda"
    assert inspect.signature(params_from_jax).parameters["device"].default == "cuda"
    from snn_object_detectionddp_tpu_torch import eval_2

    assert inspect.signature(eval_2.evaluate).parameters["device"].default == "cuda"


def test_run_lif_takes_the_card_for_a_cuda_tensor_and_never_the_plain_version():
    """run_lif picks its route by the tensor's device alone: a CPU tensor
    runs the plain version; any other device goes to the kernel wrappers,
    which raise on what they cannot take (here a meta tensor stands in for
    a card this machine may not have). Without a card a CUDA request
    raises when the tensor is made, before run_lif is reached."""
    import torch

    from snn_object_detectionddp_tpu_torch.kernels import lif as kernels_lif
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams, run_lif

    x = torch.zeros(2, 3, 4)
    before = dict(kernels_lif.launch_counts)
    s, v = run_lif(x, LIFParams())
    assert s.device.type == v.device.type == "cpu"
    assert kernels_lif.launch_counts == before  # no launch counted off the card
    for grad in (False, True):
        xm = torch.zeros(2, 3, 4, device="meta", requires_grad=grad)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            run_lif(xm, LIFParams())
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            torch.zeros(2, 3, 4, device="cuda")
    assert set(kernels_lif.KERNELS) == {"lif_scan_fwd", "lif_scan_fwd_res", "lif_scan_bwd"}


def test_evaluation_runs_on_the_detectors_device():
    """make_predict_fn and evaluate_batches take no device: they run on the
    detector's, which defaults to the card and raises without one."""
    import numpy as np
    import torch

    from snn_object_detectionddp_tpu_torch.config import Config
    from snn_object_detectionddp_tpu_torch.evals import validator
    from snn_object_detectionddp_tpu_torch.models.detector import Detector

    for fn in (validator.make_predict_fn, validator.evaluate_batches, validator.evaluate_model):
        assert "device" not in inspect.signature(fn).parameters
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            validator.make_predict_fn(Detector.from_config(Config()))
    cfg = Config()
    cfg.model.yolo_model_name, cfg.model.width_mult = "yolo11n.pt", 0.25
    cfg.runtime.precision = "f32"
    det = Detector.from_config(cfg, device="cpu")
    out = validator.make_predict_fn(det, max_det=5)(
        det.init_params(), np.zeros((1, 1, 64, 64, 3), np.uint8))
    assert out["boxes"].device.type == "cpu" and tuple(out["boxes"].shape) == (1, 5, 4)
    assert not out["boxes"].requires_grad


def test_kernel_sources_are_in_the_package():
    from snn_object_detectionddp_tpu_torch.kernels import build

    assert set(build.SOURCES) == {"affine_lif.cu", "lif_scan.cu", "png_unfilter.cpp"}
    for name in (*build.SOURCES, *build.HEADERS):
        assert (build.CSRC / name).is_file(), name
    text = (build.CSRC / "lif_scan.cu").read_text()
    for entry in ("lif_scan_fwd", "lif_scan_fwd_res", "lif_scan_bwd"):
        assert f'extern "C" int {entry}(' in text
