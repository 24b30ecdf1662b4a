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
# The multi-card script of FSDP and tensor parallelism runs on the card
# machine as the port's entry points do.
PARALLEL_SCRIPT = REPO / "scripts" / "torch_parallel_cards.py"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", PARALLEL_SCRIPT]
# FSDP and tensor parallelism: the modules they added to or changed.
PARALLEL_MODULES = ("parallel/mesh.py", "train/step.py", "train/loop.py", "train/checkpoint.py",
                    "models/layers.py", "models/convlstm.py", "models/token_lstm.py",
                    "models/unet.py", "models/backbone.py", "models/detect.py",
                    "models/detector.py", "evals/validator.py", "eval_2.py", "serve.py", "main.py")
# The tracker benchmark, its flow, the overlays, the video, profiling and
# NaN debugging.
NEW_MODULES = ("data/color.py", "evals/flow.py", "evals/legacy.py", "eval.py", "video.py",
               "viz/__init__.py", "viz/palette.py", "viz/overlay.py", "viz/video.py",
               "utils/profiling.py", "utils/debug.py")


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
    assert "scripts/torch_parallel_cards.py" in names
    assert "snn_object_detectionddp_tpu_torch/train/step.py" in names
    assert "snn_object_detectionddp_tpu_torch/losses/detection.py" in names
    for new in ("kernels/lif.py", "kernels/build.py", "models/token_lstm.py", "evals/map.py",
                "evals/validator.py", "evals/__init__.py", "data/dsec.py", "data/png.py",
                "data/native.py", "data/pipeline.py", "data/synthetic.py", "data/classes.py",
                "main.py", "eval_2.py", "data/resize.py", "utils/yaml_subset.py",
                "parallel/__init__.py", "parallel/mesh.py", *NEW_MODULES):
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
    PORT / "main.py", PORT / "eval_2.py", PORT / "evals" / "validator.py", REPO / "chip_smoke.py",
    PORT / "evals" / "legacy.py", PORT / "eval.py", PORT / "video.py",
    PORT / "utils" / "profiling.py", PORT / "utils" / "debug.py", PARALLEL_SCRIPT]


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
    imports PyYAML, even lazily. OpenCV is reached only where the port has
    no replacement for it: the HTTP endpoint's branch for non-PNG uploads
    (serve.decode_upload), the overlay's label text (cv2.putText), the MP4
    writer (cv2.VideoWriter) and Farneback flow."""
    cv2_sites = []
    for path in SOURCES:
        for where, roots in _imports_by_function(path).items():
            assert "yaml" not in roots, f"{path.name}:{where} imports yaml"
            if "cv2" in roots:
                cv2_sites.append((path.relative_to(REPO).as_posix(), where))
    assert sorted(cv2_sites) == [
        ("snn_object_detectionddp_tpu_torch/evals/flow.py", "farneback_flow"),
        ("snn_object_detectionddp_tpu_torch/serve.py", "decode_upload"),
        ("snn_object_detectionddp_tpu_torch/viz/overlay.py", "_put_label"),
        ("snn_object_detectionddp_tpu_torch/viz/video.py", "frames_to_video"),
        ("snn_object_detectionddp_tpu_torch/viz/video.py", "stitch_video"),
    ]


def test_new_modules_import_without_cv2():
    """Every module of the tracker benchmark, overlays, video, profiling and
    NaN debugging imports in a fresh process where OpenCV is absent."""
    import subprocess
    import sys

    names = [f"snn_object_detectionddp_tpu_torch.{m[:-3].replace('/', '.')}" for m in NEW_MODULES]
    code = ("import sys; sys.modules['cv2'] = None\n"
            + "".join(f"import {n}\n" for n in names)
            + "assert sys.modules['cv2'] is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("module", PARALLEL_MODULES + ("scripts/torch_parallel_cards.py",))
def test_parallel_paths_import_without_jax(module):
    """Each module FSDP and tensor parallelism run through, and the
    multi-card script, imports in a fresh process in which jax, flax and
    the JAX package cannot be imported."""
    import subprocess
    import sys

    if module.startswith("scripts/"):
        load = ("import importlib.util as u\n"
                f"spec = u.spec_from_file_location('m', {str(REPO / module)!r})\n"
                "spec.loader.exec_module(u.module_from_spec(spec))\n")
    else:
        load = f"import snn_object_detectionddp_tpu_torch.{module[:-3].replace('/', '.')}\n"
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'flax', 'optax', 'snn_object_detectionddp_tpu'):\n"
            "    sys.modules[name] = None\n" + load
            + "assert all(sys.modules.get(n) is None for n in ('jax', 'flax'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_no_msgpack_anywhere():
    """Flax checkpoints are read by utils/msgpack_subset.py: nothing of the
    port imports the msgpack package, even lazily."""
    for path in SOURCES:
        for where, roots in _imports_by_function(path).items():
            assert "msgpack" not in roots, f"{path.name}:{where} imports msgpack"


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
    runs the plain version; any other device goes to the operators of
    kernels/ops.py, whose dispatcher sends a CUDA tensor to the kernel
    wrappers and a meta tensor (standing in for a card this machine may
    not have) to the fake implementation: shapes only, no launch, and
    never the plain version. The wrappers themselves raise on a tensor off
    the card. Without a card a CUDA request raises when the tensor is
    made, before run_lif is reached."""
    import torch

    from snn_object_detectionddp_tpu_torch.kernels import lif as kernels_lif
    from snn_object_detectionddp_tpu_torch.kernels import ops
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams, run_lif

    x = torch.zeros(2, 3, 4)
    before = dict(kernels_lif.launch_counts)
    s, v = run_lif(x, LIFParams())
    assert s.device.type == v.device.type == "cpu"
    assert kernels_lif.launch_counts == before  # no launch counted off the card

    def refuse(*args, **kwargs):
        raise AssertionError("a meta tensor reached the plain version")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("lif_forward_reference", "lif_backward_reference"):
            mp.setattr(ops, name, refuse)
        for grad in (False, True):
            xm = torch.zeros(2, 3, 4, device="meta", requires_grad=grad)
            s, v = run_lif(xm, LIFParams())
            assert s.is_meta and v.is_meta and s.shape == (2, 3, 4) and v.shape == (3, 4)
            if grad:
                (gx,) = torch.autograd.grad((s, v), xm, (torch.ones_like(s), torch.ones_like(v)))
                assert gx.is_meta and gx.shape == xm.shape
    assert kernels_lif.launch_counts == before
    for call in (lambda xm: kernels_lif.lif_scan_fwd(xm, LIFParams()),
                 lambda xm: kernels_lif.lif_scan_fwd_res(xm, LIFParams())):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call(torch.zeros(2, 3, 4, device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            torch.zeros(2, 3, 4, device="cuda")
    assert set(kernels_lif.KERNELS) == {"lif_scan_fwd", "lif_scan_fwd_res", "lif_scan_bwd"}


# Spatial parallelism's row exchanges (parallel/mesh.py part (d)): a
# function or class of these names moves no tensor through the host.
SPATIAL_HELPERS = ("row_partition", "spatial_rows", "_fetch", "_return_rows", "_alltoall",
                   "_FetchRows", "fetch_rows", "_GatherRows", "gather_rows", "_ShardRows",
                   "shard_rows", "_SpatialSum", "spatial_sum", "all_reduce_spatial")


def test_spatial_helpers_keep_tensors_on_their_device():
    """The exchanges of spatial parallelism run on the device of the
    tensors given to them (NCCL on the card): no copy to the host, no
    host read of a value, no CPU device named."""
    tree = ast.parse((PORT / "parallel" / "mesh.py").read_text())
    defs = {n.name: n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert set(SPATIAL_HELPERS) <= set(defs)
    for name in SPATIAL_HELPERS:
        for node in ast.walk(defs[name]):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("cpu", "numpy", "tolist", "item"), (name, node.attr)
            if isinstance(node, ast.Constant):
                assert node.value != "cpu", name


def test_a_zero_row_shard_off_the_cpu_never_reaches_the_plain_version():
    """A spatial rank may own no row of a small map (one row over two
    ranks). Its normalize+LIF call on a tensor off the CPU goes to the
    operators of kernels/ops.py, forward and backward (on a card the
    wrappers, which launch no empty grid and count the call in
    ``skipped_empty``; on a meta tensor the fake), never to the plain
    version."""
    import torch

    from snn_object_detectionddp_tpu_torch.kernels import affine_lif as kernels_affine
    from snn_object_detectionddp_tpu_torch.kernels import ops
    from snn_object_detectionddp_tpu_torch.models.lif import LIFParams, run_affine_lif_tb

    def refuse(*args, **kwargs):
        raise AssertionError("a zero-row shard off the CPU reached the plain version")

    before = dict(kernels_affine.launch_counts)
    with pytest.MonkeyPatch.context() as mp:
        for name in ("affine_lif_forward_reference", "affine_lif_backward_reference"):
            mp.setattr(ops, name, refuse)
        for grad in (False, True):
            x = torch.zeros(2 * 3, 0, 5, 8, device="meta", requires_grad=grad)
            a = torch.ones(2, 3, 8, device="meta", requires_grad=grad)
            s, v = run_affine_lif_tb(x, a, torch.zeros(2, 3, 8, device="meta"), LIFParams())
            assert s.is_meta and s.shape == (6, 0, 5, 8) and v.shape == (3, 0, 5, 8)
            if grad:
                gx, ga = torch.autograd.grad((s.sum() + v.sum()), (x, a))
                assert gx.is_meta and gx.shape == x.shape and ga.shape == a.shape
    assert kernels_affine.launch_counts == before
    assert set(kernels_affine.skipped_empty) == set(kernels_affine.KERNELS)


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

    assert set(build.SOURCES) == {"affine_lif.cu", "lif_scan.cu", "png_unfilter.cpp", "raster.cpp"}
    for name in (*build.SOURCES, *build.HEADERS):
        assert (build.CSRC / name).is_file(), name
    text = (build.CSRC / "lif_scan.cu").read_text()
    for entry in ("lif_scan_fwd", "lif_scan_fwd_res", "lif_scan_bwd"):
        assert f'extern "C" int {entry}(' in text
