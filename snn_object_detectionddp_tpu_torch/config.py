"""Config system: the reference's ``config.yaml`` schema plus extensions.

A copy of the JAX package's config dataclasses and validation, so the same
YAML files load into the same values. Differences: ``yaml`` is imported
only inside :func:`load_config` (``Config()`` defaults need no YAML), and
there is no platform forcing — the port's entry points take an explicit
``device`` instead. ``runtime.lif_kernel`` values are still accepted for
schema compatibility, but the port picks its LIF path by tensor device
(models/lif.py::run_affine_lif_tb), not by this key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class SplitConfig:
    """One dataset split (reference: config.yaml:1-10)."""

    path: str = ""
    seq_len: int = 5


@dataclass
class DatasetConfig:
    train: SplitConfig = field(default_factory=SplitConfig)
    val: SplitConfig = field(default_factory=SplitConfig)
    test: SplitConfig = field(default_factory=SplitConfig)

    def split(self, mode: str) -> SplitConfig:
        if mode not in ("train", "val", "test"):
            raise ValueError(
                f"Invalid mode '{mode}'. Choose from 'train', 'val', or 'test'."
            )
        return getattr(self, mode)


@dataclass
class TrainingConfig:
    """Reference: config.yaml:18-27."""

    seed: int = 42
    epochs: int = 10
    batch_size: int = 64
    num_workers: int = 4
    learning_rate: float = 1e-4  # peak LR of the OneCycle schedule
    weight_decay: float = 5e-4
    save_dir: str = "runs/train/exp1"
    resume_training: bool = False
    weights_path: str = "runs/train/exp1/latest.pt"
    grad_clip_norm: float = 10.0
    pct_start: float = 0.3
    remat: bool = False
    remat_chunk: int = 0
    remat_policy: str = "full"
    grad_accum_steps: int = 1
    param_groups: bool = False
    save_every_epochs: int = 1


@dataclass
class HypConfig:
    """Detection-loss gains (reference: config.yaml:33-37)."""

    box: float = 7.5
    cls: float = 1.0
    dfl: float = 2.5
    reg_max: int = 16


@dataclass
class SpikeConfig:
    """LIF neuron parameters (see models/lif.py)."""

    threshold: float = 1.0
    decay: float = 0.05
    surrogate_slope: float = 4.0
    reset: str = "soft"  # "soft" (subtract threshold) or "hard" (to zero)


@dataclass
class ModelConfig:
    """Reference: config.yaml:29-37 plus SNN extensions."""

    num_classes: int = 8
    # Selects the backbone width preset: 'yolo11n.pt'|'yolo11s.pt'|'yolo11m.pt'.
    yolo_model_name: str = "yolo11m.pt"
    use_conv_lstm: bool = True  # ConvLSTM bottleneck vs LIF accumulator bottleneck
    hyp: HypConfig = field(default_factory=HypConfig)
    timesteps: int = 4  # T for single-image spike-encoded inference
    image_size: tuple[int, int] = (480, 640)  # (H, W); DSEC native resolution
    max_boxes: int = 64  # fixed-shape label padding per image
    spike: SpikeConfig = field(default_factory=SpikeConfig)
    bottleneck: str = "convlstm"  # "convlstm" | "lif" | "lstm"
    width_mult: float = 1.0  # backbone width scale on top of the preset
    stem: str = "s2d4"  # "s2d4" | "s2d" | "conv"
    backbone_init: str | None = None
    freeze_backbone: bool = False


@dataclass
class MeshConfig:
    """Device-mesh spec. The port serves on one device; ``tensor > 1`` is
    rejected by serve.py until tensor-parallel serving is ported."""

    data: int = -1
    spatial: int = 1
    fsdp: bool = False
    tensor: int = 1
    coordinator: str | None = None
    num_processes: int | None = None
    process_id: int | None = None


@dataclass
class RuntimeConfig:
    precision: str = "bf16"  # compute dtype for convs/matmuls: "bf16" | "f32"
    prefetch: int = 2
    lif_kernel: str = "auto"  # accepted for schema compatibility only
    debug_nans: bool = False


@dataclass
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    mode: str = "train"  # train | visualize | test | eval
    device: str = "tpu"  # kept for schema compat (reference: config.yaml:13)
    debug_train: bool = False
    debug_test: bool = False
    training: TrainingConfig = field(default_factory=TrainingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        return _build(cls, raw or {})


def _build(dc_type, raw: Any):
    """Recursively build a dataclass from a raw dict, validating keys/types."""
    if not dataclasses.is_dataclass(dc_type):
        return raw
    if raw is None:
        raw = {}
    if not isinstance(raw, dict):
        raise TypeError(f"Expected mapping for {dc_type.__name__}, got {type(raw)}")
    fields = {f.name: f for f in dataclasses.fields(dc_type)}
    kwargs = {}
    for key, value in raw.items():
        if key not in fields:
            raise KeyError(
                f"Unknown config key '{key}' for section {dc_type.__name__}; "
                f"valid keys: {sorted(fields)}"
            )
        resolved = _FIELD_TYPES.get((dc_type.__name__, key))
        if resolved is not None:
            kwargs[key] = _build(resolved, value)
        elif key == "image_size" and value is not None:
            kwargs[key] = tuple(int(v) for v in value)
        else:
            kwargs[key] = value
    obj = dc_type(**kwargs)
    _validate(obj)
    return obj


# Nested-section field types (string annotations make f.type non-introspectable).
_FIELD_TYPES = {
    ("Config", "dataset"): DatasetConfig,
    ("Config", "training"): TrainingConfig,
    ("Config", "model"): ModelConfig,
    ("Config", "mesh"): MeshConfig,
    ("Config", "runtime"): RuntimeConfig,
    ("DatasetConfig", "train"): SplitConfig,
    ("DatasetConfig", "val"): SplitConfig,
    ("DatasetConfig", "test"): SplitConfig,
    ("ModelConfig", "hyp"): HypConfig,
    ("ModelConfig", "spike"): SpikeConfig,
}


def _validate(obj) -> None:
    if isinstance(obj, Config):
        if obj.mode not in ("train", "visualize", "test", "eval"):
            raise ValueError(f"Invalid mode '{obj.mode}'")
    elif isinstance(obj, TrainingConfig):
        if obj.batch_size < 1:
            raise ValueError("training.batch_size must be >= 1")
        if obj.epochs < 1:
            raise ValueError("training.epochs must be >= 1")
        if not (0.0 < obj.pct_start < 1.0):
            raise ValueError("training.pct_start must be in (0, 1)")
        if obj.remat_policy not in ("full", "save_conv"):
            raise ValueError(
                "training.remat_policy must be 'full' or 'save_conv'"
            )
    elif isinstance(obj, ModelConfig):
        if obj.num_classes < 1:
            raise ValueError("model.num_classes must be >= 1")
        if obj.hyp.reg_max < 2:
            raise ValueError("model.hyp.reg_max must be >= 2")
        if obj.timesteps < 1:
            raise ValueError("model.timesteps must be >= 1")
    elif isinstance(obj, SpikeConfig):
        if obj.reset not in ("soft", "hard"):
            raise ValueError("model.spike.reset must be 'soft' or 'hard'")
    elif isinstance(obj, MeshConfig):
        if obj.spatial < 1:
            raise ValueError("mesh.spatial must be >= 1")
        if obj.tensor < 1:
            raise ValueError("mesh.tensor must be >= 1")
        if obj.spatial > 1 and obj.tensor > 1:
            raise ValueError(
                "mesh.spatial and mesh.tensor cannot both exceed 1 "
                "(untested composition; pick one model-parallel axis)"
            )
    elif isinstance(obj, RuntimeConfig):
        if obj.precision not in ("bf16", "f32"):
            raise ValueError("runtime.precision must be 'bf16' or 'f32'")
        if obj.lif_kernel not in ("auto", "manual", "unrolled", "pallas", "xla"):
            raise ValueError(
                "runtime.lif_kernel must be auto|manual|unrolled|pallas|xla"
            )


def load_config(path: str | Path = "config.yaml") -> Config:
    """Load and validate a YAML config (reference: main.py:120-121)."""
    import yaml

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    cfg = Config.from_dict(raw)
    # Back-compat: resolve the bottleneck kind from use_conv_lstm when the
    # raw YAML didn't set `bottleneck` (reference semantics: config.yaml:32).
    raw_model = (raw or {}).get("model") or {}
    if "bottleneck" not in raw_model:
        cfg.model.bottleneck = "convlstm" if cfg.model.use_conv_lstm else "lif"
    return cfg
