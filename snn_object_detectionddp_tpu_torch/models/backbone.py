"""Trainable spiking convolutional backbone producing P3/P4/P5 features:
a stride-4 stem and three stride-2 stages emitting spike trains at
strides 8/16/32. Width presets are keyed by ``model.yolo_model_name``."""

from __future__ import annotations

import torch
from torch import nn

from .layers import SpikingConvBlock, SpikingDownBlock
from .lif import LIFParams

# (stem, p3, p4, p5) channel widths and per-stage extra block count.
PRESETS = {
    "yolo11n.pt": ((32, 64, 128, 256), 0),
    "yolo11s.pt": ((32, 96, 192, 384), 0),
    "yolo11m.pt": ((48, 128, 256, 512), 1),
    "yolo11l.pt": ((64, 160, 320, 640), 2),
    "yolo11x.pt": ((80, 192, 384, 768), 2),
}
DEFAULT_PRESET = "yolo11m.pt"


def preset_channels(name: str, width_mult: float = 1.0) -> tuple[tuple[int, ...], int]:
    chans, depth = PRESETS.get(name, PRESETS[DEFAULT_PRESET])
    scaled = tuple(max(16, int(round(c * width_mult / 16)) * 16) for c in chans)
    return scaled, depth


def space_to_depth(x_t: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/b, W/b, C*b*b), channel order (row-in-block,
    col-in-block, c) as in the JAX package."""
    *lead, h, w, c = x_t.shape
    x = x_t.reshape(*lead, h // block, block, w // block, block, c)
    nd = len(lead)
    perm = tuple(range(nd)) + (nd, nd + 2, nd + 1, nd + 3, nd + 4)
    return x.permute(perm).reshape(*lead, h // block, w // block, c * block * block)


class SpikingBackbone(nn.Module):
    """(T, B, H, W, 3) frames -> ((p3, p4, p5) each (T, B, H/s, W/s, C),
    membrane-state dict). Stems: "s2d4" (one 4x4 space-to-depth), "s2d"
    (2x2 space-to-depth before each stem conv), "conv" (stride-2 pair)."""

    def __init__(self, lif: LIFParams, channels: tuple[int, ...] = (48, 128, 256, 512),
                 depth: int = 1, stem: str = "s2d", in_ch: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if stem not in ("s2d4", "s2d", "conv"):
            raise ValueError(f"unknown stem '{stem}'")
        self.stem, self.depth = stem, depth
        c_stem, c_p3, c_p4, c_p5 = channels
        if stem == "s2d4":
            ins, stride = (in_ch * 16, c_stem), 1
        elif stem == "s2d":
            ins, stride = (in_ch * 4, c_stem * 4), 1
        else:
            ins, stride = (in_ch, c_stem), 2
        self.stem1 = SpikingConvBlock(ins[0], c_stem, lif, stride=stride, dtype=dtype)
        self.stem2 = SpikingConvBlock(ins[1], c_stem * 2, lif, stride=stride, dtype=dtype)
        prev = c_stem * 2
        for i, c in enumerate((c_p3, c_p4, c_p5)):
            setattr(self, f"stage{i + 1}", SpikingDownBlock(prev, c, lif, dtype=dtype))
            for d in range(depth):
                setattr(self, f"stage{i + 1}_block{d}",
                        SpikingConvBlock(c, c, lif, dtype=dtype))
            prev = c

    def forward(self, x_t: torch.Tensor, state: dict | None = None):
        state = state or {}
        new_state: dict = {}
        if self.stem == "s2d4":
            x = space_to_depth(x_t, 4)
            x, new_state["stem1"] = self.stem1(x, state.get("stem1"))
            x, new_state["stem2"] = self.stem2(x, state.get("stem2"))
        elif self.stem == "s2d":
            x, new_state["stem1"] = self.stem1(space_to_depth(x_t), state.get("stem1"))
            x, new_state["stem2"] = self.stem2(space_to_depth(x), state.get("stem2"))
        else:
            x, new_state["stem1"] = self.stem1(x_t, state.get("stem1"))
            x, new_state["stem2"] = self.stem2(x, state.get("stem2"))

        feats = []
        for i in range(3):
            key = f"stage{i + 1}"
            x, new_state[key] = getattr(self, key)(x, state.get(key))
            for d in range(self.depth):
                bkey = f"{key}_block{d}"
                x, new_state[bkey] = getattr(self, bkey)(x, state.get(bkey))
            feats.append(x)
        return tuple(feats), new_state
