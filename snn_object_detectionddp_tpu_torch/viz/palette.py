"""Deterministic per-class BGR colors for overlays."""

_PALETTE = [
    (60, 200, 60),
    (60, 60, 220),
    (220, 60, 60),
    (60, 200, 220),
    (220, 60, 220),
    (220, 220, 60),
    (140, 90, 250),
    (90, 250, 140),
]


def class_color(cls: int) -> tuple[int, int, int]:
    return _PALETTE[cls % len(_PALETTE)]
