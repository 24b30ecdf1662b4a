"""The numbers that decide ``correct``: what the timed path produced,
against the frozen reference.

Training: the checked steps' losses and the per-leaf norms of the
parameters' change over them (and, read but not compared, of the first
clipped gradient, from AdamW's first moment), for the start from the
seed's weights and for the steps checked inside the window alike. A leaf's gap is
the distance between the program's norm and the reference's, over the
larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone under Adam and are left out of the change.

Serving: each checked reply against the reference's decode and NMS of
the raw maps its dispatch produced: the detections that have no equal in
the other list (same class, boxes within ``BOX_TOL`` px, scores within
``SCORE_TOL``: the reply's own rounding). And the state each checked
dispatch read for a stream against the state the stream's previous
dispatch wrote.
"""

from __future__ import annotations

import torch

SMALL_GRAD = 1e-3
BOX_TOL = 0.02  # px: replies round boxes to 0.01
SCORE_TOL = 2e-4  # replies round scores to 1e-4


def leaf_gap(prog: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor | None = None) -> float:
    """Worst leaf's |prog - ref| / max(ref, median ref); float64 norms."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    denom = torch.maximum(ref, ref.median())
    return float(((prog - ref).abs() / denom).max())


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"losses": [3 floats], "first_grad": per-leaf
    norms, "change": per-leaf norms}, leaves in one order."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    g = ref["first_grad"].double().cpu()
    moving = g >= SMALL_GRAD * g.median()
    return {"loss_gap": max(losses), "change_gap": leaf_gap(prog["change"], ref["change"], moving)}


def grad_readings(prog: dict, ref: dict) -> dict:
    """The first clipped gradient's worst-leaf and median-leaf gaps: read,
    not compared (PERF.md: no planted fault or control separates them
    from sound runs)."""
    p, r = prog["first_grad"].double().cpu(), ref["first_grad"].double().cpu()
    rel = (p - r).abs() / torch.maximum(r, r.median())
    return {"grad_gap": float(rel.max()), "grad_gap_median": float(rel.median())}


def unmatched(reply: dict, boxes, scores, classes) -> int:
    """Detections of ``reply`` and of the reference's (boxes (n, 4),
    scores (n,), classes (n,) on the host) that have no equal in the
    other."""
    pb = torch.tensor(reply["boxes"], dtype=torch.float32).reshape(-1, 4)
    ps = torch.tensor(reply["scores"], dtype=torch.float32)
    pc = torch.tensor(reply["classes"], dtype=torch.long)
    if len(pb) == 0 or len(boxes) == 0:
        return len(pb) + len(boxes)
    same = ((pb[:, None] - boxes[None].float()).abs().amax(-1) <= BOX_TOL) \
        & ((ps[:, None] - scores[None].float()).abs() <= SCORE_TOL) \
        & (pc[:, None] == classes[None].long())
    return int((~same.any(1)).sum()) + int((~same.any(0)).sum())


def state_gap(written, read) -> float:
    """Largest absolute difference over the leaves of two one-stream
    recurrent states (nested dicts / tuples of tensors)."""
    if isinstance(written, dict):
        return max(state_gap(written[k], read[k]) for k in written)
    if isinstance(written, (tuple, list)):
        return max(state_gap(a, b) for a, b in zip(written, read))
    if written.shape != read.shape:
        return float("inf")
    return float((written.float() - read.float()).abs().max())
