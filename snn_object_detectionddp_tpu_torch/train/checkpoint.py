"""Checkpointing: ``latest.pt`` / ``best.pt`` single files under save_dir.

A checkpoint per save at ``<save_dir>/latest.pt``, the best state by
validation loss at ``best.pt``, ``resume_training`` + ``weights_path`` to
continue, and warn-and-fresh-init when the path is missing. Optimizer and
schedule state are saved, so a resume continues the OneCycle schedule
instead of restarting it, and ``latest.pt`` records the post-epoch
best_val_loss.

Format: ``torch.save`` of ``{"state": train state with CPU tensors,
"epoch": int, "best_val_loss": float}``, atomic via write-to-temp + rename.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import torch


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nest of dicts/tuples/lists; other
    leaves (ints, floats) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def _pack(state: dict, epoch: int, best_val_loss: float) -> dict:
    return {
        "state": tree_map(lambda t: t.detach().cpu(), state),
        "epoch": int(epoch),
        "best_val_loss": float(best_val_loss),
    }


def save_checkpoint(path: str | Path, state: dict, epoch: int, best_val_loss: float) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(_pack(state, epoch, best_val_loss), tmp)
    os.replace(tmp, path)  # atomic on POSIX


class AsyncCheckpointer:
    """Checkpoint off the training critical path.

    ``save`` snapshots the state with a device-side clone (the train step
    updates the caller's tensors in place while the background thread
    reads) and performs the device-to-host copy, serialization and file
    writes in a background thread. ``wait()`` joins the in-flight save and
    re-raises its failure; saves never overlap.
    """

    def __init__(self):
        self._thread = None
        self._error: Exception | None = None

    def save(
        self,
        state: dict,
        epoch: int,
        best_val_loss: float,
        latest_path: str | Path,
        best_path: str | Path | None = None,
    ) -> None:
        self.wait()  # one in-flight save at a time
        snap = tree_map(lambda t: t.detach().clone(), state)

        def job():
            try:
                host = tree_map(lambda t: t.cpu(), snap)
                save_checkpoint(latest_path, host, epoch, best_val_loss)
                if best_path is not None:
                    save_checkpoint(best_path, host, epoch, best_val_loss)
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=job, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _read(path: str | Path) -> dict:
    raw = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not isinstance(raw, dict) or "params" not in (raw.get("state") or {}):
        raise ValueError(
            f"checkpoint '{path}' has no state/params entry "
            "(not a checkpoint written by this package?)"
        )
    return raw


def _check_shapes(path, what: str, template: dict, restored: dict) -> None:
    missing = sorted(set(template) - set(restored))
    extra = sorted(set(restored) - set(template))
    if missing or extra:
        raise ValueError(
            f"checkpoint '{path}' {what} structure does not match this model "
            f"(different depth/preset?): missing {missing[:5]}, unexpected {extra[:5]}"
        )
    bad = [
        (k, tuple(template[k].shape), tuple(restored[k].shape))
        for k in template if tuple(template[k].shape) != tuple(restored[k].shape)
    ]
    if bad:
        detail = "; ".join(f"{k}: expected {ts}, checkpoint has {rs}" for k, ts, rs in bad[:5])
        raise ValueError(
            f"checkpoint '{path}' {what} shapes do not match this model "
            f"({len(bad)} mismatched leaves — different width preset / width_mult?): {detail}"
        )


def load_checkpoint(path: str | Path, template_state: dict,
                    device: str | torch.device = "cuda") -> dict:
    """Restore ``{"state", "epoch", "best_val_loss"}`` against a template
    train state (structure and shapes only; its tensors may live on the
    ``meta`` device), with the tensors moved to ``device``.

    A checkpoint whose optimizer state does not fit the template (another
    optimizer wrapper, an older build) restores the parameters only and
    keeps the template's optimizer/schedule state, with a note."""
    from ..models.detector import resolve_device

    dev = resolve_device(device)
    raw = _read(path)
    state = raw["state"]
    _check_shapes(path, "params", template_state["params"], state["params"])
    out = {"epoch": int(raw.get("epoch", 0)),
           "best_val_loss": float(raw.get("best_val_loss", float("inf")))}
    opt = state.get("opt_state") or {}
    fits = all(
        set(opt.get(m, {})) == set(template_state["params"])
        and all(tuple(opt[m][k].shape) == tuple(v.shape)
                for k, v in template_state["params"].items())
        for m in ("mu", "nu")
    ) and "count" in opt and "step" in state and "sched" in state
    if fits:
        out["state"] = tree_map(lambda t: t.to(dev), {
            "params": state["params"], "opt_state": opt,
            "step": int(state["step"]), "sched": tuple(float(c) for c in state["sched"]),
        })
    else:
        print(
            "NOTE: checkpoint optimizer-state structure does not match this "
            "run's optimizer; restored params only (fresh optimizer/schedule state)."
        )
        out["state"] = {**template_state,
                        "params": tree_map(lambda t: t.to(dev), state["params"])}
    return out


def load_backbone_params(path: str | Path, template_params: dict,
                         subtree: str = "backbone") -> dict:
    """Shape-checked partial restore of one top-level module.

    Loads only the ``<subtree>.*`` parameters from a checkpoint written by
    this package into ``template_params``, leaving every other module at
    its values there. Returns a NEW params dict (restored tensors on the
    device of the ones they replace). Raises with an actionable message
    when the checkpoint lacks the subtree or any leaf's shape disagrees
    (e.g. a different width preset)."""
    prefix = subtree + "."
    template_sub = {k: v for k, v in template_params.items() if k.startswith(prefix)}
    if not template_sub:
        tops = sorted({k.split(".")[0] for k in template_params})
        raise ValueError(f"template params have no '{subtree}' subtree; top-level keys: {tops}")
    raw_params = _read(path)["state"]["params"]
    raw_sub = {k: v for k, v in raw_params.items() if k.startswith(prefix)}
    if not raw_sub:
        tops = sorted({k.split(".")[0] for k in raw_params})
        raise ValueError(f"checkpoint '{path}' has no '{subtree}' params; top-level keys: {tops}")
    _check_shapes(path, subtree, template_sub, raw_sub)
    print(f"Initialized {subtree} from '{path}' ({len(raw_sub)} param leaves).")
    out = dict(template_params)
    for k, v in raw_sub.items():
        out[k] = v.to(device=template_params[k].device, dtype=template_params[k].dtype)
    return out


def resume_or_init(cfg, template_state: dict, init_fn=None,
                   device: str | torch.device = "cuda", place=None) -> tuple[dict, int, float]:
    """Returns (state, start_epoch, best_val_loss). With
    ``training.resume_training`` the state comes from
    ``training.weights_path``; a missing or unreadable file warns and falls
    through to a fresh start, where ``init_fn`` builds the real initial
    state (the template may hold ``meta`` tensors). ``place`` maps the
    whole loaded or fresh state to what this process keeps: under FSDP
    every rank reads the same full file (or makes the same seeded init)
    and keeps its own chunks (``fns.shard_state``, the JAX package's
    ``place_state``)."""
    state, start_epoch, best = _resume_or_init(cfg, template_state, init_fn, device)
    return (place(state) if place is not None else state), start_epoch, best


def _resume_or_init(cfg, template_state, init_fn, device):
    if cfg.training.resume_training:
        weights_path = Path(cfg.training.weights_path)
        if weights_path.exists():
            print(f"Resuming training: Loading from {weights_path}")
            try:
                packed = load_checkpoint(weights_path, template_state, device)
            except Exception as e:
                # A torn or corrupt checkpoint must not strand a training
                # job: same soft-fail contract as a missing file. Writes
                # are atomic, so this catches outside corruption.
                print(
                    f"WARNING: checkpoint '{weights_path}' is unreadable "
                    f"({type(e).__name__}: {e}); starting fresh."
                )
            else:
                best = packed["best_val_loss"]
                print(f"Successfully loaded model and found previous best_val_loss: {best}")
                return packed["state"], packed["epoch"] + 1, best
        else:
            print(
                f"WARNING: 'resume_training' is True but weights_path "
                f"'{weights_path}' not found."
            )
        print("Initializing model from scratch...")
    else:
        print("Initializing new model from scratch...")
    if init_fn is not None:
        return init_fn(), 0, float("inf")
    return template_state, 0, float("inf")
