"""Convert JAX (flax) detector parameters, and whole JAX train states, into
the port's flat dicts.

The flax tree is nested dicts of arrays; the port's dict is flat, keyed by
module path (``backbone.stem1.weight``). Rules:

- ``<m>/Conv_0/kernel`` (HWIO)        -> ``<m>.weight`` (OIHW)
- ``<m>/GroupNorm_0/{scale,bias}``    -> ``<m>.gn_scale`` / ``<m>.gn_bias``
- ``<m>/ConvTranspose_0/kernel``      -> ``<m>.up_weight``: spatially flipped,
  then ``(in, out, kh, kw)``; its bias -> ``<m>.up_bias``
- any other 4D ``kernel`` (1x1 convs) -> ``<m>.weight`` (OIHW)
- ``gates_kernel`` (HWIO, kept whole) -> OIHW; the ConvLSTM slices it at
  its input width
- every other leaf keeps its name and layout: biases, and the token-LSTM
  bottleneck's ``l{n}_w_ih`` / ``l{n}_w_hh`` (in, 4*hidden) and ``l{n}_bias``.

Floating leaves are cast up to fp32 (the committed fixture checkpoint
stores fp16 to stay small).

A train state (:func:`train_state_from_jax`) carries the AdamW moments
``mu``/``nu`` in the params' tree layout, so the same rules convert them.

Flax files are read by :mod:`.utils.msgpack_subset`, without the ``msgpack``
package; :func:`load_weights` reads either a flax file or a checkpoint of
this package's trainer, telling them apart by content.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .utils import msgpack_subset

_RENAME = {
    ("Conv_0", "kernel"): "weight",
    ("GroupNorm_0", "scale"): "gn_scale",
    ("GroupNorm_0", "bias"): "gn_bias",
    ("ConvTranspose_0", "kernel"): "up_weight",
    ("ConvTranspose_0", "bias"): "up_bias",
}


def _convert_leaf(name: str, arr: np.ndarray) -> np.ndarray:
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    if name == "up_weight":
        return np.ascontiguousarray(arr[::-1, ::-1].transpose(2, 3, 0, 1))
    if name in ("weight", "gates_kernel") and arr.ndim == 4:
        return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
    return arr


def params_from_jax(tree: dict, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of numpy-convertible arrays) -> the
    port's flat parameter dict of fp32 tensors on ``device``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path: tuple[str, ...]):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
                continue
            mod, name = path, key
            if path and (path[-1], key) in _RENAME:
                mod, name = path[:-1], _RENAME[(path[-1], key)]
            elif key == "kernel":
                name = "weight"
            arr = _convert_leaf(name, np.asarray(val))
            out[".".join(mod + (name,))] = torch.tensor(arr, device=device)

    walk(tree, ())
    return out


def pwclite_params_from_jax(tree: dict, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Flax ``PWCLite`` variables (``{"params": {"enc0": {"kernel", "bias"},
    ...}}`` or the inner dict, numpy-convertible) -> the state dict of the
    port's ``evals.flow.PWCLite`` (``enc0.weight`` OIHW, ``enc0.bias``, ...)
    on ``device``."""
    return params_from_jax(tree.get("params", tree), device)


def _find_adam_state(node) -> list[dict]:
    """Every ``{"count", "mu", "nu"}`` node (optax ScaleByAdamState as a
    state dict) under ``node``."""
    if not isinstance(node, dict):
        return []
    if {"count", "mu", "nu"} <= set(node) and isinstance(node["mu"], dict):
        return [node]
    return [hit for v in node.values() for hit in _find_adam_state(v)]


def train_state_from_jax(state_dict: dict, device: str | torch.device = "cuda") -> dict:
    """A JAX train state as nested dicts of numpy-convertible leaves (what
    ``flax.serialization.to_state_dict`` gives, and what the ``state`` entry
    of a JAX ``latest.pt`` holds: ``params``, the optax ``opt_state`` with
    AdamW's ``mu``/``nu``/``count``, ``step``, ``sched``) -> the port's
    train state (train/step.py) on ``device``. Wrappers around the Adam
    state (clip, masks, injected hyperparameters) hold nothing the port's
    optimizer keeps and are dropped; an optimizer with several Adam states
    (parameter groups) is not convertible and raises."""
    adam = _find_adam_state(state_dict["opt_state"])
    if len(adam) != 1:
        raise ValueError(
            f"expected one AdamW state (count/mu/nu) in opt_state, found {len(adam)}"
        )
    (adam,) = adam
    params = params_from_jax(state_dict["params"], device)
    mu = params_from_jax(adam["mu"], device)
    nu = params_from_jax(adam["nu"], device)
    if not (set(mu) == set(nu) == set(params)):
        raise ValueError("AdamW moments do not cover the same leaves as params")
    return {
        "params": params,
        "opt_state": {"mu": mu, "nu": nu, "count": int(np.asarray(adam["count"]))},
        "step": int(np.asarray(state_dict["step"])),
        "sched": tuple(float(c) for c in np.asarray(state_dict["sched"])),
    }


def _read_flax(path: str | Path) -> dict:
    return msgpack_subset.unpackb(Path(path).read_bytes(), ext_hook=_ext_hook)


def load_flax_params(path: str | Path) -> dict:
    """Read a flax msgpack checkpoint (e.g. ``fixtures/hard_nano_ckpt.pt``)
    and return its param tree as nested dicts of numpy arrays. Accepts a
    params-only file (``{"params": ...}``) or a full train state
    (``{"state": {"params": ...}}``)."""
    return _flax_params(_read_flax(path), path)


def _flax_params(raw: dict, path) -> dict:
    if "params" in raw:
        return raw["params"]
    if "state" in raw and "params" in raw["state"]:
        return raw["state"]["params"]
    raise KeyError(f"{path}: no 'params' or 'state/params' entry")


def load_flax_state(path: str | Path) -> dict:
    """Read a JAX ``latest.pt``/``best.pt`` (flax msgpack) and return
    ``{"state", "epoch", "best_val_loss"}`` with the state as nested dicts
    of numpy arrays, ready for :func:`train_state_from_jax`."""
    raw = _read_flax(path)
    if "opt_state" not in (raw.get("state") or {}):
        raise KeyError(f"{path}: no 'state' entry with an optimizer state")
    return {"state": raw["state"], "epoch": int(raw.get("epoch", 0)),
            "best_val_loss": float(raw.get("best_val_loss", float("inf")))}


# flax.serialization's msgpack extension codes for arrays and numpy scalars.
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _ext_hook(code: int, data: bytes):
    """Decode flax's msgpack extensions: an ndarray or numpy scalar is
    packed as (shape, dtype name, raw bytes)."""
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack extension {code} in a flax checkpoint")
    shape, dtype_name, buf = msgpack_subset.unpackb(data, raw=True)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def load_weights(detector, weights: str | Path) -> dict[str, torch.Tensor]:
    """Parameters from ``weights`` on the detector's device, the reader
    chosen by the file's content: a ``torch.save`` zip (``PK\\x03\\x04``,
    a checkpoint of this package's trainer, train/checkpoint.py) or else a
    flax msgpack file of the JAX package (``fixtures/hard_nano_ckpt.pt``, a
    JAX ``best.pt``)."""
    return load_packed_weights(detector, weights)["params"]


def load_packed_weights(detector, weights: str | Path) -> dict:
    """:func:`load_weights` with the file's best validation loss:
    ``{"params", "best_val_loss"}`` (inf for a flax file that holds only
    parameters)."""
    with open(weights, "rb") as f:
        magic = f.read(4)
    if magic == b"PK\x03\x04":
        from .train.checkpoint import load_checkpoint

        # The skeleton's meta parameters give structure and shapes only.
        template = {"params": dict(detector.module.named_parameters())}
        packed = load_checkpoint(weights, template, detector.device)
        print(f"Loaded checkpoint {weights} (epoch {packed['epoch']})", flush=True)
        return {"params": packed["state"]["params"], "best_val_loss": packed["best_val_loss"]}
    raw = _read_flax(weights)
    params = params_from_jax(_flax_params(raw, weights), detector.device)
    print(f"Loaded flax checkpoint {weights}", flush=True)
    return {"params": params, "best_val_loss": float(raw.get("best_val_loss", float("inf")))}
