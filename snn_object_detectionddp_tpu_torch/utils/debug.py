"""Numerical debugging aids (``runtime.debug_nans``).

The port's counterpart of the JAX package's ``utils/debug.py``:

- :func:`enable_nan_debugging`: every operator that returns a NaN, in the
  forward as in the backward, raises ``FloatingPointError`` naming it,
  as ``jax_debug_nans`` does. A ``TorchDispatchMode`` looks at each
  floating output (``torch.autograd.set_detect_anomaly`` would check the
  backward only). The hand-written kernels' wrappers
  (kernels/affine_lif.py, kernels/lif.py) also hand their outputs to
  :func:`check_kernel_outputs`, which returns at once while debugging is
  off: a wrapper called directly passes no operator the mode sees.
- :func:`checked`: a wrapped function that raises on a non-finite output
  of any operator, or an index out of bounds, at the operator.

Checking reads every result back to the host: a debugging mode, slow.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten
# Their outputs are memory no operator has written yet.
_UNWRITTEN = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
              aten.new_empty_strided, aten.empty_permuted}
# Operators whose integer index tensors are checked against the sizes.
_INDEXING = {aten.index, aten.index_select, aten.gather, aten.take, aten.embedding}


def _bad(t: torch.Tensor, finite: bool) -> bool:
    if not (t.is_floating_point() or t.is_complex()) or t.device.type == "meta":
        return False
    return bool((~torch.isfinite(t)).any() if finite else torch.isnan(t).any())


def _views_only(func) -> bool:
    """A view returns memory another operator wrote (and checked)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write for r in rets)


def _check_indices(func, args) -> None:
    src = args[0]
    if func is aten.index:
        pairs = [(src.shape[d], i) for d, i in enumerate(args[1]) if i is not None]
    elif func is aten.take:
        pairs = [(src.numel(), args[1])]
    elif func is aten.embedding:
        pairs = [(src.shape[0], args[1])]
    else:  # index_select, gather: (self, dim, index)
        pairs = [(src.shape[args[1]], args[2])]
    for size, idx in pairs:
        if idx.dtype in (torch.bool, torch.uint8) or not idx.numel():
            continue
        if bool(((idx >= size) | (idx < -size)).any()):
            raise IndexError(f"{func}: index out of bounds for a dimension of size {size}")


class _CheckMode(TorchDispatchMode):
    def __init__(self, finite: bool = False, indices: bool = False):
        super().__init__()
        self.finite, self.indices = finite, indices

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.indices and func.overloadpacket in _INDEXING:
            _check_indices(func.overloadpacket, args)
        out = func(*args, **kwargs)
        if func.overloadpacket not in _UNWRITTEN and not _views_only(func):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and _bad(t, self.finite):
                    what = "a non-finite value" if self.finite else "NaN"
                    raise FloatingPointError(f"{what} in the output of {func}")
        return out


_NAN_MODE: _CheckMode | None = None


def nan_debugging_enabled() -> bool:
    return _NAN_MODE is not None


def enable_nan_debugging(enable: bool = True) -> None:
    """Turn NaN checking on or off for this thread (and the backward passes
    it runs)."""
    global _NAN_MODE
    if enable and _NAN_MODE is None:
        _NAN_MODE = _CheckMode()
        _NAN_MODE.__enter__()
    elif not enable and _NAN_MODE is not None:
        mode, _NAN_MODE = _NAN_MODE, None
        mode.__exit__(None, None, None)


@contextlib.contextmanager
def nan_debugging(enable: bool = True):
    """NaN checking on (or left as it is, ``enable=False``) inside the block;
    the previous setting afterwards."""
    was = nan_debugging_enabled()
    enable_nan_debugging(was or enable)
    try:
        yield
    finally:
        enable_nan_debugging(was)


def check_kernel_outputs(name: str, *outputs) -> None:
    """With NaN debugging on, raise if a hand-written kernel's output holds
    a NaN; a no-op otherwise."""
    if _NAN_MODE is None:
        return
    for t in outputs:
        if t is not None and _bad(t, finite=False):
            raise FloatingPointError(f"NaN in the output of the {name} kernel")


def checked(fn):
    """``fn`` wrapped to raise at the first operator that returns a
    non-finite value (FloatingPointError) or indexes out of bounds
    (IndexError, checked before the operator runs)."""

    def wrapper(*args, **kwargs):
        with _CheckMode(finite=True, indices=True):
            return fn(*args, **kwargs)

    return wrapper
