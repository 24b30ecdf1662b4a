"""The hand-written kernels as PyTorch operators (``torch.ops.snn_torch``).

Each kernel of csrc/affine_lif.cu, csrc/lif_scan.cu and csrc/token_lstm.cu
is one ``torch.library`` custom op, so the dispatcher, ``torch.export``
and selective activation checkpointing see it as one operator:

- ``affine_lif_fwd`` (A1; the JAX package's
  ``kernels/affine_lif_pallas.py::_fwd_kernel``): spikes, v_final and the
  per-step readouts (an empty tensor unless ``with_readouts``);
- ``affine_lif_fwd_res`` (A2, ``::_fwd_res_kernel``): spikes, v_pre, v_final;
- ``affine_lif_bwd`` (A3, ``::_bwd_kernel``): g_x, g_a, g_b, g_v0;
- ``lif_scan_fwd`` (B1, ``kernels/lif_pallas.py::_fwd_kernel``): spikes,
  v_final;
- ``lif_scan_fwd_res`` (B2, ``::_fwd_res_kernel``): spikes, v_pre, v_final;
- ``lif_scan_bwd`` (B3, ``::_bwd_kernel``): g_x, g_v0;
- ``token_lstm_fwd`` (C1; replaces no Pallas kernel: the JAX package's
  ``lax.scan`` in ``models/token_lstm.py``): y, h_fin, c_fin;
- ``token_lstm_fwd_res`` (C2): y, h_fin, c_fin and the residuals act,
  cseq, hseq;
- ``token_lstm_bwd`` (C3): dg, g_h0, g_c0.

Dispatch is by device, through the dispatcher's own CPU and CUDA keys: a
CUDA tensor runs the wrapper of kernels/affine_lif.py, kernels/lif.py or
kernels/token_lstm.py, which checks its inputs, launches the kernel (one
more in its ``launch_counts``) and raises on a refused launch; a CPU
tensor runs the plain version of models/lif.py or models/token_lstm.py. A CUDA tensor never reaches a plain
version. The fake implementations give the outputs' shapes and dtypes and
launch nothing: ``torch.export`` traces through them. No op writes to its
inputs; the backward's ticket and partial-row scratch is internal to its
wrapper. The LIF constants travel as ``threshold, decay, surrogate_slope,
reset`` (``*LIFParams``), the forwards ignoring the slope. The token-LSTM
operators take the weights in the compute dtype (the kernels: bf16).

A program saved with ``torch.export.save`` names these ops, so a process
that loads one imports this module first (utils/export.py::load_serving
does).
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..models.lif import (
    LIFParams,
    affine_lif_backward_reference,
    affine_lif_forward_reference,
    lif_backward_reference,
    lif_forward_reference,
)
from ..models.token_lstm import token_lstm_backward_reference, token_lstm_forward_reference

NAMESPACE = "snn_torch"


def _new(like: Tensor, shape=None) -> Tensor:
    """A contiguous tensor of ``like``'s dtype and device: every output of
    the six kernels and their plain versions is contiguous."""
    return like.new_empty(like.shape if shape is None else shape)


def _unaliased(out: Tensor, src: Tensor) -> Tensor:
    """An op's output may not be one of its inputs (a plain version over
    T = 0 returns the initial membrane itself)."""
    return out.clone() if out is src else out


# -- A1: the normalize+LIF inference forward --------------------------------


@torch.library.custom_op(f"{NAMESPACE}::affine_lif_fwd", mutates_args=(), device_types="cuda")
def affine_lif_fwd(x4: Tensor, a: Tensor, b: Tensor, v0: Tensor, threshold: float,
                   decay: float, surrogate_slope: float, reset: str,
                   with_readouts: bool) -> tuple[Tensor, Tensor, Tensor]:
    from .affine_lif import affine_lif_fwd as launch

    p = LIFParams(threshold, decay, surrogate_slope, reset)
    out = launch(x4, a, b, p, v0, with_readouts)
    return out[0], out[1], out[2] if with_readouts else _new(x4, (0,))


@affine_lif_fwd.register_kernel("cpu")
def _(x4, a, b, v0, threshold, decay, surrogate_slope, reset, with_readouts):
    p = LIFParams(threshold, decay, surrogate_slope, reset)
    s, v, reads, _ = affine_lif_forward_reference(x4, a, b, p, v0, with_readouts)
    return s, _unaliased(v, v0), reads if with_readouts else _new(x4, (0,))


@affine_lif_fwd.register_fake
def _(x4, a, b, v0, threshold, decay, surrogate_slope, reset, with_readouts):
    return _new(x4), _new(v0), _new(x4) if with_readouts else _new(x4, (0,))


# -- A2: the same forward, also storing v_pre --------------------------------


@torch.library.custom_op(f"{NAMESPACE}::affine_lif_fwd_res", mutates_args=(), device_types="cuda")
def affine_lif_fwd_res(x4: Tensor, a: Tensor, b: Tensor, v0: Tensor, threshold: float,
                       decay: float, surrogate_slope: float,
                       reset: str) -> tuple[Tensor, Tensor, Tensor]:
    from .affine_lif import affine_lif_fwd_res as launch

    return launch(x4, a, b, LIFParams(threshold, decay, surrogate_slope, reset), v0)


@affine_lif_fwd_res.register_kernel("cpu")
def _(x4, a, b, v0, threshold, decay, surrogate_slope, reset):
    p = LIFParams(threshold, decay, surrogate_slope, reset)
    s, v, _, vpre = affine_lif_forward_reference(x4, a, b, p, v0, with_vpre=True)
    return s, vpre, _unaliased(v, v0)


@affine_lif_fwd_res.register_fake
def _(x4, a, b, v0, threshold, decay, surrogate_slope, reset):
    return _new(x4), _new(x4), _new(v0)


# -- A3: the reverse-time surrogate BPTT ---------------------------------------


@torch.library.custom_op(f"{NAMESPACE}::affine_lif_bwd", mutates_args=(), device_types="cuda")
def affine_lif_bwd(vpre4: Tensor, x4: Tensor, a: Tensor, g_s: Tensor, g_vfin: Tensor,
                   threshold: float, decay: float, surrogate_slope: float,
                   reset: str) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    from .affine_lif import affine_lif_bwd as launch

    return launch(vpre4, x4, a, g_s, g_vfin, LIFParams(threshold, decay, surrogate_slope, reset))


@affine_lif_bwd.register_kernel("cpu")
def _(vpre4, x4, a, g_s, g_vfin, threshold, decay, surrogate_slope, reset):
    p = LIFParams(threshold, decay, surrogate_slope, reset)
    g_x, g_a, g_b, g_v0 = affine_lif_backward_reference(vpre4, x4, a, g_s, g_vfin, p)
    return g_x, g_a, g_b, _unaliased(g_v0, g_vfin)


@affine_lif_bwd.register_fake
def _(vpre4, x4, a, g_s, g_vfin, threshold, decay, surrogate_slope, reset):
    return _new(x4), _new(a), _new(a), _new(g_vfin)


# -- B1: the plain LIF scan's inference forward -------------------------------


@torch.library.custom_op(f"{NAMESPACE}::lif_scan_fwd", mutates_args=(), device_types="cuda")
def lif_scan_fwd(x_t: Tensor, v0: Tensor, threshold: float, decay: float,
                 surrogate_slope: float, reset: str) -> tuple[Tensor, Tensor]:
    from .lif import lif_scan_fwd as launch

    return launch(x_t, LIFParams(threshold, decay, surrogate_slope, reset), v0)


@lif_scan_fwd.register_kernel("cpu")
def _(x_t, v0, threshold, decay, surrogate_slope, reset):
    s, _, v = lif_forward_reference(x_t, LIFParams(threshold, decay, surrogate_slope, reset), v0)
    return s, _unaliased(v, v0)


@lif_scan_fwd.register_fake
def _(x_t, v0, threshold, decay, surrogate_slope, reset):
    return _new(x_t), _new(v0)


# -- B2: the same forward, also storing v_pre ---------------------------------


@torch.library.custom_op(f"{NAMESPACE}::lif_scan_fwd_res", mutates_args=(), device_types="cuda")
def lif_scan_fwd_res(x_t: Tensor, v0: Tensor, threshold: float, decay: float,
                     surrogate_slope: float, reset: str) -> tuple[Tensor, Tensor, Tensor]:
    from .lif import lif_scan_fwd_res as launch

    return launch(x_t, LIFParams(threshold, decay, surrogate_slope, reset), v0)


@lif_scan_fwd_res.register_kernel("cpu")
def _(x_t, v0, threshold, decay, surrogate_slope, reset):
    p = LIFParams(threshold, decay, surrogate_slope, reset)
    s, vpre, v = lif_forward_reference(x_t, p, v0, with_residuals=True)
    return s, vpre, _unaliased(v, v0)


@lif_scan_fwd_res.register_fake
def _(x_t, v0, threshold, decay, surrogate_slope, reset):
    return _new(x_t), _new(x_t), _new(v0)


# -- B3: the plain LIF scan's reverse-time BPTT -------------------------------


@torch.library.custom_op(f"{NAMESPACE}::lif_scan_bwd", mutates_args=(), device_types="cuda")
def lif_scan_bwd(v_pre: Tensor, g_s: Tensor, g_vfin: Tensor, threshold: float, decay: float,
                 surrogate_slope: float, reset: str) -> tuple[Tensor, Tensor]:
    from .lif import lif_scan_bwd as launch

    return launch(v_pre, g_s, g_vfin, LIFParams(threshold, decay, surrogate_slope, reset))


@lif_scan_bwd.register_kernel("cpu")
def _(v_pre, g_s, g_vfin, threshold, decay, surrogate_slope, reset):
    p = LIFParams(threshold, decay, surrogate_slope, reset)
    g_x, g_v0 = lif_backward_reference(v_pre, g_s, g_vfin, p)
    return g_x, _unaliased(g_v0, g_vfin)


@lif_scan_bwd.register_fake
def _(v_pre, g_s, g_vfin, threshold, decay, surrogate_slope, reset):
    return _new(v_pre), _new(g_vfin)


# -- C1: the token-LSTM scan's inference forward ---------------------------


def _lstm_ref(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0, residuals):
    return token_lstm_forward_reference(x_gates0, [None, w_ih1], [w_hh0, w_hh1], [bias0, bias1],
                                        h0, c0, with_residuals=residuals)


def _lstm_fake(x_gates0, w_hh0, h0):
    t_steps, bsz, n_tok, gates = x_gates0.shape
    return w_hh0.new_empty((t_steps, bsz, n_tok, gates // 4)), _new(h0), _new(h0)


@torch.library.custom_op(f"{NAMESPACE}::token_lstm_fwd", mutates_args=(), device_types="cuda")
def token_lstm_fwd(x_gates0: Tensor, w_hh0: Tensor, w_ih1: Tensor, w_hh1: Tensor,
                   bias0: Tensor, bias1: Tensor, h0: Tensor,
                   c0: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    from .token_lstm import token_lstm_fwd as launch

    return launch(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0)


@token_lstm_fwd.register_kernel("cpu")
def _(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0):
    return _lstm_ref(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0, False)


@token_lstm_fwd.register_fake
def _(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0):
    return _lstm_fake(x_gates0, w_hh0, h0)


# -- C2: the same forward, also storing the reverse scan's residuals ----------


@torch.library.custom_op(f"{NAMESPACE}::token_lstm_fwd_res", mutates_args=(),
                         device_types="cuda")
def token_lstm_fwd_res(x_gates0: Tensor, w_hh0: Tensor, w_ih1: Tensor, w_hh1: Tensor,
                       bias0: Tensor, bias1: Tensor, h0: Tensor,
                       c0: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    from .token_lstm import token_lstm_fwd_res as launch

    return launch(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0)


@token_lstm_fwd_res.register_kernel("cpu")
def _(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0):
    return _lstm_ref(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0, True)


@token_lstm_fwd_res.register_fake
def _(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0):
    y, h, c = _lstm_fake(x_gates0, w_hh0, h0)
    rows = tuple(x_gates0.shape[:3])
    return (y, h, c, _new(x_gates0, (2, *rows, x_gates0.shape[3])),
            _new(x_gates0, (2, *rows, y.shape[3])), _new(y, (3, *y.shape)))


# -- C3: the token-LSTM scan's reverse scan -----------------------------------


@torch.library.custom_op(f"{NAMESPACE}::token_lstm_bwd", mutates_args=(), device_types="cuda")
def token_lstm_bwd(act: Tensor, cseq: Tensor, c0: Tensor, w_hh0: Tensor, w_ih1: Tensor,
                   w_hh1: Tensor, dy: Tensor, g_hfin: Tensor,
                   g_cfin: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    from .token_lstm import token_lstm_bwd as launch

    return launch(act, cseq, c0, w_hh0, w_ih1, w_hh1, dy, g_hfin, g_cfin)


@token_lstm_bwd.register_kernel("cpu")
def _(act, cseq, c0, w_hh0, w_ih1, w_hh1, dy, g_hfin, g_cfin):
    return token_lstm_backward_reference(act, cseq, c0, w_hh0, w_ih1, w_hh1, dy, g_hfin, g_cfin)


@token_lstm_bwd.register_fake
def _(act, cseq, c0, w_hh0, w_ih1, w_hh1, dy, g_hfin, g_cfin):
    return _new(act), _new(g_hfin), _new(g_cfin)


OPS = (affine_lif_fwd, affine_lif_fwd_res, affine_lif_bwd,
       lif_scan_fwd, lif_scan_fwd_res, lif_scan_bwd,
       token_lstm_fwd, token_lstm_fwd_res, token_lstm_bwd)
