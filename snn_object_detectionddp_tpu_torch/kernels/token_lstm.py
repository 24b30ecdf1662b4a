"""Wrappers of the hand-written token-LSTM scan kernels.

The kernels (csrc/token_lstm.cu) replace no Pallas kernel: the JAX
package runs the token LSTM's recurrence as a ``lax.scan`` inside one XLA
program, and the port's plain version is a Python loop of small launches
(models/token_lstm.py::token_lstm_forward_reference). Each kernel runs the
whole two-layer recurrence over all T*N tokens of a window in one
cooperative launch, one persistent block per 8 hidden units, the block's
weight slices in shared memory:

- ``token_lstm_fwd``: the inference forward (serving, evaluation, the
  tracker, exported programs);
- ``token_lstm_fwd_res``: the same forward, also storing the reverse
  scan's residuals (the gate activations and c of every cell, each layer's
  bf16 recurrent operand and layer 0's bf16 output);
- ``token_lstm_bwd``: the reverse scan, giving every cell's gate
  pre-activation gradient and the initial state's.

:class:`TokenLSTMScan` ties the last two into a ``torch.autograd.Function``
and adds the weight and bias gradients: one fp32 product (or sum) each
over all T*N*B rows, rounded once to the weights' dtype, as the plain
loop's autograd sums the per-token products before its one rounding. The
model reaches the kernels through their operators in kernels/ops.py,
which call these wrappers on a CUDA tensor and the plain versions on a CPU
tensor.

:func:`plan` gives a launch's blocks, threads and shared memory from the
hidden size: H/8 blocks must all be resident (one an SM), so the kernels
take a hidden size that is a multiple of 8 up to 8 x the card's SMs (1,056
on an H100) whose weight slices fit in shared memory (the forward's up to
H = 1,040); anything else raises with the reason.

Build: kernels/build.py compiles the source with ``nvcc`` at first use.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.debug import check_kernel_outputs
from . import build as _build
from . import ops

SOURCE = "token_lstm.cu"
KERNELS = ("token_lstm_fwd", "token_lstm_fwd_res", "token_lstm_bwd")
# Launches of each kernel since the last reset_launch_counts(): a count
# goes up by one where its kernel is launched, and nowhere else.
launch_counts = dict.fromkeys(KERNELS, 0)

UNITS = 8  # hidden units a block owns
THREADS = 512
FWD_KGROUPS, BWD_KGROUPS = 8, 16  # warps that split a product's depth
LAYERS = 2


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0


class Plan(NamedTuple):
    blocks: int  # H / 8, all resident at once
    threads: int
    fwd_smem: int  # bytes: the three weight slices in fragment order + the partial sums
    bwd_smem: int
    m_tiles: int  # 16-row tiles of the batch
    xbuf: int  # bf16 elements of the forward's double-buffered h exchange


def plan(hidden: int, batch: int) -> Plan:
    """The launch of a scan at ``hidden`` units and ``batch`` rows; raises
    on a hidden size the kernels cannot take on any card."""
    if hidden < UNITS or hidden % UNITS:
        raise ValueError(f"the token-LSTM kernels take a hidden size that is a multiple of "
                         f"{UNITS}, got {hidden}")
    k_steps, m_tiles = -(-hidden // 16), -(-batch // 16)
    return Plan(
        blocks=hidden // UNITS, threads=THREADS,
        fwd_smem=3 * 4 * k_steps * 32 * 8 + FWD_KGROUPS * LAYERS * 16 * 32 * 4,
        bwd_smem=3 * (4 * hidden // 16) * 32 * 8 + BWD_KGROUPS * 3 * 16 * UNITS * 4,
        m_tiles=m_tiles, xbuf=2 * LAYERS * m_tiles * k_steps * 32 * 8,
    )


def _fits(p: Plan, hidden: int, device: torch.device) -> None:
    props = torch.cuda.get_device_properties(device)
    if p.blocks > props.multi_processor_count:
        raise ValueError(
            f"the token-LSTM kernels keep hidden/{UNITS} = {p.blocks} blocks resident, one an "
            f"SM; {props.name} has {props.multi_processor_count} SMs (hidden {hidden})")
    optin = getattr(props, "shared_memory_per_block_optin", None)
    if optin is not None and max(p.fwd_smem, p.bwd_smem) > optin:
        raise ValueError(
            f"the token-LSTM kernels need {max(p.fwd_smem, p.bwd_smem)} bytes of shared memory "
            f"a block at hidden {hidden}; {props.name} gives {optin}")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.token_lstm_fwd.argtypes = [vp] * 13 + [i64] * 4 + [vp]
    lib.token_lstm_fwd_res.argtypes = [vp] * 16 + [i64] * 4 + [vp]
    lib.token_lstm_bwd.argtypes = [vp] * 13 + [i64] * 4 + [vp]
    for fn in (lib.token_lstm_fwd, lib.token_lstm_fwd_res, lib.token_lstm_bwd):
        fn.restype = ctypes.c_int


def _launch(name: str, device: torch.device, *args) -> None:
    _build.launch(_build.load(SOURCE, _declare), launch_counts, name, device, *args)


def _check(name: str, **tensors):
    """Raise on any input the kernels do not take (a tensor off the card
    included): every tensor contiguous, 16-byte aligned, on one CUDA
    device, of the dtype and shape its role has. Returns (T, B, N, H)."""
    dev = next(iter(tensors.values())).device
    for nm, tns in tensors.items():
        if tns.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got {nm} on {tns.device}")
        if tns.device != dev:
            raise ValueError(f"{nm} is on {tns.device}, the others on {dev}")
        if not tns.is_contiguous() or tns.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must be contiguous and 16-byte aligned")
    w = tensors["w_hh0"]
    if w.dtype != torch.bfloat16 or w.ndim != 2 or w.shape[1] != 4 * w.shape[0]:
        raise ValueError(f"{name} takes bf16 (H, 4H) weights, got {w.dtype} {tuple(w.shape)}")
    hidden = w.shape[0]
    seq = tensors["dy"] if "dy" in tensors else tensors["x_gates0"]
    if seq.ndim != 4:
        raise ValueError(f"{name} takes (T, B, N, ...) sequences, got {tuple(seq.shape)}")
    t_steps, batch, n_tok = seq.shape[:3]
    shapes = {
        "x_gates0": ((t_steps, batch, n_tok, 4 * hidden), torch.float32),
        "w_hh0": ((hidden, 4 * hidden), torch.bfloat16),
        "w_ih1": ((hidden, 4 * hidden), torch.bfloat16),
        "w_hh1": ((hidden, 4 * hidden), torch.bfloat16),
        "bias0": ((4 * hidden,), torch.float32),
        "bias1": ((4 * hidden,), torch.float32),
        "act": ((LAYERS, t_steps, batch, n_tok, 4 * hidden), torch.float32),
        "cseq": ((LAYERS, t_steps, batch, n_tok, hidden), torch.float32),
        "dy": ((t_steps, batch, n_tok, hidden), torch.bfloat16),
    }
    for nm, tns in tensors.items():
        shape, dtype = shapes.get(nm, ((LAYERS, batch, hidden), torch.float32))
        if tuple(tns.shape) != shape or tns.dtype != dtype:
            raise ValueError(f"{name}: {nm} must be {dtype} {shape}, got {tns.dtype} "
                             f"{tuple(tns.shape)}")
    if t_steps * batch * n_tok == 0:
        raise ValueError(f"{name} needs at least one token and one batch row")
    _fits(plan(hidden, batch), hidden, dev)
    return t_steps, batch, n_tok, hidden


def _scratch(p: Plan, device):
    """The forward's zeroed h exchange and the grid barrier's counter."""
    return (torch.zeros(p.xbuf, dtype=torch.bfloat16, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def _forward(name, x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0, residuals: bool):
    t_steps, batch, n_tok, hidden = _check(
        name, x_gates0=x_gates0, w_hh0=w_hh0, w_ih1=w_ih1, w_hh1=w_hh1, bias0=bias0,
        bias1=bias1, h0=h0, c0=c0)
    dev = x_gates0.device
    y = torch.empty((t_steps, batch, n_tok, hidden), dtype=torch.bfloat16, device=dev)
    h_fin, c_fin = torch.empty_like(h0), torch.empty_like(c0)
    xbuf, bar = _scratch(plan(hidden, batch), dev)
    ptrs = [t.data_ptr() for t in (x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0, y,
                                    h_fin, c_fin)]
    out = (y, h_fin, c_fin)
    if residuals:
        rows = (t_steps, batch, n_tok)
        act = torch.empty((LAYERS, *rows, 4 * hidden), dtype=torch.float32, device=dev)
        cseq = torch.empty((LAYERS, *rows, hidden), dtype=torch.float32, device=dev)
        hseq = torch.empty((LAYERS + 1, *rows, hidden), dtype=torch.bfloat16, device=dev)
        ptrs += [act.data_ptr(), cseq.data_ptr(), hseq.data_ptr()]
        out += (act, cseq, hseq)
    _launch(name, dev, *ptrs, xbuf.data_ptr(), bar.data_ptr(), t_steps, batch, n_tok, hidden)
    check_kernel_outputs(name, *out)
    return out


def token_lstm_fwd(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0):
    """Launch the inference forward. ``x_gates0`` (T, B, N, 4H) fp32 is
    layer 0's input products, the weights (H, 4H) bf16, the biases (4H)
    and the state ``h0``, ``c0`` (2, B, H) fp32. Returns (y (T, B, N, H)
    bf16, h_fin, c_fin). Raises on any input the kernel does not take."""
    return _forward("token_lstm_fwd", x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0,
                    residuals=False)


def token_lstm_fwd_res(x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0):
    """Launch the residual-saving forward: (y, h_fin, c_fin, act (2, T, B,
    N, 4H) fp32, cseq (2, T, B, N, H) fp32, hseq (3, T, B, N, H) bf16), the
    contract of models/token_lstm.py::token_lstm_forward_reference with
    residuals."""
    return _forward("token_lstm_fwd_res", x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0,
                    residuals=True)


def token_lstm_bwd(act, cseq, c0, w_hh0, w_ih1, w_hh1, dy, g_hfin, g_cfin):
    """Launch the reverse scan. Returns (dg (2, T, B, N, 4H) fp32, g_h0,
    g_c0 (2, B, H) fp32) — the contract of
    models/token_lstm.py::token_lstm_backward_reference."""
    name = "token_lstm_bwd"
    t_steps, batch, n_tok, hidden = _check(
        name, act=act, cseq=cseq, c0=c0, w_hh0=w_hh0, w_ih1=w_ih1, w_hh1=w_hh1, dy=dy,
        g_hfin=g_hfin, g_cfin=g_cfin)
    dg = torch.empty_like(act)
    g_h0, g_c0 = torch.empty_like(g_hfin), torch.empty_like(g_cfin)
    _, bar = _scratch(plan(hidden, batch)._replace(xbuf=0), act.device)
    _launch(name, act.device, *[t.data_ptr() for t in (
        act, cseq, c0, w_hh0, w_ih1, w_hh1, dy, g_hfin, g_cfin, dg, g_h0, g_c0, bar)],
        t_steps, batch, n_tok, hidden)
    check_kernel_outputs(name, dg, g_h0, g_c0)
    return dg, g_h0, g_c0


def param_grads(dg: torch.Tensor, hseq: torch.Tensor, dtype: torch.dtype):
    """The weight and bias gradients from the gate gradients ``dg`` (2, T,
    B, N, 4H) and the operands ``hseq`` (3, T, B, N, H): (W_hh0, W_ih1,
    W_hh1) each one fp32 product over all rows rounded once to ``dtype``,
    and (bias0, bias1) fp32 sums."""
    hidden = hseq.shape[-1]
    dg0, dg1 = (d.reshape(-1, 4 * hidden) for d in dg.unbind(0))
    h_in0, h_in1, h_out0 = (h.reshape(-1, hidden).float() for h in hseq.unbind(0))
    weights = tuple(torch.matmul(a.t(), d).to(dtype)
                    for a, d in ((h_in0, dg0), (h_out0, dg1), (h_in1, dg1)))
    return weights, (dg0.sum(0), dg1.sum(0))


class TokenLSTMScan(torch.autograd.Function):
    """The differentiable two-layer scan: the forward calls the operator
    ``snn_torch::token_lstm_fwd_res`` and saves its residuals, the backward
    ``snn_torch::token_lstm_bwd`` and then :func:`param_grads`. Inputs as
    :func:`token_lstm_fwd` takes them, the weights in the compute dtype; on
    a CPU tensor the operators run the plain versions."""

    @staticmethod
    def forward(ctx, x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0):
        y, h_fin, c_fin, act, cseq, hseq = ops.token_lstm_fwd_res(
            x_gates0, w_hh0, w_ih1, w_hh1, bias0, bias1, h0, c0)
        ctx.save_for_backward(act, cseq, hseq, c0, w_hh0, w_ih1, w_hh1)
        return y, h_fin, c_fin

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_y, g_h, g_c):
        act, cseq, hseq, c0, w_hh0, w_ih1, w_hh1 = ctx.saved_tensors
        g_y = torch.zeros(hseq.shape[1:], dtype=hseq.dtype, device=hseq.device) \
            if g_y is None else g_y.contiguous()
        g_h = torch.zeros_like(c0) if g_h is None else g_h.contiguous()
        g_c = torch.zeros_like(c0) if g_c is None else g_c.contiguous()
        dg, g_h0, g_c0 = ops.token_lstm_bwd(act, cseq, c0, w_hh0, w_ih1, w_hh1, g_y, g_h, g_c)
        weights, biases = param_grads(dg, hseq, w_hh0.dtype)
        return (dg[0], *weights, *biases, g_h0, g_c0)
