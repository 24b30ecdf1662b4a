"""Token-LSTM bottleneck (``model.bottleneck: "lstm"``).

The bottleneck map is flattened into a sequence of its H*W spatial tokens
(row-major) and a 2-layer LSTM runs over them, carrying (h, c) from token
to token and from frame to frame. Explicit per-layer weights, gate order
(i, f, g, o), no inter-layer dropout (inference-mode behaviour): the
variant exists for behavioural comparison with the ConvLSTM bottleneck.

Precision: the gate products take both operands rounded to the compute
dtype (bf16 by default) and accumulate into an **fp32 result**, as the JAX
package asks of its ``jnp.dot`` (``preferred_element_type=float32``). A
bf16 ``torch.matmul`` would round its output to bf16, so
:func:`_dot_f32` multiplies the rounded operands in fp32 instead: exact
bf16 x bf16 products summed in fp32, on the CPU and on the card alike
(the card's fp32 matmul runs in full fp32 unless the caller turns TF32
on). State, gate math and the carry stay fp32.

The scan: layer 0's input products are one product over all tokens; the
recurrence then runs as the operators ``snn_torch::token_lstm_fwd``
(without a gradient) or ``token_lstm_fwd_res`` + ``token_lstm_bwd``
(kernels/token_lstm.py::TokenLSTMScan). On a CUDA tensor they launch the
hand-written kernels of csrc/token_lstm.cu, which round where the loop
rounds: bf16 operands, fp32 sums, fp32 gate math; in the backward each
recurrent product's gradient rounded to bf16 alone and each weight's
gradient once, after its sum over all tokens. On a CPU tensor they run the
plain versions here, :func:`token_lstm_forward_reference` (the loop,
frame x token x layer) and :func:`token_lstm_backward_reference` (its
gradient equations written out). The loop runs on the card only where the
kernels cannot: under tensor parallelism (``units != hidden``: every token
needs an all-gather of h, which cannot live inside one kernel), in a
compute dtype other than bf16, or with other than two layers; each such
scan is counted in ``token_lstm.plain_scans`` (utils/profiling.py).

Under tensor parallelism the gate columns of ``w_ih``, ``w_hh`` and the
bias are permuted when sharded (parallel/mesh.py::tp_shard_leaf), so a
rank computes i, f, g and o of its own slice of the hidden units; the
input tokens and each new ``h`` are gathered whole for the next product,
and the carry stays sharded.

Under spatial parallelism the scan needs every token in order, so the map
is gathered whole on every rank of the spatial group, scanned there, and
each rank keeps its rows of the output (``gather_rows`` / ``shard_rows``):
the one module computed the same on every rank. Its parameters' gradients
are therefore whole on every rank and are not summed over the group
(``rows_replicated``; train/step.py).
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import current_spatial_group, full_channels, gather_rows, shard_rows
from ..utils import profiling
from .lif import needs_grad


def _dot_f32(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``dtype`` and an fp32 result."""
    return torch.matmul(x.to(dtype).float(), w.to(dtype).float())


def token_lstm_forward_reference(x_gates0, w_ih, w_hh, bias, h0, c0, with_residuals=False):
    """The plain scan: frame x token x layer, one cell at a time.

    ``x_gates0`` (T, B, N, 4u) fp32 is layer 0's input products of the N
    tokens of each frame; ``w_ih[l]`` (layers >= 1; ``w_ih[0]`` unused) and
    ``w_hh[l]`` (hidden, 4u) are in the compute dtype, ``bias[l]`` (4u),
    ``h0`` and ``c0`` (layers, B, u) fp32, u the rank's share of the hidden
    units (u = hidden off a tensor mesh). Returns y (T, B, N, u) in the
    compute dtype and the final (h, c). ``with_residuals`` (u = hidden,
    two layers) also returns the reverse scan's residuals: ``act`` (2, T, B,
    N, 4u) the gate activations (i, f, g, o) fp32, ``cseq`` (2, T, B, N, u)
    each cell's c, ``hseq`` (3, T, B, N, u) in the compute dtype each
    layer's recurrent operand and layer 0's output."""
    dtype, hidden = w_hh[0].dtype, w_hh[0].shape[0]
    w_ih = [None if w is None else w.float() for w in w_ih]
    w_hh = [w.float() for w in w_hh]
    h_all, c_all = list(h0.unbind(0)), list(c0.unbind(0))
    # each layer's h, whole: the next token's recurrent product reads it
    h_full = [full_channels(x, hidden) for x in h_all]
    res = {k: [] for k in ("act", "cseq", "hseq")}
    frames = []
    for frame in range(x_gates0.shape[0]):
        outs, cells = [], []
        for tok in range(x_gates0.shape[2]):
            inp, cell = None, []
            for layer in range(len(w_hh)):
                x_gates = (x_gates0[frame, :, tok] if layer == 0
                           else torch.matmul(inp.to(dtype).float(), w_ih[layer]))
                h_in = h_full[layer].to(dtype)
                gates = x_gates + torch.matmul(h_in.float(), w_hh[layer]) + bias[layer]
                i, f, g, o = gates.chunk(4, -1)
                si, sf, tg, so = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
                c_all[layer] = sf * c_all[layer] + si * tg
                h_all[layer] = so * torch.tanh(c_all[layer])
                h_full[layer] = full_channels(h_all[layer], hidden)
                inp = h_full[layer]
                if with_residuals:
                    cell.append((torch.cat([si, sf, tg, so], -1), c_all[layer], h_in))
            outs.append(h_all[-1])
            if with_residuals:
                cells.append((*cell, h_all[0].to(dtype)))
        frames.append(torch.stack(outs, 1))
        if with_residuals:  # (B, N, ...) a frame

            def col(layer, k):
                return torch.stack([c[layer][k] for c in cells], 1)

            res["act"].append(torch.stack([col(0, 0), col(1, 0)]))
            res["cseq"].append(torch.stack([col(0, 1), col(1, 1)]))
            res["hseq"].append(torch.stack([col(0, 2), col(1, 2),
                                            torch.stack([c[2] for c in cells], 1)]))
    out = (torch.stack(frames).to(dtype), torch.stack(h_all), torch.stack(c_all))
    if not with_residuals:
        return out
    return out + tuple(torch.stack(res[k], 1) for k in ("act", "cseq", "hseq"))


def _cell_backward(act, c, c_prev, dc, dh):
    """One cell's reverse step from the saved activations: the gradient of
    its gate pre-activations and of the previous c."""
    si, sf, tg, so = act.chunk(4, -1)
    tc = torch.tanh(c)
    d_so = dh * tc
    dct = dc + (dh * so) * (1 - tc * tc)
    d_sf, d_si, d_tg = dct * c_prev, dct * tg, dct * si
    da = torch.cat([d_si * (1 - si) * si, d_sf * (1 - sf) * sf,
                    d_tg * (1 - tg * tg), d_so * (1 - so) * so], -1)
    return da, dct * sf


def token_lstm_backward_reference(act, cseq, c0, w_hh0, w_ih1, w_hh1, dy, g_hfin, g_cfin):
    """The reverse scan of the two-layer loop, token by token.

    From the residuals of :func:`token_lstm_forward_reference`, the initial
    c ``c0``, the weights in the compute dtype, y's gradient ``dy`` (T, B,
    N, H) and the final carry's ``g_hfin``, ``g_cfin`` (2, B, H) fp32:
    returns ``dg`` (2, T, B, N, 4H) fp32, the gradient of every cell's gate
    pre-activations (of layer 0's input products too), and the initial
    state's (g_h0, g_c0). The loop's autograd rounds to the compute dtype
    at the backward of each ``.to(dtype).float()`` pair, and so does this:
    each recurrent product's gradient into h, and layer 1's into its input,
    rounded alone before they are added. The weight and bias gradients are
    fp32 products of ``dg`` over all tokens (kernels/token_lstm.py)."""
    dtype = w_hh0.dtype
    t_steps, _, n_tok = dy.shape[:3]
    w_hh, w_ih1 = (w_hh0.float(), w_hh1.float()), w_ih1.float()
    dg = act.new_empty(act.shape)
    rec, dc = list(g_hfin.unbind(0)), list(g_cfin.unbind(0))
    for n in reversed(range(t_steps * n_tok)):
        fr, tok = divmod(n, n_tok)
        prev = [cseq[layer, (n - 1) // n_tok, :, (n - 1) % n_tok] if n else c0[layer]
                for layer in range(2)]
        dh1 = dy[fr, :, tok].float() + rec[1]
        dg[1, fr, :, tok], dc[1] = _cell_backward(act[1, fr, :, tok], cseq[1, fr, :, tok],
                                                  prev[1], dc[1], dh1)
        rec[1] = torch.matmul(dg[1, fr, :, tok], w_hh[1].t()).to(dtype).float()
        dh0 = torch.matmul(dg[1, fr, :, tok], w_ih1.t()).to(dtype).float() + rec[0]
        dg[0, fr, :, tok], dc[0] = _cell_backward(act[0, fr, :, tok], cseq[0, fr, :, tok],
                                                  prev[0], dc[0], dh0)
        rec[0] = torch.matmul(dg[0, fr, :, tok], w_hh[0].t()).to(dtype).float()
    return dg, torch.stack(rec), torch.stack(dc)


class TokenLSTM(nn.Module):
    """(T, B, H, W, C) -> (h_seq (T, B, H, W, C) in the compute dtype,
    carry): a ``num_layers``-layer LSTM scanned over the H*W tokens of each
    frame. The carry is (h, c), each (num_layers, B, hidden) fp32."""

    rows_replicated = True  # every spatial rank runs it on the whole map

    def __init__(self, hidden: int, num_layers: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden, self.num_layers, self.dtype = hidden, num_layers, dtype
        for layer in range(num_layers):
            self.register_parameter(f"l{layer}_w_ih", nn.Parameter(torch.empty(hidden, 4 * hidden)))
            self.register_parameter(f"l{layer}_w_hh", nn.Parameter(torch.empty(hidden, 4 * hidden)))
            self.register_parameter(f"l{layer}_bias", nn.Parameter(torch.empty(4 * hidden)))

    def init_param(self, name: str, t: torch.Tensor, g: torch.Generator) -> None:
        """xavier-uniform input weights, orthogonal recurrent weights,
        forget-gate bias 1."""
        if name.endswith("_w_ih"):
            nn.init.xavier_uniform_(t, generator=g)
        elif name.endswith("_w_hh"):
            nn.init.orthogonal_(t, generator=g)
        else:
            t.zero_()
            t[self.hidden : 2 * self.hidden] = 1.0

    def forward(self, x_t: torch.Tensor, state: tuple | None = None, rows: int | None = None):
        """``rows``: the global rows of ``x_t`` under spatial parallelism."""
        if current_spatial_group() is not None:
            h_seq, carry = self._scan(gather_rows(x_t, rows), state)
            return shard_rows(h_seq, rows), carry
        return self._scan(x_t, state)

    def _scan(self, x_t: torch.Tensor, state: tuple | None):
        try:
            x_t = full_channels(x_t, self.hidden)  # a channel shard is gathered whole
        except ValueError:
            raise ValueError(
                f"TokenLSTM expects input dim {self.hidden}, got {x_t.shape[-1]}") from None
        t, b, h, w, c = x_t.shape
        units = self.l0_bias.shape[0] // 4  # this rank's share of the hidden units
        if state is None:
            zeros = torch.zeros((self.num_layers, b, units), dtype=torch.float32,
                                device=x_t.device)
            state = (zeros, zeros)
        layers = range(self.num_layers)
        w_ih = [getattr(self, f"l{n}_w_ih").to(self.dtype) for n in layers]
        w_hh = [getattr(self, f"l{n}_w_hh").to(self.dtype) for n in layers]
        bias = [getattr(self, f"l{n}_bias") for n in layers]

        tokens = x_t.reshape(t, b, h * w, c).float()
        # The first layer's input products do not depend on the recurrence:
        # one (T*B*H*W, C) product for all tokens instead of one per token.
        x_gates0 = torch.matmul(tokens.to(self.dtype).float(), w_ih[0].float())
        fused = (units == self.hidden and self.num_layers == 2
                 and (x_t.device.type != "cuda" or self.dtype == torch.bfloat16))
        if not fused:
            if x_t.device.type == "cuda":
                profiling.count("token_lstm.plain_scans")
            y, h_fin, c_fin = token_lstm_forward_reference(x_gates0, w_ih, w_hh, bias, *state)
        else:
            from ..kernels import ops
            from ..kernels.token_lstm import TokenLSTMScan

            args = (x_gates0, w_hh[0], w_ih[1], w_hh[1], bias[0], bias[1],
                    state[0].contiguous(), state[1].contiguous())
            if needs_grad(*args):
                y, h_fin, c_fin = TokenLSTMScan.apply(*args)
            else:
                y, h_fin, c_fin = ops.token_lstm_fwd(*args)
        return y.reshape(t, b, h, w, units), (h_fin, c_fin)
