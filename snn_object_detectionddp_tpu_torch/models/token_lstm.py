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
"""

from __future__ import annotations

import torch
from torch import nn


def _dot_f32(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``dtype`` and an fp32 result."""
    return torch.matmul(x.to(dtype).float(), w.to(dtype).float())


class TokenLSTM(nn.Module):
    """(T, B, H, W, C) -> (h_seq (T, B, H, W, C) in the compute dtype,
    carry): a ``num_layers``-layer LSTM scanned over the H*W tokens of each
    frame. The carry is (h, c), each (num_layers, B, hidden) fp32."""

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

    def forward(self, x_t: torch.Tensor, state: tuple | None = None):
        t, b, h, w, c = x_t.shape
        if c != self.hidden:
            raise ValueError(f"TokenLSTM expects input dim {self.hidden}, got {c}")
        if state is None:
            zeros = torch.zeros((self.num_layers, b, self.hidden), dtype=torch.float32,
                                device=x_t.device)
            state = (zeros, zeros)
        h_all, c_all = list(state[0].unbind(0)), list(state[1].unbind(0))
        w_ih = [getattr(self, f"l{n}_w_ih").to(self.dtype).float() for n in range(self.num_layers)]
        w_hh = [getattr(self, f"l{n}_w_hh").to(self.dtype).float() for n in range(self.num_layers)]
        bias = [getattr(self, f"l{n}_bias") for n in range(self.num_layers)]

        tokens = x_t.reshape(t, b, h * w, c).float()
        # The first layer's input products do not depend on the recurrence:
        # one (T*B*H*W, C) product for all tokens instead of one per token.
        x_gates0 = torch.matmul(tokens.to(self.dtype).float(), w_ih[0])
        frames = []
        for frame in range(t):
            outs = []
            for tok in range(h * w):
                inp = None
                for layer in range(self.num_layers):
                    x_gates = (x_gates0[frame, :, tok] if layer == 0
                               else torch.matmul(inp.to(self.dtype).float(), w_ih[layer]))
                    gates = (x_gates
                             + torch.matmul(h_all[layer].to(self.dtype).float(), w_hh[layer])
                             + bias[layer])
                    i, f, g, o = gates.chunk(4, -1)
                    c_all[layer] = torch.sigmoid(f) * c_all[layer] + torch.sigmoid(i) * torch.tanh(g)
                    h_all[layer] = torch.sigmoid(o) * torch.tanh(c_all[layer])
                    inp = h_all[layer]
                outs.append(inp)
            frames.append(torch.stack(outs, 1).reshape(b, h, w, self.hidden))
        return torch.stack(frames).to(self.dtype), (torch.stack(h_all), torch.stack(c_all))
