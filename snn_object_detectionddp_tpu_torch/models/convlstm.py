"""2D convolutional LSTM over a (T, B, H, W, C) time-major input.

One gate conv over [x; h] producing 4*hidden gates in the order
(i, f, g, o). The conv is linear in [x; h], so it is split: the input half
conv(x, W[:, :in]) runs once over all T steps as one (T*B) batch, and only
the hidden half conv(h, W[:, in:]) runs per step — same parameter tensor
and math as one concat-conv. Convs run in the compute dtype; gate math and
the (h, c) state are fp32.

Under tensor parallelism the gate conv's output channels are permuted when
sharded (parallel/mesh.py::tp_shard_leaf), so a rank holds i, f, g and o
of its own slice of the hidden channels: the gate math is local and ``h``
and ``c`` stay channel-sharded; the hidden half's conv reads ``h``
gathered whole.

Under spatial parallelism ``x_t``, ``h`` and ``c`` hold this rank's rows;
both halves of the gate conv fetch their halo rows (the hidden half at
every step), and the gate math is per pixel.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import CONV_OUT, conv2d_nhwc


class ConvLSTM2d(nn.Module):
    """Returns (h_t (T, B, H, W, hidden) fp32, (h_final, c_final))."""

    def __init__(self, in_ch: int, hidden: int, kernel: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_ch, self.hidden, self.dtype = in_ch, hidden, dtype
        # OIHW, kept whole: input channels [0, in_ch) then hidden channels.
        self.gates_kernel = nn.Parameter(
            torch.empty(4 * hidden, in_ch + hidden, kernel, kernel)
        )
        self.gates_bias = nn.Parameter(torch.empty(4 * hidden))

    def init_param(self, name: str, t: torch.Tensor, g: torch.Generator) -> None:
        if name == "gates_kernel":
            nn.init.xavier_uniform_(t, generator=g)
        else:
            # Forget-gate bias 1 (gate order i, f, g, o).
            t.zero_()
            t[self.hidden : 2 * self.hidden] = 1.0

    def forward(self, x_t: torch.Tensor, state: tuple | None = None, rows: int | None = None):
        """``rows``: the global rows of ``x_t`` under spatial parallelism."""
        t, b, h, w, c = x_t.shape
        in_ch = self.in_ch
        hidden = self.gates_bias.shape[0] // 4  # this rank's share of the hidden channels
        if state is None:
            zeros = torch.zeros((b, h, w, hidden), dtype=torch.float32, device=x_t.device)
            state = (zeros, zeros)
        xb = x_t.reshape(t * b, h, w, c).to(self.dtype)
        x_gates = conv2d_nhwc(xb, self.gates_kernel[:, :in_ch], name=CONV_OUT, rows=rows)
        x_gates = x_gates.view(t, b, h, w, 4 * hidden)
        k_h = self.gates_kernel[:, in_ch:]
        h_state, c_state = state
        h_seq = []
        for step in range(t):
            # the hidden half's fp32 result feeds the fp32 gate sum unrounded;
            # the input half was stored in the compute dtype (x_gates)
            h_gates = conv2d_nhwc(h_state.to(self.dtype), k_h, f32_result=True, rows=rows)
            gates = x_gates[step].float() + h_gates.float() + self.gates_bias
            i, f, g, o = gates.chunk(4, -1)
            c_state = torch.sigmoid(f) * c_state + torch.sigmoid(i) * torch.tanh(g)
            h_state = torch.sigmoid(o) * torch.tanh(c_state)
            h_seq.append(h_state)
        return torch.stack(h_seq), (h_state, c_state)
