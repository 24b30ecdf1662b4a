"""Temporal U-Net: spiking encoder over time, recurrent bottleneck, decoder.

The encoder fuses P4/P5 by concatenation at matching scales, the
bottleneck (ConvLSTM, a token LSTM over the flattened map, or a spiking
block whose membrane is the recurrence) carries state across frames, and
the decoder upsamples with skip connections and 1x1-projects back to the
feature widths.

By default the decoder runs once on the final timestep and reads each
encoder block's continuous membrane readout. ``all_steps=True`` runs it
on every timestep's per-step readouts folded to one (T*B) batch: per-step
maps, same math as T chained single-step calls.

Under spatial parallelism ``rows`` gives the global rows of p3; p4, p5
and the encoder's maps have ``ceil`` halvings of it, the bottleneck
``ceil(p5 / 2)``, and the decoder doubles that (:meth:`decoder_rows`).
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import full_channels
from ..utils.profiling import span
from .convlstm import ConvLSTM2d
from .layers import (
    ConvBlock,
    Conv1x1,
    SpikingConvBlock,
    SpikingDownBlock,
    UpBlock,
    membrane_readout,
    out_rows,
)
from .lif import LIFParams
from .token_lstm import TokenLSTM


class TemporalUNet(nn.Module):
    """(p3, p4, p5) spike trains (each (T, B, h, w, c)) -> refined maps
    (B, h, w, c) — or (T*B, h, w, c) with ``all_steps`` — plus state."""

    def __init__(self, lif: LIFParams, feat_channels: tuple[int, int, int],
                 base: int = 128, bottleneck: str = "convlstm",
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if bottleneck not in ("convlstm", "lstm", "lif"):
            raise ValueError(f"unknown bottleneck '{bottleneck}'")
        self.lif, self.bottleneck_kind, self.dtype = lif, bottleneck, dtype
        ch_p3, ch_p4, ch_p5 = feat_channels
        c1, c2, c3, c4 = base, base * 2, base * 4, base * 8
        self.widths = {"p4": ch_p4, "p5": ch_p5, "d1": c2, "d2": c3}
        self.enc1 = SpikingConvBlock(ch_p3, c1, lif, dtype=dtype)
        self.down1 = SpikingDownBlock(c1, c2, lif, dtype=dtype)
        self.enc2 = SpikingConvBlock(c2 + ch_p4, c2, lif, dtype=dtype)
        self.down2 = SpikingDownBlock(c2, c3, lif, dtype=dtype)
        self.enc3 = SpikingConvBlock(c3 + ch_p5, c3, lif, dtype=dtype)
        self.down3 = SpikingDownBlock(c3, c4, lif, dtype=dtype)
        if bottleneck == "convlstm":
            self.bottleneck = ConvLSTM2d(c4, c4, dtype=dtype)
        elif bottleneck == "lstm":
            self.bottleneck = TokenLSTM(c4, dtype=dtype)
        else:
            self.bottleneck = SpikingConvBlock(c4, c4, lif, dtype=dtype)
        self.bottleneck_conv = ConvBlock(c4, c4, dtype=dtype)
        self.up1 = UpBlock(c4, c3, c3, dtype=dtype)
        self.up2 = UpBlock(c3, c2, c2, dtype=dtype)
        self.up3 = UpBlock(c2, c1, c1, dtype=dtype)
        self.out_p3 = Conv1x1(c1, ch_p3, dtype=dtype)
        self.out_p4 = Conv1x1(c2, ch_p4, dtype=dtype)
        self.out_p5 = Conv1x1(c3, ch_p5, dtype=dtype)

    @staticmethod
    def decoder_rows(rows: int | None) -> tuple:
        """Global rows of (p3, p4, p5, bottleneck, up1, up2, up3) for a p3
        of ``rows`` rows (all None without rows)."""
        if rows is None:
            return (None,) * 7
        r4 = out_rows(rows, 2)
        r5 = out_rows(r4, 2)
        r6 = out_rows(r5, 2)
        return rows, r4, r5, r6, 2 * r6, 4 * r6, 8 * r6

    def forward(self, feats: tuple, state: dict | None = None, all_steps: bool = False,
                state_only: bool = False, rows: int | None = None):
        """``state_only`` stops after the recurrent part (encoder and
        bottleneck) and returns (None, state): the decoder reads the state
        but never writes it, so a chunk whose maps nobody needs skips it.
        ``rows``: the global rows of p3 under spatial parallelism."""
        p3, p4, p5 = feats
        state = state or {}
        new_state: dict = {}
        t, b = p3.shape[:2]
        r3, r4, r5, r6, ru1, ru2, _ = self.decoder_rows(rows)

        x1, new_state["enc1"], *o1 = self.enc1(p3, state.get("enc1"), with_readouts=all_steps,
                                               rows=r3)
        d1, new_state["down1"] = self.down1(x1, state.get("down1"), rows=r3)
        x2, new_state["enc2"], *o2 = self.enc2(
            self._concat(d1, "d1", p4, "p4"), state.get("enc2"), with_readouts=all_steps, rows=r4
        )
        d2, new_state["down2"] = self.down2(x2, state.get("down2"), rows=r4)
        x3, new_state["enc3"], *o3 = self.enc3(
            self._concat(d2, "d2", p5, "p5"), state.get("enc3"), with_readouts=all_steps, rows=r5
        )
        d3, new_state["down3"] = self.down3(x3, state.get("down3"), rows=r5)

        with span("model.bottleneck"):
            if self.bottleneck_kind in ("convlstm", "lstm"):
                bott_seq, new_state["bottleneck"] = self.bottleneck(
                    d3, state.get("bottleneck"), rows=r6)
            else:  # "lif": membrane potential is the recurrence
                spikes, v_final, *rb = self.bottleneck(
                    d3, state.get("bottleneck"), with_readouts=all_steps, rows=r6
                )
                new_state["bottleneck"] = v_final
                bott_seq = None if all_steps else membrane_readout(spikes, v_final, self.lif)

        if state_only:
            return None, new_state
        if all_steps:
            if self.bottleneck_kind in ("convlstm", "lstm"):
                bott = bott_seq.reshape((t * b,) + tuple(bott_seq.shape[2:]))
            else:
                bott = rb[0]  # already (T*B, h, w, c4)
            skip3, skip2, skip1 = (o3[0].to(self.dtype), o2[0].to(self.dtype),
                                   o1[0].to(self.dtype))
        else:
            bott = bott_seq if bott_seq.ndim == 4 else bott_seq[-1]
            skip3 = self._readout(x3, new_state["enc3"])
            skip2 = self._readout(x2, new_state["enc2"])
            skip1 = self._readout(x1, new_state["enc1"])

        bott = self.bottleneck_conv(bott.to(self.dtype), rows=r6)
        u1 = self.up1(bott, skip3, rows=r6, skip_rows=r5)
        u2 = self.up2(u1, skip2, rows=ru1, skip_rows=r4)
        u3 = self.up3(u2, skip1, rows=ru2, skip_rows=r3)
        return (self.out_p3(u3), self.out_p4(u2), self.out_p5(u1)), new_state

    def _concat(self, a, a_name: str, b, b_name: str) -> torch.Tensor:
        """[a, b] on the channel axis, each gathered whole first under
        tensor parallelism (global channel order)."""
        return torch.cat([full_channels(a, self.widths[a_name]),
                          full_channels(b, self.widths[b_name])], -1)

    def _readout(self, spikes_t: torch.Tensor, v_final: torch.Tensor) -> torch.Tensor:
        return membrane_readout(spikes_t.float(), v_final, self.lif).to(self.dtype)
