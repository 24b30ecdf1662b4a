"""The layer check: every layer of a forward that the timed path ran,
recomputed by the frozen reference from the inputs that layer received.

Why layer by layer: the detector is a chain of 20 spiking blocks, and a
spike is a threshold. A rounding anywhere flips the spikes nearest the
threshold, each flip moves the next block's currents by a whole weight,
and the flips grow three- to fivefold a block: a relative perturbation of
1e-6 of the conv operands flips 7% of the deepest block's spikes, and bf16
or float8 operands flip a fifth of them alike. The end-to-end outputs of
two precisions therefore differ by about the same amount, and only a
comparison that starts every layer from the same input tells a sound bf16
program from a lower precision.
The first block reads the frames themselves (the start); what lies between
the layers (readouts, concatenations, space-to-depth) is not recomputed
here (PERF.md).

A record is ``(name, kind, args, out)`` in the reference's layout (NCHW;
sequences (T, B, C, H, W); the head's maps (B, h, w, ch)):

- ``spiking``: args (x_t, v0 or None), out (spikes, v_final);
- ``convlstm`` / ``lstm``: args (x_t, carry or None), out the h sequence;
- ``conv_block`` / ``conv1x1``: args (x,);
- ``up``: args (x, skip);
- ``head``: args (the three refined maps,), out the three raw maps.

Numbers: ``spike_flips``, the largest share of a spiking block's spikes
that differ from the reference's; ``layer_gap``, the largest normwise
relative gap ``|out - ref| / |ref|`` of any other layer.

The backward (train cells): a spiking block's gradient record is
``(name, (g_spikes, g_v_final))``, the gradients that reached its outputs,
and ``g_x``, the gradient it passed to its input (the program's conv and
A3 backward). The reference recomputes the block's vector-Jacobian
product from the block's own input and those output gradients;
``grad_layer_gap`` is the largest normwise relative gap of ``g_x``. The
first block's input is the frames, which take no gradient.
"""

from __future__ import annotations

import warnings

import torch

from .reference import model as ref

# The program's modules the check hooks, by their names under the detector
# (all spiking blocks are found by their parameters).
CONTINUOUS = {
    "unet.bottleneck": None,  # the configuration's bottleneck kind
    "unet.bottleneck_conv": "conv_block",
    "unet.up1": "up", "unet.up2": "up", "unet.up3": "up",
    "unet.out_p3": "conv1x1", "unet.out_p4": "conv1x1", "unet.out_p5": "conv1x1",
    "head": "head",
}


def spiking_names(params: dict) -> list[str]:
    """Names of the spiking blocks: the layers with a 3x3 kernel and a
    GroupNorm whose outputs are spikes (backbone and U-Net encoder)."""
    return [k[: -len(".weight")] for k in params
            if k.endswith(".weight") and (k.startswith("backbone.") or k.startswith("unet.enc")
                                          or k.startswith("unet.down"))]


def _seq(x):  # (T, B, H, W, C) -> (T, B, C, H, W)
    return x.permute(0, 1, 4, 2, 3)


def _img(x):  # (B, H, W, C) -> (B, C, H, W)
    return x.permute(0, 3, 1, 2)


def from_program(name: str, kind: str, args: tuple, out):
    """A record from a program module's forward hook (NHWC tensors)."""
    if kind == "spiking":
        v0 = args[1] if len(args) > 1 else None
        return (name, kind, (_seq(args[0]), None if v0 is None else _img(v0)),
                (_seq(out[0]), _img(out[1])))
    if kind == "convlstm":
        carry = args[1] if len(args) > 1 else None
        if carry is not None:
            carry = tuple(_img(c) for c in carry)
        return (name, kind, (_seq(args[0]), carry), _seq(out[0]))
    if kind == "lstm":
        carry = args[1] if len(args) > 1 else None
        return (name, kind, (_seq(args[0]), carry), _seq(out[0]))
    if kind == "head":
        return (name, kind, ([_img(f) for f in args[0]],), list(out))
    return (name, kind, tuple(_img(a) for a in args), _img(out))


def _recompute(params, rec_, shape, num):
    name, kind, args, _ = rec_
    f = lambda t: None if t is None else t.float()  # noqa: E731
    if kind == "spiking":
        x, v0 = args
        return ref.spiking_block(params, name, f(x), f(v0), shape, num, _stride(rec_))[0]
    if kind == "convlstm":
        carry = None if args[1] is None else tuple(f(c) for c in args[1])
        return ref.convlstm(params, f(args[0]), carry, num)[0]
    if kind == "lstm":
        carry = None if args[1] is None else tuple(f(c) for c in args[1])
        return ref.token_lstm(params, f(args[0]), carry, num)[0]
    if kind == "conv_block":
        return ref.conv_block(params, name, f(args[0]), num)
    if kind == "conv1x1":
        return ref.conv1x1(params, name, f(args[0]), num)
    if kind == "up":
        return ref.up_block(params, name, f(args[0]), f(args[1]), num)
    if kind == "head":
        return ref.head(params, [f(x) for x in args[0]], num)
    raise ValueError(f"unknown layer kind {kind!r}")


def _stride(rec_) -> int:
    """A spiking record's stride: rows in over rows out."""
    return -(-rec_[2][0].shape[3] // rec_[3][0].shape[3])


def block_vjp(params, rec_, g_out, shape, num, chunk: int = 4) -> torch.Tensor:
    """The reference's gradient of a spiking block's input ``x_t`` (T, B,
    C, H, W) for the output gradients ``g_out`` = (g_spikes, g_v_final or
    None), recomputed from the block's own input in blocks of ``chunk``
    windows (the block is independent across windows)."""
    name, _, (x, v0), _ = rec_
    out = []
    for i in range(0, x.shape[1], chunk):
        xi = x[:, i:i + chunk].float().requires_grad_(True)
        vi = None if v0 is None else v0[i:i + chunk].float()
        with torch.enable_grad():
            s, v = ref.spiking_block(params, name, xi, vi, shape, num, _stride(rec_))
            outs, grads = [s], [g_out[0][:, i:i + chunk].float()]
            if g_out[1] is not None:
                outs.append(v)
                grads.append(g_out[1][i:i + chunk].float())
            (g,) = torch.autograd.grad(outs, [xi], grads)
        out.append(g)
    return torch.cat(out, 1)


def _move(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_move(o, device) for o in obj)
    return obj


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))


@torch.no_grad()
def numbers(records, params: dict, shape, device, num=ref.F32) -> dict:
    """``{"spike_flips", "layer_gap"}`` over the records, each recomputed
    on ``device`` in float32 with TF32 off."""
    flips, gap = 0.0, 0.0
    with ref.strict_fp32():
        for rec_ in records:
            rec_ = _move(rec_, device)
            want = _recompute(params, rec_, shape, num)
            got = rec_[3]
            if rec_[1] == "spiking":
                flips = max(flips, float((got[0].float() != want).float().mean()))
                continue
            got, want = (got, want) if isinstance(got, list) else ([got], [want])
            for g, w in zip(got, want):
                gap = max(gap, rel_gap(g, w))
    return {"spike_flips": flips, "layer_gap": gap}


def grad_numbers(records, grads: dict, params: dict, shape, device, num=ref.F32) -> dict:
    """``{"grad_layer_gap"}``: the largest normwise relative gap of a
    spiking block's input gradient ``grads[name] = (g_out, g_x)`` against
    the reference's VJP (float32, TF32 off), over the blocks whose input
    takes a gradient."""
    gap = None
    with ref.strict_fp32():
        for rec_ in records:
            if rec_[1] != "spiking" or grads.get(rec_[0], (None, None))[1] is None:
                continue
            g_out, g_x = _move(grads[rec_[0]], device)
            want = block_vjp(params, _move(rec_, device), g_out, shape, num)
            gap = max(gap or 0.0, rel_gap(g_x, want))
    return {"grad_layer_gap": float("inf") if gap is None else gap}


class Capture:
    """Forward hooks on the program's layers that record what each
    received and returned while ``armed`` (records in the reference's
    layout, views of the program's tensors). With ``backward``, full
    backward hooks on the spiking blocks record ``grads[name] =
    ((g_spikes, g_v_final), g_x)`` of the armed pass's backward."""

    def __init__(self, module, params: dict, bottleneck: str, backward=False):
        self.armed, self.records, self.grads = False, [], {}
        spiking = spiking_names(params)
        kinds = {n: "spiking" for n in spiking}
        kinds.update({n: k or bottleneck for n, k in CONTINUOUS.items()})
        mods = dict(module.named_modules())
        self._hooks = [mods[n].register_forward_hook(self._hook(n, k)) for n, k in kinds.items()]
        if backward:  # the first block's input, the frames, takes no gradient
            warnings.filterwarnings("ignore", message="Full backward hook is firing")
            self._hooks += [mods[n].register_full_backward_hook(self._grad_hook(n))
                            for n in spiking]

    def _hook(self, name, kind):
        def hook(mod, args, out):
            if self.armed:
                rec_ = from_program(name, kind, tuple(a.detach() if isinstance(a, torch.Tensor)
                                                      else a for a in args), out)
                self.records.append(rec_)
        return hook

    def _grad_hook(self, name):
        def hook(mod, grad_input, grad_output):
            if name in self.grads or not any(r[0] == name for r in self.records):
                return
            g_v = grad_output[1] if len(grad_output) > 1 else None
            self.grads[name] = ((_seq(grad_output[0]), None if g_v is None else _img(g_v)),
                                None if grad_input[0] is None else _seq(grad_input[0]))
        return hook

    def remove(self):
        for h in self._hooks:
            h.remove()
