"""The token-LSTM scan as operators (kernels/ops.py: ``token_lstm_fwd``,
``token_lstm_fwd_res``, ``token_lstm_bwd``) and their plain versions
(models/token_lstm.py).

On the CPU the operators run the plain versions:

- the module's forward through the operators equals the loop it replaced
  (copied below as ``_old_scan``) bit for bit, in fp32 and bf16, with a
  carried state, at hidden 32 and odd B / H / W;
- ``token_lstm_backward_reference`` (through the module's autograd
  Function) against ``torch.autograd`` through the loop, for x, every
  weight, the biases, h0 and c0;
- the module's fp32 gradients against ``jax.grad`` of the flax TokenLSTM;
- ``opcheck`` and the fake implementations; a ``bottleneck: lstm``
  detector exported with ``torch.export``; the routes a scan takes.

Marked ``cuda`` (skipped without a card; this file imports no JAX at the
top, so on a card machine it runs with
``python -m pytest tests/test_torch_token_lstm_kernel.py -m cuda --noconftest -q``):
the kernels against the plain versions at the training cell's shape (T=5,
B=16, 8x10 tokens, hidden 1024) and serving's (T=1, B=1 and 16), forward
and every gradient; a planted fault (the plain version without the bf16
rounding of h) outside the tolerances; two launches bitwise equal; the
launch counts.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from snn_object_detectionddp_tpu_torch.kernels import ops
from snn_object_detectionddp_tpu_torch.kernels import token_lstm as KT
from snn_object_detectionddp_tpu_torch.models.token_lstm import (
    TokenLSTM,
    token_lstm_backward_reference,
    token_lstm_forward_reference,
)
from snn_object_detectionddp_tpu_torch.utils import profiling

HIDDEN = 32
SHAPE = (2, 3, 3, 5, HIDDEN)  # (T, B, H, W, C): odd B, H, W


@pytest.fixture(autouse=True)
def one_thread():
    """Compare on one thread: the CPU's sums do not depend on a pool's split."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _module(dtype, seed=0, hidden=HIDDEN):
    mod = TokenLSTM(hidden, dtype=dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            mod.init_param(name, p.data, g)
            p.add_(0.05 * torch.randn(p.shape, generator=g))  # no bias left at 0/1
    return mod


def _inputs(seed=1, shape=SHAPE):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    state = tuple(0.5 * torch.randn(2, shape[1], shape[-1], generator=g) for _ in range(2))
    return x, state


def _old_scan(mod, x_t, state):
    """models/token_lstm.py::TokenLSTM._scan as it was before the operators
    (off a tensor mesh): the loop the plain version must keep."""
    t, b, h, w, c = x_t.shape
    h_all, c_all = list(state[0].unbind(0)), list(state[1].unbind(0))
    h_full = list(h_all)
    w_ih = [getattr(mod, f"l{n}_w_ih").to(mod.dtype).float() for n in range(2)]
    w_hh = [getattr(mod, f"l{n}_w_hh").to(mod.dtype).float() for n in range(2)]
    bias = [getattr(mod, f"l{n}_bias") for n in range(2)]
    tokens = x_t.reshape(t, b, h * w, c).float()
    x_gates0 = torch.matmul(tokens.to(mod.dtype).float(), w_ih[0])
    frames = []
    for frame in range(t):
        outs = []
        for tok in range(h * w):
            inp = None
            for layer in range(2):
                x_gates = (x_gates0[frame, :, tok] if layer == 0
                           else torch.matmul(inp.to(mod.dtype).float(), w_ih[layer]))
                gates = (x_gates
                         + torch.matmul(h_full[layer].to(mod.dtype).float(), w_hh[layer])
                         + bias[layer])
                i, f, g, o = gates.chunk(4, -1)
                c_all[layer] = torch.sigmoid(f) * c_all[layer] + torch.sigmoid(i) * torch.tanh(g)
                h_all[layer] = torch.sigmoid(o) * torch.tanh(c_all[layer])
                h_full[layer] = h_all[layer]
                inp = h_full[layer]
            outs.append(h_all[layer])
        frames.append(torch.stack(outs, 1).reshape(b, h, w, c))
    return torch.stack(frames).to(mod.dtype), (torch.stack(h_all), torch.stack(c_all))


def _rel(got, want) -> float:
    """Normwise relative gap ||got - want|| / ||want||, in fp64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_through_the_operator_equals_the_loop_bitwise(dtype):
    mod = _module(dtype)
    x1, state = _inputs()
    x2, _ = _inputs(seed=2)
    got_state, old_state = state, state
    with torch.no_grad():
        for x in (x1, x2):  # the carry passed from one call to the next
            y, got_state = mod(x, got_state)
            y_old, old_state = _old_scan(mod, x, old_state)
            assert y.dtype == dtype and y.shape == SHAPE
            assert torch.equal(y, y_old)
            for a, b in zip(got_state, old_state):
                assert a.dtype == torch.float32 and torch.equal(a, b)


# Tolerances of the gradients against autograd through the loop (every
# leaf, normwise; readings over seeds 0-2 at SHAPE):
# - f32: the same arithmetic, summed in another order (the weight and bias
#   gradients in one product over all tokens where autograd adds per-token
#   products one by one): 0.6e-7 to 2.1e-7 read; 2e-6.
# - bf16: both sides round at the same places (each recurrent product's
#   gradient, the layer-1 input's, each weight's once after its sum); a
#   sum in another order can land a value on the other side of a bf16
#   rounding boundary (2^-8 relative): up to 1.5e-4 read (one weight
#   gradient's flips). Dropping the rounding of the recurrent gradients
#   (the planted fault) moves the leaves by 1.6e-3 to 1.9e-3 at their
#   largest: 5e-4 lies between, 3x from each.
GRAD_RTOL = {torch.float32: 2e-6, torch.bfloat16: 5e-4}


def _grads_via_module(mod, x, state, cot):
    x = x.clone().requires_grad_(True)
    st = tuple(s.clone().requires_grad_(True) for s in state)
    y, (h, c) = mod(x, st)
    loss = (y.float() * cot[0]).sum() + (h * cot[1]).sum() + (c * cot[2]).sum()
    return torch.autograd.grad(loss, [x, *st, *mod.parameters()])


def _grads_via_loop(mod, x, state, cot):
    x = x.clone().requires_grad_(True)
    st = tuple(s.clone().requires_grad_(True) for s in state)
    y, (h, c) = _old_scan(mod, x, st)
    loss = (y.float() * cot[0]).sum() + (h * cot[1]).sum() + (c * cot[2]).sum()
    return torch.autograd.grad(loss, [x, *st, *mod.parameters()])


def _cotangents(shape=SHAPE, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g), torch.randn(2, shape[1], shape[-1], generator=g),
            torch.randn(2, shape[1], shape[-1], generator=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_reference_equals_autograd_through_the_loop(dtype):
    mod = _module(dtype)
    x, state = _inputs()
    cot = _cotangents()
    names = ["x", "h0", "c0", *(n for n, _ in mod.named_parameters())]
    got = _grads_via_module(mod, x, state, cot)
    want = _grads_via_loop(mod, x, state, cot)
    for name, a, b in zip(names, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _rel(a, b) < GRAD_RTOL[dtype], (name, _rel(a, b))


def test_backward_reference_keeps_each_bf16_rounding():
    """The planted fault: the reverse scan with its recurrent products'
    gradients left in fp32 (a dropped ``.to(bf16)``) falls outside the
    bf16 tolerance that the true reference meets."""
    mod = _module(torch.bfloat16)
    x, state = _inputs()
    cot = _cotangents()
    want = _grads_via_loop(mod, x, state, cot)
    got = _grads_via_module(mod, x, state, cot)

    def unrounded(act, cseq, c0, w_hh0, w_ih1, w_hh1, dy, g_hfin, g_cfin):
        return token_lstm_backward_reference(act, cseq, c0, w_hh0.float(), w_ih1.float(),
                                             w_hh1.float(), dy, g_hfin, g_cfin)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "token_lstm_backward_reference", unrounded)
        faulty = _grads_via_module(mod, x, state, cot)
    gap = max(_rel(a, b) for a, b in zip(got, want))
    fault = max(_rel(a, b) for a, b in zip(faulty, want))
    assert gap < GRAD_RTOL[torch.bfloat16] < fault, (gap, fault)


def test_module_gradients_match_jax_grad_in_f32():
    """fp32: the same recurrence and its gradient; XLA and PyTorch sum in
    another order, and 2 x 15 chained tokens carry that: normwise 1e-5."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from snn_object_detectionddp_tpu.models.token_lstm import TokenLSTM as JTokenLSTM

    mod = _module(torch.float32)
    x, state = _inputs()
    cot = _cotangents()
    params = {n: p.detach() for n, p in mod.named_parameters()}
    jmod = JTokenLSTM(HIDDEN, dtype=jnp.float32)
    jtree = {n: jnp.asarray(v.numpy()) for n, v in params.items()}
    jcot = [jnp.asarray(c.numpy()) for c in cot]

    def loss(tree, xj, h0, c0):
        y, (h, c) = jmod.apply({"params": tree}, xj, (h0, c0))
        return (y * jcot[0]).sum() + (h * jcot[1]).sum() + (c * jcot[2]).sum()

    jg = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        jtree, jnp.asarray(x.numpy()), *(jnp.asarray(s.numpy()) for s in state))
    got = _grads_via_module(mod, x, state, cot)
    names = [n for n, _ in mod.named_parameters()]
    want = [jg[1], jg[2], jg[3], *(jg[0][n] for n in names)]
    for name, a, b in zip(["x", "h0", "c0", *names], got, want):
        assert _rel(a, torch.from_numpy(np.array(b))) < 1e-5, name


def _op_args(dtype, t=2, b=3, n=7, hidden=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g)  # noqa: E731
    w = [r(hidden, 4 * hidden, scale=hidden ** -0.5).to(dtype) for _ in range(3)]
    fwd = (r(t, b, n, 4 * hidden), *w, r(4 * hidden, scale=0.1), r(4 * hidden, scale=0.1),
           r(2, b, hidden, scale=0.5), r(2, b, hidden, scale=0.5))
    _, _, _, act, cseq, _ = ops.token_lstm_fwd_res(*fwd)
    bwd = (act, cseq, fwd[7], *w, r(t, b, n, hidden).to(dtype), r(2, b, hidden), r(2, b, hidden))
    return {"token_lstm_fwd": fwd, "token_lstm_fwd_res": fwd, "token_lstm_bwd": bwd}


@pytest.mark.parametrize("name", KT.KERNELS)
def test_opcheck(name):
    torch.library.opcheck(getattr(ops, name), _op_args(torch.float32)[name])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", KT.KERNELS)
def test_fake_outputs_match_the_cpu_outputs(name, dtype):
    args = _op_args(dtype)[name]
    real = getattr(ops, name)(*args)
    with FakeTensorMode() as mode:
        fake = getattr(ops, name)(*[mode.from_tensor(a) for a in args])
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype, r.stride())


def test_residuals_are_what_the_reverse_scan_reads():
    """fwd_res's residuals are the loop's own values: the activations and c
    of every cell, each layer's recurrent operand (the initial h at the
    first token) and layer 0's output."""
    t, b, n, hidden = 2, 3, 4, 16
    args = _op_args(torch.bfloat16, t, b, n, hidden)["token_lstm_fwd"]
    y, h_fin, c_fin, act, cseq, hseq = ops.token_lstm_fwd_res(*args)
    assert (act.shape, cseq.shape, hseq.shape) == (
        (2, t, b, n, 4 * hidden), (2, t, b, n, hidden), (3, t, b, n, hidden))
    assert torch.equal(hseq[0, 0, :, 0], args[6][0].bfloat16())
    assert torch.equal(hseq[1, 0, :, 0], args[6][1].bfloat16())
    assert torch.equal(hseq[0, 0, :, 1], hseq[2, 0, :, 0])  # h0 of token 0 feeds token 1
    assert torch.equal(hseq[1, 1, :, 0], y[0, :, n - 1])  # across the frame boundary
    assert torch.equal(cseq[:, -1, :, -1], c_fin)
    assert torch.equal(act[0, 0, :, 0, 2 * hidden:3 * hidden].abs().le(1), torch.ones(b, hidden).bool())


def test_exported_lstm_detector_holds_one_scan_operator():
    """``bottleneck: lstm`` exports through the fake implementation: one
    ``snn_torch::token_lstm_fwd`` node a frame and no loop of sigmoids, and
    the program answers as the eager one does."""
    from snn_object_detectionddp_tpu_torch import config as tconfig
    from snn_object_detectionddp_tpu_torch.models.detector import Detector
    from snn_object_detectionddp_tpu_torch.utils.export import build_serving_fn

    cfg = tconfig.Config()
    cfg.model.num_classes, cfg.model.bottleneck = 2, "lstm"
    cfg.model.yolo_model_name, cfg.model.width_mult = "yolo11n.pt", 0.25
    cfg.model.hyp.reg_max, cfg.model.timesteps = 8, 2
    cfg.model.image_size = (64, 64)
    cfg.runtime.precision = "f32"
    det = Detector.from_config(cfg, device="cpu")
    fn = build_serving_fn(det, det.init_params(), conf=0.0)
    frames = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (1, 2, 64, 64, 3)).astype(np.uint8))
    program = torch.export.export(fn, (frames,), strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("snn_torch.token_lstm_fwd.default") == 1
    in_scan = [str(n.target) for n in program.graph.nodes if n.op == "call_function"
               and list(n.meta["nn_module_stack"].values())[-1][1].endswith(".TokenLSTM")]
    assert "snn_torch.token_lstm_fwd.default" in in_scan
    assert not [t for t in in_scan if t.startswith(("aten.sigmoid", "aten.tanh", "aten.stack"))]
    got, want = program.module()(frames), fn(frames)
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)


def test_a_scan_off_the_cpu_never_reaches_the_plain_version():
    """Off a tensor mesh the module goes to the operators on every device:
    a meta tensor (standing in for a card) reaches the fake implementation,
    forward and backward, never the plain versions, and counts no plain
    scan; the wrappers raise on a tensor off the card."""
    mod = _module(torch.bfloat16).to("meta")

    def refuse(*args, **kwargs):
        raise AssertionError("a meta tensor reached the plain version")

    before = profiling.counters()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("token_lstm_forward_reference", "token_lstm_backward_reference"):
            mp.setattr(ops, name, refuse)
        for grad in (False, True):
            x = torch.zeros(SHAPE, device="meta", requires_grad=grad)
            with torch.set_grad_enabled(grad):
                y, (h, c) = mod(x)
            assert y.is_meta and y.shape == SHAPE and h.shape == (2, SHAPE[1], HIDDEN)
            if grad:
                (gx,) = torch.autograd.grad(y.float().sum() + h.sum(), x)
                assert gx.is_meta and gx.shape == x.shape
    after = profiling.counters()
    assert after["token_lstm.plain_scans"] == before["token_lstm.plain_scans"]
    assert {k: after[f"{k}.launches"] for k in KT.KERNELS} == {
        k: before[f"{k}.launches"] for k in KT.KERNELS}
    args = _op_args(torch.bfloat16, hidden=16)["token_lstm_fwd"]
    for call in (KT.token_lstm_fwd, KT.token_lstm_fwd_res):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            call(*args)


def test_plan_takes_the_repos_hidden_sizes_and_raises_on_others():
    """Hidden 1024 (every preset at width 1), 256 (width 0.25) and the
    fixture's 32 fit: H/8 blocks, the weight slices in the 227 KB of
    shared memory an H100 block may have."""
    for hidden, blocks in ((1024, 128), (256, 32), (32, 4)):
        p = KT.plan(hidden, 16)
        assert p.blocks == blocks and p.threads == 512 and p.m_tiles == 1
        assert max(p.fwd_smem, p.bwd_smem) <= 232_448
    assert KT.plan(1024, 1024).fwd_smem == 229_376 and KT.plan(1024, 16).bwd_smem == 221_184
    assert KT.plan(64, 17).m_tiles == 2
    for bad in (0, 4, 1020):
        with pytest.raises(ValueError, match="multiple of 8"):
            KT.plan(bad, 1)


def test_counters_carry_the_scan_launches_and_the_plain_scans():
    snap = profiling.counters()
    for name in KT.KERNELS:
        assert f"{name}.launches" in snap
    assert "token_lstm.plain_scans" in snap
    assert set(KT.KERNELS) == {"token_lstm_fwd", "token_lstm_fwd_res", "token_lstm_bwd"}


def test_reference_residual_forward_is_the_plain_forward():
    args = _op_args(torch.bfloat16)["token_lstm_fwd"]
    plain = token_lstm_forward_reference(args[0], [None, args[2]], [args[1], args[3]],
                                         list(args[4:6]), *args[6:])
    res = ops.token_lstm_fwd_res(*args)
    for a, b in zip(plain, res[:3]):
        assert torch.equal(a, b)


# -- cell by cell: the check of a scan against its plain version ----------
#
# Run free, two scans that sum in another order drift apart: wherever an h
# lands within that of a bf16 rounding boundary the next product sees the
# neighbouring bf16 value, and the recurrence carries it on (at the
# training window the kernels and the plain loop part by ~3e-4, as a scan
# without the bf16 rounding of h does). So the scans are held to the plain
# version cell by cell instead: every cell recomputed from the operands the
# scan itself recorded (its residuals), which has no chain to carry a flip.


def _flat(seq):
    """(T, B, N, X) -> (B, T*N, X): each row's tokens in scan order."""
    t, b, n = seq.shape[:3]
    return seq.transpose(0, 1).reshape(b, t * n, -1)


def _unflat(flat, like):
    t, b, n = like.shape[:3]
    return flat.reshape(b, t, n, -1).transpose(0, 1)


def _prev(seq, first):
    """Each token's predecessor's value; ``first`` (B, X) at the first token."""
    f = _flat(seq)
    return _unflat(torch.cat([first[:, None].to(f.dtype), f[:, :-1]], 1), seq)


def _next(seq, last):
    """Each token's successor's value; ``last`` (B, X) at the last token."""
    f = _flat(seq)
    return _unflat(torch.cat([f[:, 1:], last[:, None].to(f.dtype)], 1), seq)


def _fp32_product(a, w):
    return torch.matmul(a.float(), w.float())


def _bf16_product(a, w):
    """The planted forward fault: a gate product rounded to bf16."""
    return torch.matmul(a.bfloat16(), w.bfloat16()).float()


def forward_step_gaps(fwd, out, product=_fp32_product) -> dict:
    """A forward with residuals held to the plain cell, cell by cell: the
    gate activations from the recorded operands (layer 0's recurrent h,
    layer 1's input and recurrent h), c from the recorded activations and
    the previous c, h from the recorded activations and c. ``exact``: the
    recorded operands, outputs and carry are each other's (each h the next
    token's operand, y layer 1's h, the carry the last cell's)."""
    xg0, w_hh0, w_ih1, w_hh1, b0, b1, h0, c0 = fwd
    y, h_fin, c_fin, act, cseq, hseq = out
    dt = w_hh0.dtype
    exact = (torch.equal(hseq[0], _prev(hseq[2], h0[0].to(dt)))
             and torch.equal(hseq[1], _prev(y, h0[1].to(dt)))
             and torch.equal(c_fin, cseq[:, -1, :, -1])
             and torch.equal(hseq[2][-1, :, -1], h_fin[0].to(dt))
             and torch.equal(y[-1, :, -1], h_fin[1].to(dt)))
    pre = (xg0 + product(hseq[0], w_hh0) + b0,
           product(hseq[2], w_ih1) + product(hseq[1], w_hh1) + b1)
    gaps = {"act": 0.0, "c": 0.0, "h_flips": 0.0, "exact": float(not exact)}
    for layer in range(2):
        i, f, g, o = pre[layer].chunk(4, -1)
        want = torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)], -1)
        si, sf, tg, so = act[layer].chunk(4, -1)
        c = sf * _prev(cseq[layer], c0[layer]) + si * tg
        h = so * torch.tanh(cseq[layer])
        recorded = hseq[2] if layer == 0 else y
        gaps["act"] = max(gaps["act"], _rel(act[layer], want))
        gaps["c"] = max(gaps["c"], _rel(cseq[layer], c))
        gaps["h_flips"] = max(gaps["h_flips"], float((h.to(dt) != recorded).float().mean()))
        gaps["c"] = max(gaps["c"], _rel(h_fin[layer], h[-1, :, -1]))
    return gaps


def backward_step_gaps(bwd, out, rounded=True) -> dict:
    """A reverse scan held to the plain cell, token by token: each token's
    dh from the scan's own gate gradients of the next token (each product
    rounded to the compute dtype alone, unless ``rounded`` is False: the
    planted fault), y's and the carry's gradients; the dc chain carried in
    fp32 from the final carry's gradient; the initial state's gradients."""
    from snn_object_detectionddp_tpu_torch.models.token_lstm import _cell_backward

    act, cseq, c0, w_hh0, w_ih1, w_hh1, dy, g_hfin, g_cfin = bwd
    dg, g_h0, g_c0 = out
    dt = w_hh0.dtype

    def prod(d, w):
        p = torch.matmul(d, w.float().t())
        return p.to(dt).float() if rounded else p

    p1, p2, p3 = prod(dg[1], w_hh1), prod(dg[1], w_ih1), prod(dg[0], w_hh0)
    dh = (_flat(p2 + _next(p3, g_hfin[0])), _flat(dy.float() + _next(p1, g_hfin[1])))
    a, c = [_flat(x) for x in act], [_flat(x) for x in cseq]
    c_prev = [_flat(_prev(cseq[layer], c0[layer])) for layer in range(2)]
    want = [torch.empty_like(x) for x in a]
    dc = list(g_cfin.unbind(0))
    for k in reversed(range(a[0].shape[1])):
        for layer in (1, 0):
            want[layer][:, k], dc[layer] = _cell_backward(
                a[layer][:, k], c[layer][:, k], c_prev[layer][:, k], dc[layer], dh[layer][:, k])
    g_h_want = torch.stack([prod(_flat(dg[0])[:, 0], w_hh0), prod(_flat(dg[1])[:, 0], w_hh1)])
    return {"dg": max(_rel(_flat(dg[layer]), want[layer]) for layer in range(2)),
            "g_state": max(_rel(g_h0, g_h_want), _rel(g_c0, torch.stack(dc)))}


def test_cell_by_cell_checks_separate_the_planted_faults():
    """The cell-by-cell checks on the plain versions themselves (the CPU's
    operators): the sound run reads about 0, the faults (a gate product
    rounded to bf16; the recurrent gradients left unrounded) 3x or more
    above the card's limits (act 4.5e-4, dg 9.5e-4 at hidden 32)."""
    args = _op_args(torch.bfloat16, t=2, b=3, n=7, hidden=32)["token_lstm_fwd"]
    out = ops.token_lstm_fwd_res(*args)
    g = torch.Generator().manual_seed(5)
    cot = (torch.randn(out[0].shape, generator=g).bfloat16(), torch.randn(out[1].shape, generator=g),
           torch.randn(out[2].shape, generator=g))
    bwd = (out[3], out[4], args[7], *args[1:4], *cot)
    back = ops.token_lstm_bwd(*bwd)
    sound = {**forward_step_gaps(args, out), **backward_step_gaps(bwd, back)}
    assert sound["exact"] == 0 and sound["h_flips"] == 0
    assert max(sound.values()) < 1e-6, sound
    fault = {**forward_step_gaps(args, out, _bf16_product), **backward_step_gaps(bwd, back, False)}
    for key in ("act", "dg"):
        assert fault[key] > 3 * CARD_RTOL[key], (key, fault[key])


# -- on the card -------------------------------------------------------------

# (T, B, N, H): the training cell's window (T=5, B=16, 8x10 tokens, hidden
# 1024), serving's frame alone and at a full dispatch, and two M tiles with
# odd sizes at the width-0.25 hidden.
CARD_SHAPES = [(5, 16, 80, 1024), (1, 1, 80, 1024), (1, 16, 80, 1024), (2, 19, 7, 256)]
# Cell by cell the kernels and the plain version differ only in the order
# of summation (the tensor cores' fp32 sums and the k-groups' partials
# against cuBLAS's fp32) and in expf / tanhf against PyTorch's sigmoid and
# tanh. Readings on an H100 (PERF.md section 6): act under 1e-7, c and
# h_flips 0; the reverse scan's dh rounds each product to bf16, and where
# the two sums straddle a rounding boundary the neighbouring value enters
# the dc chain, so dg and g_state read 2e-5 to 6.4e-5. The planted faults
# read 1.3e-3 and more: a gate product rounded to bf16 (act), the recurrent
# gradients left unrounded (dg, g_state). ``h_flips``: the share of
# recorded bf16 h that differ from the bf16 of the recomputed h; ``free``:
# the scans run free (y, the carry and dg), held to the benchmark's layer
# limit 0.02 (read 1.5e-3 at the training window).
CARD_RTOL = {"act": 1e-5, "c": 1e-5, "h_flips": 1e-3, "exact": 0.5, "dg": 2.5e-4,
             "g_state": 2.5e-4, "free": 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _card_args(shape, seed, device):
    t, b, n, hidden = shape
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device=device)  # noqa: E731
    w = [r(hidden, 4 * hidden, scale=hidden ** -0.5).bfloat16() for _ in range(3)]
    fwd = (r(t, b, n, 4 * hidden), *w, r(4 * hidden, scale=0.1), r(4 * hidden, scale=0.1),
           r(2, b, hidden, scale=0.5), r(2, b, hidden, scale=0.5))
    cot = (r(t, b, n, hidden).bfloat16(), r(2, b, hidden), r(2, b, hidden))
    return fwd, cot


def card_gaps(shape, seed, device, fault=False) -> dict:
    """The kernels against the plain versions on the card at one shape,
    cell by cell (``fault``: the planted faults in the plain cells), and
    run free. Raises if the two forwards disagree."""
    fwd, cot = _card_args(shape, seed, device)
    y, h, c = KT.token_lstm_fwd(*fwd)
    out = KT.token_lstm_fwd_res(*fwd)
    bwd = (out[3], out[4], fwd[7], *fwd[1:4], *cot)
    back = KT.token_lstm_bwd(*bwd)
    torch.cuda.synchronize()
    for a, b_ in zip((y, h, c), out):
        assert torch.equal(a, b_)  # the two forwards run the same arithmetic
    gaps = {**forward_step_gaps(fwd, out, _bf16_product if fault else _fp32_product),
            **backward_step_gaps(bwd, back, rounded=not fault)}
    ref = token_lstm_forward_reference(fwd[0], [None, fwd[2]], [fwd[1], fwd[3]], list(fwd[4:6]),
                                       *fwd[6:])
    r_dg = token_lstm_backward_reference(*bwd)[0]
    gaps["free"] = max(_rel(y.float(), ref[0].float()), _rel(h, ref[1]), _rel(c, ref[2]),
                       _rel(back[0], r_dg))
    return gaps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "T{}_B{}_N{}_H{}".format(*s))
def test_kernels_match_the_plain_versions_on_the_card(shape, cuda_device):
    gaps = card_gaps(shape, 0, cuda_device)
    print(shape, gaps)
    for key, tol in CARD_RTOL.items():
        assert gaps[key] < tol, (key, gaps)


@pytest.mark.cuda
def test_planted_faults_fall_outside_the_tolerances(cuda_device):
    sound = card_gaps(CARD_SHAPES[0], 1, cuda_device)
    fault = card_gaps(CARD_SHAPES[0], 1, cuda_device, fault=True)
    print("sound", sound, "fault", fault)
    for key in ("act", "dg", "g_state"):
        assert sound[key] < CARD_RTOL[key] < fault[key], (key, sound[key], fault[key])


@pytest.mark.cuda
def test_two_launches_are_bitwise_equal_and_counted(cuda_device):
    fwd, cot = _card_args(CARD_SHAPES[0], 2, cuda_device)
    before = dict(KT.launch_counts)
    runs = []
    for _ in range(2):
        out = KT.token_lstm_fwd_res(*fwd)
        runs.append(out + KT.token_lstm_bwd(out[3], out[4], fwd[7], *fwd[1:4], *cot))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert KT.launch_counts["token_lstm_fwd_res"] == before["token_lstm_fwd_res"] + 2
    assert KT.launch_counts["token_lstm_bwd"] == before["token_lstm_bwd"] + 2
    mod = _module(torch.bfloat16, hidden=1024).to(cuda_device)
    x = torch.randn(5, 16, 8, 10, 1024, device=cuda_device).bfloat16().requires_grad_(True)
    counts = profiling.counters()
    y, (h, c) = mod(x)
    (y.float().sum() + h.sum() + c.sum()).backward()
    with torch.no_grad():
        mod(x[:1, :1])
    torch.cuda.synchronize()
    after = profiling.counters()
    assert {k: after[f"{k}.launches"] - counts[f"{k}.launches"] for k in KT.KERNELS} == {
        "token_lstm_fwd": 1, "token_lstm_fwd_res": 1, "token_lstm_bwd": 1}
    assert after["token_lstm.plain_scans"] == counts["token_lstm.plain_scans"]


@pytest.mark.cuda
def test_unsupported_inputs_raise_on_the_card(cuda_device):
    fwd, _ = _card_args((1, 2, 3, 1024), 0, cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        KT.token_lstm_fwd(fwd[0], *(w.float() for w in fwd[1:4]), *fwd[4:])
    big, _ = _card_args((1, 1, 2, 8 * 136), 0, cuda_device)
    with pytest.raises(ValueError, match="SMs"):
        KT.token_lstm_fwd(*big)
