"""The port's TokenLSTM bottleneck against the JAX (flax) module on
converted weights and the same numpy inputs, with the (h, c) carry passed
through two calls.

Tolerances and their reasons:
- fp32 compute: both sides run the same fp32 recurrence; XLA and PyTorch
  sum the gate products in another order (~1e-7 relative per product), and
  80 chained tokens carry that along: outputs and carry atol 1e-5.
- bf16 compute: both sides round the operands of every gate product to
  bf16 and sum in fp32 (the port multiplies the rounded operands in fp32,
  JAX asks its dot for an fp32 result), so they differ only by the order of
  summation — until a hidden value lands within that of a bf16 rounding
  boundary and the next product sees a neighbouring bf16 value (2^-8
  relative). Outputs are bf16 (one ulp: rtol 2^-7); the fp32 carry is held
  to atol 2e-3, a small multiple of one such flip, where a bf16-rounded
  product (torch.matmul in bf16) is off by ~1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu.models.token_lstm import TokenLSTM as JTokenLSTM
from snn_object_detectionddp_tpu_torch.convert import params_from_jax
from snn_object_detectionddp_tpu_torch.models.token_lstm import TokenLSTM

HIDDEN = 32
SHAPE = (2, 2, 3, 4, HIDDEN)  # (T, B, H, W, C)


def _setup(jdtype, tdtype, seed=0):
    rng = np.random.RandomState(seed)
    x1 = rng.randn(*SHAPE).astype(np.float32)
    x2 = rng.randn(*SHAPE).astype(np.float32)
    jmod = JTokenLSTM(HIDDEN, dtype=jdtype)
    tree = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x1))["params"]
    # Perturb every leaf so no bias stays at its 0/1 init.
    tree = jax.tree.map(
        lambda v: (np.asarray(v) + 0.05 * rng.randn(*np.shape(v))).astype(np.float32), tree)
    with torch.device("meta"):
        tmod = TokenLSTM(HIDDEN, dtype=tdtype)
    tparams = params_from_jax(tree, "cpu")
    assert set(tparams) == {n for n, _ in tmod.named_parameters()} == {
        f"l{n}_{k}" for n in range(2) for k in ("w_ih", "w_hh", "bias")}
    return jmod, tree, tmod, tparams, x1, x2


def _run_both(jmod, tree, tmod, tparams, x, jstate, tstate):
    y_j, c_j = jmod.apply({"params": tree}, jnp.asarray(x), jstate)
    with torch.no_grad():
        y_t, c_t = torch.func.functional_call(tmod, tparams, (torch.from_numpy(x), tstate))
    return (y_j, c_j), (y_t, c_t)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_token_lstm_matches_flax_with_carried_state(precision):
    jdtype, tdtype = ((jnp.float32, torch.float32) if precision == "f32"
                      else (jnp.bfloat16, torch.bfloat16))
    out_tol = dict(atol=1e-5) if precision == "f32" else dict(rtol=2 ** -7, atol=2e-3)
    carry_atol = 1e-5 if precision == "f32" else 2e-3
    jmod, tree, tmod, tparams, x1, x2 = _setup(jdtype, tdtype)
    jstate = tstate = None
    for x in (x1, x2):
        (y_j, jstate), (y_t, tstate) = _run_both(jmod, tree, tmod, tparams, x, jstate, tstate)
        assert y_t.dtype == tdtype and tuple(y_t.shape) == SHAPE
        np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j, np.float32), **out_tol)
        assert len(tstate) == 2
        for leaf_t, leaf_j in zip(tstate, jstate):
            assert leaf_t.dtype == torch.float32 and tuple(leaf_t.shape) == (2, SHAPE[1], HIDDEN)
            np.testing.assert_allclose(leaf_t.numpy(), np.asarray(leaf_j), atol=carry_atol)
    # the carry matters: the second call from a zero state gives another answer
    with torch.no_grad():
        y_fresh, _ = torch.func.functional_call(tmod, tparams, (torch.from_numpy(x2), None))
    assert (y_fresh.float() - y_t.float()).abs().max() > 1e-2


def test_gate_products_keep_an_fp32_result():
    """The bf16 module must not round its gate products to bf16: against
    the flax module its carry agrees far better than the same recurrence
    with bf16 torch.matmul outputs does."""
    jmod, tree, tmod, tparams, x1, _ = _setup(jnp.bfloat16, torch.bfloat16, seed=1)
    (_, c_j), (_, c_t) = _run_both(jmod, tree, tmod, tparams, x1, None, None)
    err = max(np.abs(t.numpy() - np.asarray(j)).max() for t, j in zip(c_t, c_j))

    # the same recurrence with products rounded to bf16
    w = {k: v.bfloat16() for k, v in tparams.items() if "bias" not in k}
    t_, b_, h_, w_, c_ = SHAPE
    hs = [torch.zeros(b_, HIDDEN) for _ in range(2)]
    cs = [torch.zeros(b_, HIDDEN) for _ in range(2)]
    toks = torch.from_numpy(x1).reshape(t_, b_, h_ * w_, c_)
    for frame in range(t_):
        for tok in range(h_ * w_):
            inp = toks[frame, :, tok]
            for n in range(2):
                gates = ((inp.bfloat16() @ w[f"l{n}_w_ih"]).float()
                         + (hs[n].bfloat16() @ w[f"l{n}_w_hh"]).float() + tparams[f"l{n}_bias"])
                i, f, g, o = gates.chunk(4, -1)
                cs[n] = torch.sigmoid(f) * cs[n] + torch.sigmoid(i) * torch.tanh(g)
                hs[n] = torch.sigmoid(o) * torch.tanh(cs[n])
                inp = hs[n]
    rounded_err = max(np.abs(torch.stack(s).numpy() - np.asarray(j)).max()
                      for s, j in zip((hs, cs), c_j))
    assert err < 2e-3 < rounded_err, (err, rounded_err)


def test_init_follows_the_flax_recipe():
    with torch.device("meta"):
        tmod = TokenLSTM(HIDDEN)
    g = torch.Generator().manual_seed(0)
    leaves = {}
    for name, p in tmod.named_parameters():
        t = torch.empty(p.shape)
        tmod.init_param(name, t, g)
        leaves[name] = t
    for n in range(2):
        bias = leaves[f"l{n}_bias"]
        assert bias[HIDDEN:2 * HIDDEN].eq(1).all() and bias.sum() == HIDDEN  # forget gate 1
        w_hh = leaves[f"l{n}_w_hh"]  # orthogonal rows
        np.testing.assert_allclose((w_hh @ w_hh.T).numpy(), np.eye(HIDDEN), atol=1e-5)
        limit = np.sqrt(6.0 / (HIDDEN + 4 * HIDDEN))  # xavier uniform
        w_ih = leaves[f"l{n}_w_ih"]
        assert w_ih.abs().max() <= limit and w_ih.abs().max() > 0.8 * limit
    assert not torch.equal(leaves["l0_w_ih"], leaves["l1_w_ih"])


def test_wrong_width_raises():
    with torch.device("meta"):
        tmod = TokenLSTM(HIDDEN)
    with pytest.raises(ValueError, match="input dim"):
        tmod(torch.zeros(1, 1, 2, 2, HIDDEN + 1))


def test_token_lstm_bf16_matches_jit():
    """Against ``jax.jit(apply)`` the bf16 gate products (bf16 operands,
    fp32 result on both sides) are the same function: the fp32 carry within
    1e-5, the bf16 outputs equal in >= 99%."""
    jmod, tree, tmod, tparams, x1, _ = _setup(jnp.bfloat16, torch.bfloat16)
    y_j, c_j = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(tree, jnp.asarray(x1))
    with torch.no_grad():
        y_t, c_t = torch.func.functional_call(tmod, tparams, (torch.from_numpy(x1), None))
    assert np.mean(y_t.float().numpy() == np.asarray(y_j, np.float32)) >= 0.99
    for leaf_t, leaf_j in zip(c_t, c_j):
        np.testing.assert_allclose(leaf_t.numpy(), np.asarray(leaf_j), atol=1e-5)
