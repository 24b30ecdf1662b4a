"""Each ported layer against its flax counterpart, with the flax params
converted by convert.params_from_jax, on the same numpy inputs (fp32).

Tolerances: convs are summed in a different order by XLA and by PyTorch's
CPU kernels, so continuous outputs agree to ~1e-5 relative, and a spike
(a Heaviside of the membrane) may flip where the membrane sits within that
distance of threshold; spike agreement is therefore held to a share
(>= 99.9%), and membranes are compared where no flip happened.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu.models import backbone as jbb
from snn_object_detectionddp_tpu.models import convlstm as jcl
from snn_object_detectionddp_tpu.models import detect as jdet
from snn_object_detectionddp_tpu.models import layers as jl
from snn_object_detectionddp_tpu.models.lif import LIFParams as JLIF
from snn_object_detectionddp_tpu.data import encoding as jenc
from snn_object_detectionddp_tpu_torch.convert import params_from_jax
from snn_object_detectionddp_tpu_torch.data import encoding as tenc
from snn_object_detectionddp_tpu_torch.models import backbone as tbb
from snn_object_detectionddp_tpu_torch.models import convlstm as tcl
from snn_object_detectionddp_tpu_torch.models import detect as tdet
from snn_object_detectionddp_tpu_torch.models import layers as tl
from snn_object_detectionddp_tpu_torch.models.lif import LIFParams as TLIF

F32 = jnp.float32


def _port(ctor, tree, *args, **kwargs):
    """Build the port module on meta and run it with converted params."""
    with torch.device("meta"):
        module = ctor()
    sd = params_from_jax(jax.tree.map(np.asarray, tree), "cpu")
    with torch.no_grad():
        return torch.func.functional_call(module, sd, args, kwargs, strict=True)


def _randomize(tree, seed):
    """Replace ones/zeros initial GroupNorm affines with random values so
    the affine path is exercised."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.2 * rng.randn(*np.shape(x))).astype(np.float32), tree
    )


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
@pytest.mark.parametrize("readouts", [False, True])
def test_spiking_conv_block(stride, hw, readouts):
    t, b, cin, cout = 2, 2, 8, 16
    rng = np.random.RandomState(0)
    x = rng.randn(t, b, *hw, cin).astype(np.float32)
    out_hw = tuple(-(-n // stride) for n in hw)
    v0 = (0.3 * rng.randn(b, *out_hw, cout)).astype(np.float32)
    jblock = jl.SpikingConvBlock(cout, JLIF(), stride=stride, dtype=F32)
    tree = _randomize(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    ref = jblock.apply({"params": tree}, jnp.asarray(x), jnp.asarray(v0), with_readouts=readouts)
    got = _port(lambda: tl.SpikingConvBlock(cin, cout, TLIF(), stride=stride, dtype=torch.float32),
                tree, torch.from_numpy(x), torch.from_numpy(v0), with_readouts=readouts)
    assert len(got) == len(ref)
    s_t, s_j = _np(got[0]), _np(ref[0])
    assert s_t.shape == s_j.shape == (t, b, *out_hw, cout)
    assert np.mean(s_t == s_j) >= 0.999
    no_flip = (s_t == s_j).all(axis=0)
    np.testing.assert_allclose(_np(got[1])[no_flip], _np(ref[1])[no_flip], atol=1e-4)
    if readouts:
        r_t, r_j = _np(got[2]).reshape(t, b, *out_hw, cout), _np(ref[2]).reshape(t, b, *out_hw, cout)
        np.testing.assert_allclose(r_t[:, no_flip], r_j[:, no_flip], atol=1e-4)


def test_same_pads_match_flax_rule():
    # Even side at stride 2 pads (0, 1), odd side (1, 1); stride 1 k3 (1, 1).
    assert tl.same_pads(20, 3, 2) == (0, 1)
    assert tl.same_pads(15, 3, 2) == (1, 1)
    assert tl.same_pads(15, 3, 1) == (1, 1)
    assert tl.same_pads(15, 1, 1) == (0, 0)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_block(stride):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 10, 7, 12).astype(np.float32)
    jblock = jl.ConvBlock(16, stride=stride, dtype=F32)
    tree = _randomize(jblock.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 3)
    ref = jblock.apply({"params": tree}, jnp.asarray(x))
    got = _port(lambda: tl.ConvBlock(12, 16, stride=stride, dtype=torch.float32), tree,
                torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-4)


def test_up_block_with_resize():
    """2x transposed conv (kernel flip handled by the converter) and the
    bilinear skip resize (4x5 -> 8x10 up, skip 7x9 resized to 8x10)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 5, 16).astype(np.float32)
    skip = rng.randn(2, 7, 9, 8).astype(np.float32)
    jblock = jl.UpBlock(8, dtype=F32)
    tree = _randomize(jblock.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(skip))["params"], 5)
    ref = jblock.apply({"params": tree}, jnp.asarray(x), jnp.asarray(skip))
    got = _port(lambda: tl.UpBlock(16, 8, 8, dtype=torch.float32), tree,
                torch.from_numpy(x), torch.from_numpy(skip))
    assert got.shape == (2, 8, 10, 8)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-4)


def test_convlstm_with_carried_state():
    t, b, h, w, cin, hid = 3, 2, 4, 5, 8, 8
    rng = np.random.RandomState(6)
    x = rng.randn(t, b, h, w, cin).astype(np.float32)
    state = tuple((0.5 * rng.randn(b, h, w, hid)).astype(np.float32) for _ in range(2))
    jcell = jcl.ConvLSTM2d(hid, dtype=F32)
    tree = _randomize(jcell.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"], 7)
    h_j, (hf_j, cf_j) = jcell.apply({"params": tree}, jnp.asarray(x), tuple(map(jnp.asarray, state)))
    h_t, (hf_t, cf_t) = _port(lambda: tcl.ConvLSTM2d(cin, hid, dtype=torch.float32), tree,
                              torch.from_numpy(x), tuple(map(torch.from_numpy, state)))
    for got, ref in ((h_t, h_j), (hf_t, hf_j), (cf_t, cf_j)):
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5)


@pytest.mark.parametrize("block", [2, 4])
def test_space_to_depth(block):
    x = np.random.RandomState(8).randn(2, 1, 8, 12, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tbb.space_to_depth(torch.from_numpy(x), block).numpy(),
        np.asarray(jbb.space_to_depth(jnp.asarray(x), block)),
    )


def test_preset_channels_match():
    for name in jbb.PRESETS:
        for mult in (0.25, 0.5, 1.0):
            assert tbb.preset_channels(name, mult) == jbb.preset_channels(name, mult)


def test_detect_head_and_decode():
    rng = np.random.RandomState(9)
    feats = [rng.randn(2, h, w, c).astype(np.float32)
             for (h, w, c) in ((8, 10, 16), (4, 5, 32), (2, 3, 64))]
    nc, reg_max = 3, 8
    jhead = jdet.DetectHead(nc, reg_max, dtype=F32)
    tree = jhead.init(jax.random.PRNGKey(4), [jnp.asarray(f) for f in feats])["params"]
    ref = jhead.apply({"params": tree}, [jnp.asarray(f) for f in feats])
    got = _port(lambda: tdet.DetectHead(nc, (16, 32, 64), reg_max, dtype=torch.float32), tree,
                [torch.from_numpy(f) for f in feats])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-4, rtol=1e-4)
    # Decode the same raw maps on both sides, with the image_hw rescale
    # (a 60x80 image whose P3 map is 8x10 -> 64x80 map space).
    raw = [np.array(r) for r in ref]
    b_j, s_j = jdet.decode_predictions([jnp.asarray(r) for r in raw], reg_max, nc, image_hw=(60, 80))
    b_t, s_t = tdet.decode_predictions([torch.from_numpy(r) for r in raw], reg_max, nc,
                                       image_hw=(60, 80))
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_preprocess_and_encode(dtype):
    imgs = np.random.RandomState(10).randint(0, 256, (2, 3, 8, 12, 3), dtype=np.uint8)
    jd, td = (F32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = jenc.preprocess_video(jnp.asarray(imgs), dtype=jd)
    got = tenc.preprocess_video(torch.from_numpy(imgs), dtype=td)
    # /255 in fp32 and one rounding to the output dtype on both sides.
    np.testing.assert_array_equal(_np(got), _np(ref))
    ref = jenc.encode_direct(jnp.asarray(imgs[:, 0]), 3, dtype=jd)
    got = tenc.encode_direct(torch.from_numpy(imgs[:, 0]), 3, dtype=td)
    assert got.shape == (3, 2, 8, 12, 3)
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("out_hw", [(4, 6), (16, 20)], ids=["down", "up"])
def test_preprocess_resize(out_hw):
    """Bilinear resize with antialiasing on a downscale, as
    jax.image.resize does; fp32 rounding differences only (1e-6)."""
    imgs = np.random.RandomState(11).randint(0, 256, (2, 2, 8, 12, 3), dtype=np.uint8)
    ref = jenc.preprocess_video(jnp.asarray(imgs), out_hw, dtype=F32)
    got = tenc.preprocess_video(torch.from_numpy(imgs), out_hw, dtype=torch.float32)
    assert got.shape == (2, 2, *out_hw, 3)
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-6)


@pytest.mark.parametrize("level", [0, 64, 191, 255])
def test_encode_rate_statistics(level):
    """Bernoulli spikes with p = intensity. The port draws from a
    torch.Generator and JAX from jax.random, so the bits differ: both are
    held to the same statistics. Over 64 x 32 x 32 x 3 = 196,608 draws the
    standard error of the rate is at most 1.2e-3; the limit 0.01 is 8 of
    them, as tests/test_encoding.py allows 0.02 over 3x fewer draws."""
    imgs = np.full((1, 32, 32, 3), level, np.uint8)
    p = level / 255
    got = tenc.encode_rate(torch.from_numpy(imgs), torch.Generator().manual_seed(0), 64)
    ref = np.asarray(jenc.encode_rate(jnp.asarray(imgs), jax.random.PRNGKey(0), timesteps=64))
    assert got.shape == ref.shape == (64, 1, 32, 32, 3) and got.dtype == torch.float32
    assert set(np.unique(_np(got))) <= {0.0, 1.0}
    assert abs(float(got.mean()) - p) < 0.01 and abs(float(ref.mean()) - p) < 0.01
    # Independent draws per timestep and the same seed giving the same bits.
    again = tenc.encode_rate(torch.from_numpy(imgs), torch.Generator().manual_seed(0), 64)
    assert torch.equal(got, again)
    if 0 < level < 255:
        assert not torch.equal(got[0], got[1])
    bf = tenc.encode_rate(torch.from_numpy(imgs), torch.Generator().manual_seed(0), 64,
                          out_hw=(16, 16), dtype=torch.bfloat16)
    assert bf.shape == (64, 1, 16, 16, 3) and bf.dtype == torch.bfloat16


# --- bf16 against the jitted JAX package ---------------------------------
# XLA keeps a bf16 conv's fp32 result wherever an fp32 consumer reads it
# (conv -> GroupNorm, the ConvLSTM's hidden-half gates, a spiking block's
# statistics): the port computes "bf16 operands, fp32 result" at those
# sites (layers.conv2d_nhwc's ``f32_result``). Each case holds the port's
# bf16 block to ``jax.jit(module.apply)`` on the same inputs, with the share
# of equal (or, for fp32 outputs, of 1e-5-close) elements stated. What
# stays unequal is fp32 summation order and XLA's own tanh/logistic, which
# a following bf16 rounding can amplify to one bf16 step.

BF16 = jnp.bfloat16


def _jit_apply(module, tree, *args, **kwargs):
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kwargs))(tree, *args)


def test_conv_block_bf16_matches_jit():
    """GroupNorm normalizes the conv's fp32 result with statistics of its
    bf16 rounding; equal in >= 99.5% of the bf16 outputs."""
    x = np.random.RandomState(10).randn(2, 12, 16, 64).astype(np.float32)
    jblock = jl.ConvBlock(64, dtype=BF16)
    tree = _randomize(jblock.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 3)
    ref = _np(_jit_apply(jblock, tree, jnp.asarray(x)))
    got = _port(lambda: tl.ConvBlock(64, 64, dtype=torch.bfloat16), tree, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert np.mean(_np(got) == ref) >= 0.995


def test_convlstm_bf16_matches_jit():
    """The input half of the gates is stored in bf16, the hidden half's fp32
    result feeds the fp32 gate sum: h_seq within 1e-5 of jit in >= 99.9%
    of its elements."""
    xl = np.random.RandomState(11).randn(4, 2, 6, 8, 16).astype(np.float32)
    jm = jcl.ConvLSTM2d(16, dtype=BF16)
    tree = _randomize(jm.init(jax.random.PRNGKey(2), jnp.asarray(xl))["params"], 4)
    ref = _np(_jit_apply(jm, tree, jnp.asarray(xl))[0])
    got = _np(_port(lambda: tcl.ConvLSTM2d(16, 16, dtype=torch.bfloat16), tree, torch.from_numpy(xl))[0])
    assert np.mean(np.abs(got - ref) <= 1e-5) >= 0.999


def test_detect_head_bf16_matches_jit():
    """ConvBlocks as above; the 1x1 outputs add their bf16 bias to the
    conv's bf16 rounding and round again: equal in >= 99% of the maps."""
    rng = np.random.RandomState(12)
    feats = [rng.randn(2, 8, 10, 32).astype(np.float32), rng.randn(2, 4, 5, 64).astype(np.float32),
             rng.randn(2, 2, 3, 64).astype(np.float32)]
    jhead = jdet.DetectHead(3, dtype=BF16)
    tree = _randomize(jhead.init(jax.random.PRNGKey(3), [jnp.asarray(f) for f in feats])["params"], 5)
    ref = np.concatenate([_np(v).ravel() for v in _jit_apply(jhead, tree, [jnp.asarray(f) for f in feats])])
    got = _port(lambda: tdet.DetectHead(3, (32, 64, 64), dtype=torch.bfloat16), tree,
                [torch.from_numpy(f) for f in feats])
    assert all(g.dtype == torch.float32 for g in got)
    assert np.mean(np.concatenate([_np(v).ravel() for v in got]) == ref) >= 0.99


@pytest.mark.parametrize("hw,cout", [((16, 16), 16), ((16, 20), 32)])
def test_spiking_conv_block_bf16_matches_jit(hw, cout):
    """The group statistics read the conv's fp32 result, the LIF stage its
    bf16 rounding: spikes equal, v_final within 2e-6 in >= 99.5%."""
    xs = np.random.RandomState(13).randn(3, 2, *hw, 8).astype(np.float32)
    jblock = jl.SpikingConvBlock(cout, JLIF(), dtype=BF16)
    tree = _randomize(jblock.init(jax.random.PRNGKey(4), jnp.asarray(xs))["params"], 6)
    ref = _jit_apply(jblock, tree, jnp.asarray(xs))
    got = _port(lambda: tl.SpikingConvBlock(8, cout, TLIF(), dtype=torch.bfloat16), tree,
                torch.from_numpy(xs))
    assert np.array_equal(_np(got[0]), _np(ref[0]))
    assert np.mean(np.abs(_np(got[1]) - _np(ref[1])) <= 2e-6) >= 0.995
