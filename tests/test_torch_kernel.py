"""The hand-written CUDA normalize+LIF kernels and plain-LIF-scan kernels
(each: inference forward, residual-saving forward, reverse-time backward)
against their plain PyTorch versions, on the card. Every test marked ``cuda`` needs an NVIDIA GPU
and skips with a reason elsewhere. The file imports no JAX, so on a card machine it runs
without the JAX stack:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -q

Tolerance: the kernels perform the same rounded fp32 operations as the
plain versions (no contracted multiply-adds, an IEEE division), so every
per-element output (spikes, v_final, readouts, v_pre, g_x, g_v0) must be
equal. The affine gradients da/db are sums over pixels taken in another
order than torch.sum takes them: they are held to 1e-5 of the sum of the
absolute terms (fp32 summation error grows with that sum, not with the
possibly cancelled result).
"""

import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
from snn_object_detectionddp_tpu_torch.kernels import lif as KL
from snn_object_detectionddp_tpu_torch.models.lif import (
    LIFParams,
    affine_lif_backward_reference,
    affine_lif_forward_reference,
    affine_lif_tb_reference,
    lif_backward_reference,
    lif_forward_reference,
    run_affine_lif_tb,
    run_lif,
)

SUM_RTOL = 1e-5

PARAMS = [LIFParams(), LIFParams(threshold=0.7, decay=0.9, reset="hard")]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _inputs(t, b, h, w, c, dtype, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(t * b, h, w, c) * 1.2).astype(np.float32)).to(dtype)
    a = torch.from_numpy((1.0 + 0.3 * rng.randn(t, b, c)).astype(np.float32))
    bb = torch.from_numpy((0.2 * rng.randn(t, b, c)).astype(np.float32))
    v0 = torch.from_numpy((0.3 * rng.randn(b, h, w, c)).astype(np.float32))
    return x, a, bb, v0


@pytest.mark.cuda
@pytest.mark.parametrize("p", PARAMS, ids=["soft", "hard"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1, 2, 15, 20, 512), (3, 2, 7, 9, 24), (2, 1, 3, 5, 7),
                                   (2, 3, 9, 7, 88), (2, 3, 9, 7, 44), (1, 1, 120, 160, 96),
                                   (2, 3, 160, 100, 48)],
                         ids=["vec", "vec_odd_hw", "scalar_c", "b3_ragged_channel_tile",
                              "b3_ragged_channel_tile_f32", "stem_one_sample",
                              "two_pixels_a_thread"])
@pytest.mark.parametrize("readouts", [False, True])
def test_kernel_equals_plain(cuda_device, p, dtype, shape, readouts):
    args = [t.to(cuda_device) for t in _inputs(*shape, dtype)]
    before = dict(K.launch_counts)
    got = K.affine_lif_fwd(args[0], args[1], args[2], p, args[3], readouts)
    ref = affine_lif_tb_reference(args[0], args[1], args[2], p, args[3], readouts)
    assert K.launch_counts == {**before, "affine_lif_fwd": before["affine_lif_fwd"] + 1}
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.cuda
def test_unaligned_view_takes_scalar_path(cuda_device):
    """A batch slice at an odd offset breaks 32-byte alignment; the kernel
    must fall back to its scalar path and still be exact."""
    x, a, b, v0 = (t.to(cuda_device) for t in _inputs(1, 3, 4, 5, 8, torch.bfloat16))
    xs = x.reshape(-1)[8:8 + 160].reshape(1, 4, 5, 8)  # 16-byte offset view
    vs = v0.reshape(-1)[4:4 + 160].reshape(1, 4, 5, 8)
    got = K.affine_lif_fwd(xs, a[:, :1].contiguous(), b[:, :1].contiguous(), LIFParams(), vs)
    ref = affine_lif_tb_reference(xs, a[:, :1], b[:, :1], LIFParams(), vs)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_device):
    x, a, b, v0 = (t.to(cuda_device) for t in _inputs(2, 1, 4, 6, 8, torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        K.affine_lif_fwd(x.transpose(1, 2), a, b, LIFParams(), v0.transpose(1, 2))
    with pytest.raises(ValueError, match="bf16/f32"):
        K.affine_lif_fwd(x.half(), a, b, LIFParams(), v0)
    with pytest.raises(ValueError, match="fp32"):
        K.affine_lif_fwd(x, a.double(), b, LIFParams(), v0)
    with pytest.raises(ValueError, match="match"):
        K.affine_lif_fwd(x[:1], a, b, LIFParams(), v0)


# The later shapes cross the edges of the kernels' tiles: C that is no
# multiple of the channel tile (88 = 64 + 24 in bf16, 44 = 32 + 12 in fp32:
# 11 vectors, which no tile divides, so the last tile's lanes are masked), H*W that is no
# multiple of a block's pixel run, three samples, two and four pixels a
# thread in the forward with a two-level partial-row tree in the backward,
# and more steps than the backward parks in shared memory between two
# barriers.
SHAPES = [(1, 2, 15, 20, 512), (3, 2, 7, 9, 24), (2, 1, 3, 5, 7), (5, 2, 13, 11, 48),
          (4, 1, 3, 2, 2048), (2, 3, 9, 7, 88), (2, 3, 9, 7, 44), (2, 3, 160, 100, 48),
          (1, 3, 160, 150, 96), (20, 1, 5, 6, 64)]
SHAPE_IDS = ["vec", "vec_odd_hw", "scalar_c", "c48", "two_channel_tiles",
             "b3_ragged_channel_tile", "b3_ragged_channel_tile_f32", "two_pixels_a_thread",
             "four_pixels_a_thread", "chunked_steps"]


def _cotangents(x, v0, seed=1):
    rng = np.random.RandomState(seed)
    g_s = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(x.dtype)
    g_v = torch.from_numpy(rng.randn(*v0.shape).astype(np.float32))
    return g_s.to(x.device), g_v.to(x.device)


def _assert_sums_close(got, terms_abs_sum, ref, name):
    err = (got - ref).abs()
    bound = SUM_RTOL * terms_abs_sum + 1e-30
    assert (err <= bound).all(), f"{name}: max err/bound {(err / bound).max().item():.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("p", PARAMS, ids=["soft", "hard"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_fwd_res_equals_plain(cuda_device, p, dtype, shape):
    x, a, b, v0 = (t.to(cuda_device) for t in _inputs(*shape, dtype))
    before = dict(K.launch_counts)
    s, vpre, vfin = K.affine_lif_fwd_res(x, a, b, p, v0)
    assert K.launch_counts == {**before, "affine_lif_fwd_res": before["affine_lif_fwd_res"] + 1}
    s_r, vfin_r, _, vpre_r = affine_lif_forward_reference(x, a, b, p, v0, with_vpre=True)
    assert vpre.dtype == x.dtype
    assert torch.equal(s, s_r) and torch.equal(vfin, vfin_r) and torch.equal(vpre, vpre_r)
    # and the inference forward gives the same spikes and membrane
    s1, vfin1 = K.affine_lif_fwd(x, a, b, p, v0)
    assert torch.equal(s, s1) and torch.equal(vfin, vfin1)


@pytest.mark.cuda
@pytest.mark.parametrize("p", PARAMS, ids=["soft", "hard"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_bwd_equals_plain(cuda_device, p, dtype, shape):
    x, a, b, v0 = (t.to(cuda_device) for t in _inputs(*shape, dtype))
    _, vpre, _ = K.affine_lif_fwd_res(x, a, b, p, v0)
    g_s, g_v = _cotangents(x, v0)
    before = dict(K.launch_counts)
    g_x, g_a, g_b, g_v0 = K.affine_lif_bwd(vpre, x, a, g_s, g_v, p)
    assert K.launch_counts == {**before, "affine_lif_bwd": before["affine_lif_bwd"] + 1}
    r_x, r_a, r_b, r_v0 = affine_lif_backward_reference(vpre, x, a, g_s, g_v, p)
    assert g_x.dtype == x.dtype and torch.equal(g_x, r_x)
    assert torch.equal(g_v0, r_v0)
    # |terms| summed: recover g_cur from g_b's definition by a second plain
    # pass with |.|: g_b sums g_cur, g_a sums g_cur * x.
    t_steps, bsz, c = a.shape
    ones = torch.ones_like(a)
    gx_unit = affine_lif_backward_reference(vpre.float(), x.float(), ones, g_s.float(), g_v, p)[0]
    g_cur = gx_unit.view(t_steps, bsz, *x.shape[1:])
    xs = x.float().view_as(g_cur)
    _assert_sums_close(g_b, g_cur.abs().sum((2, 3)), r_b, "g_b")
    _assert_sums_close(g_a, (g_cur * xs).abs().sum((2, 3)), r_a, "g_a")
    # two launches on the same inputs: bitwise-equal sums (no atomics)
    again = K.affine_lif_bwd(vpre, x, a, g_s, g_v, p)
    assert torch.equal(again[1], g_a) and torch.equal(again[2], g_b)


def test_tile_edge_shapes_take_the_planned_paths():
    """The shapes above reach what their names say (the plan is Python:
    this test needs no card)."""
    shapes = dict(zip(SHAPE_IDS, SHAPES))
    bwd = {i: K.bwd_plan(s[0], s[1], s[2] * s[3], s[4], torch.bfloat16, True)
           for i, s in shapes.items()}
    fwd = {i: K.fwd_plan(s[1], s[2] * s[3], s[4], torch.bfloat16, True) for i, s in shapes.items()}
    for plans in (fwd, bwd):  # 11 vectors in tiles of 8: the second tile is ragged
        assert (plans["b3_ragged_channel_tile"].cvt, plans["b3_ragged_channel_tile"].c_tiles) == (8, 2)
    s44 = shapes["b3_ragged_channel_tile_f32"]
    f32 = K.bwd_plan(s44[0], s44[1], s44[2] * s44[3], s44[4], torch.float32, True)
    assert (f32.vec, f32.cvt, f32.c_tiles) == (4, 8, 2)
    assert bwd["c48"].cvt == 2 and bwd["c48"].c_tiles == 3  # exact tiles of one sector
    assert fwd["two_pixels_a_thread"].ppt == 2 and len(bwd["two_pixels_a_thread"].fold_rows) == 2
    assert fwd["four_pixels_a_thread"].ppt == 4 and len(bwd["four_pixels_a_thread"].fold_rows) == 2
    assert bwd["chunked_steps"].t_chunk < shapes["chunked_steps"][0]
    assert bwd["vec"].threads == 256 and bwd["scalar_c"].threads == 128


@pytest.mark.cuda
def test_bwd_on_two_streams_is_bitwise_repeatable(cuda_device):
    """50 launches of the backward on one input, alternating between two
    streams: each stream has its own tickets and partial-row scratch, so
    the launches may overlap, and every one gives the same da/db bits."""
    p = LIFParams()
    x, a, b, v0 = (t.to(cuda_device) for t in _inputs(5, 2, 15, 20, 512, torch.bfloat16))
    _, vpre, _ = K.affine_lif_fwd_res(x, a, b, p, v0)
    g_s, g_v = _cotangents(x, v0)
    first = K.affine_lif_bwd(vpre, x, a, g_s, g_v, p)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for i in range(50):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(K.affine_lif_bwd(vpre, x, a, g_s, g_v, p))
    torch.cuda.synchronize()
    assert len(K._bwd_scratch) >= 3  # the default stream's and the two streams'
    for got in outs:
        for g, r in zip(got, first):
            assert torch.equal(g, r)
    # and the tickets are back at zero on every stream
    assert all(int(held[0].abs().sum()) == 0 for held in K._bwd_scratch.values())


@pytest.mark.cuda
def test_bwd_refused_launch_drops_the_scratch(cuda_device, monkeypatch):
    """The entry point refuses a plan made for another ring depth than the
    library was built with; the wrapper raises, drops the stream's scratch
    (its tickets might have been left counted), and the next call is right."""
    p = LIFParams()
    x, a, b, v0 = (t.to(cuda_device) for t in _inputs(2, 2, 7, 9, 24, torch.bfloat16))
    _, vpre, _ = K.affine_lif_fwd_res(x, a, b, p, v0)
    g_s, g_v = _cotangents(x, v0)
    first = K.affine_lif_bwd(vpre, x, a, g_s, g_v, p)
    key = K._scratch_key(x.device)
    assert key in K._bwd_scratch
    before = dict(K.launch_counts)
    with monkeypatch.context() as m:
        m.setattr(K, "RING_DEPTH", K.RING_DEPTH + 1)
        with pytest.raises(RuntimeError, match="launch failed"):
            K.affine_lif_bwd(vpre, x, a, g_s, g_v, p)
    assert key not in K._bwd_scratch and K.launch_counts == before
    again = K.affine_lif_bwd(vpre, x, a, g_s, g_v, p)
    for g, r in zip(again, first):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("p", PARAMS, ids=["soft", "hard"])
def test_autograd_function_matches_plain(cuda_device, p):
    """The whole AffineLIF under torch.autograd.grad, through the
    dispatcher, against the plain differentiable version on the card; one
    output left unused so its cotangent arrives as None."""
    x, a, b, v0 = (t.to(cuda_device).requires_grad_() for t in _inputs(3, 2, 7, 9, 24, torch.bfloat16))

    def grads(fn, use_v):
        s, v = fn(x, a, b, p, v0)
        w = torch.linspace(0.5, 1.5, s.numel(), device=s.device).view_as(s).to(s.dtype)
        loss = (s * w).float().sum() + (1.3 * v.sum() if use_v else 0.0)
        return torch.autograd.grad(loss, (x, a, b, v0))

    for use_v in (True, False):
        before = dict(K.launch_counts)
        got = grads(run_affine_lif_tb, use_v)
        assert K.launch_counts["affine_lif_fwd_res"] == before["affine_lif_fwd_res"] + 1
        assert K.launch_counts["affine_lif_bwd"] == before["affine_lif_bwd"] + 1
        assert K.launch_counts["affine_lif_fwd"] == before["affine_lif_fwd"]
        ref = grads(affine_lif_tb_reference, use_v)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[3], ref[3])
        for g, r in zip(got[1:3], ref[1:3]):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError):
        run_affine_lif_tb(x, a, b, p, v0, with_readouts=True)
    with torch.no_grad():  # no gradient needed: the inference kernel, readouts allowed
        before = K.launch_counts["affine_lif_fwd"]
        run_affine_lif_tb(x, a, b, p, v0, with_readouts=True)
        assert K.launch_counts["affine_lif_fwd"] == before + 1


@pytest.mark.cuda
def test_bwd_wrapper_rejects_bad_inputs(cuda_device):
    x, a, b, v0 = (t.to(cuda_device) for t in _inputs(2, 1, 4, 6, 8, torch.bfloat16))
    _, vpre, _ = K.affine_lif_fwd_res(x, a, b, LIFParams(), v0)
    g_s, g_v = _cotangents(x, v0)
    with pytest.raises(ValueError, match="g_s must be"):
        K.affine_lif_bwd(vpre, x, a, g_s.float(), g_v, LIFParams())
    strided = g_s.repeat(1, 1, 1, 2)[..., ::2]  # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        K.affine_lif_bwd(vpre, x, a, strided, g_v, LIFParams())
    with pytest.raises(ValueError, match="CUDA"):
        K.affine_lif_bwd(vpre.cpu(), x.cpu(), a.cpu(), g_s.cpu(), g_v.cpu(), LIFParams())


# -- the plain LIF scan kernels (csrc/lif_scan.cu) ---------------------------

# (T, ...) shapes: whole 16-byte vectors; the odd-size case of the JAX
# package's own test (N = 10500: 4-wide in fp32 and in bf16); an odd N
# (single elements); one row with a scalar tail; a 1-D input.
SCAN_SHAPES = [(5, 2, 15, 20, 512), (4, 3, 50, 70), (3, 7, 9, 5), (1, 3, 50, 71), (2, 24)]
SCAN_IDS = ["vec", "odd_10500", "odd_315", "one_row_tail", "flat"]


def _scan_inputs(shape, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 1.2).astype(np.float32)).to(dtype)
    v0 = torch.from_numpy((0.3 * rng.randn(*shape[1:])).astype(np.float32))
    g_s = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    g_v = torch.from_numpy(rng.randn(*shape[1:]).astype(np.float32))
    return tuple(t.to(device) for t in (x, v0, g_s, g_v))


@pytest.mark.cuda
@pytest.mark.parametrize("p", PARAMS, ids=["soft", "hard"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=SCAN_IDS)
def test_lif_scan_kernels_equal_plain(cuda_device, p, dtype, shape):
    x, v0, g_s, g_v = _scan_inputs(shape, dtype, cuda_device)
    before = dict(KL.launch_counts)
    s1, vfin1 = KL.lif_scan_fwd(x, p, v0)
    s, vpre, vfin = KL.lif_scan_fwd_res(x, p, v0)
    g_x, g_v0 = KL.lif_scan_bwd(vpre, g_s, g_v, p)
    assert KL.launch_counts == {k: before[k] + 1 for k in before}
    s_r, vpre_r, vfin_r = lif_forward_reference(x, p, v0, with_residuals=True)
    r_x, r_v0 = lif_backward_reference(vpre, g_s, g_v, p)
    assert s.dtype == vpre.dtype == g_x.dtype == x.dtype
    assert vfin.dtype == g_v0.dtype == torch.float32
    assert torch.equal(s, s_r) and torch.equal(vfin, vfin_r) and torch.equal(vpre, vpre_r)
    assert torch.equal(s1, s_r) and torch.equal(vfin1, vfin_r)
    assert torch.equal(g_x, r_x) and torch.equal(g_v0, r_v0)


@pytest.mark.cuda
def test_lif_scan_unaligned_view_and_default_v0(cuda_device):
    """A contiguous view at an odd storage offset breaks 16-byte alignment:
    the launcher narrows the vector and stays exact. v0=None is zeros."""
    p = LIFParams()
    x, v0, g_s, g_v = _scan_inputs((3, 4, 40), torch.bfloat16, cuda_device)
    for off in (1, 2, 4):
        xs = x.reshape(-1)[off : off + 3 * 128].reshape(3, 128)
        vs = v0.reshape(-1)[off : off + 128]
        gs, gvs = g_s.reshape(-1)[off : off + 3 * 128].reshape(3, 128), g_v.reshape(-1)[off : off + 128]
        s, vpre, vfin = KL.lif_scan_fwd_res(xs, p, vs)
        s_r, vpre_r, vfin_r = lif_forward_reference(xs, p, vs, with_residuals=True)
        assert torch.equal(s, s_r) and torch.equal(vpre, vpre_r) and torch.equal(vfin, vfin_r)
        g_x, g_v0 = KL.lif_scan_bwd(vpre_r, gs, gvs, p)
        r_x, r_v0 = lif_backward_reference(vpre_r, gs, gvs, p)
        assert torch.equal(g_x, r_x) and torch.equal(g_v0, r_v0)
    s, vfin = KL.lif_scan_fwd(x, p)
    s_r, _, vfin_r = lif_forward_reference(x, p, torch.zeros_like(v0))
    assert torch.equal(s, s_r) and torch.equal(vfin, vfin_r)


@pytest.mark.cuda
@pytest.mark.parametrize("p", PARAMS, ids=["soft", "hard"])
def test_run_lif_dispatch_and_gradients(cuda_device, p):
    """run_lif on CUDA tensors: one lif_scan_fwd without a gradient, one
    lif_scan_fwd_res + one lif_scan_bwd with; gradients equal the plain
    autograd function's on the same tensors; a strided input is copied and
    gives the same result; an unused output's cotangent arrives as None."""
    x, v0, g_s, g_v = _scan_inputs((4, 2, 9, 11, 24), torch.bfloat16, cuda_device)
    with torch.no_grad():
        before = dict(KL.launch_counts)
        s, vfin = run_lif(x, p, v0)
        assert KL.launch_counts == {**before, "lif_scan_fwd": before["lif_scan_fwd"] + 1}
        s_t, vfin_t = run_lif(x.transpose(2, 3).contiguous().transpose(2, 3), p, v0)
        assert torch.equal(s_t, s) and torch.equal(vfin_t, vfin)
    from snn_object_detectionddp_tpu_torch.models.lif import _LIFScanReference

    x.requires_grad_()
    v0.requires_grad_()
    for use_v in (True, False):
        before = dict(KL.launch_counts)
        s2, v2 = run_lif(x, p, v0)
        outs, cots = ((s2, v2), (g_s, g_v)) if use_v else ((s2,), (g_s,))
        got = torch.autograd.grad(outs, (x, v0), cots)
        assert KL.launch_counts == {"lif_scan_fwd": before["lif_scan_fwd"],
                                    "lif_scan_fwd_res": before["lif_scan_fwd_res"] + 1,
                                    "lif_scan_bwd": before["lif_scan_bwd"] + 1}
        s3, v3 = _LIFScanReference.apply(x, v0, p)
        outs = (s3, v3) if use_v else (s3,)
        ref = torch.autograd.grad(outs, (x, v0), cots)
        assert torch.equal(s2, s) and torch.equal(s3, s)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_lif_scan_wrapper_rejects_bad_inputs(cuda_device):
    x, v0, g_s, g_v = _scan_inputs((2, 4, 6, 8), torch.float32, cuda_device)
    p = LIFParams()
    with pytest.raises(ValueError, match="contiguous"):
        KL.lif_scan_fwd(x.transpose(1, 2), p, v0.transpose(0, 1))
    with pytest.raises(ValueError, match="bf16/f32"):
        KL.lif_scan_fwd(x.half(), p, v0)
    with pytest.raises(ValueError, match="v0 must be"):
        KL.lif_scan_fwd(x, p, v0.double())
    with pytest.raises(ValueError, match="g_s must be"):
        KL.lif_scan_bwd(x, g_s.bfloat16(), g_v, p)
    with pytest.raises(ValueError, match="CUDA"):
        KL.lif_scan_fwd(x.cpu(), p, v0.cpu())
