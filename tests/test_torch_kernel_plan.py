"""The launch plans of the normalize+LIF CUDA kernels, on the CPU.

The kernels run only on a card, but how a problem is cut into thread
blocks is planned in Python (kernels/affine_lif.py::fwd_plan, bwd_plan)
and the kernels follow the map that ``LaunchPlan`` documents. These tests
replay that map with numpy: every pixel and channel is owned by exactly
one thread, the launch stays inside CUDA's and the card's limits, the
small late-stage shapes still give every SM a block, and the scratch and
tickets the plan sizes are exactly what the backward kernel writes. The
order in which the backward adds up da/db (a thread's pixels, the lanes of
a warp by xor butterfly, the warps in order, then a tree over the blocks'
partial rows) is replayed in plain fp32 PyTorch against
``affine_lif_backward_reference``: within 1e-5 of the summed |terms|, the
tolerance the card tests hold the kernel to (the two differ only in the
order of fp32 additions).
"""

import numpy as np
import pytest
import torch

from snn_object_detectionddp_tpu_torch.kernels import affine_lif as K
from snn_object_detectionddp_tpu_torch.models.lif import (
    LIFParams,
    affine_lif_backward_reference,
    affine_lif_forward_reference,
)

N_SMS = 132
MAX_SMEM = 232_448
SUM_RTOL = 1e-5

# (H*W, C) of the 20 spiking blocks of the default model (yolo11m, 480x640,
# s2d4 stem), and two odd sizes.
MAIN = ([(120 * 160, 48), (120 * 160, 96)] + [(60 * 80, 128)] * 4 + [(30 * 40, 256)] * 6
        + [(15 * 20, 512)] * 6 + [(8 * 10, 1024)] * 2)
ODD = [(3 * 5, 7), (7 * 9, 24)]
PAIRS = sorted(set(MAIN)) + ODD
T_STEPS = 5


def _plan(kind, bsz, hw, c, dtype, aligned):
    if kind == "fwd":
        return K.fwd_plan(bsz, hw, c, dtype, aligned)
    return K.bwd_plan(T_STEPS, bsz, hw, c, dtype, aligned)


def _thread_map(plan, hw, c):
    """(pix (n_runs, threads, ppt), ch (c_tiles, threads), ok masks) of
    the map LaunchPlan documents."""
    tid = np.arange(plan.threads)
    cx, py = tid % plan.cvt, tid // plan.cvt
    ch = (np.arange(plan.c_tiles)[:, None] * plan.cvt + cx[None, :]) * plan.vec
    ch_ok = (py[None, :] < plan.ny) & (ch < c)
    run = np.arange(plan.n_runs)[:, None, None]
    j = np.arange(plan.ppt)[None, None, :]
    pix = (run * plan.ppt + j) * plan.ny + py[None, :, None]
    return pix, ch, pix < hw, ch_ok


def test_main_path_has_20_shapes():
    assert len(MAIN) == 20 and len(set(MAIN)) == 6


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_plan_covers_every_element_once_within_limits(kind, pair, bsz, dtype, aligned):
    hw, c = pair
    plan = _plan(kind, bsz, hw, c, dtype, aligned)
    wide = 8 if dtype == torch.bfloat16 else 4
    assert plan.vec == (wide if aligned and c % wide == 0 else 1)
    assert c % plan.vec == 0 and 1 <= plan.cvt <= plan.threads and plan.ppt in (1, 2, 4)
    assert plan.vec > 1 or plan.ppt == 1  # the scalar path is built for one pixel a thread

    pix, ch, pix_ok, ch_ok = _thread_map(plan, hw, c)
    owners = np.zeros((hw, c), np.int64)
    for tile in range(plan.c_tiles):
        pp = pix[:, ch_ok[tile], :][pix_ok[:, ch_ok[tile], :]]
        cc = np.broadcast_to(ch[tile][None, :, None], pix.shape)[:, ch_ok[tile], :][
            pix_ok[:, ch_ok[tile], :]]
        for k in range(plan.vec):
            np.add.at(owners, (pp, cc + k), 1)
    assert (owners == 1).all(), "a pixel/channel is owned by no thread or by several"

    # CUDA's and the card's limits
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.c_tiles * plan.n_runs <= 2**31 - 1 and bsz <= 65535
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.blocks(bsz) == plan.c_tiles * plan.n_runs * bsz
    # a pixel's segment inside a block is at least one 32-byte sector on the vector path
    itemsize = 2 if dtype == torch.bfloat16 else 4
    if plan.vec > 1:
        assert min(plan.cvt, c // plan.vec) * plan.vec * itemsize >= 32
    # every SM gets a block where there is work for 132 blocks of 128 threads
    if bsz * hw * c // plan.vec >= N_SMS * 128:
        assert plan.blocks(bsz) >= N_SMS
    if kind == "bwd":
        # the warp shuffles need a power-of-two tile that divides a warp
        assert plan.cvt & (plan.cvt - 1) == 0 and plan.cvt <= 32
        assert 1 <= plan.t_chunk <= T_STEPS
        ring = 16 * K.RING_DEPTH * 3 * plan.threads if plan.vec > 1 else 0
        slots = 4 * plan.t_chunk * (plan.threads // 32) * 2 * plan.vec * plan.cvt
        assert plan.smem_bytes == ring + slots and plan.ppt == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}x{p[1]}")
def test_bwd_scratch_and_tickets_are_what_the_kernel_writes(pair, bsz, dtype):
    """Replay the indices the backward kernel writes: level 0 of the
    scratch is part[2][n_runs][T][B][C], every further level of the tree
    follows; one ticket per group of plan.fan rows, level, sample and
    tile. Each float and each ticket is written exactly once, and the
    plan's sizes are exactly their extent."""
    hw, c = pair
    plan = K.bwd_plan(T_STEPS, bsz, hw, c, dtype, True)
    tbc = T_STEPS * bsz * c
    assert plan.fold_rows[0] == plan.n_runs
    written = np.zeros(plan.scratch_floats, np.int64)
    tickets = np.zeros(plan.n_tickets, np.int64)
    level_off, ticket_off, n = 0, 0, plan.n_runs
    levels = 0
    while True:
        # rows of this level: [which][row][t][b][c], every (b, c) of every row
        written[level_off : level_off + 2 * n * tbc] += 1
        n_next = -(-n // plan.fan)
        for b in range(bsz):
            for tile in range(plan.c_tiles):
                for group in range(n_next):
                    tickets[ticket_off + (b * plan.c_tiles + tile) * n_next + group] += 1
        levels += 1
        if n_next == 1:
            break
        level_off += 2 * n * tbc
        ticket_off += bsz * plan.c_tiles * n_next
        n = n_next
    assert levels == len(plan.fold_rows)
    assert (written == 1).all() and (tickets == 1).all()
    # the (T, B, C) rows use 32-bit offsets in the kernel
    assert tbc < 2**31 and bsz * hw * c < 2**31


def test_fold_tree_shapes():
    small = K.bwd_plan(5, 2, 80, 1024, torch.bfloat16, True)
    assert small.fold_rows == (5,) and 2 <= small.fan <= 2 * K.FOLD_FAN
    # up to twice FOLD_FAN rows are added in one level
    mid = K.bwd_plan(5, 2, 30 * 40, 256, torch.bfloat16, True)
    assert K.FOLD_FAN < mid.n_runs <= 2 * K.FOLD_FAN and mid.fold_rows == (mid.n_runs,)
    big = K.bwd_plan(5, 1, 120 * 160, 48, torch.bfloat16, True)
    assert big.fan == K.FOLD_FAN and len(big.fold_rows) >= 2
    assert -(-big.fold_rows[-1] // big.fan) == 1
    for lo, hi in zip(big.fold_rows[1:], big.fold_rows[:-1]):
        assert lo == -(-hi // big.fan)
    assert K.bwd_plan(5, 1, 15, 7, torch.float32, True).fan >= 2  # a single row still folds


def test_check_grid_refuses_what_32_bit_offsets_cannot_hold():
    plan = K.bwd_plan(1, 1, 2**20, 2**11, torch.bfloat16, True)
    with pytest.raises(ValueError, match="32-bit"):
        K._check_grid("affine_lif_bwd", plan, 1, 1, 2**20, 2**11)
    with pytest.raises(ValueError, match="grid"):
        K._check_grid("affine_lif_fwd", K.fwd_plan(70000, 4, 8, torch.float32, True),
                      1, 70000, 4, 8)


def _seq_sum(x, dim):
    """fp32 sum along ``dim`` in index order, starting from 0.0."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _emulated_sums(plan, terms):
    """terms (T, B, H*W, C) fp32 -> (T, B, C) summed over pixels in the
    backward kernel's order."""
    t_steps, bsz, hw, c = terms.shape
    pix, ch, pix_ok, ch_ok = _thread_map(plan, hw, c)
    pix_i = torch.from_numpy(np.where(pix_ok, pix, 0))  # (runs, threads, ppt)
    chv = ch[:, :, None] + np.arange(plan.vec)[None, None, :]  # (tiles, threads, vec)
    ch_i = torch.from_numpy(np.where(ch_ok[:, :, None], chv, 0))
    ok = torch.from_numpy(pix_ok[:, None, :, :, None] & ch_ok[None, :, :, None, None])
    # (T, B, runs, tiles, threads, ppt, vec)
    g = terms[:, :, pix_i[:, None, :, :, None], ch_i[None, :, :, None, :]]
    g = torch.where(ok, g, torch.zeros((), dtype=g.dtype))
    acc = _seq_sum(g, 5)  # a thread's pixels, in j order
    # the lanes of a warp that share a channel vector: xor butterfly
    acc = acc.reshape(*acc.shape[:4], plan.threads // 32, 32, plan.vec)
    lanes = torch.arange(32)
    m = plan.cvt
    while m < 32:
        acc = acc + acc[..., lanes ^ m, :]
        m <<= 1
    blocks = _seq_sum(acc[..., : plan.cvt, :], 4)  # warps in order: (T, B, runs, tiles, cvt, vec)
    rows = blocks.reshape(t_steps, bsz, plan.n_runs, -1)[..., :c]
    # the tree over the runs' partial rows
    rows = list(rows.unbind(2))
    while len(rows) > 1:
        rows = [_seq_sum(torch.stack(rows[i : i + plan.fan]), 0)
                for i in range(0, len(rows), plan.fan)]
    return rows[0]


FOLD_CASES = [  # (T, B, H, W, C)
    (3, 2, 3, 5, 7), (3, 2, 7, 9, 24), (2, 3, 13, 11, 48), (5, 2, 8, 10, 1024),
    (2, 2, 15, 20, 512), (2, 1, 30, 40, 256), (1, 1, 120, 160, 48),
]


@pytest.mark.parametrize("p", [LIFParams(), LIFParams(threshold=0.7, decay=0.9, reset="hard")],
                         ids=["soft", "hard"])
@pytest.mark.parametrize("shape", FOLD_CASES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_fold_order_matches_reference(shape, p):
    t_steps, bsz, h, w, c = shape
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(t_steps * bsz, h, w, c) * 1.2).astype(np.float32))
    a = torch.from_numpy((1.0 + 0.3 * rng.randn(t_steps, bsz, c)).astype(np.float32))
    b = torch.from_numpy((0.2 * rng.randn(t_steps, bsz, c)).astype(np.float32))
    v0 = torch.from_numpy((0.3 * rng.randn(bsz, h, w, c)).astype(np.float32))
    g_s = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
    g_v = torch.from_numpy(rng.randn(*v0.shape).astype(np.float32))
    vpre = affine_lif_forward_reference(x, a, b, p, v0, with_vpre=True)[3]
    _, r_a, r_b, _ = affine_lif_backward_reference(vpre, x, a, g_s, g_v, p)
    # g_cur is g_x of a plain pass with a = 1
    g_cur = affine_lif_backward_reference(vpre, x, torch.ones_like(a), g_s, g_v, p)[0]
    g_cur = g_cur.view(t_steps, bsz, h * w, c)
    xs = x.view(t_steps, bsz, h * w, c)
    plan = K.bwd_plan(t_steps, bsz, h * w, c, torch.float32, True)
    for name, terms, ref in (("da", g_cur * xs, r_a), ("db", g_cur, r_b)):
        got = _emulated_sums(plan, terms)
        bound = SUM_RTOL * terms.abs().sum(2) + 1e-30
        err = (got - ref).abs()
        assert (err <= bound).all(), f"{name}: max err/bound {(err / bound).max().item():.3g}"
    if shape == FOLD_CASES[-1]:
        assert len(plan.fold_rows) >= 2  # the tree has more than one level here
