"""Data parallelism over ``torch.distributed``.

The port's counterpart of the JAX package's ``parallel/mesh.py`` parts (a)
and (b): one process per card, each holding the whole model, a 1-D
``data`` mesh over the process group, every process feeding its own
contiguous shard of the sample list. The JAX package writes its
data-parallel step in local shapes under ``shard_map`` and psums; here the
same collectives are explicit:

- the loss sums its normalisation terms across processes before dividing
  (:func:`global_sum`), so every process holds the GLOBAL-batch loss, not a
  mean of local means;
- the gradients of that loss on each local batch are summed across
  processes in one flat buffer (:func:`all_reduce_grads`) before the
  clip and AdamW, so every process takes the same step.

Setup: :func:`maybe_init_distributed` reads the JAX package's keys
(``mesh.coordinator`` / ``num_processes`` / ``process_id``, env
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``) or torchrun's
environment (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT``). NCCL on the card, gloo on the CPU. A failed rendezvous
raises: nothing falls back to another backend or device.

Part (c), FSDP (``mesh.fsdp``): every leaf of the parameters and of the
AdamW moments is flattened, padded with zeros to a multiple of the data
axis size W, and rank r keeps chunk r (:class:`ShardLayout`,
:func:`shard_state`). A train step gathers the full parameters once
(:func:`gather_params`, one all-gather), runs forward and backward on its
local batch, and reduce-scatters the summed gradients
(:func:`reduce_scatter_grads`) so that the optimizer updates only the
local chunks. The JAX package shards each leaf on its largest divisible
dimension instead; the arithmetic is the same.

Part (e), tensor parallelism (``mesh.tensor``, inference only): a 2-D
``data x tensor`` mesh (:func:`make_mesh`), ranks laid out ``rank = d *
tensor + t`` so that a tensor group is consecutive processes. Every
parameter shards its output-channel axis over the tensor group where the
group size k divides it (:func:`tp_shard_params`), activations are
channel-sharded, and a conv all-gathers its input's shards in global
channel order (:func:`all_gather_channels`, entered through
:func:`tensor_parallel`).

Part (d), spatial parallelism (``mesh.spatial``, training and evaluation):
a 2-D ``data x spatial`` mesh, ranks ``rank = d * spatial + s``. Every
activation keeps its own rows on each rank of a spatial group: a map of n
global rows is split by :func:`row_partition`, whatever the scale. There
is no partitioner; each layer asks for the rows it needs, explicitly
(:func:`fetch_rows`: conv halos, stride-2 convs, the decoder's resizes and
transposed convs), GroupNorm sums its statistics over the group
(:func:`spatial_sum`), and the head's maps are gathered whole
(:func:`gather_rows`). The layers read the group and the input's global
height from :func:`spatial_parallel`. Serving stays ``1 x tensor``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import re
import threading
from dataclasses import dataclass
from typing import NamedTuple
from datetime import timedelta

import torch
import torch.distributed as dist

# Workers of a loaded host may take minutes to reach the rendezvous (the
# JAX package's initialization_timeout).
RENDEZVOUS_TIMEOUT = timedelta(seconds=600)


def _backend(device: str | torch.device) -> str:
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: str | torch.device = "cuda", backend: str | None = None) -> None:
    """Join the process group through a ``tcp://`` rendezvous at
    ``coordinator`` (``host:port`` or ``tcp://host:port``). Backend NCCL on
    the card; gloo when ``device`` is the CPU, or when ``backend`` says so
    (several processes on one card, which NCCL refuses). On the card the
    caller sets this process's CUDA device first
    (:func:`maybe_init_distributed` does)."""
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend or _backend(device), init_method=init_method,
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=RENDEZVOUS_TIMEOUT)


def process_device(device: str | torch.device = "cuda") -> torch.device:
    """The device this process runs on: ``cuda:LOCAL_RANK`` (torchrun's
    card on this host, 0 without it) for a card request, the CPU when
    asked."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def maybe_init_distributed(cfg, device: str | torch.device = "cuda") -> bool:
    """Initialise the process group from the config's ``mesh`` keys with
    the JAX package's env fallbacks, or from torchrun's environment; then
    run :func:`collective_barrier`. Returns whether a group was made (no
    coordinator configured and no torchrun environment: one process, no
    group). On the card, ``torch.cuda.set_device(LOCAL_RANK)`` runs before
    the NCCL group is created."""
    env = os.environ
    mesh_cfg = getattr(cfg, "mesh", None)
    coord = getattr(mesh_cfg, "coordinator", None) or env.get("COORDINATOR_ADDRESS")
    if not coord and env.get("MASTER_ADDR") and env.get("MASTER_PORT") and env.get("WORLD_SIZE"):
        coord = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if not coord:
        return False

    def pick(attr, *names):
        value = getattr(mesh_cfg, attr, None)
        for name in names:
            if value is None and env.get(name) is not None:
                value = int(env[name])
        if value is None:
            raise ValueError(f"distributed launch via {coord}: mesh.{attr} is not set and "
                             f"none of {', '.join(names)} is in the environment")
        return int(value)

    num_processes = pick("num_processes", "NUM_PROCESSES", "WORLD_SIZE")
    process_id = pick("process_id", "PROCESS_ID", "RANK")
    dev = process_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(coord, num_processes, process_id, dev)
    print(f"torch.distributed initialized ({dist.get_backend()}): process {dist.get_rank()}/"
          f"{dist.get_world_size()} via {coord} on {dev}", flush=True)
    collective_barrier(dev)
    return True


def collective_barrier(device: str | torch.device | None = None) -> None:
    """One all-reduce of ones over the process group, its result checked:
    fails fast at startup when the fabric is broken, and pays the
    backend's lazy context set-up here rather than inside the first train
    step (JAX ``parallel/mesh.py::collective_barrier``)."""
    n = dist.get_world_size()
    dev = process_device(device) if device is not None else _group_device()
    ones = torch.ones(1, dtype=torch.float32, device=dev)
    dist.all_reduce(ones)
    total = float(ones.item())
    if total != n:
        raise RuntimeError(f"collective barrier mismatch: all-reduce over {n} processes returned "
                           f"{total}: broken fabric or inconsistent group")


def is_main_process() -> bool:
    """True on the process that owns logging and checkpoint writes (rank 0,
    or the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _world() -> tuple[int, int]:
    """(number of processes, this process's rank); (1, 0) without a group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def _group_device() -> torch.device:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def refuse_unported_axes(mesh_cfg, train: bool) -> None:
    """Raise on a tensor axis in training (``ValueError``: tensor
    parallelism is inference-only by design, as in the JAX package). The
    training entry points call this first."""
    if train and mesh_cfg.tensor > 1:
        raise ValueError(
            "mesh.tensor > 1 is inference-only (eval/serving latency); "
            "training supports data and fsdp parallelism")


@dataclass(frozen=True)
class DataMesh:
    """A ``data x tensor`` or ``data x spatial`` process mesh. ``size``,
    ``rank`` and ``group`` are the data axis (the global batch tiles over
    it; ``group`` is None for a single process without a group, where every
    collective is the identity); ``tensor``, ``tensor_rank`` and
    ``tensor_group`` the tensor axis, ``spatial``, ``spatial_rank`` and
    ``spatial_group`` the spatial axis (a group is None when its axis is
    1). Collectives run on the device of the tensors given to them."""

    size: int
    rank: int
    group: object | None
    tensor: int = 1
    tensor_rank: int = 0
    tensor_group: object | None = None
    spatial: int = 1
    spatial_rank: int = 0
    spatial_group: object | None = None


def make_mesh(data: int = -1, spatial: int = 1, tensor: int = 1) -> DataMesh:
    """The ``data x spatial`` or ``data x tensor`` mesh over the whole
    process group (the JAX ``make_mesh``'s order of arguments), ranks laid
    out ``rank = d * k + j`` for the model axis of size k, so that a
    spatial or tensor group is consecutive processes. The two model axes
    cannot both exceed 1. ``data=-1`` (or 0) takes every process the model
    axis leaves; any other value must make ``data * k`` the world size: a
    mesh over part of the processes would leave the others idle, and a
    mesh larger than the world raises, as the JAX ``make_mesh`` does. Every
    process must call this with the same arguments (each axis group is
    made by every rank)."""
    n, rank = _world()
    data, spatial, tensor = int(data), int(spatial), int(tensor)
    if spatial > 1 and tensor > 1:
        raise ValueError("mesh.spatial and mesh.tensor cannot both exceed 1")
    axis, k = ("spatial", spatial) if spatial > 1 else ("tensor", tensor)
    if k < 1 or n % k:
        raise ValueError(f"mesh.{axis}={k} must divide the world size of {n} process(es)")
    if data in (-1, 0):
        data = n // k
    if data * k > n:
        raise ValueError(f"mesh.data={data} x mesh.{axis}={k} exceeds the world size of {n} "
                         f"process(es): launch {data * k} processes (torchrun "
                         f"--nproc_per_node {data * k}) or set mesh.data: -1")
    if data * k != n:
        raise ValueError(f"mesh.data={data} x mesh.{axis}={k} must equal the world size "
                         f"({n}): the mesh spans the whole process group")
    if not dist.is_initialized():
        return DataMesh(size=1, rank=0, group=None)
    if k == 1:
        return DataMesh(size=n, rank=rank, group=dist.group.WORLD)
    d, j = divmod(rank, k)
    data_group = model_group = None
    for col in range(k):  # every rank makes every group, in one order
        g = dist.new_group([i * k + col for i in range(data)])
        if col == j:
            data_group = g
    for i in range(data):
        g = dist.new_group([i * k + col for col in range(k)])
        if i == d:
            model_group = g
    return DataMesh(size=data, rank=d, group=data_group,
                    **{axis: k, f"{axis}_rank": j, f"{axis}_group": model_group})


def local_batch_size(global_batch_size: int, num_processes: int | None = None) -> int:
    """This process's slice of the global batch (global batch = the
    concatenation of the processes' batches in rank order)."""
    n = _world()[0] if num_processes is None else int(num_processes)
    if global_batch_size % n:
        raise ValueError(f"global batch_size {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n


def pad_batch_to_devices(batch_size: int, n_devices: int) -> int:
    """Round a global batch size up to a multiple of the mesh size."""
    return -(-batch_size // n_devices) * n_devices


def host_shard_indices(indices: list[int], num_processes: int | None = None,
                       process_id: int | None = None) -> list[int]:
    """This process's contiguous shard of the sample indices, padded by
    wrapping within its own shard (an empty shard borrows from the whole
    list) so that every process yields the same number of batches: the
    collectives of the train step must stay in lockstep. Training only:
    the wrapped rows would count twice in an evaluation (see
    :func:`eval_shard`). No-op for one process."""
    n, i = _world()
    n = n if num_processes is None else int(num_processes)
    i = i if process_id is None else int(process_id)
    if n == 1:
        return list(indices)
    per = -(-len(indices) // n)
    shard = list(indices[i * per : (i + 1) * per])
    base = tuple(shard) if shard else tuple(indices)
    j = 0
    while len(shard) < per and base:
        shard.append(base[j % len(base)])
        j += 1
    return shard


def eval_shard(indices: list[int], mesh: DataMesh | None) -> list[int]:
    """This process's contiguous share of ``indices`` for evaluation,
    unpadded: concatenated in rank order the shares are ``indices`` once
    each, in order."""
    if mesh is None or mesh.size == 1:
        return list(indices)
    per = -(-len(indices) // mesh.size)
    return list(indices[mesh.rank * per : (mesh.rank + 1) * per])


def _collective(mesh: DataMesh | None) -> bool:
    return mesh is not None and mesh.group is not None


# The collectives on flat buffers (named ``*_single`` from torch 2.13 on).
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# Each gradient's segment of the flat buffer starts at a multiple of this
# many elements (128 bytes of fp32), and its view keeps the gradient's own
# strides (autograd may hand back a conv weight's gradient channels-last):
# the multi-tensor kernels that read the gradients next (the clip's norm)
# then see the memory they see without a mesh, take the same vectorised
# path and sum in the same order.
SEGMENT_ALIGN = 32


@torch.no_grad()
def all_reduce_grads(grads: dict, mesh: DataMesh | None) -> dict:
    """Sum the fp32 ``{name: gradient}`` across the mesh: one flat buffer
    (each segment aligned to ``SEGMENT_ALIGN`` and laid out as its
    gradient is), one SUM all-reduce; returns views of the buffer."""
    if not _collective(mesh):
        return grads
    names = list(grads)
    views, offset = [], 0
    flat = torch.empty(sum(-(-grads[k].numel() // SEGMENT_ALIGN) * SEGMENT_ALIGN for k in names),
                       dtype=torch.float32, device=grads[names[0]].device)
    for k in names:
        g = grads[k]
        # empty_like keeps a dense tensor's strides (else it is contiguous).
        strides = torch.empty_like(g, device="meta").stride()
        views.append(flat.as_strided(g.shape, strides, offset))
        offset += -(-g.numel() // SEGMENT_ALIGN) * SEGMENT_ALIGN
    torch._foreach_copy_(views, [grads[k] for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    return dict(zip(names, views))


def global_sum(values, mesh: DataMesh | None):
    """Cross-process sums of a sequence of 0-d tensors in one all-reduce,
    with the gradient flowing through each process's own term only:
    ``x + (all_reduce(x.detach()) - x.detach())``. (Not
    ``torch.distributed.nn.functional.all_reduce``: its backward
    all-reduces the cotangent, which with the gradient all-reduce after it
    would scale every gradient by the world size.) Returns a tuple."""
    values = tuple(values)
    if not _collective(mesh):
        return values
    local = torch.stack([v.to(torch.float32).reshape(()) for v in values])
    total = local.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    summed = local + (total - local.detach())
    return tuple(summed.unbind(0))


def gather_to_main(items: list, mesh: DataMesh | None) -> list | None:
    """Every process's ``items`` concatenated in rank order on rank 0
    (``gather_object``); None on the other ranks."""
    if not _collective(mesh):
        return list(items)
    parts: list | None = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(list(items), parts, dst=dist.get_global_rank(mesh.group, 0),
                       group=mesh.group)
    return None if parts is None else [x for part in parts for x in part]


def broadcast_from_main(obj, mesh: DataMesh | None):
    """Data rank 0's ``obj`` on every rank of the data axis
    (``broadcast_object_list``)."""
    if not _collective(mesh):
        return obj
    return broadcast_object(obj, mesh.group)


def broadcast_object(obj, group):
    """The ``obj`` of ``group``'s first rank on every rank of ``group``."""
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


# ---------------------------------------------------------------------------
# (c) FSDP: sharded parameters and AdamW moments over the data axis
# ---------------------------------------------------------------------------


def _aligned(n: int) -> int:
    return -(-n // SEGMENT_ALIGN) * SEGMENT_ALIGN


@dataclass(frozen=True)
class ShardLayout:
    """Where each leaf's chunks live. Leaf ``names[i]`` of shape
    ``shapes[i]`` is flattened in row-major order and padded with zeros to
    ``world * chunks[i]`` elements; rank r keeps elements ``[r * c, (r + 1)
    * c)``. A rank's chunks sit in one local buffer of ``local_numel``
    elements, chunk i at ``offsets[i]`` (a multiple of ``SEGMENT_ALIGN``);
    the buffer of a collective is the ``world`` local buffers rank after
    rank."""

    names: tuple
    shapes: tuple
    chunks: tuple
    offsets: tuple
    local_numel: int
    world: int

    def numel(self, i: int) -> int:
        n = 1
        for d in self.shapes[i]:
            n *= d
        return n

    def local_views(self, buf: torch.Tensor) -> dict:
        """``{name: chunk}`` views of a local buffer."""
        return {k: buf[o : o + c] for k, o, c in zip(self.names, self.offsets, self.chunks)}


def shard_layout(shapes: dict, world: int) -> ShardLayout:
    """The layout of ``{name: shape}`` (tensors or shapes) over ``world``
    ranks."""
    names = tuple(shapes)
    shp = tuple(tuple(getattr(v, "shape", v)) for v in shapes.values())
    chunks, offsets, off = [], [], 0
    for s in shp:
        n = 1
        for d in s:
            n *= d
        c = -(-n // world)
        chunks.append(c)
        offsets.append(off)
        off += _aligned(c)
    return ShardLayout(names, shp, tuple(chunks), tuple(offsets), off, world)


def shard_tree(full: dict, layout: ShardLayout, rank: int) -> dict:
    """This rank's chunks of a full ``{name: tensor}`` tree, as views of
    one fresh local buffer on the tensors' device (pads zero)."""
    dev = full[layout.names[0]].device
    buf = torch.zeros(layout.local_numel, dtype=torch.float32, device=dev)
    out = layout.local_views(buf)
    with torch.no_grad():
        for i, k in enumerate(layout.names):
            flat = full[k].detach().reshape(-1)
            c = layout.chunks[i]
            part = flat[rank * c : (rank + 1) * c]
            out[k][: part.numel()].copy_(part)
    return out


def shard_state(state: dict, layout: ShardLayout, rank: int) -> dict:
    """A full train state with its parameters and AdamW moments replaced
    by this rank's chunks (the JAX package's ``place_state``): every rank
    holds the same full state (a seeded init or the same checkpoint file)
    and keeps 1/W of it."""
    opt = state["opt_state"]
    return {**state, "params": shard_tree(state["params"], layout, rank),
            "opt_state": {**opt, "mu": shard_tree(opt["mu"], layout, rank),
                          "nu": shard_tree(opt["nu"], layout, rank)}}


def _global_buffer(layout: ShardLayout, like: torch.Tensor, zero: bool) -> torch.Tensor:
    make = torch.zeros if zero else torch.empty
    return make(layout.world * layout.local_numel, dtype=torch.float32, device=like.device)


@torch.no_grad()
def gather_params(chunks: dict, layout: ShardLayout, mesh: DataMesh | None) -> dict:
    """Full ``{name: tensor}`` leaves (the parameters, or a moment) from
    every rank's chunks: the local chunks are copied into one local buffer,
    one all-gather over the data axis fills the rank-major buffer, and each
    leaf is copied out of it. Every rank of the data axis must call this
    together."""
    first = chunks[layout.names[0]]
    local = torch.empty(layout.local_numel, dtype=torch.float32, device=first.device)
    views = layout.local_views(local)
    torch._foreach_copy_([views[k] for k in layout.names], [chunks[k] for k in layout.names])
    if _collective(mesh):
        whole = _global_buffer(layout, first, zero=False)
        _all_gather_flat(whole, local, group=mesh.group)
    else:
        whole = local
    rows = whole.view(layout.world, layout.local_numel)
    out = {}
    for i, k in enumerate(layout.names):
        o, c, n = layout.offsets[i], layout.chunks[i], layout.numel(i)
        out[k] = rows[:, o : o + c].reshape(-1)[:n].view(layout.shapes[i])
    return out


def gather_state(state: dict, layout: ShardLayout, mesh: DataMesh | None) -> dict:
    """A sharded train state made whole on every rank (the JAX package's
    ``make_state_gatherer``): what checkpoints, validation and the
    spike-rate pass read. Every rank must call this together."""
    opt = state["opt_state"]
    return {**state, "params": gather_params(state["params"], layout, mesh),
            "opt_state": {**opt, "mu": gather_params(opt["mu"], layout, mesh),
                          "nu": gather_params(opt["nu"], layout, mesh)}}


@torch.no_grad()
def reduce_scatter_grads(grads: dict, layout: ShardLayout, mesh: DataMesh | None) -> dict:
    """Sum the full fp32 ``{name: gradient}`` over the data axis and keep
    this rank's chunk of each: every gradient is written, zero-padded, into
    its rows of one rank-major buffer and one SUM reduce-scatter leaves the
    local buffer; returns ``{name: chunk}`` views of it."""
    first = grads[layout.names[0]]
    whole = _global_buffer(layout, first, zero=True)
    rows = whole.view(layout.world, layout.local_numel)
    for i, k in enumerate(layout.names):
        o, c, n = layout.offsets[i], layout.chunks[i], layout.numel(i)
        flat = grads[k].reshape(-1)
        full_rows, rest = divmod(n, c)
        if full_rows:
            rows[:full_rows, o : o + c].copy_(flat[: full_rows * c].view(full_rows, c))
        if rest:
            rows[full_rows, o : o + rest].copy_(flat[full_rows * c :])
    if _collective(mesh):
        local = torch.empty(layout.local_numel, dtype=torch.float32, device=first.device)
        _reduce_scatter_flat(local, whole, op=dist.ReduceOp.SUM, group=mesh.group)
    else:
        local = whole
    return layout.local_views(local)


def sharded_norm(chunks, mesh: DataMesh | None) -> torch.Tensor:
    """The global L2 norm of tensors whose chunks the ranks hold: each
    rank's per-chunk norms are all-gathered over the data axis and the norm
    of all of them is taken. Over one rank it is ``global_norm`` of the
    chunks, summed in the same order."""
    chunks = list(chunks)
    norms = torch.stack(torch._foreach_norm(chunks))
    if _collective(mesh):
        every = torch.empty(mesh.size * norms.numel(), dtype=norms.dtype, device=norms.device)
        _all_gather_flat(every, norms, group=mesh.group)
        norms = every
    return torch.linalg.vector_norm(norms)


# ---------------------------------------------------------------------------
# (e) Tensor parallelism: channel-sharded inference over the tensor axis
# ---------------------------------------------------------------------------

# Gate-stacked leaves ([i | f | g | o] along the sharded axis): the
# ConvLSTM's gate conv and the token LSTM's products. Their shard holds
# i, f, g and o of one slice of the hidden channels.
_CONVLSTM_GATES = re.compile(r"(^|\.)gates_(kernel|bias)$")
_TOKEN_LSTM_GATES = re.compile(r"(^|\.)l\d+_(w_ih|w_hh|bias)$")


def tp_spec(name: str, shape, k: int) -> tuple[int, bool] | None:
    """How a parameter leaf shards over a tensor group of ``k`` (the JAX
    package's ``tp_spec`` in the port's layouts): ``(axis, gated)`` where
    ``axis`` is its output-channel axis and ``gated`` says it stacks the
    four LSTM gates along it, or None to replicate. The axis is dim 0 of
    an OIHW conv weight, of biases and of GroupNorm affines, dim 1 of the
    ``(in, out, 2, 2)`` ConvTranspose weight and the trailing ``4*hidden``
    of the token LSTM's ``w_ih`` / ``w_hh``. A leaf shards when ``k``
    divides that axis (for a gated leaf: each gate's width)."""
    shape = tuple(shape)
    if k <= 1 or not shape:
        return None
    gated = bool(_CONVLSTM_GATES.search(name) or _TOKEN_LSTM_GATES.search(name))
    if name.endswith("up_weight"):
        axis = 1
    elif _TOKEN_LSTM_GATES.search(name):
        axis = len(shape) - 1
    else:
        axis = 0
    width = shape[axis] // 4 if gated else shape[axis]
    if (gated and shape[axis] % 4) or width % k:
        return None
    return axis, gated


def tp_shard_leaf(name: str, leaf: torch.Tensor, k: int, t: int) -> torch.Tensor:
    """Rank ``t``'s shard of one leaf (:func:`tp_spec`), contiguous; the
    leaf itself when it replicates."""
    spec = tp_spec(name, leaf.shape, k)
    if spec is None:
        return leaf
    axis, gated = spec
    if gated:
        gates = leaf.chunk(4, axis)
        w = gates[0].shape[axis] // k
        return torch.cat([g.narrow(axis, t * w, w) for g in gates], axis).contiguous()
    w = leaf.shape[axis] // k
    return leaf.narrow(axis, t * w, w).contiguous()


def tp_shard_params(params: dict, mesh: DataMesh) -> dict:
    """This rank's channel shards of full parameters over the mesh's
    tensor axis (:func:`tp_spec`); the dict itself without one."""
    if mesh is None or mesh.tensor == 1:
        return params
    return {k: tp_shard_leaf(k, v, mesh.tensor, mesh.tensor_rank) for k, v in params.items()}


@dataclass(frozen=True)
class _TensorGroup:
    size: int
    rank: int
    group: object


_tp = threading.local()


def current_tensor_group() -> _TensorGroup | None:
    """The tensor group this thread's forward shards channels over, None
    outside :func:`tensor_parallel`."""
    return getattr(_tp, "group", None)


@contextlib.contextmanager
def tensor_parallel(mesh: DataMesh | None):
    """Run the model's layers channel-sharded over ``mesh``'s tensor axis
    in this thread (a no-op without a tensor axis)."""
    prev = current_tensor_group()
    _tp.group = (None if mesh is None or mesh.tensor == 1
                 else _TensorGroup(mesh.tensor, mesh.tensor_rank, mesh.tensor_group))
    try:
        yield
    finally:
        _tp.group = prev


def all_gather_channels(x: torch.Tensor, tg: _TensorGroup) -> torch.Tensor:
    """The tensor group's channel shards of ``x`` (last axis), rank after
    rank: the global channel order."""
    # gloo wants the output as the inputs stacked on their first axis
    parts = torch.empty((tg.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    _all_gather_flat(parts, x.contiguous(), group=tg.group)
    parts = parts.view((tg.size,) + tuple(x.shape))
    return torch.movedim(parts, 0, -2).reshape(tuple(x.shape[:-1]) + (tg.size * x.shape[-1],))


def full_channels(x: torch.Tensor, channels: int) -> torch.Tensor:
    """``x`` with all ``channels`` channels on its last axis: itself when
    it has them, else (under :func:`tensor_parallel`) its shards gathered
    over the tensor group. Any other width raises."""
    c = x.shape[-1]
    if c == channels:
        return x
    tg = current_tensor_group()
    if tg is None or c * tg.size != channels:
        raise ValueError(f"a tensor of {c} channels where {channels} are expected"
                         + ("" if tg is None else f" (or 1/{tg.size} of them)"))
    return all_gather_channels(x, tg)


# ---------------------------------------------------------------------------
# (d) Spatial parallelism: image rows sharded over the spatial axis
# ---------------------------------------------------------------------------


def row_partition(n_rows: int, spatial: int, rank: int) -> tuple[int, int]:
    """The global rows ``[lo, hi)`` that spatial rank ``rank`` of
    ``spatial`` keeps of a map of ``n_rows`` rows: GSPMD's ceil blocks,
    ``ceil(n_rows / spatial)`` rows a rank, the last ranks short or empty.
    Every map is split by this rule from its own global height, at every
    scale, so a rank may own zero rows of a small map (one row of the
    stride-64 map over two ranks)."""
    block = -(-int(n_rows) // int(spatial))
    return min(rank * block, n_rows), min((rank + 1) * block, n_rows)


@dataclass(frozen=True)
class _SpatialGroup:
    size: int
    rank: int
    group: object
    height: int | None  # the global rows of the model's input frames

    def part(self, n: int, rank: int | None = None) -> tuple[int, int]:
        return row_partition(n, self.size, self.rank if rank is None else rank)


_sp = threading.local()


def current_spatial_group() -> _SpatialGroup | None:
    """The spatial group this thread's forward shards rows over, None
    outside :func:`spatial_parallel`."""
    return getattr(_sp, "group", None)


@contextlib.contextmanager
def spatial_parallel(mesh: DataMesh | None, height: int | None = None):
    """Run the model's layers row-sharded over ``mesh``'s spatial axis in
    this thread (a no-op without a spatial axis). ``height`` is the global
    row count of the input frames, whose rows ``row_partition(height)``
    this rank holds; the layers derive every other map's global height
    from it. Entered inside a checkpoint region, so the recompute of the
    backward (on the autograd engine's thread) runs sharded as well."""
    prev = current_spatial_group()
    _sp.group = (None if mesh is None or mesh.spatial == 1
                 else _SpatialGroup(mesh.spatial, mesh.spatial_rank, mesh.spatial_group,
                                    None if height is None else int(height)))
    try:
        yield
    finally:
        _sp.group = prev


def spatial_rows(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """This rank's rows (``row_partition`` of axis -3) of a whole tensor
    that every rank of the spatial group holds (an input batch): a slice,
    for inputs that need no gradient. ``x`` itself without a spatial
    axis."""
    if mesh is None or mesh.spatial == 1:
        return x
    lo, hi = row_partition(x.shape[-3], mesh.spatial, mesh.spatial_rank)
    return x.narrow(-3, lo, hi - lo)


class _Plan(NamedTuple):
    """What one rank of an exchange sends and receives. Rank ``r`` asks for
    the global rows ``want[r]``; ``send[j]`` are the local rows ``[a, b)``
    this rank sends rank j, ``recv[j]`` the count it receives from rank j
    (0 for itself); ``own`` its own local rows that it keeps;
    ``before`` / ``after`` the zero rows above 0 and below n it asks for."""

    send: tuple
    recv: tuple
    own: tuple
    before: int
    after: int
    exchange: bool  # does any rank receive a row from another?


def _plan_for(sg: _SpatialGroup, n: int, want: tuple | None = None) -> _Plan:
    """The plan of this rank of ``sg`` when each rank asks for ``want``
    (default: the whole map, every rank)."""
    return _plan(sg.size, sg.rank, n, want or ((0, n),) * sg.size)


@functools.lru_cache(maxsize=1024)  # a model asks for the same few plans at every call
def _plan(size: int, me: int, n: int, want: tuple) -> _Plan:
    parts = [row_partition(n, size, r) for r in range(size)]

    def overlap(r, j):  # global rows of rank r's that rank j asks for
        (p, q), (lo, hi) = parts[r], want[j]
        a, b = max(lo, p), min(hi, q)
        return (a, b) if b > a else (p, p)

    p = parts[me][0]
    send = tuple((a - p, b - p) if j != me else (0, 0)
                 for j in range(size) for a, b in [overlap(me, j)])
    recv = tuple(0 if r == me else overlap(r, me)[1] - overlap(r, me)[0] for r in range(size))
    a, b = overlap(me, me)
    lo, hi = want[me]
    total = max(hi - lo, 0)
    inside = max(0, min(hi, n) - max(lo, 0))
    before = min(max(0, -lo), total)
    exchange = any(overlap(r, j)[1] > overlap(r, j)[0]
                   for r in range(size) for j in range(size) if r != j)
    return _Plan(send, recv, (a - p, b - p), before, total - before - inside, exchange)


def _rows_first(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    return x[..., a:b, :, :].movedim(-3, 0)


def _alltoall(chunks: list, counts_in: list, counts_out: list, like: torch.Tensor,
              group) -> torch.Tensor:
    """One ``all_to_all_single`` of row chunks (rows first): ``chunks[j]``
    (``counts_in[j]`` rows) goes to rank j; returns the rows received,
    ``counts_out[j]`` of them from rank j, in rank order."""
    rest = tuple(like.shape[1:])
    inp = (torch.cat([c for c in chunks if c.shape[0]], 0) if any(counts_in)
           else like.new_empty((0,) + rest))
    out = like.new_empty((sum(counts_out),) + rest)
    dist.all_to_all_single(out, inp.contiguous(), list(counts_out), list(counts_in), group=group)
    return out


def _fetch(x: torch.Tensor, sg: _SpatialGroup, plan: _Plan) -> torch.Tensor:
    """The rows ``plan`` asks for, from the ranks that own them, between
    the zero rows it asks for above and below the map."""
    a, b = plan.own
    parts = [x[..., a:b, :, :]]
    if plan.exchange:
        like = _rows_first(x, 0, 0)
        got = _alltoall([_rows_first(x, s0, s1) for s0, s1 in plan.send],
                        [s1 - s0 for s0, s1 in plan.send], plan.recv, like, sg.group)
        above = sum(plan.recv[: sg.rank])
        parts = [got[:above].movedim(0, -3), parts[0], got[above:].movedim(0, -3)]
    shape = list(x.shape)
    if plan.before:
        shape[-3] = plan.before
        parts.insert(0, x.new_zeros(shape))
    if plan.after:
        shape[-3] = plan.after
        parts.append(x.new_zeros(shape))
    return torch.cat(parts, -3) if len(parts) > 1 else parts[0].contiguous()


def _return_rows(g: torch.Tensor, x_shape, sg: _SpatialGroup, plan: _Plan) -> torch.Tensor:
    """The backward of :func:`_fetch`: each fetched row's gradient sent
    back to the rank that owns the row and added there."""
    g = g.narrow(-3, plan.before, g.shape[-3] - plan.before - plan.after)
    above = sum(plan.recv[: sg.rank])
    a, b = plan.own
    grad = g.new_zeros(x_shape)
    grad[..., a:b, :, :] += g.narrow(-3, above, b - a)
    if plan.exchange:
        below = sum(plan.recv[sg.rank + 1:])
        mine = g.narrow(-3, above + b - a, below)
        rows = torch.cat([g.narrow(-3, 0, above).movedim(-3, 0), mine.movedim(-3, 0)], 0)
        counts = list(plan.recv)
        chunks = list(torch.split(rows, [c for c in counts], 0))
        back = _alltoall(chunks, counts, [s1 - s0 for s0, s1 in plan.send],
                         _rows_first(g, 0, 0), sg.group)
        off = 0
        for s0, s1 in plan.send:
            if s1 > s0:
                grad[..., s0:s1, :, :] += back[off: off + s1 - s0].movedim(0, -3)
                off += s1 - s0
    return grad


class _FetchRows(torch.autograd.Function):
    # Every exchange saves a tensor and reads it first in its backward: a
    # checkpoint region then recomputes (and exchanges) before any of its
    # backward exchanges on every rank, whatever else each rank saved.
    @staticmethod
    def forward(ctx, x, sg, plan):
        ctx.sg, ctx.plan, ctx.x_shape = sg, plan, x.shape
        ctx.save_for_backward(x.new_empty(0))
        return _fetch(x, sg, plan)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        ctx.saved_tensors
        return _return_rows(g.contiguous(), ctx.x_shape, ctx.sg, ctx.plan), None, None


def fetch_rows(x_local: torch.Tensor, n_global: int, lo, hi) -> torch.Tensor:
    """Global rows ``[lo[r], hi[r])`` of a row-sharded map of ``n_global``
    rows (axis -3) on spatial rank r: its own rows plus the ones the other
    ranks send; rows outside ``[0, n_global)`` are zeros. ``lo`` and ``hi``
    give every rank's request (the same sequences on every rank), so no
    request is exchanged; when every rank asks only for rows it owns, no
    rank communicates. Every rank of the group calls this together. The
    backward sends each fetched row's gradient back to its owner, which
    adds it."""
    sg = current_spatial_group()
    want = tuple(zip((int(v) for v in lo), (int(v) for v in hi)))
    return _FetchRows.apply(x_local, sg, _plan_for(sg, int(n_global), want))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sg, n):
        ctx.sg, ctx.n = sg, n
        ctx.save_for_backward(x.new_empty(0))
        return _fetch(x, sg, _plan_for(sg, n))

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors
        lo, hi = ctx.sg.part(ctx.n)
        return g[..., lo:hi, :, :].contiguous(), None, None


def gather_rows(x_local: torch.Tensor, n_global: int) -> torch.Tensor:
    """The whole map (axis -3) on every rank of the spatial group. What
    follows a gather is computed the same on every rank, so its backward
    keeps this rank's rows of the incoming gradient (a slice, no sum)."""
    return _GatherRows.apply(x_local, current_spatial_group(), int(n_global))


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sg, n):
        ctx.sg, ctx.n = sg, n
        ctx.save_for_backward(x.new_empty(0))
        lo, hi = sg.part(n)
        return x[..., lo:hi, :, :].contiguous()

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors
        sg, n = ctx.sg, ctx.n
        return _fetch(g.contiguous(), sg, _plan_for(sg, n)), None, None


def shard_rows(x_whole: torch.Tensor, n_global: int) -> torch.Tensor:
    """This rank's rows of a map that every rank of the spatial group
    computed whole (the token LSTM's output): the dual of
    :func:`gather_rows`. Its backward gathers the gradient's rows from
    every rank, so the whole computation before it gets the whole
    gradient on every rank."""
    return _ShardRows.apply(x_whole, current_spatial_group(), int(n_global))


class _SpatialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.save_for_backward(x.new_empty(0))
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors
        g = g.clone().contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the spatial group (GroupNorm's per-channel sums,
    the spike-rate counts); its backward sums the gradient likewise, since
    every rank's rows read the sum. ``x`` itself outside
    :func:`spatial_parallel`."""
    sg = current_spatial_group()
    return x if sg is None else _SpatialSum.apply(x, sg.group)


@torch.no_grad()
def all_reduce_spatial(grads: dict, mesh: DataMesh | None, skip=()) -> dict:
    """Sum the fp32 ``{name: gradient}`` over the spatial group, all but
    the names in ``skip`` (the parameters every rank used the same way on
    whole maps), in one flat all-reduce; returns a new dict."""
    if mesh is None or mesh.spatial == 1:
        return grads
    names = [k for k in grads if k not in skip]
    summed = all_reduce_grads({k: grads[k] for k in names},
                              DataMesh(mesh.spatial, mesh.spatial_rank, mesh.spatial_group))
    return {k: summed.get(k, g) for k, g in grads.items()}
