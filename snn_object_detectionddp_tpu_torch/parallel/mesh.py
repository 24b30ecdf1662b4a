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

Spatial parallelism (part (d)) is not ported; the entry points raise on it.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

# Workers of a loaded host may take minutes to reach the rendezvous (the
# JAX package's initialization_timeout).
RENDEZVOUS_TIMEOUT = timedelta(seconds=600)


def _backend(device: str | torch.device) -> str:
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: str | torch.device = "cuda") -> None:
    """Join the process group through a ``tcp://`` rendezvous at
    ``coordinator`` (``host:port`` or ``tcp://host:port``). Backend NCCL on
    the card; gloo when ``device`` is the CPU. On the card the caller sets
    this process's CUDA device first (:func:`maybe_init_distributed` does)."""
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(_backend(device), init_method=init_method,
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
    """Raise on the mesh axes the port does not run: spatial parallelism
    (``NotImplementedError``), and a tensor axis in training
    (``ValueError``: tensor parallelism is inference-only by design, as in
    the JAX package). Every entry point calls this first."""
    if mesh_cfg.spatial > 1:
        raise NotImplementedError(
            "mesh.spatial > 1 (image height split over devices) is not ported: "
            "ROADMAP §1 item 3 (d), spatial parallelism")
    if train and mesh_cfg.tensor > 1:
        raise ValueError(
            "mesh.tensor > 1 is inference-only (eval/serving latency); "
            "training supports data and fsdp parallelism")


@dataclass(frozen=True)
class DataMesh:
    """A ``data x tensor`` process mesh. ``size``, ``rank`` and ``group``
    are the data axis (the global batch tiles over it; ``group`` is None
    for a single process without a group, where every collective is the
    identity); ``tensor``, ``tensor_rank`` and ``tensor_group`` the tensor
    axis (``tensor_group`` None when ``tensor`` is 1). Collectives run on
    the device of the tensors given to them."""

    size: int
    rank: int
    group: object | None
    tensor: int = 1
    tensor_rank: int = 0
    tensor_group: object | None = None


def make_mesh(data: int = -1, tensor: int = 1) -> DataMesh:
    """The ``data x tensor`` mesh over the whole process group, ranks laid
    out ``rank = d * tensor + t``. ``data=-1`` (or 0) takes every process
    the tensor axis leaves; any other value must make ``data * tensor`` the
    world size: a mesh over part of the processes would leave the others
    idle, and a mesh larger than the world raises, as the JAX
    ``make_mesh`` does. Every process must call this with the same
    arguments (each axis group is made by every rank)."""
    n, rank = _world()
    data, tensor = int(data), int(tensor)
    if tensor < 1 or n % tensor:
        raise ValueError(f"mesh.tensor={tensor} must divide the world size of {n} process(es)")
    if data in (-1, 0):
        data = n // tensor
    if data * tensor > n:
        raise ValueError(f"mesh.data={data} x mesh.tensor={tensor} exceeds the world size of {n} "
                         f"process(es): launch {data * tensor} processes (torchrun "
                         f"--nproc_per_node {data * tensor}) or set mesh.data: -1")
    if data * tensor != n:
        raise ValueError(f"mesh.data={data} x mesh.tensor={tensor} must equal the world size "
                         f"({n}): the mesh spans the whole process group")
    if not dist.is_initialized():
        return DataMesh(size=1, rank=0, group=None)
    if tensor == 1:
        return DataMesh(size=n, rank=rank, group=dist.group.WORLD)
    d, t = divmod(rank, tensor)
    data_group = tensor_group = None
    for j in range(tensor):  # every rank makes every group, in one order
        g = dist.new_group([i * tensor + j for i in range(data)])
        if j == t:
            data_group = g
    for i in range(data):
        g = dist.new_group([i * tensor + j for j in range(tensor)])
        if i == d:
            tensor_group = g
    return DataMesh(size=data, rank=d, group=data_group, tensor=tensor, tensor_rank=t,
                    tensor_group=tensor_group)


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
