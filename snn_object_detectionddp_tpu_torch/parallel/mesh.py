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

FSDP, spatial and tensor parallelism (the JAX package's parts (c)-(e)) are
not ported; the entry points raise on them.
"""

from __future__ import annotations

import os
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
    """Raise on the mesh axes the port does not run: FSDP (an axis of the
    train state, so checked when ``train``), spatial and tensor
    parallelism. Every entry point calls this first."""
    if train and mesh_cfg.fsdp:
        raise NotImplementedError(
            "mesh.fsdp (sharded train state) is not ported: ROADMAP §1 item 3 (c), FSDP")
    if mesh_cfg.spatial > 1:
        raise NotImplementedError(
            "mesh.spatial > 1 (image height split over devices) is not ported: "
            "ROADMAP §1 item 3 (d), spatial parallelism")
    if mesh_cfg.tensor > 1:
        raise NotImplementedError(
            "mesh.tensor > 1 (channel-sharded inference) is not ported: "
            "ROADMAP §1 item 3 (e), tensor parallelism")


@dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh: ``size`` processes (the data axis size: the global
    batch tiles over it), this one's ``rank`` and the process ``group``
    (None for a single process without a group, where every collective is
    the identity). Collectives run on the device of the tensors given to
    them."""

    size: int
    rank: int
    group: object | None


def make_mesh(data: int = -1) -> DataMesh:
    """The data mesh over the whole process group. ``data=-1`` (or 0) takes
    every process; any other value must equal the world size: a mesh over
    part of the processes would leave the others idle, and a ``data``
    larger than the world raises, as the JAX ``make_mesh`` does."""
    n, rank = _world()
    data = int(data)
    if data in (-1, 0):
        data = n
    if data > n:
        raise ValueError(f"mesh.data={data} exceeds the world size of {n} process(es): launch "
                         f"{data} processes (torchrun --nproc_per_node {data}) or set mesh.data: -1")
    if data != n:
        raise ValueError(f"mesh.data={data} must equal the world size ({n}) or be -1: the data "
                         "mesh spans the whole process group")
    return DataMesh(size=n, rank=rank, group=dist.group.WORLD if dist.is_initialized() else None)


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
    dist.gather_object(list(items), parts, dst=0, group=mesh.group)
    return None if parts is None else [x for part in parts for x in part]


def broadcast_from_main(obj, mesh: DataMesh | None):
    """Rank 0's ``obj`` on every rank (``broadcast_object_list``)."""
    if not _collective(mesh):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]
