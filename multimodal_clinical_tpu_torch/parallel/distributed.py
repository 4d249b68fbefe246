"""Multi-process start-up and the process group's collectives (port of
``multimodal_clinical_tpu/parallel/distributed.py``).

The JAX package calls ``jax.distributed.initialize`` from the config's
``dist_*`` keys or the TPU metadata.  Here the keys give
``torch.distributed.init_process_group`` its address
(``dist_coordinator``: ``host:port``, or a URL such as ``tcp://...`` or
``file://...``), world size (``dist_num_processes``) and rank
(``dist_process_id``); ``dist_init`` alone reads the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, as
``torchrun`` sets them), the counterpart of the TPU metadata.  One process
drives one device: ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` from the
environment, else the rank modulo the visible cards), or the CPU when the
caller asks for it.  The backend follows from that layout: NCCL where
every local rank has a card of its own, gloo where ranks share a card
(NCCL refuses two ranks on one device) and on the CPU.

The collectives below, and the pipeline's hop (``parallel/pipeline.py``),
are the only ones the port issues.  Each takes the group it runs over,
and is a no-op on None or a group of one, so a run without a group, or
with a group of one, computes exactly what the single-device code does.
They use ``all_reduce``, ``broadcast`` and ``barrier`` only, which gloo
also offers for CUDA tensors; an all-gather is the all-reduce of a
zero-padded buffer.  The autograd ones carry tensor parallelism and
sequence sharding: Megatron's f (``copy_to_axis``: the identity, its
gradient summed over the axis) and g (``gather_from_axis``: the axis's
parts gathered, the gradient's own part kept), the entry into a sharded
region (``scatter_to_axis``: the own part, the gradient gathered) and the
gather whose consumers differ by rank (``gather_partial``: its gradient
summed over the axis, then the own part kept).  The ops that see the global
batch (global BatchNorm, the dropout and SpecAugment draws) read the data
axis's group from ``axis_group``, which the train and eval steps set for
their extent (``data_axis``): outside a step, an initialised process
group switches nothing.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

_backend: Optional[str] = None
# the data axis's process group for the extent of a step (``data_axis``)
_axis = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return rank() == 0


def backend() -> Optional[str]:
    return _backend


def _address(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_if_requested(args, device="cuda") -> torch.device:
    """Start the process group when ``dist_init`` or ``dist_coordinator``
    is set, and return this rank's device.  A no-op (the device as given)
    otherwise, and when the group is already up."""
    global _backend
    want = bool(getattr(args, "dist_init", False))
    coordinator = getattr(args, "dist_coordinator", None)
    device = torch.device(device)
    if not want and coordinator is None:
        return resolve_device(device)
    if dist.is_initialized():
        return _rank_device(device, rank())
    num = getattr(args, "dist_num_processes", None)
    pid = getattr(args, "dist_process_id", None)
    if coordinator:
        if num is None or pid is None:
            raise ValueError("dist_coordinator needs dist_num_processes and "
                             "dist_process_id")
        init, world, this = _address(str(coordinator)), int(num), int(pid)
    else:
        init = "env://"
        world = int(num if num is not None else os.environ["WORLD_SIZE"])
        this = int(pid if pid is not None else os.environ["RANK"])
    device = _rank_device(device, this)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        _backend = "nccl"
    else:
        _backend = "gloo"
    kwargs = {}
    if _backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(_backend, init_method=init, world_size=world,
                            rank=this, **kwargs)
    print(f"[dist] initialized: process {this}/{world}, {world} devices "
          f"(1 local), backend {_backend}", flush=True)
    return device


def _rank_device(device: torch.device, this: int) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK",
                               this % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def shutdown() -> None:
    global _backend
    if dist.is_initialized():
        dist.destroy_process_group()
    _backend = None


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


@contextlib.contextmanager
def data_axis(group):
    """Inside the block ``axis_group()`` is ``group``: the step's data
    axis (``parallel/mesh.py::Mesh.data_group``; None for one rank)."""
    global _axis
    before, _axis = _axis, group
    try:
        yield
    finally:
        _axis = before


def axis_group():
    """The data axis's group of the step that is running, else None."""
    return _axis


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_sum_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` over ``group``'s ranks in place; returns it."""
    if group_size(group) > 1:
        dist.all_reduce(tensor, group=group)
    return tensor


def gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    """(world * b, ...) from every rank's (b, ...) rows, in rank order,
    without gradient: each rank writes its rows into a zero buffer and the
    buffers are summed (adding zeros is exact)."""
    world = group_size(group)
    if world == 1:
        return local
    # gloo sums no bfloat16 or bool: those go through fp32, exactly
    wide = local.dtype in (torch.bfloat16, torch.float16, torch.bool)
    buf = local.new_zeros((world,) + tuple(local.shape),
                          dtype=torch.float32 if wide else local.dtype)
    buf[group_rank(group)] = local.detach()
    dist.all_reduce(buf, group=group)
    return buf.flatten(0, 1).to(local.dtype)


def global_rows(local: torch.Tensor, group) -> torch.Tensor:
    """The global batch of ``local``'s rows, with this rank's rows the
    tensor itself (its gradient flows there) and the others' constants."""
    if group_size(group) == 1:
        return local
    b, r = local.shape[0], group_rank(group)
    others = gather_rows(local, group)
    return torch.cat([others[:r * b], local, others[(r + 1) * b:]])


def rank_rows(global_batch: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of a (world * b, ...) tensor."""
    world = group_size(group)
    if world == 1:
        return global_batch
    b, r = global_batch.shape[0] // world, group_rank(group)
    return global_batch[r * b:(r + 1) * b]


def _sum_(tensor: torch.Tensor, group) -> torch.Tensor:
    """``all_reduce_sum_`` for any float dtype: gloo sums no bfloat16, so
    half types go through fp32 (one rounding of the exact sum)."""
    if group_size(group) == 1:
        return tensor
    if tensor.dtype in (torch.bfloat16, torch.float16):
        return tensor.copy_(all_reduce_sum_(tensor.float(), group))
    return all_reduce_sum_(tensor, group)


def all_gather_dim(local: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``local`` concatenated along ``dim`` in rank order,
    without gradient."""
    if group_size(group) == 1:
        return local
    return gather_rows(local.movedim(dim, 0).contiguous(),
                       group).movedim(0, dim)


def own_part(full: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal part of ``full`` along ``dim``."""
    world = group_size(group)
    if world == 1:
        return full
    n = full.shape[dim] // world
    return full.narrow(dim, group_rank(group) * n, n)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_(grad.clone(), ctx.group), None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return own_part(grad, ctx.dim, ctx.group).contiguous(), None, None


class _ScatterToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return own_part(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_dim(grad, ctx.dim, ctx.group), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        summed = _sum_(grad.contiguous().clone(), ctx.group)
        return own_part(summed, ctx.dim, ctx.group).contiguous(), None, None


def copy_to_axis(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; its gradient summed over ``group``
    (each rank's part of a sharded consumer adds its share)."""
    return x if group_size(group) == 1 else _CopyToAxis.apply(x, group)


def gather_from_axis(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Megatron's g: the ranks' parts of ``x`` gathered along ``dim``; the
    consumers are the same on every rank, so the gradient's own part is
    this rank's gradient."""
    if group_size(group) == 1:
        return x
    return _GatherFromAxis.apply(x, dim, group)


def scatter_to_axis(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part of the replicated ``x`` along ``dim``; the
    gradient gathered, so the producers' gradient is whole on every
    rank."""
    if group_size(group) == 1:
        return x
    return _ScatterToAxis.apply(x, dim, group)


def gather_partial(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' parts of ``x`` gathered along ``dim`` for consumers that
    differ by rank (a sequence shard's queries over every key): the
    gradient summed over ``group``, then its own part kept."""
    if group_size(group) == 1:
        return x
    return _GatherPartial.apply(x, dim, group)
