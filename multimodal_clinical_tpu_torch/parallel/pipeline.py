"""GPipe over the ranks of the ``stage`` mesh axis (port of
``multimodal_clinical_tpu/parallel/pipeline.py``).

A stack of S shape-preserving blocks is laid out one stage a rank along
the stage axis, a batch is cut into M microbatches, and the activations
hop stage -> stage + 1.  The schedule is JAX's: M + S - 1 ticks, stage 0
feeds microbatch t at tick t, stage s runs microbatch t - s, the last
stage finishes microbatch j at tick j + S - 1; its outputs are then made
whole on every stage rank (JAX's masked ``psum``; here a ``broadcast``).

The backward runs the reverse pipeline: each stage rank takes the
gradient of the outputs, which the same loss gives every stage rank, the
last stage back-propagates each microbatch through its blocks and hands
the input gradient to the stage before, and stage 0's input gradient is
made whole on every stage rank.  So every leaf outside the pipelined
region ends the backward with the same gradient on every stage rank, as
JAX's one program gives it, and a stage's parameters get its stage's.

The hop (JAX's ``ppermute``) follows the backend
(``parallel/distributed.py``): NCCL sends and receives device tensors
between separate cards; gloo offers send and receive for host tensors
only, so where ranks share a card, or run on the CPU, an activation is
staged through the host.  With a data axis each rank's rows are its data
coordinate's, so the microbatches split those rows (JAX shards the
microbatch dim over ``data``).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.distributed as dist

from .distributed import backend, group_rank, group_size
from .mesh import STAGE_AXIS, Mesh

Params = Dict[str, torch.Tensor]


def stack_stage_params(params_list: Sequence[Params]) -> Params:
    """Stack S per-stage parameter dicts along a new leading stage dim."""
    return {k: torch.stack([p[k] for p in params_list])
            for k in params_list[0]}


def stage_sharding(mesh: Mesh, axis: str = STAGE_AXIS):
    """The placement of stacked stage parameters: the leading dim over the
    stage axis (each rank holds exactly its stage's weights)."""
    return (axis,)


def _wire(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor of ``dtype`` travels in: gloo moves no half
    type, so those go as fp32 (exactly) there."""
    if backend() != "nccl" and dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


class _Hop:
    """Point to point between neighbouring stage ranks of ``group``."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, device
        self.host = backend() != "nccl" and device.type != "cpu"
        self.pending = []

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def send(self, tensor: torch.Tensor, stage: int) -> None:
        t = tensor.detach().to("cpu" if self.host else tensor.device,
                               _wire(tensor.dtype)).contiguous()
        self.pending.append((dist.isend(t, self._peer(stage),
                                        group=self.group), t))

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=_wire(like.dtype),
                          device="cpu" if self.host else like.device)
        dist.recv(buf, self._peer(stage), group=self.group)
        return buf.to(self.device, like.dtype)

    def wait(self) -> None:
        for work, _ in self.pending:
            work.wait()
        self.pending = []


def _broadcast_from(tensor: torch.Tensor, stage: int, group) -> torch.Tensor:
    buf = tensor.to(_wire(tensor.dtype))
    dist.broadcast(buf, dist.get_global_rank(group, stage), group=group)
    return tensor.copy_(buf)


def _fill_drain(block_fn, params: Params, x_micro: torch.Tensor, group,
                build: bool):
    """JAX's forward schedule on this stage rank: at tick t it runs
    microbatch t - stage, fed by stage 0's stream or the hop from the
    stage before, and hands its output on; the last stage keeps each
    output.  With ``build`` each microbatch's graph is kept (its input and
    output).  Returns the last stage's outputs on every stage rank and
    the kept graphs."""
    stages, stage = group_size(group), group_rank(group)
    n_micro = x_micro.shape[0]
    hop = _Hop(group, x_micro.device)
    outs, saved = torch.zeros_like(x_micro), []
    for t in range(n_micro + stages - 1):
        j = t - stage
        if not 0 <= j < n_micro:
            continue
        x_in = (x_micro[j] if stage == 0
                else hop.recv(x_micro[j], stage - 1)).detach()
        x_in.requires_grad_(build)
        with torch.set_grad_enabled(build):
            y = block_fn(params, x_in)
        if stage < stages - 1:
            hop.send(y, stage + 1)
        else:
            outs[j] = y.detach()
        if build:
            saved.append((x_in, y))
    hop.wait()
    return _broadcast_from(outs, stages - 1, group), saved


class _GPipe(torch.autograd.Function):
    """The schedule on one stage rank, forward and reverse."""

    @staticmethod
    def forward(ctx, block_fn, names, group, x_micro, *values):
        params = [v.detach().requires_grad_(v.requires_grad) for v in values]
        out, ctx.saved = _fill_drain(block_fn, dict(zip(names, params)),
                                     x_micro, group, True)
        ctx.params, ctx.group = params, group
        return out

    @staticmethod
    def backward(ctx, grad_out):
        group = ctx.group
        stages, stage = group_size(group), group_rank(group)
        hop = _Hop(group, grad_out.device)
        trained = [i for i, p in enumerate(ctx.params) if p.requires_grad]
        grads = [None] * len(ctx.params)
        dx_micro = torch.zeros_like(grad_out)
        for j in reversed(range(len(ctx.saved))):
            x_in, y = ctx.saved[j]
            dy = (grad_out[j] if stage == stages - 1
                  else hop.recv(grad_out[j], stage + 1)).to(y.dtype)
            got = torch.autograd.grad(
                y, [x_in] + [ctx.params[i] for i in trained], dy,
                allow_unused=True)
            if stage > 0:
                hop.send(got[0], stage - 1)
            else:
                dx_micro[j] = got[0]
            for i, g in zip(trained, got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        hop.wait()
        ctx.saved = None
        dx_micro = _broadcast_from(dx_micro, 0, group)
        return (None, None, None, dx_micro) + tuple(grads)


def pipeline_spmd(block_fn: Callable, params: Params,
                  x_micro: torch.Tensor, group) -> torch.Tensor:
    """One stage rank's GPipe: ``block_fn(params, x) -> y`` with
    ``y.shape == x.shape``; ``params`` this stage's parameters (the stage
    dim dropped); ``x_micro`` the (M, mb, ...) microbatches (stage 0
    feeds them; the others take their shape).  Returns the last stage's
    (M, mb, ...) outputs on every stage rank."""
    if group_size(group) == 1:
        return torch.stack([block_fn(params, xm) for xm in x_micro])
    if not (torch.is_grad_enabled() and (x_micro.requires_grad or any(
            v.requires_grad for v in params.values()))):
        return _fill_drain(block_fn, params, x_micro, group, False)[0]
    return _GPipe.apply(block_fn, list(params), group, x_micro,
                        *params.values())


def pipeline_apply(mesh: Mesh, block_fn: Callable, stacked_params: Params,
                   x: torch.Tensor, n_micro: int, axis: str = STAGE_AXIS,
                   data_axis: str | None = None) -> torch.Tensor:
    """Run ``x`` (this rank's B / D rows of the global batch of B) through
    the S-stage pipeline on ``mesh``.  ``stacked_params``: per-stage
    parameters stacked on a leading dim of S (``stack_stage_params``), or
    this rank's stage of them (a leading dim of 1, as
    ``parallel/sharding.py`` leaves a stage-sharded leaf).  ``n_micro``
    microbatches must divide the global batch, and with ``data_axis`` a
    data coordinate's rows.  Returns the (B / D, ...) output of the final
    stage on every stage rank."""
    dp = mesh.shape[data_axis] if data_axis else 1
    batch = x.shape[0] * dp
    if batch % n_micro:
        raise ValueError(f"n_micro {n_micro} must divide batch {batch}")
    if x.shape[0] % n_micro:
        raise ValueError(f"n_micro {n_micro} must divide the "
                         f"{x.shape[0]} rows of a {data_axis!r} "
                         "coordinate")
    n_stages = mesh.shape[axis]
    leaves = list(stacked_params.values())
    if leaves and leaves[0].shape[0] not in (n_stages, 1):
        raise ValueError(
            f"stacked_params has {leaves[0].shape[0]} stages but mesh axis "
            f"{axis!r} has {n_stages} devices; they must match 1:1")
    stage = mesh.coordinate(axis)
    params = {k: (v[stage] if v.shape[0] == n_stages and n_stages > 1
                  else v[0]) for k, v in stacked_params.items()}
    x_micro = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    out = pipeline_spmd(block_fn, params, x_micro, mesh.group(axis))
    return out.reshape(x.shape[0], *out.shape[2:])
