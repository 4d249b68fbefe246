"""FSDP over the data axis: which leaf is sharded, on which dim, and the
sharded train state (port of ``multimodal_clinical_tpu/parallel/
sharding.py``, reduced to the data axis).

The JAX rule (``_fsdp_dim``): a leaf of at least ``_FSDP_MIN_SIZE``
elements shards one dim over the data axis, its last dim in the flax
layout when the axis size divides it, else its largest divisible dim;
smaller leaves stay replicated.  The port's leaves are in the torch
layout, so the rule reads each leaf in its flax layout (a conv's OIHW
weight as HWIO, a dense weight (out, in) as (in, out); the leaf kinds of
``models/jax_weights.py``) and maps the dim back.

``ShardedParams`` applies it to a train state: a sharded leaf lives
between steps as this rank's 1/D slice, which the optimizer updates, so
its momentum is a slice too.  A step gathers every slice into its whole
leaf before the forward, sums the full gradients over the ranks as the
replicated leaves' are (the modulation of OGM-GE needs each leaf's whole
gradient), keeps this rank's slice of each, and frees the whole leaves
after the update.  So FSDP here saves the state held between steps (the
sharded leaves' weights and momentum): the step's peak holds the whole
model and its full gradients, as data parallelism's does, and each
gather and gradient sum is an ``all_reduce`` of the whole leaf (gloo
offers no all-gather or reduce-scatter of CUDA tensors).  Checkpoints
hold the full tree (``full_state``), so a run on any number of ranks
loads them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .distributed import all_reduce_sum_, group_rank, group_size, world_size
from .mesh import DATA_AXIS

#: leaves smaller than this many elements stay replicated under FSDP
_FSDP_MIN_SIZE = 65536

# flax dim d of a leaf is torch dim PERM[d]: HWIO <- OIHW, (in, out) <-
# (out, in); the kinds whose torch leaf merges flax axes read as dense
_CONV = (2, 3, 1, 0)
_DENSE = (1, 0)
_DENSE_KINDS = ("dense", "heads_in", "heads_out", "vgg_classifier", "gates",
                "packed_heads_in")


def _fsdp_dim(shape: Sequence[int], fsdp: int, taken_dim: int = -1) -> int:
    """Dim of a leaf of ``shape`` (flax layout) to shard over the data
    axis, or -1.  Prefers the last dim, then the largest divisible one;
    never the TP-taken dim."""
    ndim = len(shape)
    if fsdp <= 1 or ndim == 0:
        return -1
    if int(np.prod(shape)) < _FSDP_MIN_SIZE:
        return -1
    dims = sorted(range(ndim), key=lambda d: (d != ndim - 1, -shape[d]))
    for d in dims:
        if d != taken_dim and shape[d] % fsdp == 0:
            return d
    return -1


def _perm(kind: Optional[str], ndim: int) -> Tuple[int, ...]:
    if ndim == 4 and kind in (None, "conv"):
        return _CONV
    if ndim == 2 and (kind in _DENSE_KINDS or kind is None):
        return _DENSE
    return tuple(range(ndim))


def fsdp_dim(shape: Sequence[int], fsdp: int,
             kind: Optional[str] = None) -> int:
    """Torch dim of a torch-layout leaf of ``shape`` that FSDP shards, or
    -1.  ``kind``: the leaf's ``models/jax_weights.py`` layout kind; None
    reads a 4-D leaf as a conv and a 2-D one as a dense weight."""
    perm = _perm(kind, len(shape))
    d = _fsdp_dim([shape[p] for p in perm], fsdp)
    return perm[d] if d >= 0 else -1


def param_spec(leaf: torch.Tensor, fsdp_axis_size: int = 1,
               kind: Optional[str] = None) -> Tuple[Optional[str], ...]:
    """The leaf's placement as the JAX ``PartitionSpec`` would give it:
    the data axis's name at the sharded dim, () when replicated."""
    d = fsdp_dim(tuple(leaf.shape), fsdp_axis_size, kind)
    if d < 0:
        return ()
    return tuple(DATA_AXIS if i == d else None for i in range(leaf.dim()))


def layout_kinds(model: nn.Module) -> Dict[str, str]:
    """Parameter name -> layout kind (``models/jax_weights.py``)."""
    from ..models.jax_weights import jax_key_map

    return {name: kind for name, (_, _, kind) in jax_key_map(model).items()}


class _Leaf:
    def __init__(self, param: nn.Parameter, dim: int, group):
        world, this = group_size(group), group_rank(group)
        self.param, self.dim, self.group = param, dim, group
        self.size = param.shape[dim] // world
        self.start = this * self.size
        self.shape, self.stride = tuple(param.shape), param.stride()
        self.shard = nn.Parameter(
            param.detach().narrow(dim, self.start, self.size).contiguous(),
            requires_grad=param.requires_grad)

    def slice_of(self, full: torch.Tensor) -> torch.Tensor:
        return full.narrow(self.dim, self.start, self.size)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        full = torch.empty_strided(self.shape, self.stride, dtype=shard.dtype,
                                   device=shard.device).zero_()
        self.slice_of(full).copy_(shard)
        return all_reduce_sum_(full, self.group)


class ShardedParams:
    """FSDP of ``model``'s parameters under ``optimizer``, which was built
    over the full parameters and holds no state yet, over the data axis's
    ``group``: its sharded leaves are swapped for their slices."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 group, kinds: Optional[Dict[str, str]] = None):
        world = group_size(group)
        kinds = layout_kinds(model) if kinds is None else kinds
        self.leaves: List[_Leaf] = []
        by_param = {}
        for name, param in model.named_parameters():
            d = fsdp_dim(tuple(param.shape), world, kinds.get(name))
            if d >= 0:
                leaf = _Leaf(param, d, group)
                self.leaves.append(leaf)
                by_param[param] = leaf
        for group in optimizer.param_groups:
            group["params"] = [by_param[p].shard if p in by_param else p
                               for p in group["params"]]
        self._by_shard = {leaf.shard: leaf for leaf in self.leaves}
        self.gathered = True
        self.release()

    def gather(self) -> None:
        """Every sharded leaf whole in its module, from the ranks'
        slices; a no-op until the next update."""
        if self.gathered:
            return
        with torch.no_grad():
            for leaf in self.leaves:
                leaf.param.data = leaf.gather(leaf.shard.detach())
        self.gathered = True

    def release(self) -> None:
        """Free the whole leaves: the slices are the state."""
        for leaf in self.leaves:
            leaf.param.data = leaf.param.data.new_empty(0)
            leaf.param.grad = None
        self.gathered = False

    def keep_grad_slices(self) -> None:
        """After the gradients' sum over the ranks: each slice's gradient
        is this rank's slice of its leaf's."""
        for leaf in self.leaves:
            grad = leaf.param.grad
            leaf.shard.grad = (None if grad is None
                               else leaf.slice_of(grad).contiguous())
            leaf.param.grad = None

    def reshard(self) -> None:
        """The slices from the gathered leaves (after a load into them)."""
        with torch.no_grad():
            for leaf in self.leaves:
                leaf.shard.copy_(leaf.slice_of(leaf.param.detach()))

    # -- the optimizer's state as the full tree ------------------------
    def _params_in_order(self, optimizer) -> List[nn.Parameter]:
        return [p for g in optimizer.param_groups for p in g["params"]]

    def full_optimizer_state(self, optimizer) -> Dict:
        """``optimizer.state_dict()`` with every slice-shaped tensor of a
        sharded leaf gathered whole: what the optimizer of an unsharded
        run would hold."""
        sd = optimizer.state_dict()
        state = {}
        for i, p in enumerate(self._params_in_order(optimizer)):
            entry = sd["state"].get(i)
            if entry is None:
                continue
            leaf = self._by_shard.get(p)
            state[i] = {k: (leaf.gather(v) if leaf is not None
                            and torch.is_tensor(v)
                            and tuple(v.shape) == tuple(p.shape) else v)
                        for k, v in entry.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_full_optimizer_state(self, optimizer, sd: Dict) -> None:
        state = {}
        params = self._params_in_order(optimizer)
        for i, entry in sd["state"].items():
            leaf = self._by_shard.get(params[int(i)])
            state[i] = {k: (leaf.slice_of(v).contiguous() if leaf is not None
                            and torch.is_tensor(v)
                            and tuple(v.shape) == leaf.shape else v)
                        for k, v in entry.items()}
        optimizer.load_state_dict({"state": state,
                                   "param_groups": sd["param_groups"]})


def shard_params(model: nn.Module, optimizer: torch.optim.Optimizer,
                 fsdp: bool, group) -> Optional[ShardedParams]:
    """FSDP of ``model`` over the data axis's ``group`` when ``fsdp`` is
    set and the axis has more than one rank, else None (every leaf
    replicated)."""
    if not fsdp or group_size(group) == 1:
        return None
    return ShardedParams(model, optimizer, group)


def place_state(state, mesh, fsdp: bool = False):
    """The train state on the mesh: replicated, or under FSDP when
    ``fsdp`` (the JAX ``place_state``); its steps run over the mesh's
    data axis (``state.data_axis``).  Every rank draws the same weights
    from the seed, so nothing is broadcast."""
    if mesh.shape[DATA_AXIS] != world_size():
        raise ValueError(f"data axis {mesh.shape[DATA_AXIS]} != "
                         f"{world_size()} ranks")
    state.data_axis = mesh.data_group
    state.fsdp = shard_params(state.model, state.optimizer, fsdp,
                              state.data_axis)
    return state
