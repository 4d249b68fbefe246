"""Which leaf is sharded over which mesh axis, on which dim, and the
sharded train state (port of ``multimodal_clinical_tpu/parallel/
sharding.py``).

The JAX rules (``param_spec``), read on the flax leaf:

  * stage: a leaf under a ``PipelinedEncoderStack``'s ``stages`` whose
    leading dim is the stage axis's size holds one stage a rank
    (``P("stage", ...)``), FSDP composing on another dim;
  * model (tensor parallelism): a 2-D ``kernel`` whose output dim the
    model axis divides shards that dim, a 1-D ``bias`` likewise;
    attention's 3-D ``DenseGeneral`` kernels and (H, d) biases stay
    replicated;
  * data (FSDP, ``fsdp: true``): a leaf of at least ``_FSDP_MIN_SIZE``
    elements shards one dim, its last in the flax layout when the axis
    divides it, else its largest divisible one, never the model's.

The port's leaves are in the torch layout, so the rules read each leaf in
its flax layout (a conv's OIHW weight as HWIO, a dense weight (out, in)
as (in, out), the leaf kinds and paths of ``models/jax_weights.py``) and
map the dims back.  A packed torch leaf (a recurrent cell's gates) holds
several flax leaves: under the model axis each member shards as JAX
shards it, so a rank's rows of it are not contiguous.

``ShardedParams`` applies them to a train state.  Every rank holds its
block of each sharded leaf, and the optimizer updates that block, so its
momentum or Adam moments are blocks too.  Two leaves compute on their
block: a column-parallel Dense's weight and bias (its input through
Megatron's f, its output gathered through g:
``parallel/distributed.py``), and a stage's slice of the pipelined
stack.  Every other sharded leaf is gathered whole before the step's
forward, its gradient summed as the replicated leaves' are, and its block
of the gradient kept; the whole leaves are freed after the update.
Checkpoints hold the full tree (``full_model_state``), so a run on any
mesh loads them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .distributed import _sum_, world_size
from .mesh import DATA_AXIS, MODEL_AXIS, STAGE_AXIS

#: leaves smaller than this many elements stay replicated under FSDP
_FSDP_MIN_SIZE = 65536

# flax dim d of a leaf is torch dim PERM[d]: HWIO <- OIHW, (in, out) <-
# (out, in); the kinds whose torch leaf merges flax axes read as dense
_CONV = (2, 3, 1, 0)
_DENSE = (1, 0)
_DENSE_KINDS = ("dense", "heads_in", "heads_out", "vgg_classifier", "gates",
                "packed_heads_in")
#: a ``PipelinedEncoderStack`` leaf's kind: its stage kind after this
STAGES = "stages:"
# each kind's flax rank (a packed kind's members'); "vector" keeps its own
_FLAX_NDIM = {"dense": 2, "vgg_classifier": 2, "conv": 4, "heads_in": 3,
              "heads_out": 3, "flat": 2, "table": 3, "gates": 2,
              "gate_biases": 1, "packed_heads_in": 3, "packed_flat": 2}
_PACKED = ("gates", "gate_biases", "packed_heads_in", "packed_flat")


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
    if kind is not None and kind.startswith(STAGES):
        inner = _perm(kind[len(STAGES):], ndim - 1)
        return (0,) + tuple(d + 1 for d in inner)
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


@dataclasses.dataclass(frozen=True)
class Shard:
    """One sharded dim of a torch leaf: ``dim`` split over ``axis``; a
    packed leaf's ``members`` equal runs along it each split alike."""

    dim: int
    axis: str
    members: int = 1


def block_index(length: int, shard: Shard, size: int,
                coord: int) -> np.ndarray:
    """The indices along ``shard.dim`` (of ``length``) that coordinate
    ``coord`` of an axis of ``size`` holds: its part of each member."""
    run = length // shard.members
    part = run // size
    return np.concatenate([np.arange(m * run + coord * part,
                                     m * run + (coord + 1) * part)
                           for m in range(shard.members)])


def _leaf_name(path) -> Optional[str]:
    if not path:
        return None
    return path[0][-1] if isinstance(path[0], tuple) else path[-1]


def leaf_shards(shape: Sequence[int], kind: Optional[str] = None,
                path: Optional[tuple] = None, model_axis_size: int = 1,
                fsdp_axis_size: int = 1,
                stage_axis_size: int = 1) -> Tuple[Shard, ...]:
    """JAX's ``param_spec`` on a torch-layout leaf of ``shape``: its
    sharded dims.  ``kind`` and ``path`` are the leaf's layout kind and
    flax path (``models/jax_weights.py::jax_key_map``; a packed kind's
    tuple of paths)."""
    shape = tuple(shape)
    perm = _perm(kind, len(shape))
    proxy = [shape[p] for p in perm]
    stacked = kind is not None and kind.startswith(STAGES)
    if (stage_axis_size > 1 and stacked and shape
            and shape[0] == stage_axis_size):
        d = _fsdp_dim(proxy, fsdp_axis_size, 0)
        return (Shard(0, STAGE_AXIS),) + (
            (Shard(perm[d], DATA_AXIS),) if d > 0 else ())
    shards: List[Shard] = []
    taken = -1
    name = _leaf_name(path)
    if model_axis_size > 1 and not stacked and shape:
        members = len(path) if kind in _PACKED else 1
        flax_ndim = _FLAX_NDIM.get(kind, len(shape))
        out = shape[0] // members
        if ((name == "kernel" and flax_ndim == 2)
                or (name == "bias" and flax_ndim == 1)) \
                and out % model_axis_size == 0:
            shards.append(Shard(0, MODEL_AXIS, members))
            taken = perm.index(0)
    d = _fsdp_dim(proxy, fsdp_axis_size, taken)
    if d >= 0:
        shards.append(Shard(perm[d], DATA_AXIS))
    return tuple(shards)


def param_spec(leaf: torch.Tensor, fsdp_axis_size: int = 1,
               kind: Optional[str] = None, path: Optional[tuple] = None,
               model_axis_size: int = 1, stage_axis_size: int = 1
               ) -> Tuple[Optional[str], ...]:
    """The leaf's placement as the JAX ``PartitionSpec`` would give it,
    in torch dims: an axis name at each sharded dim, () when
    replicated."""
    return _spec(leaf_shards(tuple(leaf.shape), kind, path, model_axis_size,
                             fsdp_axis_size, stage_axis_size), leaf.dim())


def _spec(shards: Tuple[Shard, ...], ndim: int) -> Tuple[Optional[str], ...]:
    if not shards:
        return ()
    by_dim = {s.dim: s.axis for s in shards}
    return tuple(by_dim.get(i) for i in range(ndim))


def layouts(model: nn.Module) -> Dict[str, Tuple[tuple, str]]:
    """Parameter name -> (flax path, layout kind)
    (``models/jax_weights.py``)."""
    from ..models.jax_weights import jax_key_map

    return {name: (path, kind) for name, (coll, path, kind)
            in jax_key_map(model).items() if coll == "params"}


def _axis_sizes(mesh, fsdp: bool) -> Dict[str, int]:
    return dict(model_axis_size=mesh.shape[MODEL_AXIS],
                fsdp_axis_size=mesh.shape[DATA_AXIS] if fsdp else 1,
                stage_axis_size=mesh.shape.get(STAGE_AXIS, 1))


def state_shardings(model: nn.Module, mesh, fsdp: bool = False
                    ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Parameter name -> placement (``param_spec``) under the mesh's TP,
    stage and FSDP rules; the optimizer's state mirrors its parameter,
    everything else is replicated (the JAX ``state_shardings``)."""
    shards_of = _shards_of(model, mesh, fsdp)
    return {name: _spec(shards_of.get(name, ()), p.dim())
            for name, p in model.named_parameters()}


class _Leaf:
    """One sharded parameter.  ``param`` is the module's: its compute
    block (the whole leaf, or a column-parallel Dense's or a stage's
    block), filled over the other axes for a step; ``shard`` is what the
    optimizer updates: this rank's block on every sharded dim."""

    def __init__(self, name: str, param: nn.Parameter,
                 shards: Tuple[Shard, ...], mesh, compute_axes):
        self.name, self.shards = name, shards
        self.shape = tuple(param.shape)
        self.groups = {s.axis: mesh.group(s.axis) for s in shards}
        self.index = {s.dim: torch.from_numpy(block_index(
            self.shape[s.dim], s, mesh.shape[s.axis],
            mesh.coordinate(s.axis))).to(param.device) for s in shards}
        self.compute = tuple(s for s in shards if s.axis in compute_axes)
        self.extra = tuple(s for s in shards if s.axis not in compute_axes)
        # a leaf computed whole keeps its layout (a channels_last conv)
        self.stride = None if self.compute else param.stride()
        block = self.take(param.detach(), self.compute).contiguous()
        self.param = nn.Parameter(block, requires_grad=param.requires_grad)
        self.shard = self.param
        if self.extra:
            self.shard = nn.Parameter(
                self.take(block, self.extra).contiguous(),
                requires_grad=param.requires_grad)

    def take(self, full: torch.Tensor, shards) -> torch.Tensor:
        """This rank's block of ``full`` along ``shards``' dims."""
        for s in shards:
            full = full.index_select(s.dim, self.index[s.dim].to(
                full.device))
        return full

    def gather(self, block: torch.Tensor, shards) -> torch.Tensor:
        """``block`` whole along ``shards``' dims, from every rank's
        (zero-padded all-reduces over each axis)."""
        for s in shards:
            shape = list(block.shape)
            shape[s.dim] = self.shape[s.dim]
            buf = block.new_zeros(shape).index_copy_(
                s.dim, self.index[s.dim].to(block.device), block)
            block = _sum_(buf, self.groups[s.axis])
        return block

    def whole(self, block: torch.Tensor) -> torch.Tensor:
        """The compute block from the shard's ``block``."""
        full = self.gather(block, self.extra)
        if self.stride is None:
            return full
        out = torch.empty_strided(self.shape, self.stride, dtype=full.dtype,
                                  device=full.device)
        return out.copy_(full)


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    parent, _, attr = name.rpartition(".")
    return (model.get_submodule(parent) if parent else model), attr


def _column_parallel(model: nn.Module, shards_of) -> set:
    """Names of the Dense modules that compute on their column block:
    weight and bias sharded over the model axis on the output dim, and
    no ancestor that shards the sequence (whose Dense leaves are gathered
    whole: ``models/siglip.py``)."""
    from ..models.common import TorchDense

    inside_sp = set()
    for name, module in model.named_modules():
        if getattr(module, "sequence_parallel", False):
            inside_sp.update(f"{name}.{sub}" if name else sub
                             for sub, _ in module.named_modules())
    tp = Shard(0, MODEL_AXIS)
    return {name for name, module in model.named_modules()
            if isinstance(module, TorchDense) and name not in inside_sp
            and tp in shards_of.get(f"{name}.weight", ())
            and tp in shards_of.get(f"{name}.bias", ())}


def _install_column_parallel(module: nn.Module, group) -> None:
    from .distributed import copy_to_axis, gather_from_axis

    module.register_forward_pre_hook(
        lambda m, args: (copy_to_axis(args[0], group),) + tuple(args[1:]))
    module.register_forward_hook(
        lambda m, args, out: gather_from_axis(out, out.dim() - 1, group))


def _shards_of(model: nn.Module, mesh, fsdp: bool
               ) -> Dict[str, Tuple[Shard, ...]]:
    """Parameter name -> its sharded dims, for the sharded leaves."""
    sizes = _axis_sizes(mesh, fsdp)
    found = layouts(model)
    out = {}
    for name, param in model.named_parameters():
        path, kind = found.get(name, (None, None))
        shards = leaf_shards(tuple(param.shape), kind, path, **sizes)
        if shards:
            out[name] = shards
    return out


class ShardedParams:
    """``model``'s parameters sharded over ``mesh`` as ``shards_of``
    gives them (``_shards_of``: the TP, stage and FSDP rules), under
    ``optimizer``, which was built over the full parameters and holds no
    state yet: each sharded leaf's module parameter becomes its compute
    block and the optimizer's its shard."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 mesh, shards_of: Dict[str, Tuple[Shard, ...]]):
        columns = _column_parallel(model, shards_of)
        self.leaves: List[_Leaf] = []
        by_param = {}
        for name, param in list(model.named_parameters()):
            if name not in shards_of:
                continue
            compute = {STAGE_AXIS}
            if name.rpartition(".")[0] in columns:
                compute.add(MODEL_AXIS)
            leaf = _Leaf(name, param, shards_of[name], mesh, compute)
            module, attr = _owner(model, name)
            setattr(module, attr, leaf.param)
            self.leaves.append(leaf)
            by_param[param] = leaf.shard
        for name in columns:
            _install_column_parallel(model.get_submodule(name),
                                     mesh.model_group)
        for group in optimizer.param_groups:
            group["params"] = [by_param.get(p, p) for p in group["params"]]
        self._by_shard = {leaf.shard: leaf for leaf in self.leaves}
        self._gathered = [leaf for leaf in self.leaves if leaf.extra]
        self.gathered = True
        self.release()

    def gather(self) -> None:
        """Every leaf's compute block in its module, from the ranks'
        shards; a no-op until the next update."""
        if self.gathered:
            return
        with torch.no_grad():
            for leaf in self._gathered:
                leaf.param.data = leaf.whole(leaf.shard.detach())
        self.gathered = True

    def release(self) -> None:
        """Free the gathered blocks: the shards are the state."""
        for leaf in self._gathered:
            leaf.param.data = leaf.param.data.new_empty(0)
            leaf.param.grad = None
        self.gathered = False

    def keep_grad_slices(self) -> None:
        """After the gradients' sums: each shard's gradient is this
        rank's block of its compute block's."""
        for leaf in self._gathered:
            grad = leaf.param.grad
            leaf.shard.grad = (None if grad is None else
                               leaf.take(grad, leaf.extra).contiguous())
            leaf.param.grad = None

    def reshard(self) -> None:
        """The shards from the gathered blocks (after a load into them)."""
        with torch.no_grad():
            for leaf in self._gathered:
                leaf.shard.copy_(leaf.take(leaf.param.detach(), leaf.extra))

    # -- the full tree ---------------------------------------------------
    def full_model_state(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """``model.state_dict()`` with every sharded leaf whole (a
        collective: every rank calls it)."""
        self.gather()
        state = model.state_dict()
        for leaf in self.leaves:
            state[leaf.name] = leaf.gather(state[leaf.name], leaf.compute)
        return state

    def load_full_model_state(self, model: nn.Module, state: Dict) -> None:
        self.gather()  # the compute blocks to load into
        local = dict(state)
        for leaf in self.leaves:
            local[leaf.name] = leaf.take(state[leaf.name].to(
                leaf.param.device), leaf.compute)
        model.load_state_dict(local)
        self.reshard()

    def _params_in_order(self, optimizer) -> List[nn.Parameter]:
        return [p for g in optimizer.param_groups for p in g["params"]]

    def full_optimizer_state(self, optimizer) -> Dict:
        """``optimizer.state_dict()`` with every shard-shaped tensor of a
        sharded leaf gathered whole: what the optimizer of an unsharded
        run would hold."""
        sd = optimizer.state_dict()
        state = {}
        for i, p in enumerate(self._params_in_order(optimizer)):
            entry = sd["state"].get(i)
            if entry is None:
                continue
            leaf = self._by_shard.get(p)
            state[i] = {k: (leaf.gather(v, leaf.shards) if leaf is not None
                            and torch.is_tensor(v)
                            and tuple(v.shape) == tuple(p.shape) else v)
                        for k, v in entry.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_full_optimizer_state(self, optimizer, sd: Dict) -> None:
        state = {}
        params = self._params_in_order(optimizer)
        for i, entry in sd["state"].items():
            leaf = self._by_shard.get(params[int(i)])
            state[i] = {k: (leaf.take(v.to(leaf.shard.device),
                                      leaf.shards).contiguous()
                            if leaf is not None and torch.is_tensor(v)
                            and tuple(v.shape) == leaf.shape else v)
                        for k, v in entry.items()}
        optimizer.load_state_dict({"state": state,
                                   "param_groups": sd["param_groups"]})


def shard_params(model: nn.Module, optimizer: torch.optim.Optimizer,
                 mesh, fsdp: bool = False) -> Optional[ShardedParams]:
    """``ShardedParams`` of ``model`` over ``mesh``, or None where the
    rules shard no leaf (every leaf replicated)."""
    shards_of = _shards_of(model, mesh, fsdp)
    if not shards_of:
        return None
    return ShardedParams(model, optimizer, mesh, shards_of)


def place_state(state, mesh, fsdp: bool = False):
    """The train state on the mesh (the JAX ``place_state``): every leaf
    under the TP, stage and FSDP rules; its steps sum gradients over the
    mesh's data axis (``state.data_axis``).  Every rank draws the same
    weights from the seed, so nothing is broadcast."""
    ranks = int(np.prod(list(mesh.shape.values())))
    if ranks != world_size():
        raise ValueError(f"mesh of {ranks} ranks != {world_size()} ranks")
    state.data_axis = mesh.data_group
    state.sharded = shard_params(state.model, state.optimizer, mesh, fsdp)
    return state
