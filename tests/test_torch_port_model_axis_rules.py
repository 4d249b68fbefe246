"""The model and stage axes' rules in one process, against the JAX
package, on the CPU.

The TP and stage branches of ``parallel/sharding.py::param_spec`` (with
FSDP composed) against JAX's on every parameter leaf of the VGGSound,
Crema-D, MIMIC (its GRU), MUsTARD (its LSTMs) and Food101 (plain and
pipelined) nets at full width, shapes only: the port's nets on the meta
device, JAX's through ``eval_shape``.  Each coordinate of each axis holds
the same elements of the flax leaf, numbered, as JAX's shard on that
coordinate.  The one-process mesh raises JAX's errors.  All exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu.parallel import mesh as jax_mesh
from multimodal_clinical_tpu.parallel import sharding as jax_sharding

from multimodal_clinical_tpu_torch.models import zoo as port_zoo
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, to_torch_layout,
)
from multimodal_clinical_tpu_torch.parallel import mesh, sharding

torch.set_num_threads(2)

class _Key:
    def __init__(self, key):
        self.key = key


_AV = (jnp.zeros((2, 33, 40, 1)), jnp.zeros((2, 1, 32, 32, 3)))
_FOOD = (jnp.zeros((2, 64), jnp.int32), jnp.zeros((2, 224, 224, 3)))
NETS = {
    "vggsound": (lambda: jax_zoo.CremadFusionNet(309), _AV,
                 lambda: port_zoo.CremadFusionNet(309)),
    "cremad": (lambda: jax_zoo.CremadFusionNet(6), _AV,
               lambda: port_zoo.CremadFusionNet(6)),
    "mimic": (lambda: jax_zoo.MimicFusionNet(6),
              (jnp.zeros((2, 5)), jnp.zeros((2, 24, 12))),
              lambda: port_zoo.MimicFusionNet(6)),
    "mustard": (lambda: jax_zoo.MustardFusionNet(2),
                (jnp.zeros((2, 40, 371)), jnp.zeros((2, 40, 81)),
                 jnp.zeros((2, 40, 300))),
                lambda: port_zoo.MustardFusionNet(2)),
    "food101": (lambda: jax_zoo.Food101FusionNet(101), _FOOD,
                lambda: port_zoo.Food101FusionNet(101)),
    "food101_pipelined": (
        lambda: jax_zoo.Food101FusionNet(101, pipeline_stages=2), _FOOD,
        lambda: port_zoo.Food101FusionNet(101, pipeline_stages=2)),
}


@functools.lru_cache(maxsize=None)
def _tree(net):
    """(JAX's parameter shapes, the port's net on the meta device)."""
    jmod, sample, make = NETS[net]
    shapes = jax.eval_shape(functools.partial(jmod().init, train=False),
                            jax.random.PRNGKey(0), *sample)["params"]
    with torch.device("meta"):
        return shapes, make()


def _jax_block(numbered, spec, coords):
    """The elements of ``numbered`` that JAX's ``spec`` gives the device
    at ``coords`` (axis -> (size, coordinate))."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            size, coord = coords[axis]
            numbered = np.split(numbered, size, axis=dim)[coord]
    return numbered


def _port_block(numbered, shards, coords):
    for s in shards:
        size, coord = coords[s.axis]
        numbered = np.take(numbered, sharding.block_index(
            numbered.shape[s.dim], s, size, coord), axis=s.dim)
    return numbered


@pytest.mark.parametrize("sizes", [(2, 1, 1), (4, 1, 1), (2, 2, 1),
                                   (1, 1, 2), (2, 2, 2)],
                         ids=["model2", "model4", "model2_fsdp2", "stage2",
                              "stage2_fsdp2_model2"])
@pytest.mark.parametrize("net", list(NETS))
def test_param_spec_matches_jax(net, sizes):
    """Every parameter leaf: the port shards it over an axis exactly where
    JAX's ``param_spec`` does, and each coordinate of each axis holds the
    same elements of the flax leaf (numbered; a packed leaf's members
    numbered apart) as JAX's shard there, the 3-D attention kernels and
    (H, d) biases replicated under the model axis, a GRU's and an LSTM's
    gates each sharded."""
    mp_, fs, pp = sizes
    shapes, model = _tree(net)
    seen = set()  # a layout checked once: the towers repeat their blocks
    named = dict(model.named_parameters())
    counted = {}
    for key, (coll, path, kind) in jax_key_map(model).items():
        if coll != "params":
            continue
        leaf = named[key]
        shards = sharding.leaf_shards(tuple(leaf.shape), kind, path, mp_,
                                      fs, pp)
        spec = sharding.param_spec(leaf, fs, kind, path, mp_, pp)
        paths = path if isinstance(path[0], tuple) else (path,)
        flax = [get_leaf(shapes, p) for p in paths]
        jspecs = [jax_sharding.param_spec(tuple(_Key(k) for k in p), f,
                                          mp_, fs, pp)
                  for p, f in zip(paths, flax)]
        axes = {a for js in jspecs for a in js if a is not None}
        mine = {s.axis for s in shards}
        assert set(a for a in spec if a) == mine, key
        inner = kind.split(":")[-1]
        if fs > 1 and inner not in EXACT_FSDP:
            # FSDP of a leaf whose torch layout merges or packs flax
            # leaves reads it as one dense leaf (the data axis's rule, held in
            # ``test_torch_port_parallel.py``): the other axes as JAX's
            assert mine - {"data"} == axes - {"data"}, key
            if "data" in mine | axes:
                continue
        assert mine == axes, (key, shards, jspecs)
        for axis in mine:
            counted[axis] = counted.get(axis, 0) + 1
        layout = (kind, tuple(f.shape for f in flax), shards, tuple(jspecs))
        if layout in seen:
            continue
        seen.add(layout)
        sizes_of = {"model": mp_, "data": fs, "stage": pp}
        offset, members = 0, []
        for f in flax:
            members.append(np.arange(offset, offset + int(np.prod(f.shape)),
                                     dtype=np.int32).reshape(f.shape))
            offset += members[-1].size
        packed = isinstance(path[0], tuple)
        torch_leaf = to_torch_layout(kind, members if packed
                                     else members[0], np.int32)
        grid = [range(sizes_of[a]) for a in sorted(mine)]
        for coords in np.ndindex(*[len(g) for g in grid]):
            at = {a: (sizes_of[a], c) for a, c in zip(sorted(mine), coords)}
            got = _port_block(torch_leaf, shards, at)
            want = np.concatenate([_jax_block(m, js, at).ravel()
                                   for m, js in zip(members, jspecs)])
            assert np.array_equal(np.sort(got, axis=None), np.sort(want)), (
                key, at)
    if mp_ > 1 and net != "mustard":
        assert counted.get("model"), counted
    if pp > 1:
        assert bool(counted.get("stage")) == (net == "food101_pipelined")


# the kinds whose torch leaf is a permutation of one flax leaf
EXACT_FSDP = ("conv", "dense", "vector", "table")


def test_attention_kernels_stay_replicated_under_the_model_axis():
    """SigLIP's attention ``DenseGeneral`` kernels (3-D in flax, 2-D in
    torch) and their (H, d) biases stay whole; its MLP kernels and 1-D
    biases shard."""
    _, model = _tree("food101")
    specs = sharding.state_shardings(model, mesh.Mesh({"data": 1,
                                                       "model": 2}))
    block = "model.text_model.encoder.layers.0."
    for name, want in (("self_attn.q_proj.weight", ()),
                       ("self_attn.q_proj.bias", ()),
                       ("self_attn.out_proj.weight", ()),
                       ("self_attn.out_proj.bias", ("model",)),
                       ("mlp.fc1.weight", ("model", None)),
                       ("mlp.fc1.bias", ("model",))):
        assert specs[block + name] == want, name


def test_mesh_in_one_process():
    """One process: the model and stage axes of size 1 are the default
    mesh; larger ones raise JAX's error for one device."""
    assert mesh.make_mesh({"model": 1, "stage": 1}).shape == {
        "data": 1, "model": 1}
    m = mesh.make_mesh()
    assert m.model_group is None and m.stage_group is None
    assert {a: m.coordinate(a) for a in ("data", "model", "stage")} == {
        "data": 0, "model": 0, "stage": 0}
    x = torch.arange(6.0).reshape(1, 6)
    assert mesh.constrain_model_parallel(x, (None, "model"), m) is x
    for shape in ({"model": 2}, {"stage": 2}, {"data": 1, "model": 2,
                                              "stage": 2}):
        with pytest.raises(ValueError) as exc:
            jax_mesh.make_mesh(shape, devices=jax.devices()[:1])
        with pytest.raises(ValueError, match=str(exc.value)):
            mesh.make_mesh(shape)
