"""The pipelined SigLIP layout in one process, against the JAX package,
on the CPU.

  * ``stack_tower_layers`` and ``unstack_tower_layers`` (numpy) against
    JAX's, and ``load_jax_variables`` on a pipelined tree.  Exact.
  * The one-device ``PipelinedEncoderStack`` (no stage axis: the loop
    over the stages) against JAX's ``lax.scan``: the forward within 1e-5
    of its largest entry, and Food101 jlogits's two train steps through
    the benchmark harness, held as ``test_torch_port_food101.py`` holds
    the unpipelined net (losses 1e-5 relative, updates and momentum 3e-4
    of each tensor's largest entry, attention's key bias to rounding).
  * The errors JAX raises for a pipeline, raised in its words.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.models import siglip as jax_siglip
from multimodal_clinical_tpu.parallel import mesh as jax_mesh
from multimodal_clinical_tpu.parallel import pipeline as jax_pipeline

from multimodal_clinical_tpu_torch.models import siglip
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from multimodal_clinical_tpu_torch.parallel import mesh, pipeline

import torch_port_benchmark_harness as BH
import torch_port_contract_harness as H

torch.set_num_threads(2)

TINY = dict(width=16, layers=4, heads=2, mlp_dim=32, patch=8,
            image_size=16, text_len=8, vocab=50)
FORWARD_TOL = 1e-5
ROUNDING = (".k_proj.bias",)


def test_stack_and_unstack_match_jax():
    """The numpy ``stack_tower_layers`` and ``unstack_tower_layers`` give
    JAX's trees, bit for bit, and invert each other."""
    tower = jax_siglip.SigLIPTextTower(
        **{k: v for k, v in TINY.items() if k not in ("patch",
                                                      "image_size")})
    ids = jnp.zeros((2, 8), jnp.int32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(tower.init)(
        jax.random.PRNGKey(0), ids)["params"])
    for stages in (1, 2, 4):
        got = siglip.stack_tower_layers(params, stages)
        want = jax.tree_util.tree_map(np.asarray,
                                      jax_siglip.stack_tower_layers(
                                          params, stages))
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        back = siglip.unstack_tower_layers(got)
        jback = jax_siglip.unstack_tower_layers(want)
        for tree in (back, jax.tree_util.tree_map(np.asarray, jback)):
            for a, b in zip(jax.tree_util.tree_leaves(tree),
                            jax.tree_util.tree_leaves(params)):
                assert np.array_equal(a, b)
    with pytest.raises(ValueError) as exc:
        jax_siglip.stack_tower_layers(params, 3)
    with pytest.raises(ValueError, match=str(exc.value)):
        siglip.stack_tower_layers(params, 3)


@functools.lru_cache(maxsize=None)
def _tiny_pair(stages):
    """JAX's tiny pipelined SigLIP (no mesh: its scan) with its init, and
    the port's with those weights."""
    jmodel = jax_siglip.SigLIPModel(pipeline_stages=stages, **TINY)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 50, (4, 8)).astype(np.int32)
    px = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(ids),
                                     jnp.asarray(px))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    model = siglip.SigLIPModel(pipeline_stages=stages, **TINY)
    load_jax_variables(model, params, {})
    return jmodel, variables, model, params, ids, px


def test_load_jax_variables_on_a_pipelined_tree():
    """A flax tree holding ``pipeline/stages`` loads into the port's
    pipelined net (each stage's slice in its block's layout), and gives
    what the unstacked tree gives the unpipelined net, leaf by leaf and
    in the forward, bit for bit."""
    _, _, model, params, ids, px = _tiny_pair(2)
    flat = dict(params)
    for tower in ("text_model", "vision_model"):
        flat[tower] = jax.tree_util.tree_map(
            np.asarray, jax_siglip.unstack_tower_layers(params[tower]))
    plain = load_jax_variables(siglip.SigLIPModel(**TINY), flat, {})
    sd, psd = model.state_dict(), plain.state_dict()
    per = TINY["layers"] // 2
    for key, value in sd.items():
        if ".pipeline.stages.layers." not in key:
            assert torch.equal(value, psd[key]), key
            continue
        head, rest = key.split(".pipeline.stages.layers.")
        j, tail = rest.split(".", 1)
        for s in range(2):
            assert torch.equal(value[s], psd[
                f"{head}.encoder.layers.{s * per + int(j)}.{tail}"]), key
    with torch.no_grad():
        for a, b in zip(model(torch.from_numpy(ids), torch.from_numpy(px)),
                        plain(torch.from_numpy(ids), torch.from_numpy(px))):
            assert torch.equal(a, b)
    # the HF port stacks its per-layer entries the same way
    hf = siglip.SigLIPModel(pipeline_stages=2, **TINY)
    siglip.port_siglip_state_dict(plain.state_dict(), hf)
    for key, value in hf.state_dict().items():
        assert torch.equal(value, sd[key]), key


@pytest.mark.parametrize("stages", [2, 4])
def test_one_device_pipeline_matches_jax_scan(stages):
    """Without a stage axis the pipelined towers run their stages in turn,
    as JAX's ``lax.scan`` does: the forward equals JAX's."""
    jmodel, variables, model, _, ids, px = _tiny_pair(stages)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(ids),
                                 jnp.asarray(px))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(px))
    for a, b in zip(got, want):
        H._scaled_close(a.numpy(), np.asarray(b), FORWARD_TOL, "embeds")


def test_one_device_pipeline_train_steps_match_jax(monkeypatch):
    """Food101 jlogits with ``pipeline_stages: 2`` in one process (the
    stacked layout, no mesh) trains as JAX's scan does: the benchmark
    harness's two steps and eval.  The harness caches each net's flax
    init by its class: the pipelined init gets a cache of its own."""
    monkeypatch.setattr(H, "_INIT", {})
    r = BH.run_pair("food101", "jlogits", pipeline_stages=2)
    assert any(".pipeline.stages." in k for k in r["state"].model.state_dict())
    H.check_train_metrics(r)
    H.check_state(r, rounding_grads=ROUNDING)
    H.check_eval(r)


def test_pipeline_errors_are_jaxs():
    """``pipeline_apply`` and the stack raise JAX's errors, before any
    collective: a microbatch count that does not divide the batch, a
    stack whose stage count is not the stage axis's size, layers that the
    stages do not divide."""
    jm = jax_mesh.make_mesh({"data": 1, "model": 1, "stage": 2},
                            devices=jax.devices()[:2])
    pm = mesh.Mesh({"data": 1, "model": 1, "stage": 2})
    assert pipeline.stage_sharding(pm) == ("stage",)
    block = lambda p, x: x
    for n_stack, batch, micro in ((2, 10, 3), (4, 8, 4)):
        jstack = jax_pipeline.stack_stage_params(
            [{"w": jnp.zeros(3)}] * n_stack)
        stack = pipeline.stack_stage_params([{"w": torch.zeros(3)}] * n_stack)
        assert stack["w"].shape == jstack["w"].shape
        with pytest.raises(ValueError) as exc:
            jax_pipeline.pipeline_apply(jm, block, jstack,
                                        jnp.zeros((batch, 3)), micro)
        with pytest.raises(ValueError) as got:
            pipeline.pipeline_apply(pm, block, stack, torch.zeros(batch, 3),
                                    micro)
        assert str(got.value) == str(exc.value)
    with pytest.raises(ValueError) as exc:
        jax_siglip.SigLIPModel(pipeline_stages=3, **TINY).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
            jnp.zeros((1, 16, 16, 3)))
    with pytest.raises(ValueError) as got:
        siglip.SigLIPModel(pipeline_stages=3, **TINY)
    assert str(got.value) == str(exc.value)
