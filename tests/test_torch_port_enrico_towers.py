"""Enrico's towers in the port (``models/pretrained.py``'s ResNet18Slim and
VGG11Slim, ``models/common.py::adaptive_avg_pool2d``) against the JAX
package's flax modules on the CPU, at full width.

Tolerances: the towers' fp32 forwards within 1e-5 of the largest entry
in eval mode; in train mode, with their BN running statistics, within
1e-4 (BN over the few values a channel has at the last stage of a
three-image batch amplifies the two frameworks' last-bit conv
differences to 2e-5-5e-5; ``test_torch_port_models.py`` holds the
scratch ResNet towers to 1e-4 too); ``adaptive_avg_pool2d`` within 1e-6.
In float64, three SGD steps of each tower (momentum 0.9, weight decay
1e-4 masked off the frozen features) end within 1e-8 of each tensor's
largest entry of the JAX package's.  The weight key maps are bit-equal
inverses of the JAX package's ``port_resnet18_slim`` and
``port_vgg11_slim``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_clinical_tpu.engine import state as jax_state
from multimodal_clinical_tpu.models import common as jax_common
from multimodal_clinical_tpu.models import pretrained as jax_pretrained
from multimodal_clinical_tpu.models import torch_port
from multimodal_clinical_tpu_torch.engine.state import (
    decay_groups, make_optimizer,
)
from multimodal_clinical_tpu_torch.models import common, pretrained
from multimodal_clinical_tpu_torch.models.jax_weights import (
    load_jax_variables,
)
from torch_port_benchmark_harness import patch_dropout

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

FWD_TOL = 1e-5
TRAIN_FWD_TOL = 1e-4


@pytest.mark.parametrize("hw", [(8, 4), (14, 14), (7, 7), (9, 20)])
def test_adaptive_avg_pool_matches_jax(hw):
    """8 x 4 is Enrico's VGG map at 256 x 128 (uneven bins, W upsampled),
    14 x 14 divides, 7 x 7 is the identity."""
    x = np.random.default_rng(0).normal(size=(2, *hw, 5)).astype(np.float32)
    want = np.asarray(jax_common.adaptive_avg_pool2d(jnp.asarray(x), (7, 7)))
    got = common.adaptive_avg_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), (7, 7)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 7, 7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _flax_tower(tower, x, train, rngs=None):
    variables = jax.jit(lambda r, x: tower.init(r, x, train=False))(
        jax.random.PRNGKey(3), x)
    out, updated = jax.jit(lambda v, x: tower.apply(
        v, x, train=train, rngs=rngs, mutable=["batch_stats"]))(variables, x)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    new_stats = jax.tree_util.tree_map(np.asarray, updated["batch_stats"])
    return out, params, stats, new_stats


def _close(got, want, name, train):
    want = np.asarray(want)
    tol = TRAIN_FWD_TOL if train else FWD_TOL
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("train", [True, False])
def test_resnet18_slim_matches_flax(train):
    """The full-width tower, fp32: embedding and logits, and in train mode
    the updated BN running statistics (scale starts at 1)."""
    x = np.random.default_rng(1).random((3, 48, 32, 3)).astype(np.float32)
    (emb, logits), params, stats, new_stats = _flax_tower(
        jax_pretrained.ResNet18Slim(20), jnp.asarray(x), train)
    model = load_jax_variables(pretrained.ResNet18Slim(20), params, stats)
    assert (model.features.bn1.weight == 1).all()
    model.train(train)
    with torch.no_grad():
        got_emb, got_logits = model(torch.from_numpy(x))
    _close(got_emb.numpy(), emb, "embedding", train)
    _close(got_logits.numpy(), logits, "logits", train)
    want = load_jax_variables(pretrained.ResNet18Slim(20), params,
                              new_stats).state_dict()
    for key, value in model.state_dict().items():
        if "running" in key:
            _close(value.numpy(), want[key].numpy(), key, train)


@pytest.mark.parametrize("train", [True, False])
def test_vgg11_slim_matches_flax(train):
    """The full-width VGG11Slim on a 64 x 32 screen (its map reaches the
    7 x 7 pool at 2 x 1), fp32, in train mode with the same dropout
    masks on both sides; the classifier's rows permuted from the NHWC
    flatten."""
    x = np.random.default_rng(2).random((2, 64, 32, 3)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        source, drawn = patch_dropout(mp, 8)
        out, params, stats, new_stats = _flax_tower(
            jax_pretrained.VGG11Slim(20, dropout_p=0.1), jnp.asarray(x),
            train, rngs={"dropout": jax.random.PRNGKey(4)})
        model = load_jax_variables(pretrained.VGG11Slim(20, dropout_p=0.1),
                                   params, stats)
        model.train(train)
        with torch.no_grad(), common.dropout_source(source(None)):
            got = model(torch.from_numpy(x))
    assert drawn["port"] == drawn["jax"]
    assert len(drawn["jax"]) == (8 if train else 0)
    _close(got.numpy(), out, "logits", train)
    want = load_jax_variables(pretrained.VGG11Slim(20), params,
                              new_stats).state_dict()
    for key, value in model.state_dict().items():
        if "running" in key:
            _close(value.numpy(), want[key].numpy(), key, train)


F64_TOL = 1e-8
SGD = dict(lr=0.05, momentum=0.9, weight_decay=1e-4)
# (tower, its frozen flax prefixes, the input's (H, W)); the full-width
# towers, VGG11Slim with its dropouts injected
F64_TOWERS = {
    "resnet_frozen": (lambda: (jax_pretrained.ResNet18Slim(5),
                               pretrained.ResNet18Slim(5)),
                      ("features",), (32, 32)),
    "resnet_trained": (lambda: (
        jax_pretrained.ResNet18Slim(5, freeze_features=False),
        pretrained.ResNet18Slim(5, freeze_features=False)), (), (32, 32)),
    "vgg_frozen": (lambda: (jax_pretrained.VGG11Slim(5),
                            pretrained.VGG11Slim(5)),
                   ("Conv_", "TorchBatchNorm_"), (64, 32)),
}


def _logits(out):
    return out[1] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", sorted(F64_TOWERS))
def test_float64_sgd_steps_match_jax(name):
    """Three SGD steps on the CE of each tower's logits in train mode, in
    float64 on both sides, each side's optimizer with its weight-decay
    mask: parameters and BN statistics within F64_TOL of each tensor's
    largest entry, the frozen leaves bit-unchanged with a zero momentum
    in JAX and none in the port."""
    make, jax_frozen, hw = F64_TOWERS[name]
    jtower, tower = make()
    rng = np.random.default_rng(6)
    x = rng.random((4, *hw, 3))
    labels = np.array([0, 3, 1, 4])
    with pytest.MonkeyPatch.context() as mp:
        source, _ = patch_dropout(mp, 8)
        variables = jax.jit(lambda r, x: jtower.init(r, x, train=False))(
            jax.random.PRNGKey(5), jnp.asarray(x, jnp.float32))
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables)
        load_jax_variables(tower, variables["params"],
                           variables["batch_stats"])
        tower.double().train()
        init = {k: v.clone() for k, v in tower.named_parameters()}
        opt = make_optimizer(decay_groups(tower, ("features",) if jax_frozen
                                          else ()), SGD["lr"],
                             SGD["momentum"], SGD["weight_decay"])
        for _ in range(3):
            opt.zero_grad()
            with common.dropout_source(source(None)):
                logits = _logits(tower(torch.from_numpy(x)))
            torch.nn.functional.cross_entropy(
                logits, torch.from_numpy(labels)).backward()
            opt.step()
        tx = jax_state.make_optimizer(
            optax.constant_schedule(SGD["lr"]), momentum=SGD["momentum"],
            weight_decay=SGD["weight_decay"], frozen_prefixes=jax_frozen)
        with jax.enable_x64(True):
            params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
            stats = jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"])
            opt_state = tx.init(params)

            def loss(p, stats):
                out, new = jtower.apply(
                    {"params": p, "batch_stats": stats}, jnp.asarray(x),
                    train=True, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.PRNGKey(0)})
                return optax.softmax_cross_entropy_with_integer_labels(
                    _logits(out), jnp.asarray(labels)).mean(), new

            grad = jax.jit(jax.grad(loss, has_aux=True))
            for _ in range(3):
                grads, new = grad(params, stats)
                stats = new["batch_stats"]
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
            assert jax.tree_util.tree_leaves(params)[0].dtype == jnp.float64
    trace = jax.tree_util.tree_map(np.asarray, opt_state[1].trace)
    to64 = functools.partial(jax.tree_util.tree_map, np.asarray)
    want = load_jax_variables(make()[1].double(), to64(params), to64(stats),
                              np.float64).state_dict()
    momentum = load_jax_variables(make()[1].double(), trace, to64(stats),
                                  np.float64).state_dict()
    named = dict(tower.named_parameters())
    for key, value in tower.state_dict().items():
        got, ref = value.numpy(), want[key].numpy()
        assert np.abs(got - ref).max() <= F64_TOL * np.abs(ref).max(), key
        if key in named and key.startswith("features") and jax_frozen:
            assert torch.equal(value, init[key]) and (ref == got).all(), key
            assert not opt.state[named[key]], key
            assert not momentum[key].any(), key


def test_key_maps_invert_torch_port():
    """``jax_key_map`` is the exact inverse of the JAX package's
    ``port_resnet18_slim`` and ``port_vgg11_slim``: a port tower's
    state_dict through them and back is bit-equal."""
    torch.manual_seed(0)
    resnet = pretrained.ResNet18Slim(20)
    sd = {k: v for k, v in resnet.features.state_dict().items()}
    sd["fc.weight"] = resnet.classifier.weight.detach()
    sd["fc.bias"] = resnet.classifier.bias.detach()
    params, stats = torch_port.port_resnet18_slim(sd)
    back = load_jax_variables(pretrained.ResNet18Slim(20), params, stats)
    for key, value in resnet.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
    vgg = pretrained.VGG11Slim(20)
    for p in vgg.parameters():
        torch.nn.init.normal_(p)
    params, stats = torch_port.port_vgg11_slim(vgg.state_dict())
    back = load_jax_variables(pretrained.VGG11Slim(20), params, stats)
    for key, value in vgg.state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key
