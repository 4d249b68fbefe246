"""The port's training contracts against the JAX package's on the CPU:
Crema-D's jlogits, jprobas, ensemble, ogm_ge and ensemble_ogm_ge model
types (the modulation mode OGM_GE; the other two are held against JAX in
``test_torch_port_algos.py``), two train steps (a full batch, then a padded
tail) and one eval step from the same weights, through each package's
``benchmarks/cremad.py::get_model_spec`` and ``device_preprocess`` (see
``torch_port_contract_harness.py`` for the inputs, the injected OGM noise
and the tolerances).  Then the specs every contract builds, and the
port's own noise stream."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.engine import spec as jax_spec_lib
from multimodal_clinical_tpu_torch.algos import ogm_ge
from multimodal_clinical_tpu_torch.benchmarks import cremad
from multimodal_clinical_tpu_torch.engine import contracts
from multimodal_clinical_tpu_torch.engine.spec import CONTRACTS, ModelSpec
from multimodal_clinical_tpu_torch.engine.state import create_train_state
from multimodal_clinical_tpu_torch.engine.steps import make_train_step
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet

import torch_port_contract_harness as H

CASES = {
    "jlogits": {},
    "jprobas": {},
    "ensemble": {},
    "ogm_ge": dict(grad_mod_type="OGM_GE", alpha=0.8),
    "ensemble_ogm_ge": dict(grad_mod_type="OGM_GE", alpha=0.8),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    return H.run_pair("cremad", request.param, **CASES[request.param])


def test_train_metrics_match_jax(run):
    H.check_train_metrics(run)


def test_params_bn_buffers_momentum_and_ema_match_jax(run):
    H.check_state(run)


def test_eval_step_matches_jax(run):
    H.check_eval(run)
    H.check_qmf_tables(run)


@pytest.mark.parametrize("contract", CONTRACTS)
@pytest.mark.parametrize("grad_mod_type", [None, "OGM"])
def test_every_contract_builds_the_jax_spec(contract, grad_mod_type):
    """Each contract's spec, its ``__post_init__`` rules included: qmf
    sets ``use_idx``; ogm_ge sets ``apply_grad_mod`` and defaults the
    modulation to OGM_GE."""
    kwargs = dict(contract=contract, grad_mod_type=grad_mod_type,
                  n_train_samples=10 if contract == "qmf" else 0)
    spec = ModelSpec(module=torch.nn.Identity(), **kwargs)
    want = jax_spec_lib.ModelSpec(module=None, **kwargs)
    assert H.spec_fields(spec) == H.spec_fields(want)
    if contract == "ogm_ge":
        assert spec.apply_grad_mod
        assert spec.grad_mod_type == (grad_mod_type or "OGM_GE")
    assert spec.use_idx == (contract == "qmf")


def test_spec_rules_raise_as_the_jax_spec():
    with pytest.raises(ValueError, match="n_train_samples"):
        ModelSpec(module=torch.nn.Identity(), contract="qmf")
    with pytest.raises(ValueError, match="unknown contract"):
        ModelSpec(module=torch.nn.Identity(), contract="nosuch")
    # frozen_prefixes is accepted, as in JAX, and keeps weight decay off
    # the parameters under its prefixes
    net = torch.nn.Module()
    net.x1_model = torch.nn.Linear(2, 2)
    net.x2_model = torch.nn.Linear(2, 2)
    spec = ModelSpec(module=net, frozen_prefixes=("x1_model",))
    want = jax_spec_lib.ModelSpec(module=None, frozen_prefixes=("x1_model",))
    assert spec.frozen_prefixes == want.frozen_prefixes
    from multimodal_clinical_tpu_torch.engine.state import decay_groups

    decayed, frozen = decay_groups(net, spec.frozen_prefixes)
    assert "weight_decay" not in decayed and frozen["weight_decay"] == 0.0
    assert [id(p) for p in frozen["params"]] == [
        id(p) for p in net.x1_model.parameters()]
    assert [id(p) for p in decayed["params"]] == [
        id(p) for p in net.x2_model.parameters()]


@pytest.mark.parametrize("model_type", cremad.MODEL_TYPES)
def test_cremad_model_specs_equal_the_jax_specs(model_type):
    from multimodal_clinical_tpu.benchmarks import cremad as jax_cremad

    args = SimpleNamespace(num_classes=6, model_type=model_type, alpha=0.8,
                           grad_mod_type="OGM_GE")
    spec, opt = cremad.get_model_spec(args, n_train=40)
    want, jopt = jax_cremad.get_model_spec(args, n_train=40)
    assert H.spec_fields(spec) == H.spec_fields(want)
    assert opt == jopt == {}
    assert spec.device_preprocess is cremad.device_preprocess
    assert isinstance(spec.module, CremadFusionNet)
    with pytest.raises(NotImplementedError, match="nosuch"):
        cremad.get_model_spec(SimpleNamespace(num_classes=6,
                                              model_type="nosuch"), 40)


def test_fuse_logits_weights_match_jax():
    import jax.numpy as jnp
    from multimodal_clinical_tpu.engine import contracts as jax_contracts

    rng = np.random.default_rng(0)
    logits = [rng.normal(size=(4, 5)).astype(np.float32) for _ in range(2)]
    for weights in (None, (0.7, 0.3)):
        got = contracts.fuse_logits([torch.from_numpy(l) for l in logits],
                                    weights)
        want = jax_contracts.fuse_logits([jnp.asarray(l) for l in logits],
                                         weights)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_ogm_step_draws_its_noise_from_seed_and_step():
    """The default noise source: the same (seed, step) gives the same
    update, so a resumed run draws what the uninterrupted one drew; another
    step gives another."""
    args = SimpleNamespace(num_classes=3, learning_rate=0.1)
    rng = np.random.default_rng(0)
    batch = {"x1": torch.from_numpy(rng.normal(size=(4, 9, 11, 1))
                                    .astype(np.float32)),
             "x2": torch.from_numpy(rng.normal(size=(4, 1, 9, 9, 3))
                                    .astype(np.float32)),
             "label": torch.tensor([0, 1, 2, 0]), "valid": torch.ones(4)}
    seen = []

    def noise_at(state):
        source = ogm_ge.device_noise(state.seed, state.step)
        return lambda name, g: seen.append(name) or source(name, g)

    weights = []
    for start in (0, 0, 1):
        spec = ModelSpec(module=CremadFusionNet(3, width=4), contract="ogm_ge")
        state = create_train_state(spec, args, seed=0, steps_per_epoch=2,
                                   device="cpu")
        state.step = start
        step = make_train_step(spec, ogm_noise=noise_at)
        state, _ = step(state, batch)
        weights.append(state.model.x1_model.conv1.weight.detach().clone())
    assert torch.equal(weights[0], weights[1])
    assert not torch.equal(weights[0], weights[2])
    assert len(seen) == 3 * 40 and seen[0] == "x1_model.conv1.weight"
