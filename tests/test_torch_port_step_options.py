"""The step's options that no ported benchmark sets yet, each on the
narrow Crema-D net, held against the JAX step as the model types are
(``torch_port_contract_harness.py``): two train steps, the second with a
padded tail, from the same weights; then one eval step of each package
on the JAX run's final weights.

  * ``track_min_loss_counts`` (Enrico's ``*_counts`` types): the
    ``count_*`` streams at train and eval, under jlogits and ensemble;
  * ``report_logprobs`` (AV-MNIST's ``ensemble_probas``);
  * ``fusion_weights`` (MIMIC's ensemble, (0.8, 1.5));
  * ``eval_fusion="logits"`` (the ``jprobas_jlogits`` types);
  * ``vicreg_weight`` (Enrico's ``ensemble_vicreg``), on a net that also
    returns the towers' pooled features as ``embeddings``;
  * ``num_inputs`` 3 (Fakeddit with dialogue), on a net that adds a third
    input to its first head's logits.

The two nets below are ``CremadFusionNet`` with another forward, in each
package, so the weights carry over by the same names."""

from typing import Any, Optional

import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn

from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu.models.common import (
    global_avg_pool as jax_global_avg_pool,
)
from multimodal_clinical_tpu_torch.models import zoo as port_zoo
from multimodal_clinical_tpu_torch.models.common import global_avg_pool

import torch_port_contract_harness as H

torch.set_num_threads(2)


class JaxOptionsNet(jax_zoo.CremadFusionNet):
    """``CremadFusionNet`` that also returns the pooled features as
    ``embeddings`` and adds an optional third input to the x1 logits."""

    @nn.compact
    def __call__(self, x1, x2, x3: Optional[Any] = None, train: bool = True):
        a = jax_zoo.ResNetEncoder(dtype=self.dtype, name="x1_model")(x1, train)
        b, t = x2.shape[0], x2.shape[1]
        v = jax_zoo.ResNetEncoder(dtype=self.dtype, name="x2_model")(
            x2.reshape((b * t,) + x2.shape[2:]), train)
        a = jax_global_avg_pool(a)
        v = jnp.mean(v.reshape(b, t, *v.shape[1:]), axis=(1, 2, 3))
        l1 = jax_zoo.TorchDense(self.num_classes, dtype=self.dtype,
                                name="x1_classifier")(a)
        l2 = jax_zoo.TorchDense(self.num_classes, dtype=self.dtype,
                                name="x2_classifier")(v)
        if x3 is not None:
            l1 = l1 + x3
        return {"logits": [l1, l2], "embeddings": [a, v]}


class PortOptionsNet(port_zoo.CremadFusionNet):
    """The port's counterpart of ``JaxOptionsNet``."""

    def forward(self, x1, x2, x3=None):
        a = global_avg_pool(self.x1_model(x1))
        b, t = x2.shape[:2]
        v = self.x2_model(x2.flatten(0, 1))
        v = v.unflatten(0, (b, t)).mean(dim=(1, 2, 3))
        l1, l2 = self.x1_classifier(a), self.x2_classifier(v)
        if x3 is not None:
            l1 = l1 + x3
        return {"logits": [l1, l2], "embeddings": [a, v]}


NETS = (JaxOptionsNet, PortOptionsNet)
CASES = {
    "jlogits-min_loss_counts": ("jlogits", {"track_min_loss_counts": True},
                                None),
    "ensemble-min_loss_counts-report_logprobs": (
        "ensemble", {"track_min_loss_counts": True, "report_logprobs": True},
        None),
    "ensemble-fusion_weights": ("ensemble", {"fusion_weights": (0.8, 1.5)},
                                None),
    "jprobas-eval_fusion_logits": ("jprobas", {"eval_fusion": "logits"},
                                   None),
    "ensemble-vicreg": ("ensemble", {"vicreg_weight": 0.1}, NETS),
    "jlogits-three_inputs": ("jlogits", {"num_inputs": 3}, NETS),
}
# the streams each option adds, at train and at eval
STREAMS = {
    "track_min_loss_counts": ({"count_joint", "count_x1", "count_x2"},
                              {"count_joint", "count_x1", "count_x2"}),
    "vicreg_weight": ({"train_vicreg_loss"}, {"vicreg_loss"}),
}


@pytest.fixture(scope="module", params=list(CASES), ids=list(CASES))
def run(request):
    model_type, options, nets = CASES[request.param]
    return H.run_pair("cremad", model_type, options=options, nets=nets)


def test_train_metrics_match_jax(run):
    H.check_train_metrics(run)
    for option, (train, _) in STREAMS.items():
        if getattr(run["spec"], option):
            assert train <= set(run["metrics"][0])


def test_params_bn_buffers_momentum_and_ema_match_jax(run):
    H.check_state(run)


def test_eval_step_matches_jax(run):
    """From the same weights: the eval step of the port's copy of the JAX
    run's final weights.  The two trainings' drift is held by the state
    test; under ``vicreg_weight`` it reaches 2.2e-5 in the x2 logits after
    two steps (the VICReg variance term's gradient grows as 1 / std of
    the narrow net's pooled features), past the eval's 1e-5."""
    H.check_eval(run, H.eval_on_jax_weights(run))
    for option, (_, evaluated) in STREAMS.items():
        if getattr(run["spec"], option):
            assert evaluated <= set(run["out"])


def test_options_reach_both_specs(run):
    spec, jspec = run["spec"], run["jspec"]
    assert H.spec_fields(spec) == H.spec_fields(jspec)
    assert isinstance(spec.module, port_zoo.CremadFusionNet)
