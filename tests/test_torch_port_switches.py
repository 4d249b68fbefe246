"""The port's last tower switches against the JAX package on the CPU: the
space-to-depth stem (``stem_space_to_depth``), block recompute (``remat``)
and the Bottleneck encoder's ``bn_fused``.

Tolerances.  The space-to-depth stem computes the same sums as the 7x7
stride-2 stem with the taps regrouped, so the two orders of fp32 summation
differ by rounding: each output within 1e-5 of the largest entry
(measured up to 4.6e-7), against JAX's rewrite and against the plain stem.
Recompute re-runs the same ops on the same inputs, so under ``remat`` the
port's loss, gradients and running buffers must equal those of the same
tower without it bit for bit: that is how the running statistics are
shown to move once a step, not twice.  Against JAX the towers are held as
``test_torch_port_models.py`` holds them (outputs to 1e-4, gradients to
3e-4 of each tensor's largest entry, running buffers to 1e-4), the
Bottleneck encoder as ``test_torch_port_fakenews_towers.py`` holds it
(1e-4 of the largest entry in train mode).
"""

import functools
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.models import resnet as jax_resnet
from multimodal_clinical_tpu.models import zoo as jax_zoo
from multimodal_clinical_tpu_torch.benchmarks.vggsound_fixture import (
    build_vggsound_bench,
)
from multimodal_clinical_tpu_torch.engine.multiseed import (
    create_multiseed_state, make_multiseed_steps,
)
from multimodal_clinical_tpu_torch.models import resnet
from multimodal_clinical_tpu_torch.models.common import (
    FusedBatchNorm, init_weights,
)
from multimodal_clinical_tpu_torch.models.jax_weights import (
    get_leaf, jax_key_map, load_jax_variables,
)
from multimodal_clinical_tpu_torch.models.resnet import (
    BottleneckResNetEncoder, ResNetEncoder, StemConv,
)
from multimodal_clinical_tpu_torch.models import zoo
from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet
from multimodal_clinical_tpu_torch.ops import fused_bn
from test_torch_port_models import (
    ATOL, RTOL, WIDTH, _assert_grads_match, _assert_scaled_close,
    _jax_reference, _torch_model,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False

STEM_TOL = 1e-5
BOTTLENECK_TOL = 1e-4
CLASSES = 5


def _scaled_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("cin", [1, 3])
@pytest.mark.parametrize("hw", [(17, 19), (18, 20), (129, 46)])
def test_space_to_depth_stem_matches_jax_and_the_plain_stem(cin, hw):
    """Odd and even sizes (the audio stem's 129 rows are odd), C_in 1 and
    3: the same (width, C_in, 7, 7) weight through both forms."""
    rng = np.random.default_rng(cin * 100 + hw[0])
    x = rng.normal(size=(2, *hw, cin)).astype(np.float32)
    stem = StemConv(cin, 16, space_to_depth=True)
    init_weights(stem, torch.Generator().manual_seed(hw[1]))
    plain = StemConv(cin, 16)
    plain.load_state_dict(stem.state_dict())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = stem(xt).permute(0, 2, 3, 1).numpy()
        base = plain(xt).permute(0, 2, 3, 1).numpy()
    kernel = stem.weight.detach().permute(2, 3, 1, 0).numpy()   # HWIO
    want = jax_resnet.StemConv(16, space_to_depth=True).apply(
        {"params": {"kernel": jnp.asarray(kernel)}}, jnp.asarray(x))
    assert got.shape == base.shape == want.shape == (
        2, (hw[0] + 1) // 2, (hw[1] + 1) // 2, 16)
    assert _scaled_err(got, want) <= STEM_TOL
    assert _scaled_err(got, base) <= STEM_TOL


def _train_pass(enc, x, w):
    """One train-mode pass: loss, gradients (the input's too) and running
    buffers."""
    xt = torch.from_numpy(x).requires_grad_(True)
    enc.train()
    loss = (enc(xt) * torch.from_numpy(w)).sum()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in enc.named_parameters()}
    grads["input"] = xt.grad.clone()
    return (loss.detach(), grads,
            {k: v.clone() for k, v in enc.state_dict().items()
             if "running" in k})


SWITCHED = dict(bn_fused=True, pool_kernel="pallas")


@pytest.mark.parametrize("switches", [{}, SWITCHED],
                         ids=["default", "bn_fused_pallas"])
@pytest.mark.parametrize("remat", ["convs", "none"])
def test_remat_equals_no_remat_and_moves_buffers_once(switches, remat):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 21, 23, 1)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 16)).astype(np.float32)

    def run(policy):
        enc = ResNetEncoder(1, stage_sizes=(1, 1), width=8, remat=policy,
                            **switches)
        init_weights(enc, torch.Generator().manual_seed(0))
        return enc.to(memory_format=torch.channels_last)

    base_enc, enc = run(None), run(remat)
    assert list(enc.state_dict()) == list(base_enc.state_dict())
    base, got = _train_pass(base_enc, x, w), _train_pass(enc, x, w)
    assert torch.equal(got[0], base[0])
    for key in base[1]:
        assert torch.equal(got[1][key], base[1][key]), key
    for key in base[2]:
        assert torch.equal(got[2][key], base[2][key]), key
    # the buffers moved: from (0, 1) by one momentum step
    assert not torch.equal(got[2]["layer1.0.bn1.running_mean"],
                           torch.zeros(8))


def test_remat_convs_saves_the_conv_outputs(monkeypatch):
    """The "convs" policy is asked about every op of a block's forward and
    saves aten.convolution's outputs (conv1, conv2, the projection);
    backward then recomputes the rest."""
    asked, saved = [], []
    policy = resnet._save_conv_outputs

    def recording(ctx, op, *args, **kwargs):
        choice = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            asked.append(op)
            if choice == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
                saved.append(op)
        return choice

    monkeypatch.setattr(resnet, "_save_conv_outputs", recording)
    enc = ResNetEncoder(1, stage_sizes=(1, 1), width=8, remat="convs")
    enc(torch.randn(2, 17, 19, 1, requires_grad=True)).sum().backward()
    # two blocks: 2 + 3 convolutions (the second block projects)
    assert saved == [torch.ops.aten.convolution.default] * 5
    assert torch.ops.aten.native_batch_norm.default in asked


def test_remat_counts_the_recomputed_bn_sums():
    """Under "convs" the BN-sums forward runs once a BN in the forward and
    once more for every BN inside a block in the backward's recompute: the
    launches the card counts (chip_smoke.py phase 22a)."""
    calls = []
    enc = ResNetEncoder(1, stage_sizes=(1, 1), width=8, remat="convs",
                        bn_fused=True)
    def counting(x):
        calls.append(tuple(x.shape))
        return fused_bn.channel_sums(x.reshape(-1, x.shape[-1]))

    with pytest.MonkeyPatch.context() as mp:
        # the CPU path takes the plain sums; count them where they run
        mp.setattr(fused_bn, "_sums", counting)
        enc(torch.randn(2, 17, 19, 1, requires_grad=True)).sum().backward()
    bns = sum(isinstance(m, FusedBatchNorm) for m in enc.modules())
    assert bns == 6
    assert len(calls) == bns + (bns - 1)  # the stem BN is not recomputed


@pytest.fixture(scope="module")
def remat_cases():
    """JAX references of a narrow encoder under each policy: the default
    tower under "convs", the switched one under "none"."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 33, 37, 1)).astype(np.float32)
    w = [rng.normal(size=(2, 5, 5, 2 * WIDTH)).astype(np.float32)]
    cases = {}
    for remat, switches in (("convs", {}), ("none", SWITCHED)):
        jmod = jax_resnet.ResNetEncoder(stage_sizes=(1, 1), width=WIDTH,
                                        remat=remat, **switches)
        cases[remat] = ((x,), w, switches, _jax_reference(jmod, (x,), w))
    return cases


@pytest.mark.parametrize("remat", ["convs", "none"])
def test_remat_encoder_matches_jax(remat_cases, remat):
    """Forward, input and parameter gradients, and the running buffers
    after one train pass, against JAX's ``nn.remat`` encoder."""
    (x,), (w,), switches, ref = remat_cases[remat]
    model = _torch_model(ResNetEncoder(1, stage_sizes=(1, 1), width=WIDTH,
                                       remat=remat, **switches),
                         ref["params"], ref["stats"])
    xt = torch.from_numpy(x).requires_grad_(True)
    model.train()
    out = model(xt)
    np.testing.assert_allclose(out.detach().numpy(), ref["train"][0],
                               rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(w)).sum().backward()
    from test_torch_port_models import GRAD_SCALED_TOL

    _assert_scaled_close(xt.grad.numpy(), ref["input_grads"][0],
                         GRAD_SCALED_TOL, "input")
    _assert_grads_match(model, ref["grads"])
    sd = model.state_dict()
    checked = 0
    for key, (coll, path, _) in jax_key_map(model).items():
        if coll == "batch_stats":
            np.testing.assert_allclose(sd[key].numpy(),
                                       get_leaf(ref["new_stats"], path),
                                       rtol=RTOL, atol=ATOL, err_msg=key)
            checked += 1
    assert checked == 2 * 6
    model = _torch_model(ResNetEncoder(1, stage_sizes=(1, 1), width=WIDTH,
                                       remat=remat, **switches),
                         ref["params"], ref["stats"]).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref["eval"][0], rtol=RTOL,
                               atol=ATOL)


def test_cremad_fusion_net_switches_match_jax(monkeypatch):
    """``CremadFusionNet(remat="convs", stem_space_to_depth=True)``, both
    towers, against the JAX net with the same switches: train-mode logits,
    gradients and the running buffers."""
    # one block a stage on both sides (the port's net looks its encoder
    # up when built)
    monkeypatch.setattr(jax_zoo, "ResNetEncoder", functools.partial(
        jax_resnet.ResNetEncoder, width=WIDTH, stage_sizes=(1, 1, 1, 1)))
    monkeypatch.setattr(zoo, "ResNetEncoder", functools.partial(
        ResNetEncoder, stage_sizes=(1, 1, 1, 1)))
    rng = np.random.default_rng(5)
    inputs = (rng.normal(size=(2, 41, 32, 1)).astype(np.float32),
              rng.normal(size=(2, 2, 33, 33, 3)).astype(np.float32))
    weights = [np.full((2, CLASSES), 1.0, np.float32),
               np.full((2, CLASSES), 2.0, np.float32)]
    ref = _jax_reference(jax_zoo.CremadFusionNet(
        num_classes=CLASSES, remat="convs", stem_space_to_depth=True),
        inputs, weights)
    model = _torch_model(CremadFusionNet(CLASSES, width=WIDTH, remat="convs",
                                         stem_space_to_depth=True),
                         ref["params"], ref["stats"])
    xs = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
    model.train()
    outs = model(*xs)["logits"]
    for got, want in zip(outs, ref["train"]):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                                   atol=ATOL)
    sum((o * torch.from_numpy(w)).sum()
        for o, w in zip(outs, weights)).backward()
    _assert_grads_match(model, ref["grads"])
    sd = model.state_dict()
    for key, (coll, path, _) in jax_key_map(model).items():
        if coll == "batch_stats":
            np.testing.assert_allclose(sd[key].numpy(),
                                       get_leaf(ref["new_stats"], path),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


def test_bottleneck_bn_fused_matches_jax():
    """The Bottleneck encoder with ``bn_fused=True`` (every BN, the stem's
    included, the BN-sums path with torch's unbiased running variance),
    narrowed to width 16 and one block a stage, against the JAX encoder
    with ``bn_fused=True``: train-mode output, gradients of the input and
    the stem conv, and the running buffers."""
    stages = (1, 1, 1, 1)
    x = np.random.default_rng(2).random((3, 48, 48, 3)).astype(np.float32)
    jenc = jax_resnet.BottleneckResNetEncoder(stage_sizes=stages, width=16,
                                              bn_fused=True)
    variables = jax.jit(lambda r, x: jenc.init(r, x, train=False))(
        jax.random.PRNGKey(3), jnp.asarray(x))

    def loss(params, xin):
        out, new = jenc.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              xin, train=True, mutable=["batch_stats"])
        return jnp.sum(out * out), (out, new["batch_stats"])

    (_, (want, new_stats)), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                             jnp.asarray(x))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    enc = load_jax_variables(
        BottleneckResNetEncoder(3, stages, width=16, bn_fused=True),
        to_np(variables["params"]), to_np(variables["batch_stats"]))
    fused = [m for m in enc.modules() if isinstance(m, FusedBatchNorm)]
    assert len(fused) == 1 + 3 * 4 + 4
    assert all(bool((m.weight == 1).all()) for m in fused)
    xt = torch.from_numpy(x).requires_grad_(True)
    enc.train()
    out = enc(xt)
    assert _scaled_err(out.detach().numpy(), want) <= BOTTLENECK_TOL
    (out * out).sum().backward()
    assert _scaled_err(xt.grad.numpy(), g_x) <= BOTTLENECK_TOL
    stem = np.asarray(g_params["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
    assert _scaled_err(enc.conv1.weight.grad.numpy(), stem) <= BOTTLENECK_TOL
    ref = load_jax_variables(
        BottleneckResNetEncoder(3, stages, width=16, bn_fused=True),
        to_np(variables["params"]), to_np(new_stats)).state_dict()
    for key, value in enc.state_dict().items():
        if "running" in key:
            assert _scaled_err(value.numpy(), ref[key].numpy()) <= (
                BOTTLENECK_TOL), key
    plain = BottleneckResNetEncoder(3, stages, width=16)
    assert list(plain.state_dict()) == list(enc.state_dict())


def _fixture_steps(steps, **knobs):
    step, state, batch, _ = build_vggsound_bench(
        batch=2, num_classes=CLASSES, device="cpu", frames_bf16=False,
        num_frames=1, image_size=32, samples=4000, width=8, dtype=None,
        **knobs)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(metrics["train_loss"].clone())
    return torch.stack(losses), state.model.state_dict()


def test_fixture_knobs_at_narrow_size():
    """The fixture's ``remat`` gives the default fixture's two steps bit
    for bit (stored-index pool on).  ``stem_space_to_depth`` gives its
    first step to rounding (the loss within 1e-5 relative, BN buffers
    within 1e-4 of each tensor's largest entry); later steps part, since
    SpecAugment's bands zero whole stem windows and the max-pool's ties
    then break by the stems' last bits (as in
    ``test_torch_port_multiseed_step.py``)."""
    base_losses, base = _fixture_steps(2, pool_kernel="pallas")
    losses, state = _fixture_steps(2, pool_kernel="pallas", remat="convs")
    assert torch.equal(losses, base_losses)
    for key, value in base.items():
        assert torch.equal(state[key], value), key
    losses, state = _fixture_steps(1, stem_space_to_depth=True)
    base_losses, base = _fixture_steps(1)
    torch.testing.assert_close(losses, base_losses, rtol=1e-5, atol=0)
    for key, value in base.items():
        if "running" in key:
            assert _scaled_err(state[key].numpy(), value.numpy()) <= 1e-4


def test_remat_under_the_sweep_raises_naming_the_switch():
    """A checkpoint's recompute runs in the backward, outside the sweep's
    vmap, so the port refuses ``remat`` there (ROADMAP.md section C)."""
    _, _, batch, spec = build_vggsound_bench(
        batch=2, num_classes=CLASSES, device="cpu", frames_bf16=False,
        num_frames=1, image_size=32, samples=4000, width=8, dtype=None,
        remat="convs")
    args = SimpleNamespace(num_classes=CLASSES, batch_size=2,
                           learning_rate=1e-2, use_scheduler=False, seed=0)
    state = create_multiseed_state(spec, args, [0, 1], steps_per_epoch=10,
                                   device="cpu")
    train, _ = make_multiseed_steps(spec)
    stacked = {k: torch.stack([v, v]) for k, v in batch.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(NotImplementedError, match="remat='convs'"):
            train(state, stacked)
