"""The port's fused BatchNorm (``multimodal_clinical_tpu_torch/ops/fused_bn.py``
and ``models/common.py::FusedBatchNorm``) held against the JAX package's on
the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_fused_bn.py`` does; the port's wrapper takes the plain sums
for a CPU tensor (the CUDA kernels are held against those sums on the card
in ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).  Inputs come
from numpy seeds and pass between the frameworks as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.models.common import (
    FusedBatchNorm as JaxFusedBatchNorm,
)
from multimodal_clinical_tpu.ops.fused_bn import (
    _bwd_sums_pallas, _channel_sums_pallas,
    batch_norm_inference as jax_batch_norm_inference,
    batch_norm_train_stats as jax_batch_norm_train_stats,
)
from multimodal_clinical_tpu_torch.models.common import FusedBatchNorm
from multimodal_clinical_tpu_torch.ops import cuda_fused_bn, fused_bn

torch.set_num_threads(2)

# fp32 sums of the same terms in another order: within a few roundings of
# the sum of the terms' magnitudes
SUM_RTOL = 1e-5
# y, mean, var and gradients: fp32 on both sides, the same formulas with
# the sums (and, in dx, one addition) in another order.  Measured on the
# CPU: within 4e-7 of each tensor's largest entry.
F32_SCALED_TOL = 2e-6
# bf16 y: both sides compute in fp32 and round once; an fp32 difference of
# an ulp can move the rounding by one bf16 ulp (2^-8 relative).
BF16_RTOL = 2 ** -7


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("m,c", [(1003, 64), (1003, 128), (517, 24)])
def test_channel_sums_match_pallas_interpret(m, c):
    x = np.random.default_rng(0).normal(0.5, 2.0, size=(m, c)).astype(
        np.float32)
    want = _channel_sums_pallas(jnp.asarray(x), interpret=True)
    got = fused_bn.channel_sums(torch.from_numpy(x))
    magnitude = (np.abs(x).sum(0), (x * x).sum(0))
    for g, w, mag in zip(got, want, magnitude):
        assert g.dtype == torch.float32
        assert np.all(np.abs(g.numpy() - np.asarray(w)) <= SUM_RTOL * mag)


@pytest.mark.parametrize("m,c", [(514, 64), (1003, 128)])
def test_bwd_sums_match_pallas_interpret(m, c):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(m, c)).astype(np.float32)
    dy = rng.normal(size=(m, c)).astype(np.float32)
    mean = rng.normal(size=c).astype(np.float32)
    rstd = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    want = _bwd_sums_pallas(*map(jnp.asarray, (dy, x, mean, rstd)),
                            interpret=True)
    got = fused_bn.bwd_sums(*map(torch.from_numpy, (dy, x, mean, rstd)))
    xhat = (x - mean) * rstd
    magnitude = (np.abs(dy).sum(0), np.abs(dy * xhat).sum(0))
    for g, w, mag in zip(got, want, magnitude):
        assert np.all(np.abs(g.numpy() - np.asarray(w)) <= SUM_RTOL * mag)


def _bn_case(shape, seed, loc=2.0, scale=3.0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return dict(
        x=rng.normal(loc, scale, size=shape).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, size=c).astype(np.float32),
        bias=rng.normal(size=c).astype(np.float32),
        ct=rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 5, 7, 16), (3, 4, 4, 64)])
def test_train_stats_and_gradients_match_jax_vjp(shape):
    """y, mean, var and the vjp in (x, scale, bias) against ``jax.vjp`` of
    the Pallas path (interpret mode)."""
    case = _bn_case(shape, seed=2)
    (y, mean, var), vjp = jax.vjp(
        lambda x, s, b: jax_batch_norm_train_stats(
            x, s, b, use_pallas=True, interpret=True),
        *map(jnp.asarray, (case["x"], case["scale"], case["bias"])))
    zeros = jnp.zeros(shape[-1], jnp.float32)
    grads = vjp((jnp.asarray(case["ct"]), zeros, zeros))

    x, s, b = (torch.from_numpy(case[k]).requires_grad_(True)
               for k in ("x", "scale", "bias"))
    ty, tmean, tvar = fused_bn.batch_norm_train_stats(x, s, b)
    assert not tmean.requires_grad and not tvar.requires_grad
    ty.backward(torch.from_numpy(case["ct"]))
    for got, want in [(ty, y), (tmean, mean), (tvar, var), (x.grad, grads[0]),
                      (s.grad, grads[1]), (b.grad, grads[2])]:
        assert got.shape == want.shape and got.dtype == torch.float32
        assert _scaled_err(got.detach().numpy(), want) <= F32_SCALED_TOL


def test_train_bf16_output_matches_jax():
    """bf16 input: y in bf16, statistics in fp32, as the JAX op."""
    case = _bn_case((2, 6, 6, 32), seed=3, loc=0.5, scale=1.0)
    xb = jnp.asarray(case["x"], jnp.bfloat16)
    y, mean, var = jax_batch_norm_train_stats(
        xb, jnp.asarray(case["scale"]), jnp.asarray(case["bias"]),
        use_pallas=True, interpret=True)
    ty, tmean, tvar = fused_bn.batch_norm_train_stats(
        torch.from_numpy(np.array(xb, np.float32)).bfloat16(),
        torch.from_numpy(case["scale"]), torch.from_numpy(case["bias"]))
    assert ty.dtype == torch.bfloat16 and tmean.dtype == torch.float32
    assert _scaled_err(tmean.numpy(), mean) <= F32_SCALED_TOL
    assert _scaled_err(tvar.numpy(), var) <= F32_SCALED_TOL
    want = np.asarray(y, np.float32)
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(want).max())


def test_variance_is_the_clamped_one_pass_form():
    """|mean| >> std: s2/M - mean^2 cancels, and may round below 0.  The
    port keeps the JAX formula with its clamp (not Welford): var is
    max(s2/M - mean^2, 0) of the same sums, bit for bit, never negative,
    and JAX's within the rounding of mean^2; y stays finite."""
    rng = np.random.default_rng(7)
    x = (3.1 + 1e-4 * rng.normal(size=(4, 3, 3, 8))).astype(np.float32)
    _, _, var = jax_batch_norm_train_stats(
        jnp.asarray(x), jnp.ones(8), jnp.zeros(8), use_pallas=True,
        interpret=True)
    tx = torch.from_numpy(x)
    ty, tmean, tvar = fused_bn.batch_norm_train_stats(tx, torch.ones(8),
                                                      torch.zeros(8))
    m = x.size // 8
    s, s2 = fused_bn.channel_sums(tx.reshape(m, 8))
    assert torch.equal(tvar, torch.clamp_min(s2 / m - (s / m) ** 2, 0.0))
    assert (tvar >= 0).all() and torch.isfinite(ty).all()
    ulp = np.finfo(np.float32).eps * tmean.numpy() ** 2
    assert np.all(np.abs(tvar.numpy() - np.asarray(var)) <= 8 * ulp)


def test_inference_matches_jax():
    rng = np.random.default_rng(6)
    x, scale, bias, mean = (rng.normal(size=s).astype(np.float32)
                            for s in ((4, 6, 6, 16), 16, 16, 16))
    var = rng.uniform(0.5, 2.0, size=16).astype(np.float32)
    want = jax_batch_norm_inference(*map(jnp.asarray,
                                         (x, scale, bias, mean, var)))
    got = fused_bn.batch_norm_inference(*map(torch.from_numpy,
                                             (x, scale, bias, mean, var)))
    assert _scaled_err(got.numpy(), want) <= F32_SCALED_TOL


def test_module_matches_flax_fused_batch_norm():
    """Three train-mode passes, then eval: the running buffers take the
    UNBIASED variance, and the outputs match, from the same parameters."""
    rng = np.random.default_rng(5)
    xs = [rng.normal(1.0, 2.0, size=(4, 5, 5, 8)).astype(np.float32)
          for _ in range(3)]
    jmod = JaxFusedBatchNorm(use_running_average=False, use_pallas=False)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params, stats = variables["params"], variables["batch_stats"]
    params = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 8), jnp.float32),
              "bias": jnp.asarray(rng.normal(size=8), jnp.float32)}

    tmod = FusedBatchNorm(8)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(np.array(params["scale"])))
        tmod.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    tmod.train()
    for x in xs:
        y, mutated = jmod.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        with torch.no_grad():  # NCHW in, as the towers call it
            ty = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert _scaled_err(ty.permute(0, 2, 3, 1).numpy(), y) <= \
            F32_SCALED_TOL
    np.testing.assert_allclose(tmod.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tmod.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6,
                               atol=1e-7)
    # the unbiased estimator (torch's), not the default BN's biased one
    want = np.ones(8)
    for x in xs:
        want = 0.9 * want + 0.1 * x.reshape(-1, 8).astype(np.float64).var(
            axis=0, ddof=1)
    np.testing.assert_allclose(tmod.running_var.numpy(), want, rtol=1e-5)
    tmod.eval()
    y_eval = JaxFusedBatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(xs[0]))
    with torch.no_grad():
        ty = tmod(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    assert _scaled_err(ty.permute(0, 2, 3, 1).numpy(), y_eval) <= \
        F32_SCALED_TOL


def test_module_launches_no_kernel_on_the_cpu(monkeypatch):
    before = (cuda_fused_bn.launch_channel_sums.launches,
              cuda_fused_bn.launch_bwd_sums.launches)
    grad_sums, contiguous = fused_bn._grad_sums, []

    def recording(dy, *args):
        contiguous.append(dy.is_contiguous())
        return grad_sums(dy, *args)

    monkeypatch.setattr(fused_bn, "_grad_sums", recording)
    x = torch.randn(2, 8, 5, 5).to(memory_format=torch.channels_last)
    x.requires_grad_(True)
    FusedBatchNorm(8)(x).square().sum().backward()
    assert x.grad.shape == x.shape
    assert (cuda_fused_bn.launch_channel_sums.launches,
            cuda_fused_bn.launch_bwd_sums.launches) == before
    # the gradient arrives channels_last, the layout the CUDA sums take
    # (their wrapper raises on any other)
    assert contiguous == [True]


def test_expanded_gradient_reaches_the_sums_contiguous(monkeypatch):
    """``y.sum()`` hands the backward an expanded dy (all strides 0); the
    op copies it to the row-major (..., C) layout that the CUDA sums read
    (their wrapper raises on any other)."""
    grad_sums, contiguous = fused_bn._grad_sums, []

    def recording(dy, *args):
        contiguous.append(dy.is_contiguous())
        return grad_sums(dy, *args)

    monkeypatch.setattr(fused_bn, "_grad_sums", recording)
    x = torch.randn(2, 8, 5, 5).to(memory_format=torch.channels_last)
    bn = FusedBatchNorm(8)
    grads = []
    for ones in (False, True):
        xi = x.clone().requires_grad_(True)
        bn.zero_grad(set_to_none=True)
        y = bn(xi)
        if ones:
            y.backward(torch.ones_like(y))
        else:
            y.sum().backward()
        grads.append((xi.grad, bn.weight.grad, bn.bias.grad))
    assert contiguous == [True, True]
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _fold_mirror(x2d, row_blocks):
    """The CUDA forward's fixed fold order (csrc/bn_sums.cu) in plain fp32
    torch: per channel group of 64, thread lane l of a row block adds its
    slab's rows l, l + lanes, ... in order; the block adds its lanes in
    order; the group's last block adds the blocks' partials, warp w the
    blocks w, w + 8, ..., then the 8 warps' runs in order."""
    m, c = x2d.shape
    x = x2d.float()
    out = torch.empty(2, c)
    for g0 in range(0, c, cuda_fused_bn.GROUP_C):
        width = min(cuda_fused_bn.GROUP_C, c - g0)
        lanes = cuda_fused_bn.THREADS // (width // 8)
        partials = []
        for r0, r1 in cuda_fused_bn.fwd_slabs(m, row_blocks):
            per_lane = torch.zeros(2, lanes, width)
            for k in range(r0, r1, lanes):
                rows = x[k:min(k + lanes, r1), g0:g0 + width]
                per_lane[0, :len(rows)] += rows
                per_lane[1, :len(rows)] += rows * rows
            block = torch.zeros(2, width)
            for lane in range(lanes):
                block += per_lane[:, lane]
            partials.append(block)
        total = torch.zeros(2, width)
        for warp in range(8):
            run = torch.zeros(2, width)
            for blk in range(warp, len(partials), 8):
                run += partials[blk]
            total += run
        out[:, g0:g0 + width] = total
    return out[0], out[1]


# (M, C, SMs): two row blocks; eight per group over two groups (a short
# last slab); sixteen, so that each warp of the fold adds two; C = 24 (85
# lanes of a 256-thread block); C = 2048 (32 groups of one row block)
@pytest.mark.parametrize("m,c,sms", [(1003, 64, 4), (4099, 128, 8),
                                     (20000, 64, 8), (517, 24, 132),
                                     (300, 2048, 132)])
def test_forward_fold_order_matches_pallas_interpret(m, c, sms):
    """The forward kernel's slabs and fold order, on the grid the wrapper
    gives a card with ``sms`` SMs, against ``channel_sums`` and
    ``_channel_sums_pallas`` (interpret mode)."""
    row_blocks = cuda_fused_bn.fwd_row_blocks(m, c, sms)
    slabs = cuda_fused_bn.fwd_slabs(m, row_blocks)
    assert slabs[0][0] == 0 and slabs[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(slabs, slabs[1:]))
    x = np.random.default_rng(m).normal(0.5, 1.0, size=(m, c)).astype(
        np.float32)
    got = _fold_mirror(torch.from_numpy(x), row_blocks)
    magnitude = (np.abs(x).sum(0), (x * x).sum(0))
    for want in (fused_bn.channel_sums(torch.from_numpy(x)),
                 _channel_sums_pallas(jnp.asarray(x), interpret=True)):
        for g, w, mag in zip(got, want, magnitude):
            assert np.all(np.abs(g.numpy() - np.asarray(w)) <= SUM_RTOL * mag)


def test_forward_grid_fits_the_card():
    """Two blocks per SM in all, at least one row block per channel group,
    and no more row blocks than give each thread 16 bf16 rows (8 fp32)."""
    assert cuda_fused_bn.fwd_row_blocks(11239424, 64, 132) == 264
    assert cuda_fused_bn.fwd_row_blocks(43904, 512, 132) == 33
    assert cuda_fused_bn.fwd_row_blocks(300, 2048, 132) == 1
    assert cuda_fused_bn.fwd_row_blocks(1, 8, 132) == 1
    # 32 lanes x 16 rows of bf16 (8 of fp32) per step at C = 64
    assert cuda_fused_bn.fwd_row_blocks(512 * 3, 64, 132) == 3
    assert cuda_fused_bn.fwd_row_blocks(512 * 3, 64, 132, bf16=False) == 6
