"""The port's tool probes (``multimodal_clinical_tpu_torch/tools/``) and the
plain versions of their kernels, held against the JAX package's probes in
``tools/`` on the CPU.

The JAX probes' Pallas kernels take no ``interpret`` argument, so the
``interpret`` fixture patches ``jax.experimental.pallas.pallas_call`` to
interpret mode before the first call; nothing in the JAX package changes.
The JAX probes are imported by path, as ``tests/test_tools.py`` imports
``tools/``.  The port's wrappers take the plain versions for CPU tensors
(the CUDA kernels are held against them on the card in
``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).  Inputs are
numpy draws passed between the frameworks as arrays.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from jax.experimental import pallas as jax_pallas

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))

import probe_pallas_layout as jax_layout  # noqa: E402
import proto_bn_stats as jax_bn_stats  # noqa: E402
import proto_pallas_conv as jax_conv  # noqa: E402

from multimodal_clinical_tpu_torch.ops import (  # noqa: E402
    cuda_bn_stats, cuda_conv3x3, cuda_identity,
)
from multimodal_clinical_tpu_torch.ops.bn_stats import bn_stats  # noqa: E402
from multimodal_clinical_tpu_torch.ops.conv3x3 import conv3x3  # noqa: E402
from multimodal_clinical_tpu_torch.ops.identity import identity  # noqa: E402
from multimodal_clinical_tpu_torch.tools import (  # noqa: E402
    probe_pallas_layout, proto_bn_stats, proto_pallas_conv,
)

torch.set_num_threads(2)

# BN stats: fp32 sums of the same terms in another order; mean within 1e-5
# of the channel's mean |x|, var within 2e-5 of its mean x^2 (measured on
# the CPU: under 1e-7 of either)
MEAN_TOL, VAR_TOL = 1e-5, 2e-5
# conv: both sides sum exact bf16 x bf16 products in fp32, in another
# order, and round to bf16 once, so an entry differs by at most one bf16
# ulp (2^-7 of the larger of the two) where its fp32 sums straddle a
# rounding boundary; the second term covers entries near 0, where the fp32
# sums' own difference can exceed that ulp (at these K, up to 9 * 128, it
# stays under 1e-6 of the largest entry on the CPU)
ULP_RTOL, ULP_ATOL = 2.0 ** -7, 1e-6


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_pallas, "pallas_call", functools.partial(
        jax_pallas.pallas_call, interpret=True))


def _bf16(a):
    """A numpy float array as a bf16 torch tensor and a bf16 JAX array (the
    same bits: both round each value once from fp32)."""
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)


def _bits(t):
    """Raw 16-bit patterns of a bf16 torch tensor or JAX array."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _assert_stats_close(mean, var, want_mean, want_var, x32):
    x32 = x32.reshape(-1, x32.shape[-1])
    assert np.all(np.abs(np.asarray(mean) - np.asarray(want_mean))
                  <= MEAN_TOL * np.abs(x32).mean(0))
    assert np.all(np.abs(np.asarray(var) - np.asarray(want_var))
                  <= VAR_TOL * (x32 * x32).mean(0))


def _assert_within_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    limit = (ULP_RTOL * np.maximum(np.abs(got), np.abs(want))
             + ULP_ATOL * np.abs(want).max())
    assert np.all(np.abs(got - want) <= limit), np.abs(got - want).max()


@pytest.mark.parametrize("shape", [(2, 5, 7, 16), (3, 4, 9, 24),
                                   (1, 3, 157, 64)])
def test_bn_stats_matches_pallas_interpret(interpret, shape):
    rng = np.random.default_rng(0)
    x, xj = _bf16(rng.normal(0.5, 1.0, size=shape))
    want = jax_bn_stats.pallas_bn_stats(xj)
    got = bn_stats(x)
    assert all(g.dtype == torch.float32 and g.shape == (shape[-1],)
               for g in got)
    _assert_stats_close(*got, *want, x.float().numpy())


@pytest.mark.parametrize("geom,nb", [
    ((2, 5, 7, 16, 32), 2),     # Cin < 128: the TPU kernel's im2col path
    ((2, 4, 5, 128, 16), 1),    # Cin >= 128: its per-tap path
    ((1, 3, 20, 32, 48), 1),
], ids=["im2col", "tap", "w20"])
def test_conv_plain_matches_pallas_interpret(interpret, geom, nb):
    b, h, wd, cin, cout = geom
    rng = np.random.default_rng(1)
    x, xj = _bf16(rng.normal(size=(b, h, wd, cin)))
    w, wj = _bf16(rng.normal(size=(3, 3, cin, cout)) * 0.05)
    want = jax_conv.conv_pallas(xj, wj, nb)
    got = conv3x3(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, wd, cout)
    _assert_within_ulp(got.float(), want.astype(jnp.float32))


@pytest.mark.parametrize("geom", [(2, 5, 7, 16, 32), (1, 6, 9, 3, 16)])
def test_conv_xla_matches_jax(geom):
    """The probes' library conv, on the CPU fp32 from the bf16 values
    rounded once, against the JAX probe's ``conv_xla``."""
    b, h, wd, cin, cout = geom
    rng = np.random.default_rng(2)
    x, xj = _bf16(rng.normal(size=(b, h, wd, cin)))
    w, wj = _bf16(rng.normal(size=(3, 3, cin, cout)) * 0.1)
    got = proto_pallas_conv.conv_xla(x, w)
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    _assert_within_ulp(got.float(), jax_conv.conv_xla(xj, wj).astype(
        jnp.float32))
    # and the kernel's plain version against the library conv
    _assert_within_ulp(proto_pallas_conv.conv_pallas(x, w).float(),
                       got.float())


@pytest.mark.parametrize("view", ["nhwc", "hwcn"])
def test_identity_matches_pallas_interpret(interpret, view):
    rng = np.random.default_rng(3)
    x, xj = _bf16(rng.normal(size=(3, 5, 7, 16)))
    if view == "hwcn":
        x, xj = x.permute(1, 2, 3, 0), jnp.transpose(xj, (1, 2, 3, 0))
    got = identity(x)
    assert got.stride() == x.stride() and got.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(jax_layout.pallas_identity(xj)))


BN_GEOM = (4, 6, 10, 16, 16)


def test_bn_stats_probe_draws_the_jax_operands():
    _, args = jax_bn_stats.build("xla", BN_GEOM)
    _, got = proto_bn_stats.build("xla", BN_GEOM, device="cpu")
    for g, a in zip(got[:2], args[:2]):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(g), _bits(a))
    for g, a in zip(got[2:], args[2:]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(a))


@pytest.mark.parametrize("variant", ["xla", "pallas"])
def test_bn_stats_probe_matches_jax(interpret, variant):
    fn, args = jax_bn_stats.build(variant, BN_GEOM)
    want = fn(*args)
    port_fn, port_args = proto_bn_stats.build(variant, BN_GEOM, device="cpu")
    before = cuda_bn_stats.launch_bn_stats.launches
    got = port_fn(*port_args)
    assert cuda_bn_stats.launch_bn_stats.launches == before
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-3)
    # the JAX probe's own check of the two stats against each other
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=2e-2, atol=2e-2)


def test_bn_stats_probe_variants_agree():
    """The port's two variants on one conv output: the same fp32 sums in
    another order."""
    _, args = proto_bn_stats.build("xla", BN_GEOM, device="cpu")
    a = proto_bn_stats.step("xla")(*args)
    b = proto_bn_stats.step("pallas")(*args)
    t = proto_pallas_conv.conv_xla(args[0], args[1]).float().numpy()
    _assert_stats_close(b[1], b[2], a[1], a[2], t)
    np.testing.assert_allclose(float(b[0]), float(a[0]), rtol=1e-5)


LAYOUT_GEOM = (2, 9, 11, 3, 16)


def test_layout_probe_variants_agree_and_match_jax(interpret):
    sums = {}
    before = cuda_identity.launch_identity.launches
    for variant in ("A", "B", "C"):
        fn, x, w = probe_pallas_layout.build(variant, LAYOUT_GEOM, "cpu")
        sums[variant] = fn(x, w)
    assert cuda_identity.launch_identity.launches == before
    assert torch.equal(sums["A"], sums["B"]) and torch.equal(sums["A"],
                                                             sums["C"])
    # the JAX pieces from the same draws: its conv, ReLU, the Pallas copy of
    # the (H, W, C, N) view, nn.max_pool
    xj, wj = jnp.asarray(_bits(x).view(jnp.bfloat16)), jnp.asarray(
        _bits(w).view(jnp.bfloat16))
    t = jax.nn.relu(jax.lax.conv_general_dilated(
        xj, wj, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    tt = jnp.transpose(jax_layout.pallas_identity(
        jnp.transpose(t, (1, 2, 3, 0))), (3, 0, 1, 2))
    y = nn.max_pool(tt, (3, 3), (2, 2), [(1, 1), (1, 1)])
    np.testing.assert_allclose(float(sums["A"]),
                               float(jnp.sum(y.astype(jnp.float32))),
                               rtol=1e-3)
    # the same copy and pool of the port's own conv output: bit for bit
    t_port = torch.relu(proto_pallas_conv.conv_xla(x, w))
    pooled = F.max_pool2d(probe_pallas_layout.pallas_identity(t_port).permute(
        0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    want = nn.max_pool(jax_layout.pallas_identity(
        jnp.asarray(_bits(t_port).view(jnp.bfloat16))), (3, 3), (2, 2),
        [(1, 1), (1, 1)])
    np.testing.assert_array_equal(_bits(pooled), _bits(want))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda: proto_pallas_conv.main(check=True),
    lambda: proto_bn_stats.main(),
    lambda: probe_pallas_layout.main(),
    lambda: proto_bn_stats.build("pallas", BN_GEOM),
    lambda: probe_pallas_layout.build("C", LAYOUT_GEOM),
], ids=["conv_main", "bn_stats_main", "layout_main", "bn_stats_build",
        "layout_build"])
def test_probe_entry_points_raise_without_cuda(no_cuda, call):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def _misaligned(n=64):
    """A dense 1-D bf16 tensor whose data starts 2 bytes past a 16-byte
    boundary."""
    base = torch.zeros(n + 16, dtype=torch.bfloat16)
    start = (-base.data_ptr() % 16) // 2 + 1
    return base[start:start + n]


@pytest.mark.parametrize("call,match", [
    (lambda: cuda_identity.launch_identity(torch.zeros(4, 8)), "CUDA tensor"),
    (lambda: cuda_identity.launch_identity(torch.zeros(4, 8)[:, ::2]),
     "dense"),
    (lambda: cuda_identity.launch_identity(torch.zeros(0, 8)), "non-empty"),
    (lambda: cuda_identity.launch_identity(_misaligned()), "aligned"),
    (lambda: cuda_bn_stats.launch_bn_stats(
        torch.zeros(4, 8, dtype=torch.bfloat16)), "CUDA tensor"),
    (lambda: cuda_bn_stats.launch_bn_stats(torch.zeros(4, 8).double()),
     "bfloat16"),
    (lambda: cuda_bn_stats.launch_bn_stats(torch.zeros(4, 12)),
     "multiple of 8"),
    (lambda: cuda_bn_stats.launch_bn_stats(torch.zeros(8, 4).t()),
     "contiguous"),
    (lambda: cuda_conv3x3.launch_conv3x3(
        torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16),
        torch.zeros(3, 3, 16, 16, dtype=torch.bfloat16)), "CUDA tensor"),
    (lambda: cuda_conv3x3.launch_conv3x3(torch.zeros(1, 4, 4, 16),
                                         torch.zeros(3, 3, 16, 16)),
     "bfloat16"),
    (lambda: cuda_conv3x3.launch_conv3x3(
        torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16),
        torch.zeros(3, 3, 8, 16, dtype=torch.bfloat16)), "multiples of 16"),
    (lambda: cuda_conv3x3.launch_conv3x3(
        torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16),
        torch.zeros(3, 3, 32, 16, dtype=torch.bfloat16)), r"\(3, 3, Cin"),
    (lambda: cuda_conv3x3.launch_conv3x3(
        torch.zeros(1, 16, 4, 4, dtype=torch.bfloat16).permute(0, 2, 3, 1),
        torch.zeros(3, 3, 16, 16, dtype=torch.bfloat16)), "contiguous"),
], ids=["identity_cpu", "identity_gap", "identity_empty",
        "identity_misaligned", "bn_stats_cpu", "bn_stats_dtype",
        "bn_stats_channels", "bn_stats_layout", "conv_cpu", "conv_dtype",
        "conv_channels", "conv_weight_shape", "conv_layout"])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, match):
    """A wrapper launches its kernel or raises, before it builds anything:
    no plain fallback, on the CPU or on the card."""
    with pytest.raises(ValueError, match=match):
        call()


def test_is_dense_reads_strides():
    x = torch.zeros(2, 3, 4, 5)
    assert cuda_identity.is_dense(x)
    assert cuda_identity.is_dense(x.permute(1, 2, 3, 0))
    assert cuda_identity.is_dense(x[:1])  # a size-1 dim's stride is free
    assert not cuda_identity.is_dense(x[:, :1])  # a gap between images
    assert not cuda_identity.is_dense(torch.zeros(3, 1).expand(3, 4))
