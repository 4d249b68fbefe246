"""The CUDA kernels against their plain versions, on the card: the
log-spectrogram, the BN sums (forward and backward) and the stored-index
max-pool (forward and backward), at ragged shapes, with the inputs they
refuse and bit-identical repeat launches.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, so every worker collects the same
tests).  Run on a machine with a card:
``python -m pytest tests/test_torch_port_cuda.py -q``; ``chip_smoke.py``
makes the same comparison at the main path's shape.
"""

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu_torch.ops import (
    cuda_fused_bn, cuda_maxpool, cuda_spectrogram, fused_bn, maxpool,
)
from multimodal_clinical_tpu_torch.ops.spectrogram import log_spectrogram

pytestmark = pytest.mark.cuda

# Both sides are fp32 sums of the same 256 products in another order
# (TF32 is off for the plain version's matmul).  In |X| they agree to a
# few fp32 ulps of the batch's largest |X|; the log turns that into up to
# ~1e-2 in the few bins where |X| is near zero, so the log is held tight
# only where |X| is at least 1e-3 of the batch's rms.
MAG_TOL = 1e-5
LOG_ATOL = 1e-3
# BN sums: fp32 sums of the same terms in another order (per-thread runs of
# up to a few hundred rows, then fixed-order trees, against PyTorch's
# reduction): each differs by a few hundred fp32 roundings at most, held
# to 1e-5 of the sum of the terms' magnitudes.
SUM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _compare(got, want):
    got_mag, want_mag = got.exp(), want.exp()
    scale = want_mag.max()
    assert (got_mag - want_mag).abs().max() <= MAG_TOL * scale
    clear = want_mag >= 1e-3 * want_mag.square().mean().sqrt()
    assert (got - want).abs()[clear].max() <= LOG_ATOL


@pytest.mark.parametrize("shape,hop", [((8, 80000), 128), ((3, 4001), 100),
                                       ((2, 1000), 256), ((1, 300), 37)])
def test_kernel_matches_plain_version(shape, hop):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(scale=0.1, size=shape).astype(
        np.float32)).cuda()
    before = cuda_spectrogram.launch_log_spectrogram.launches
    got = cuda_spectrogram.log_spectrogram(x, n_fft=256, hop=hop)
    torch.cuda.synchronize()
    assert cuda_spectrogram.launch_log_spectrogram.launches == before + 1
    want = log_spectrogram(x, n_fft=256, hop=hop)
    assert got.shape == want.shape and got.dtype == torch.float32
    _compare(got, want)


def test_kernel_refuses_what_it_does_not_take():
    x = torch.zeros(2, 3000, device="cuda")
    with pytest.raises(ValueError):
        cuda_spectrogram.launch_log_spectrogram(x.double())
    with pytest.raises(ValueError):
        cuda_spectrogram.launch_log_spectrogram(x.t())
    with pytest.raises(ValueError):
        cuda_spectrogram.launch_log_spectrogram(x[:, :100])  # n <= n_fft/2
    # too much shared memory: the C entry refuses it (cudaErrorInvalidValue)
    with pytest.raises(RuntimeError, match="invalid argument"):
        cuda_spectrogram.launch_log_spectrogram(x, hop=4096)


def _card_tensor(rng, shape, dtype, loc=0.0):
    return torch.from_numpy(rng.normal(loc, 1.0, size=shape).astype(
        np.float32)).to("cuda", dtype)


def _assert_sums_close(got, want, magnitude):
    for g, w, mag in zip(got, want, magnitude):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert ((g - w).abs() <= SUM_RTOL * mag).all(), (
            (g - w).abs().max(), mag.max())


# (M, C): ragged M, C = 8 (one vector) to 512, and C = 24 (a lane count
# that does not divide the block)
BN_SHAPES = [(1003, 64), (4099, 128), (37, 512), (1, 8), (513, 24)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", BN_SHAPES)
def test_bn_sums_kernels_match_plain(m, c, dtype):
    rng = np.random.default_rng(m)
    x = _card_tensor(rng, (m, c), dtype, loc=0.5)
    dy = _card_tensor(rng, (m, c), dtype)
    mean = torch.from_numpy(rng.normal(size=c).astype(np.float32)).cuda()
    rstd = torch.from_numpy(rng.uniform(0.5, 2, size=c).astype(
        np.float32)).cuda()
    before = (cuda_fused_bn.launch_channel_sums.launches,
              cuda_fused_bn.launch_bwd_sums.launches)
    got = cuda_fused_bn.launch_channel_sums(x)
    got_bwd = cuda_fused_bn.launch_bwd_sums(dy, x, mean, rstd)
    torch.cuda.synchronize()
    assert (cuda_fused_bn.launch_channel_sums.launches,
            cuda_fused_bn.launch_bwd_sums.launches) == (before[0] + 1,
                                                        before[1] + 1)
    x32, dy32 = x.float(), dy.float()
    _assert_sums_close(got, fused_bn.channel_sums(x),
                       (x32.abs().sum(0), (x32 * x32).sum(0)))
    xhat = (x32 - mean) * rstd
    _assert_sums_close(got_bwd, fused_bn.bwd_sums(dy, x, mean, rstd),
                       (dy32.abs().sum(0), (dy32 * xhat).abs().sum(0)))
    # no atomics: a second launch adds the same numbers in the same order
    again = cuda_fused_bn.launch_channel_sums(x)
    again_bwd = cuda_fused_bn.launch_bwd_sums(dy, x, mean, rstd)
    for a, b in zip(got + got_bwd, again + again_bwd):
        assert torch.equal(a, b)


def test_bn_sums_kernels_refuse_what_they_do_not_take():
    x = torch.zeros(4, 6, 5, 16, device="cuda")
    stat = torch.zeros(16, device="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_fused_bn.launch_channel_sums(x.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        # the NHWC view of an NCHW-contiguous map: not channels_last
        cuda_fused_bn.launch_channel_sums(
            torch.zeros(4, 16, 6, 5, device="cuda").permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="dtype|bfloat16"):
        cuda_fused_bn.launch_channel_sums(x.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_fused_bn.launch_channel_sums(x[..., :12].contiguous())
    with pytest.raises(ValueError, match="does not match"):
        cuda_fused_bn.launch_bwd_sums(x.bfloat16(), x, stat, stat)
    with pytest.raises(ValueError, match="mean"):
        cuda_fused_bn.launch_bwd_sums(x, x, stat.double(), stat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 11, 16), (3, 8, 8, 8),
                                   (1, 65, 13, 64), (2, 1, 2, 8)])
@pytest.mark.parametrize("ties", [False, True])
def test_pool_kernels_match_plain(shape, dtype, ties):
    """Forward y and index, and the routed dx, equal the plain version's
    exactly: the max is one of its inputs, and dx is the same fp32 sum in
    the same order, rounded once."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    if ties:
        x = np.maximum(np.round(x * 2) / 2, 0)  # ReLU-like tie plateaus
    x = torch.from_numpy(x).to("cuda", dtype)
    y, idx = cuda_maxpool.launch_pool_fwd(x)
    want_y, want_idx = maxpool.pool_fwd(x)
    assert y.dtype == dtype and idx.dtype == torch.uint8
    assert torch.equal(y, want_y) and torch.equal(idx, want_idx)
    dy = _card_tensor(rng, y.shape, dtype)
    dx = cuda_maxpool.launch_pool_bwd(dy, idx, *shape[1:3])
    torch.cuda.synchronize()
    assert torch.equal(dx, maxpool.pool_bwd(dy, idx, *shape[1:3]))
    y2, idx2 = cuda_maxpool.launch_pool_fwd(x)
    assert torch.equal(y, y2) and torch.equal(idx, idx2)
    assert torch.equal(dx, cuda_maxpool.launch_pool_bwd(dy, idx, *shape[1:3]))


def test_pool_op_on_the_card_launches_both_kernels():
    x = torch.randn(2, 9, 7, 8, device="cuda", requires_grad=True)
    before = (cuda_maxpool.launch_pool_fwd.launches,
              cuda_maxpool.launch_pool_bwd.launches)
    maxpool.max_pool_3x3_s2_stored_index(x).sum().backward()
    assert (cuda_maxpool.launch_pool_fwd.launches,
            cuda_maxpool.launch_pool_bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
    ref = x.detach().clone().requires_grad_(True)
    torch.nn.functional.max_pool2d(ref.permute(0, 3, 1, 2), 3, 2, 1).sum(
        ).backward()
    assert torch.equal(x.grad, ref.grad)


def test_pool_kernels_refuse_what_they_do_not_take():
    x = torch.zeros(2, 9, 7, 16, device="cuda")
    y, idx = cuda_maxpool.launch_pool_fwd(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_maxpool.launch_pool_fwd(x.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_maxpool.launch_pool_fwd(
            torch.zeros(2, 16, 9, 7, device="cuda").permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="dtype"):
        cuda_maxpool.launch_pool_fwd(x.double())
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_maxpool.launch_pool_fwd(x[..., :4].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        cuda_maxpool.launch_pool_bwd(y, idx.int(), 9, 7)
    with pytest.raises(ValueError, match="do not pool"):
        cuda_maxpool.launch_pool_bwd(y, idx, 11, 7)
