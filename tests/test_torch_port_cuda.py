"""The CUDA kernels against their plain versions, on the card: the
log-spectrogram, the BN sums (forward and backward), the stored-index
max-pool (forward and backward), and the tool probes' kernels (identity
copy, one-pass BN stats, 3x3 conv), at ragged shapes, with the inputs they
refuse and bit-identical repeat launches; then the contracts' device code
(the QMF History scatter, OGM-GE's modulation, ``cremad_spectrogram``)
against the CPU.

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
    cuda_bn_stats, cuda_conv3x3, cuda_fused_bn, cuda_identity, cuda_maxpool,
    cuda_spectrogram, fused_bn, maxpool,
)
from multimodal_clinical_tpu_torch.ops.bn_stats import bn_stats
from multimodal_clinical_tpu_torch.ops.conv3x3 import conv3x3
from multimodal_clinical_tpu_torch.ops.identity import identity
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
# one-pass BN stats: mean within 1e-5 of the channel's mean |x|, var within
# 2e-5 of its mean x^2 (fp32 sums in another order); the shapes add C = 96
# (a 64-channel group and a 32-channel one), 2048 (32 groups) and the
# towers' stage-4 map
MEAN_TOL, VAR_TOL = 1e-5, 2e-5
# conv: both sides sum exact bf16 products in fp32 and round once; an entry
# may differ by one bf16 ulp (2^-7 of the larger of the two), and near 0 by
# the fp32 sums' own difference (past 1e-6 of the largest entry at
# K = 9 * 512 on the H100; chip_smoke.py states the same limit)
ULP_RTOL, ULP_ATOL = 2.0 ** -7, 1e-5


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
    # n_fft without a digit plan: a power of two past 1024, and none
    with pytest.raises(ValueError, match="power of two from 64 to 1024"):
        cuda_spectrogram.launch_log_spectrogram(x, n_fft=2048)
    with pytest.raises(ValueError, match="power of two from 64 to 1024"):
        cuda_spectrogram.launch_log_spectrogram(x, n_fft=300)


# (n_fft, shape, hop): every other digit plan (16 x 8, 32 x 16, 32 x 32, and
# 8 x 8), hop 1, hop > n_fft, and a length with one frame (N < hop)
FFT_CASES = [(128, (3, 4001), 64), (512, (2, 20000), 100),
             (1024, (2, 30001), 300), (64, (2, 1000), 16),
             (256, (2, 700), 1), (256, (2, 5000), 300), (256, (3, 200), 256)]


@pytest.mark.parametrize("n_fft,shape,hop", FFT_CASES)
def test_fft_kernel_takes_every_plan_and_hop(n_fft, shape, hop):
    rng = np.random.default_rng(n_fft + hop)
    x = torch.from_numpy(rng.normal(scale=0.1, size=shape).astype(
        np.float32)).cuda()
    got = cuda_spectrogram.launch_log_spectrogram(x, n_fft=n_fft, hop=hop)
    torch.cuda.synchronize()
    want = log_spectrogram(x, n_fft=n_fft, hop=hop)
    assert got.shape == want.shape
    _compare(got, want)
    assert torch.equal(got, cuda_spectrogram.launch_log_spectrogram(
        x, n_fft=n_fft, hop=hop))


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


@pytest.mark.parametrize("make", [
    lambda: torch.randn(3, 5, 7, 16, device="cuda").bfloat16(),
    lambda: torch.randn(3, 5, 7, 16, device="cuda").bfloat16().permute(
        1, 2, 3, 0),                                  # the (H, W, C, N) view
    lambda: torch.randn(1001, device="cuda").bfloat16(),   # a 2-byte tail
    lambda: torch.randn(5, 16, 9, 3, device="cuda").to(
        memory_format=torch.channels_last),
    lambda: torch.randint(0, 255, (4099,), device="cuda", dtype=torch.uint8),
], ids=["nhwc", "hwcn_view", "tail", "channels_last", "uint8"])
def test_identity_kernel_matches_plain(make):
    x = make()
    before = cuda_identity.launch_identity.launches
    got = cuda_identity.launch_identity(x)
    torch.cuda.synchronize()
    assert cuda_identity.launch_identity.launches == before + 1
    want = identity(x)
    assert got.stride() == x.stride() and got.dtype == x.dtype
    assert torch.equal(got, want) and got.data_ptr() != x.data_ptr()


def test_identity_kernel_refuses_what_it_does_not_take():
    x = torch.zeros(4, 6, 5, 16, device="cuda")
    with pytest.raises(ValueError, match="dense"):
        cuda_identity.launch_identity(x[:, :3])
    with pytest.raises(ValueError, match="dense"):
        cuda_identity.launch_identity(torch.zeros(3, 1, device="cuda").expand(
            3, 4))
    with pytest.raises(ValueError, match="aligned"):
        cuda_identity.launch_identity(x.flatten()[1:])


def _assert_stats_close(got, want, x32):
    mean, var = got
    assert mean.dtype == var.dtype == torch.float32
    assert ((mean - want[0]).abs() <= MEAN_TOL * x32.abs().mean(0)).all()
    assert ((var - want[1]).abs() <= VAR_TOL * x32.square().mean(0)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", BN_SHAPES + [(1_000_003, 64), (2001, 96),
                                            (300, 2048), (43_904, 512)])
def test_bn_stats_kernel_matches_plain(m, c, dtype):
    rng = np.random.default_rng(m)
    x = _card_tensor(rng, (m, c), dtype, loc=0.5)
    before = cuda_bn_stats.launch_bn_stats.launches
    got = cuda_bn_stats.launch_bn_stats(x)
    torch.cuda.synchronize()
    assert cuda_bn_stats.launch_bn_stats.launches == before + 1
    _assert_stats_close(got, bn_stats(x), x.float())
    # no float atomics, and the ticket counter is back at 0: a second
    # launch gives the same bits
    again = cuda_bn_stats.launch_bn_stats(x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bn_stats_kernel_back_to_back_launches_agree():
    """Launches of two shapes queued back to back on one stream, with no
    synchronisation between them: each shape's results are the same bits
    every time (the last block of each launch resets the counter the next
    launch takes tickets from)."""
    rng = np.random.default_rng(7)
    a = _card_tensor(rng, (300_001, 64), torch.bfloat16, loc=0.5)
    b = _card_tensor(rng, (4099, 128), torch.bfloat16, loc=-1.0)
    outs = [cuda_bn_stats.launch_bn_stats(t) for t in (a, b, a, b, a)]
    torch.cuda.synchronize()
    for i, t in enumerate((a, b, a, b, a)):
        first = outs[i % 2]
        assert all(torch.equal(u, v) for u, v in zip(outs[i], first))
        _assert_stats_close(outs[i], bn_stats(t), t.float())


def test_bn_stats_kernel_refuses_what_it_does_not_take():
    x = torch.zeros(4, 6, 5, 16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bn_stats.launch_bn_stats(
            torch.zeros(4, 16, 6, 5, device="cuda").permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_bn_stats.launch_bn_stats(x.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_bn_stats.launch_bn_stats(x[..., :12].contiguous())


def _assert_within_ulp(got, want):
    got, want = got.float(), want.float()
    limit = (ULP_RTOL * torch.maximum(got.abs(), want.abs())
             + ULP_ATOL * want.abs().max())
    assert ((got - want).abs() <= limit).all(), (got - want).abs().max()


# (B, H, W, Cin, Cout): W = 5, 20, 79 and 157 (the audio stages' widths),
# H W not a multiple of the 128-row tile, B H W below one tile, Cin = 16
# (K = 144, a ragged K step), Cout not a multiple of the 64- or 128-wide
# tile, and a visual stage-4 shape
CONV_SHAPES = [(3, 5, 5, 16, 16), (2, 7, 20, 32, 48), (1, 9, 79, 64, 64),
               (2, 3, 157, 16, 32), (1, 4, 6, 128, 144), (5, 7, 7, 512, 512),
               (3, 17, 79, 128, 128), (1, 1, 1, 16, 16)]
# the wgmma design's edges: fewer K steps than ring stages (Cin = 16: 3 of
# 64), Cout = 64 on the 256 x 64 tile and Cout = 192 (a 128-wide N tile and
# a half-empty one), an M tail of one row on each tile (129 = 128 + 1 with
# the cp.async gather, 257 = 256 + 1 with the im2col TMA), and more M tiles
# than SMs (196 and 160 tiles for 132)
CONV_SHAPES += [(2, 11, 13, 16, 64), (1, 33, 40, 64, 64), (2, 9, 14, 64, 192),
                (1, 3, 43, 32, 128), (1, 1, 257, 64, 64),
                (16, 56, 56, 64, 64), (4, 64, 80, 128, 128)]


@pytest.mark.parametrize("b,h,w,cin,cout", CONV_SHAPES)
def test_conv3x3_kernel_matches_plain(b, h, w, cin, cout):
    rng = np.random.default_rng(b * h * w + cin)
    x = _card_tensor(rng, (b, h, w, cin), torch.bfloat16)
    wt = (_card_tensor(rng, (3, 3, cin, cout), torch.float32) * 0.05).to(
        torch.bfloat16)
    before = cuda_conv3x3.launch_conv3x3.launches
    got = cuda_conv3x3.launch_conv3x3(x, wt)
    torch.cuda.synchronize()
    assert cuda_conv3x3.launch_conv3x3.launches == before + 1
    assert got.shape == (b, h, w, cout) and got.dtype == torch.bfloat16
    _assert_within_ulp(got, conv3x3(x, wt))
    # and the plain version against the library conv in fp32 (the halo)
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2).float(), wt.permute(3, 2, 0, 1).float(),
        padding=1).permute(0, 2, 3, 1)
    _assert_within_ulp(got, want)
    assert torch.equal(got, cuda_conv3x3.launch_conv3x3(x, wt))


def test_conv3x3_kernel_refuses_what_it_does_not_take():
    x = torch.zeros(2, 5, 5, 16, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 16, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_conv3x3.launch_conv3x3(x.float(), w)
    with pytest.raises(ValueError, match="multiples of 16"):
        cuda_conv3x3.launch_conv3x3(x[..., :8].contiguous(), w[:, :, :8])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_conv3x3.launch_conv3x3(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="one card|CUDA"):
        cuda_conv3x3.launch_conv3x3(x, w.cpu())


# the one-launch BN-sums forward at its edges: one row, fewer rows than
# the grid has blocks, C = 2048 (32 channel groups), C = 24, and a map
# long enough for every block of the grid
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", [(1, 64), (1, 2048), (300, 2048), (37, 24),
                                 (2_000_001, 64), (100_003, 512)])
def test_bn_sums_forward_edges_match_plain(m, c, dtype):
    rng = np.random.default_rng(m + c)
    x = _card_tensor(rng, (m, c), dtype, loc=0.5)
    got = cuda_fused_bn.launch_channel_sums(x)
    torch.cuda.synchronize()
    x32 = x.float()
    _assert_sums_close(got, fused_bn.channel_sums(x),
                       (x32.abs().sum(0), (x32 * x32).sum(0)))
    again = cuda_fused_bn.launch_channel_sums(x)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bn_sums_forward_is_one_launch():
    """One kernel per call (the last block folds the partial sums), and no
    allocation on the card but the (2, C) output."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(43_904, 512, device="cuda", dtype=torch.bfloat16)
    cuda_fused_bn.launch_channel_sums(x)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = cuda_fused_bn.launch_channel_sums(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert torch.cuda.memory_allocated() - before <= 2 * 512 * 4 + 512
    del out


# one pass of the switched towers' BN-sums forward calls, (M, C) and calls
BN_TOWER_CALLS = [((11_239_424, 64), 1), ((2_809_856, 64), 4),
                  ((702_464, 128), 5), ((175_616, 256), 5),
                  ((43_904, 512), 5), ((4_557_280, 64), 1),
                  ((1_160_544, 64), 4), ((300_832, 128), 5),
                  ((80_640, 256), 5), ((22_400, 512), 5)]


def test_bn_sums_forward_towers_calls_back_to_back():
    """The 40 calls of a towers pass queued on one stream without a
    synchronisation: each right, and each repeat of a shape the same bits
    (the scratch and counters are reused call after call)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    inputs = [torch.randn(shape, device="cuda", dtype=torch.bfloat16,
                          generator=gen).add_(0.5)
              for shape, _ in BN_TOWER_CALLS]
    outs = [[cuda_fused_bn.launch_channel_sums(x) for _ in range(count)]
            for x, (_, count) in zip(inputs, BN_TOWER_CALLS)]
    torch.cuda.synchronize()
    assert sum(len(o) for o in outs) == 40
    for x, calls in zip(inputs, outs):
        x32 = x.float()
        _assert_sums_close(calls[0], fused_bn.channel_sums(x),
                           (x32.abs().sum(0), (x32 * x32).sum(0)))
        del x32
        for again in calls[1:]:
            assert all(torch.equal(a, b) for a, b in zip(calls[0], again))


def test_bn_sums_forward_on_two_streams():
    """Calls in flight at once on two streams, each with its own scratch
    and counters: both right."""
    rng = np.random.default_rng(3)
    xs = [_card_tensor(rng, (1_000_003, 64), torch.bfloat16, loc=0.5),
          _card_tensor(rng, (200_001, 256), torch.bfloat16, loc=-1.0)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for _ in range(3):
        for x, stream in zip(xs, streams):
            with torch.cuda.stream(stream):
                outs.append(cuda_fused_bn.launch_channel_sums(x))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        x = xs[i % 2]
        x32 = x.float()
        _assert_sums_close(got, fused_bn.channel_sums(x),
                           (x32.abs().sum(0), (x32 * x32).sum(0)))
        assert all(torch.equal(a, b) for a, b in zip(got, outs[i % 2]))
    keys = {(0, s.cuda_stream) for s in streams}
    assert keys <= set(cuda_fused_bn._SCRATCH)


# the max-pool backward's tiles: H or W of 1 or 2, odd and even H and W,
# C = 8 and 24 (one channel vector per tile), 256 (four 64-channel slices),
# and more than 256 windows in a row (two column tiles)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 1, 1, 8), (2, 2, 1, 24),
                                   (1, 1, 2, 256), (3, 66, 70, 8),
                                   (2, 65, 313, 24), (1, 17, 9, 256),
                                   (2, 9, 600, 8), (2, 65, 313, 64)])
def test_pool_backward_tiles_match_plain(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = np.maximum(np.round(rng.normal(size=shape) * 2) / 2, 0)
    x = torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)
    _, idx = cuda_maxpool.launch_pool_fwd(x)
    dy = _card_tensor(rng, idx.shape, dtype)
    dx = cuda_maxpool.launch_pool_bwd(dy, idx, *shape[1:3])
    torch.cuda.synchronize()
    assert torch.equal(dx, maxpool.pool_bwd(dy, idx, *shape[1:3]))
    assert torch.equal(dx, cuda_maxpool.launch_pool_bwd(dy, idx, *shape[1:3]))


def _loader_twin():
    from multimodal_clinical_tpu_torch.data import loader, sampler, synthetic

    train = synthetic.make_synthetic_splits(
        "vggsound", 5, n_train=37, n_val=1, n_test=1,
        shapes=[(9, 12, 1), (2, 6, 6, 3)])[0]
    return loader.Loader(train, 8, sampler.WeightedSampler(train.labels,
                                                           seed=3),
                         workers=3, transfer_dtype=torch.bfloat16,
                         device="cuda")


def test_loader_copies_the_host_batches_to_the_card():
    """Pinned copies on the loader's side stream, read by a consumer on a
    stream of its own: bit-equal to the host batches, and ``skip``."""
    ld = _loader_twin()
    ld.set_epoch(2)
    host = list(ld._host_batches())
    consumer = torch.cuda.Stream()
    with torch.cuda.stream(consumer):
        got = [{k: v.clone() for k, v in b.items()} for b in ld]
    torch.cuda.synchronize()
    assert len(got) == len(host) == 5
    for b, h in zip(got, host):
        assert b.keys() == h.keys()
        for k in h:
            assert b[k].device.type == "cuda" and b[k].dtype == h[k].dtype
            assert torch.equal(b[k].cpu(), h[k]), k
    ld.skip(2)
    assert len(list(ld)) == 3


def test_loader_producer_stops_when_abandoned_on_the_card():
    import threading
    import time

    ld = _loader_twin()
    it = iter(ld)
    next(it)
    it.close()
    deadline = time.monotonic() + 10
    while (any(t.name == "loader-producer" for t in threading.enumerate())
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert not any(t.name == "loader-producer"
                   for t in threading.enumerate())


# -- the contracts' device code: QMF scatter, OGM-GE, Crema-D front end ----

def test_qmf_history_update_drops_padded_duplicates_on_the_card():
    """The loader's padded tail repeats the last real row, ``idx``
    included; on the card the pad rows must not win the scatter."""
    from multimodal_clinical_tpu_torch.algos import qmf

    rng = np.random.default_rng(0)
    corr = torch.from_numpy(rng.uniform(0.5, 2, 50).astype(np.float32))
    conf = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    idx = torch.tensor([7, 0, 41, 5] + [3] * 60)
    valid = (torch.arange(64) < 5).float()
    batch_conf = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    loss = torch.tensor(1.37)
    want = qmf.history_update(corr, conf, idx, loss, batch_conf, valid)
    for _ in range(3):
        got = qmf.history_update(*(t.cuda() for t in (
            corr, conf, idx, loss, batch_conf, valid)))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    assert want[1][3] == batch_conf[4]


def test_qmf_history_update_keeps_the_last_of_a_drawn_twice_idx_on_the_card():
    """The sampler draws with replacement: a valid ``idx`` repeated in a
    batch writes its last row's confidence on the card, every time, as on
    the CPU."""
    from multimodal_clinical_tpu_torch.algos import qmf

    rng = np.random.default_rng(2)
    corr = torch.from_numpy(rng.uniform(0.5, 2, 50).astype(np.float32))
    conf = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 8, 64))  # each idx ~8 times
    valid = (torch.arange(64) < 60).float()
    batch_conf = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    loss = torch.tensor(0.83)
    want = qmf.history_update(corr, conf, idx, loss, batch_conf, valid)
    last = {int(i): r for r, i in enumerate(idx[:60].tolist())}
    for i, r in last.items():
        assert want[1][i] == batch_conf[r]
    for _ in range(3):
        got = qmf.history_update(*(t.cuda() for t in (
            corr, conf, idx, loss, batch_conf, valid)))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("modulation", ["OGM", "OGM_GE"])
def test_modulate_gradients_on_the_card_matches_cpu(modulation):
    """The same gradients, logits and noise on the card and on the CPU:
    the coefficient and each std are fp32 reductions in another order."""
    from multimodal_clinical_tpu_torch.algos import ogm_ge
    from multimodal_clinical_tpu_torch.models.zoo import CremadFusionNet

    rng = np.random.default_rng(1)
    models = [CremadFusionNet(5, width=4), CremadFusionNet(5, width=4).cuda()]
    noise = {}
    for name, p in models[0].named_parameters():
        p.grad = torch.from_numpy(rng.normal(scale=1e-2, size=p.shape)
                                  .astype(np.float32))
        noise[name] = torch.from_numpy(rng.normal(size=p.shape)
                                       .astype(np.float32))
    for (_, p), (_, q) in zip(models[0].named_parameters(),
                              models[1].named_parameters()):
        q.grad = p.grad.cuda()
    x1, x2 = (torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
              for _ in range(2))
    label = torch.from_numpy(rng.integers(0, 5, 8))
    valid = (torch.arange(8) < 6).float()
    for model in models:
        dev = next(model.parameters()).device
        ogm_ge.modulate_gradients(
            model, x1.to(dev), x2.to(dev), label.to(dev),
            lambda name, g: noise[name].to(g.device), alpha=0.8,
            modulation=modulation, valid=valid.to(dev))
    for (name, p), (_, q) in zip(models[0].named_parameters(),
                                 models[1].named_parameters()):
        np.testing.assert_allclose(q.grad.cpu().numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_cremad_spectrogram_on_the_card_matches_cpu():
    """cuFFT against the CPU's FFT, both fp32, at the (257, 1004)
    geometry: the standardised log-power within 5e-5, as the CPU tests
    hold the port's against the JAX function."""
    from multimodal_clinical_tpu_torch.ops.spectrogram import (
        cremad_spectrogram,
    )

    rng = np.random.default_rng(2)
    wave = torch.from_numpy(rng.normal(scale=0.3, size=(3, 160000))
                            .astype(np.float32))
    got = cremad_spectrogram(wave.cuda())
    assert got.shape == (3, 257, 1004) and got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(),
                               cremad_spectrogram(wave).numpy(),
                               rtol=0, atol=5e-5)


def test_disk_batches_through_the_loader_equal_their_gathers(tmp_path):
    """A VGGSound disk corpus through the Loader on the card (3 gather
    threads, pinned host batches copied on its side stream): every batch
    of an epoch, its padded tail included, equals the dataset's gather at
    the sampler's indices bit for bit."""
    from types import SimpleNamespace

    from multimodal_clinical_tpu_torch.benchmarks import (
        disk_fixture, vggsound,
    )
    from multimodal_clinical_tpu_torch.data.loader import Loader
    from multimodal_clinical_tpu_torch.data.sampler import WeightedSampler

    tree = str(tmp_path) + "/"
    disk_fixture.build_vggsound_tree(tree, 12, 4, 3, n_frames=4,
                                     seconds=1.0, frame_size=(64, 48),
                                     distinct=4)
    data = vggsound.get_data(SimpleNamespace(data_path=tree, seed=1,
                                             num_classes=3))
    sampler = WeightedSampler(data.train.labels, seed=1)
    loader = Loader(data.train, 8, sampler, workers=3, device="cuda")
    loader.set_epoch(1)
    idx = np.asarray(sampler.indices(1))
    batches = list(loader)
    torch.cuda.synchronize()
    assert len(batches) == 2
    for start, batch in zip(range(0, len(idx), 8), batches):
        chunk = idx[start:start + 8]
        want = data.train.gather(chunk)
        assert batch["valid"].sum().item() == len(chunk)
        for key, arr in want.items():
            got = batch[key]
            assert got.is_cuda
            np.testing.assert_array_equal(got[:len(chunk)].cpu().numpy(),
                                          arr, err_msg=key)
