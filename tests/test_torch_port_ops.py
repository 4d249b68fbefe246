"""The port's ops (``multimodal_clinical_tpu_torch/ops``, ``data/imageops``)
held against the JAX package on the CPU.

Inputs come from numpy with a fixed seed and go through both sides.  fp32
only; TF32 is off for the torch side (it matters on the card only, but the
comparison states its precision either way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.data.imageops import (
    normalize_frames_device as jax_normalize_frames,
)
from multimodal_clinical_tpu.ops.pallas_spectrogram import (
    pallas_log_spectrogram,
)
from multimodal_clinical_tpu.ops.spectrogram import (
    log_spectrogram as jax_log_spectrogram,
)
from multimodal_clinical_tpu.ops.specaugment import spec_augment
from multimodal_clinical_tpu_torch.data.imageops import (
    normalize_frames_device, to_unit_floats_device,
)
from multimodal_clinical_tpu_torch.ops import cuda_spectrogram, specaugment
from multimodal_clinical_tpu_torch.ops.spectrogram import (
    frame_signal, log_spectrogram,
)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Both sides are fp32 products over 256 taps in another summation order,
# the port with the window folded into its tables.  The log turns an
# absolute error e in |X| into e / |X|; the smallest |X| here is 4e-3.
# Measured on the CPU: at most 1.2e-4 at (2, 16000), 2.2e-5 at hop 100.
SPEC_ATOL = 1e-3
SPEC_RTOL = 1e-5
# The FFT mirror against the references, at lengths where some bin's |X|
# comes within 1e-4 of 0 and an fp32 rounding there moves the log by ~1e-3:
# |X| within 1e-5 of the largest |X|, the log within SPEC_ATOL where |X| is
# at least 1e-3 of the rms (the limits the GPU tests hold the kernel to).
MAG_TOL = 1e-5


def _assert_log_magnitudes_close(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    got_mag, want_mag = got.exp(), want.exp()
    assert (got_mag - want_mag).abs().max() <= MAG_TOL * want_mag.max()
    clear = want_mag >= 1e-3 * want_mag.square().mean().sqrt()
    assert (got - want).abs()[clear].max() <= SPEC_ATOL


@pytest.mark.parametrize("shape,hop", [((2, 16000), 128), ((1, 4000), 100)])
def test_log_spectrogram_matches_jax_and_pallas(shape, hop):
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    got = log_spectrogram(torch.from_numpy(x), n_fft=256, hop=hop).numpy()
    want = np.asarray(jax_log_spectrogram(jnp.asarray(x), n_fft=256, hop=hop))
    pallas = np.asarray(pallas_log_spectrogram(jnp.asarray(x), n_fft=256,
                                               hop=hop, interpret=True))
    assert got.shape == want.shape == pallas.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SPEC_RTOL, atol=SPEC_ATOL)
    np.testing.assert_allclose(got, pallas, rtol=SPEC_RTOL, atol=SPEC_ATOL)


def test_spectrogram_wrapper_takes_plain_version_on_cpu():
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(2, 3000)).astype(np.float32))
    before = cuda_spectrogram.launch_log_spectrogram.launches
    got = cuda_spectrogram.log_spectrogram(x, n_fft=256, hop=100)
    assert torch.equal(got, log_spectrogram(x, n_fft=256, hop=100))
    assert cuda_spectrogram.launch_log_spectrogram.launches == before


def test_spectrogram_kernel_launch_raises_for_cpu_tensor():
    x = torch.zeros(2, 3000)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_spectrogram.launch_log_spectrogram(x)


@pytest.mark.parametrize("n_fft", [300, 2048, 32])
def test_spectrogram_kernel_refuses_unplanned_n_fft_before_the_device(n_fft):
    """An n_fft without a digit plan raises naming what the kernel takes,
    before the device check (this tensor is on the CPU)."""
    with pytest.raises(ValueError, match="power of two from 64 to 1024"):
        cuda_spectrogram.launch_log_spectrogram(torch.zeros(2, 3000),
                                                n_fft=n_fft)


def _four_step_mirror(wave, n_fft, hop, eps=1e-7):
    """The kernel's arithmetic in plain torch, from the wrapper's tables:
    windowed frames, two per complex transform (z = x_t + i x_{t+1}), the
    N1-point DFTs over n1 of z[N2 n1 + p], the twiddle W^(p k1), the
    N2-point DFTs over p (bin k1 + N1 k2), the split, log(|X| + eps).
    Every root of unity is an entry of the twiddle table."""
    n1, n2, window, twiddle = cuda_spectrogram.fft_tables(n_fft)
    tw = torch.complex(*torch.from_numpy(twiddle).T.contiguous())
    frames = frame_signal(wave, n_fft, hop) * torch.from_numpy(window)
    b, t, _ = frames.shape
    if t % 2:
        frames = torch.cat([frames, frames.new_zeros(b, 1, n_fft)], 1)
    z = torch.complex(frames[:, 0::2], frames[:, 1::2])
    z = z.reshape(b, -1, n1, n2)                          # [n1][p]
    r1, r2 = torch.arange(n1), torch.arange(n2)
    y = torch.einsum("bjnp,nk->bjkp", z, tw[(n2 * r1[:, None] * r1) % n_fft])
    y = y * tw[r1[:, None] * r2]                          # [k1][p]
    x = torch.einsum("bjkp,pm->bjmk", y, tw[(n1 * r2[:, None] * r2) % n_fft])
    xa, xb = cuda_spectrogram.split_pairs(x.reshape(b, -1, n_fft))
    spec = torch.stack([xa, xb], 2).reshape(b, -1, n_fft // 2 + 1)[:, :t]
    return torch.log(spec.abs() + eps).transpose(1, 2)


@pytest.mark.parametrize("shape,hop", [((3, 4001), 100), ((2, 80000), 128)])
def test_fft_kernel_tables_match_plain_jax_and_pallas(shape, hop):
    """What the wrapper hands the FFT kernel (digit plan, window, twiddles)
    and the two-frame split, run through the mirror above, against the
    port's plain version, the JAX function and the Pallas kernel."""
    x = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    got = _four_step_mirror(torch.from_numpy(x), 256, hop).numpy()
    plain = log_spectrogram(torch.from_numpy(x), n_fft=256, hop=hop).numpy()
    want = np.array(jax_log_spectrogram(jnp.asarray(x), n_fft=256, hop=hop))
    pallas = np.array(pallas_log_spectrogram(jnp.asarray(x), n_fft=256,
                                             hop=hop, interpret=True))
    assert got.shape == plain.shape == want.shape == pallas.shape
    for ref in (plain, want, pallas):
        _assert_log_magnitudes_close(got, ref)


@pytest.mark.parametrize("n_fft", sorted(cuda_spectrogram.FFT_PLANS))
def test_every_fft_plan_matches_plain_version(n_fft):
    """Each digit plan's tables give the plain version's spectrogram, at a
    hop that is no fraction of n_fft and an odd frame count."""
    n1, n2, window, twiddle = cuda_spectrogram.fft_tables(n_fft)
    assert n1 * n2 == n_fft and n1 >= n2
    assert window.dtype == twiddle.dtype == np.float32
    assert window.shape == (n_fft,) and twiddle.shape == (n_fft, 2)
    torch.testing.assert_close(
        torch.from_numpy(window),
        torch.hann_window(n_fft, periodic=True, dtype=torch.float64).float(),
        rtol=0, atol=6e-8)
    x = torch.from_numpy(np.random.default_rng(n_fft).normal(
        size=(2, 5 * n_fft + 3)).astype(np.float32))
    hop = n_fft // 3 + 1
    got = _four_step_mirror(x, n_fft, hop)
    want = log_spectrogram(x, n_fft=n_fft, hop=hop)
    assert got.shape == want.shape and want.shape[-1] % 2
    _assert_log_magnitudes_close(got, want)


def _split_masks(combined):
    """(B, F, T) product of a frequency and a time mask -> the two masks
    (exact: where the product is all zero, any split gives it back)."""
    return combined.any(axis=2).astype(np.float32), \
        combined.any(axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_augment_injected_masks_match_jax(seed):
    import jax

    b, f, t = 4, 129, 157
    key = jax.random.PRNGKey(seed)
    combined = np.asarray(spec_augment(key, jnp.ones((b, f, t))))
    fmask, tmask = _split_masks(combined)
    x = np.random.default_rng(seed).normal(size=(b, f, t)).astype(np.float32)
    want = np.asarray(spec_augment(key, jnp.asarray(x)))
    got = specaugment.apply_masks(torch.from_numpy(x),
                                  torch.from_numpy(fmask),
                                  torch.from_numpy(tmask)).numpy()
    np.testing.assert_array_equal(got, want)  # products by 0 and 1: exact


def test_band_mask_marks_half_open_bands():
    widths = torch.tensor([[0, 3], [5, 2]])
    starts = torch.tensor([[4, 1], [0, 6]])
    got = specaugment.band_mask(widths, starts, 10, "cpu").numpy()
    want = np.ones((2, 10), np.float32)
    want[0, 1:4] = 0       # width 0 at 4 masks nothing
    want[1, 0:5] = 0
    want[1, 6:8] = 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim,param,num", [(129, 30, 2), (626, 120, 3),
                                           (32, 120, 3)])
def test_spec_augment_draw_distribution(dim, param, num):
    """Widths ~ randint[0, param), starts = int(U * max(dim - w, 1)): the
    JAX and torch streams differ, so the draws are held to their law."""
    n = 20000
    widths, starts = specaugment.draw_bands(
        torch.Generator().manual_seed(0), n, dim, param, num)
    w, s = widths.numpy(), starts.numpy()
    assert w.shape == s.shape == (n, num)
    assert w.min() == 0 and w.max() == param - 1
    assert np.bincount(w.ravel(), minlength=param).min() > 0
    assert abs(w.mean() - (param - 1) / 2) < 0.02 * param
    room = np.maximum(dim - w, 1)
    assert (s >= 0).all() and (s < room).all()
    frac = (s + 0.5) / room
    assert abs(frac[room > 20].mean() - 0.5) < 0.01
    mask = specaugment.band_mask(widths, starts, dim, "cpu").numpy()
    masked = (mask == 0).sum(axis=1)
    assert (masked <= np.minimum(w.sum(axis=1), dim)).all()
    assert (masked >= np.minimum(w, dim - s).max(axis=1)).all()


def test_spec_augment_masks_shapes_and_generator_replay():
    gen = lambda: torch.Generator().manual_seed(5)
    fm, tm = specaugment.spec_augment_masks(gen(), 3, 129, 626, "cpu")
    fm2, tm2 = specaugment.spec_augment_masks(gen(), 3, 129, 626, "cpu")
    assert fm.shape == (3, 129) and tm.shape == (3, 626)
    assert torch.equal(fm, fm2) and torch.equal(tm, tm2)
    assert set(torch.unique(fm).tolist()) <= {0.0, 1.0}


def test_normalize_frames_device_uint8_and_float():
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, size=(2, 3, 8, 8, 3), dtype=np.uint8)
    got = normalize_frames_device(torch.from_numpy(u8)).numpy()
    want = np.asarray(jax_normalize_frames(jnp.asarray(u8)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    f = torch.from_numpy(rng.normal(size=(2, 8, 8, 3)).astype(np.float32))
    assert normalize_frames_device(f) is f
    assert to_unit_floats_device(f) is f
    np.testing.assert_allclose(to_unit_floats_device(torch.from_numpy(u8)),
                               u8.astype(np.float32) / 255.0, rtol=1e-7)
