"""The CUDA log-spectrogram kernel against its plain version, on the card.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (decided inside the fixture, so every worker collects the same
tests).  Run on a machine with a card:
``python -m pytest tests/test_torch_port_cuda.py -q``; ``chip_smoke.py``
makes the same comparison at the main path's shape.
"""

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu_torch.ops import cuda_spectrogram
from multimodal_clinical_tpu_torch.ops.spectrogram import log_spectrogram

pytestmark = pytest.mark.cuda

# Both sides are fp32 sums of the same 256 products in another order
# (TF32 is off for the plain version's matmul).  In |X| they agree to a
# few fp32 ulps of the batch's largest |X|; the log turns that into up to
# ~1e-2 in the few bins where |X| is near zero, so the log is held tight
# only where |X| is at least 1e-3 of the batch's rms.
MAG_TOL = 1e-5
LOG_ATOL = 1e-3


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
