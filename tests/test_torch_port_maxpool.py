"""The port's stored-index max-pool (``multimodal_clinical_tpu_torch/ops/
maxpool.py``) held against the JAX package's ``max_pool_3x3_s2_pallas`` on
the CPU, where its Pallas kernels run in interpret mode (as
``tests/test_maxpool.py`` runs them).  The port's wrapper takes the plain
versions for a CPU tensor; the CUDA kernels are held against those on the
card in ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.ops.maxpool_pallas import max_pool_3x3_s2_pallas
from multimodal_clinical_tpu_torch.ops import cuda_maxpool, maxpool

torch.set_num_threads(2)

# bf16 dx: both sides add the routed fp32 values of up to 4 windows in
# the same order and round once; held to one bf16 ulp of the largest dx
# (2^-8) in case the two libraries' fp32 adds differ in the last bit.
BF16_ULP = 2.0 ** -8

SHAPES = [
    (2, 8, 8, 8),      # even H and W
    (3, 9, 11, 16),    # odd H and W
    (1, 65, 13, 8),    # tall and odd, as the audio stem (65 x 313)
    (2, 1, 2, 8),      # a single input row
]


def _inputs(shape, ties, dtype, seed=42):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if ties:
        x = np.maximum(np.round(x * 2) / 2, 0)  # ReLU-like tie plateaus
    xj = jnp.asarray(x, dtype)
    ho, wo = (shape[1] - 1) // 2 + 1, (shape[2] - 1) // 2 + 1
    ct = jnp.asarray(rng.normal(size=(shape[0], ho, wo, shape[3])), dtype)
    return xj, ct


def _to_torch(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_pool_matches_pallas_interpret(shape, ties, dtype):
    """y, and dx routed through the stored index (ties to the first tap in
    row-major order), against ``jax.vjp`` of the Pallas op."""
    xj, ct = _inputs(shape, ties, dtype)
    y, vjp = jax.vjp(max_pool_3x3_s2_pallas, xj)
    (dx,) = vjp(ct)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    x = _to_torch(xj).to(tdtype).requires_grad_(True)
    ty = maxpool.max_pool_3x3_s2_stored_index(x)
    ty.backward(_to_torch(ct).to(tdtype))
    assert ty.dtype == x.grad.dtype == tdtype
    np.testing.assert_array_equal(ty.detach().float().numpy(),
                                  np.asarray(y, np.float32))
    want = np.asarray(dx, np.float32)
    if dtype == jnp.float32:
        np.testing.assert_array_equal(x.grad.numpy(), want)
    else:
        np.testing.assert_allclose(x.grad.float().numpy(), want, rtol=0,
                                   atol=BF16_ULP * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_forward_index_is_the_first_maximum(shape):
    """The uint8 index: 0..8, the FIRST tap holding the maximum, with
    padded taps at -inf (an all-equal map picks the first in-map tap)."""
    xj, _ = _inputs(shape, True, jnp.float32)
    x = _to_torch(xj)
    y, idx = maxpool.pool_fwd(x)
    assert idx.dtype == torch.uint8 and int(idx.max()) <= 8
    y0, idx0 = maxpool.pool_fwd(torch.zeros(shape))
    assert torch.equal(y0, torch.zeros_like(y0))
    # window (0, 0) starts at the padded corner: its first in-map tap is 4;
    # interior windows start in the map: tap 0
    assert int(idx0[0, 0, 0, 0]) == 4
    if shape[1] > 2 and shape[2] > 2:
        assert int(idx0[0, 1, 1, 0]) == 0
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    for a in range(3):
        for s in range(3):
            tap = xp[:, a:a + 2 * y.shape[1] - 1:2, s:s + 2 * y.shape[2] - 1:2]
            t = 3 * a + s
            assert torch.equal(tap[idx == t], y[idx == t])
            # no earlier tap already held the maximum
            assert not (tap[idx > t] == y[idx > t]).any()


def test_no_grad_primal_is_max_pool2d_and_launches_nothing():
    """Without autograd the op is the JAX primal's ``reduce_window``:
    ``F.max_pool2d``, no index, no kernel."""
    xj, _ = _inputs((2, 9, 11, 16), False, jnp.float32)
    x = _to_torch(xj)
    before = (cuda_maxpool.launch_pool_fwd.launches,
              cuda_maxpool.launch_pool_bwd.launches)
    with torch.no_grad():
        y = maxpool.max_pool_3x3_s2_stored_index(x.requires_grad_(True))
    np.testing.assert_array_equal(y.numpy(),
                                  np.asarray(max_pool_3x3_s2_pallas(xj)))
    assert y.grad_fn is None
    assert (cuda_maxpool.launch_pool_fwd.launches,
            cuda_maxpool.launch_pool_bwd.launches) == before


def test_autograd_saves_only_the_uint8_index():
    x = torch.randn(2, 9, 7, 8, requires_grad=True)
    y = maxpool.max_pool_3x3_s2_stored_index(x)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].dtype == torch.uint8
    assert saved[0].shape == y.shape


def test_expanded_gradient_reaches_the_backward_contiguous(monkeypatch):
    """``y.sum()`` hands the backward an expanded dy (all strides 0); the
    op copies it to the row-major layout that the CUDA kernel reads (its
    wrapper raises on any other)."""
    pool_bwd, contiguous = maxpool.pool_bwd, []

    def recording(dy, *args):
        contiguous.append(dy.is_contiguous())
        return pool_bwd(dy, *args)

    monkeypatch.setattr(maxpool, "pool_bwd", recording)
    x = torch.randn(2, 9, 7, 8, requires_grad=True)
    maxpool.max_pool_3x3_s2_stored_index(x).sum().backward()
    x_ones = x.detach().clone().requires_grad_(True)
    y = maxpool.max_pool_3x3_s2_stored_index(x_ones)
    y.backward(torch.ones_like(y))
    assert contiguous == [True, True]
    torch.testing.assert_close(x.grad, x_ones.grad, rtol=0, atol=0)
