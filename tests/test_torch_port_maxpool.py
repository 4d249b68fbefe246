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


# The CUDA backward's routing (csrc/maxpool.cu), mirrored in plain torch:
# window (i, j) owns dx rows 2i, 2i + 1 and columns 2j, 2j + 1 and reads
# only windows (i, j), (i, j + 1), (i + 1, j), (i + 1, j + 1); a block stages
# a tile of ``rows`` window rows x ``tw`` windows x ``cv`` channel vectors
# with a one-row, one-column halo, windows outside the map as index 9.


def _kernel_tiling(c, wo, dtype):
    """(rows, tw, cv) of the kernel's tiles (``bwd_grid``): cv the largest
    power of two up to 8 dividing C / 8, tw the even split of Wo into
    column tiles of at most 256 / cv windows, 4 window rows (bf16) or 2."""
    vecs, cv = c // 8, 1
    while cv < 8 and vecs % (2 * cv) == 0:
        cv *= 2
    col_tiles = -(-wo // (256 // cv))
    return (4 if dtype == torch.bfloat16 else 2), -(-wo // col_tiles), cv


def _quad_tiles_bwd(dy, idx, h, w, rows, tw, cv):
    b, ho, wo, c = dy.shape
    d = dy.float()
    dx = torch.full((b, 2 * ho, 2 * wo, c), float("nan"))
    for oh0 in range(0, ho, rows):
        for c0 in range(0, c, 8 * cv):
            for ow0 in range(0, wo, tw):
                ch = slice(c0, c0 + 8 * cv)
                rr, cc = min(rows + 1, ho - oh0), min(tw + 1, wo - ow0)
                td = torch.zeros(b, rows + 1, tw + 1, 8 * cv)
                ti = torch.full(td.shape, 9, dtype=torch.uint8)
                td[:, :rr, :cc] = d[:, oh0:oh0 + rr, ow0:ow0 + cc, ch]
                ti[:, :rr, :cc] = idx[:, oh0:oh0 + rr, ow0:ow0 + cc, ch]

                def tap(t, r, s):
                    v = td[:, r:r + rows, s:s + tw]
                    return torch.where(ti[:, r:r + rows, s:s + tw] == t, v,
                                       0.0)

                quads = {(0, 0): tap(4, 0, 0),
                         (0, 1): tap(5, 0, 0) + tap(3, 0, 1),
                         (1, 0): tap(7, 0, 0) + tap(1, 1, 0),
                         (1, 1): tap(8, 0, 0) + tap(6, 0, 1) + tap(2, 1, 0)
                         + tap(0, 1, 1)}
                nr, nc = min(rows, ho - oh0), min(tw, wo - ow0)
                for (p, q), v in quads.items():
                    dx[:, 2 * oh0 + p:2 * (oh0 + nr):2,
                       2 * ow0 + q:2 * (ow0 + nc):2, ch] = v[:, :nr, :nc]
    # quad rows and columns past an odd H or W are not written
    return dx[:, :h, :w].to(dy.dtype)


# even and odd H and W, H or W of 1 or 2, C = 24 (one vector per tile), and
# tiles that do not divide the map
TILE_SHAPES = [(2, 8, 8, 8), (3, 9, 11, 16), (1, 65, 13, 8), (2, 1, 2, 8),
               (2, 2, 1, 24), (1, 20, 33, 64)]


def _pool_case(shape, dtype, seed=42):
    xj, ct = _inputs(shape, True, dtype, seed)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    x, dy = _to_torch(xj).to(tdtype), _to_torch(ct).to(tdtype)
    return xj, ct, dy, maxpool.pool_fwd(x)[1]


@pytest.mark.parametrize("tiling", ["kernel", "ragged"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", TILE_SHAPES)
def test_quad_tile_routing_equals_pool_bwd(shape, dtype, tiling):
    """The kernel's tile-by-tile routing gives ``pool_bwd``'s dx bit for
    bit, with its own tiles and with 3-row, 5-window, one-vector tiles."""
    _, _, dy, idx = _pool_case(shape, dtype)
    b, h, w, c = shape
    tiles = (_kernel_tiling(c, dy.shape[2], dy.dtype) if tiling == "kernel"
             else (3, 5, 1))
    got = _quad_tiles_bwd(dy, idx, h, w, *tiles)
    want = maxpool.pool_bwd(dy, idx, h, w)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("shape,dtype", [((3, 9, 11, 16), jnp.float32),
                                         ((1, 20, 33, 64), jnp.bfloat16)])
def test_quad_tile_routing_equals_pallas_interpret(shape, dtype):
    """... and ``_pool_bwd_pallas``'s (``jax.vjp`` of the Pallas op, in
    interpret mode on the CPU) bit for bit."""
    xj, ct, dy, idx = _pool_case(shape, dtype)
    _, vjp = jax.vjp(max_pool_3x3_s2_pallas, xj)
    (want,) = vjp(ct)
    got = _quad_tiles_bwd(dy, idx, *shape[1:3],
                          *_kernel_tiling(shape[3], dy.shape[2], dy.dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
