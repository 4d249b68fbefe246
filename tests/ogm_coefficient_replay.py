"""Replays the OGM case of ``test_torch_port_algos.py::
test_modulate_gradients_matches_jax`` on this host's CPU with JAX and
without flax: both packages' coefficients for the case's logits (bias
0.7 and -0.7), their distance in ulps, and a modulated 4-D gradient (OGM
mode) held port against JAX, and given each side's own coefficient.

    python tests/ogm_coefficient_replay.py
"""

import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from multimodal_clinical_tpu.algos import ogm_ge as jax_ogm  # noqa: E402
from multimodal_clinical_tpu_torch.algos import ogm_ge  # noqa: E402


def _case(bias: float):
    """``test_torch_port_algos.py::_logits(3, bias=bias)`` and
    ``_valid(8, 6)``."""
    rng = np.random.default_rng(3)
    x1 = rng.normal(size=(8, 5)).astype(np.float32)
    x2 = rng.normal(size=(8, 5)).astype(np.float32)
    label = rng.integers(0, 5, size=8)
    x1[np.arange(8), label] += bias
    valid = np.zeros(8, np.float32)
    valid[:6] = 1.0
    return x1, x2, label, valid


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    print("jax", jax.__version__, "torch", torch.__version__)
    for bias in (0.7, -0.7):
        x1, x2, label, valid = _case(bias)
        port = [float(c) for c in ogm_ge.ogm_coefficients(
            torch.from_numpy(x1), torch.from_numpy(x2),
            torch.from_numpy(label), 0.8, torch.from_numpy(valid))]
        ref = [float(c) for c in jax_ogm.ogm_coefficients(
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(label), 0.8,
            jnp.asarray(valid))]
        ulps = [int(np.float32(a).view(np.int32))
                - int(np.float32(b).view(np.int32))
                for a, b in zip(port, ref)]
        g = np.random.default_rng(7).normal(
            scale=1e-2, size=(64, 3, 3, 32)).astype(np.float32)
        k = 0 if port[0] != 1.0 else 1  # the suppressed modality
        got = (torch.from_numpy(g) * torch.tensor(port[k])).numpy()
        want = np.asarray(jnp.asarray(g) * jnp.float32(ref[k]))
        given = want.astype(np.float64) + g.astype(np.float64) * (
            port[k] - ref[k])
        scale = np.abs(want).max()
        print(f"bias {bias}: port {port} jax {ref}, {ulps} ulps apart; "
              f"OGM gradient port against JAX "
              f"{np.abs(got - want).max() / scale:.3e}, given each side's "
              f"coefficient {np.abs(got - given).max() / scale:.3e} of the "
              "largest entry")


if __name__ == "__main__":
    main()
