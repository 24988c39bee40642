"""The encoded input product of the port on the CPU
(``encoded_input_matmul`` through its plain PyTorch versions, forward and
backward) against the JAX Pallas kernel (ops/pallas_encode.py) in interpret
mode, on identical numpy latencies and weights.

TTFS and periodic encoding, float32 and bfloat16 weights, T = 7 (the JAX
suite's shape) and T = 24, latencies drawn from [0, T + 2) so that some
never fire; and the degenerate production latencies of
tests/test_pallas_encode.py (0 and t_max, quirk Q2).  Currents and the W
gradient of ``sum(out * cot)`` within 1e-5 relative (float32 sums of the
same terms in another order); the latencies get no gradient.

The CUDA kernels run only on the card: tests/test_torch_cuda.py and
``chip_smoke.py`` hold them against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops.pallas_encode import (  # noqa: E402
    encoded_input_matmul as j_encode,
)
from snnimageclassification_tpu_torch.ops import encode as tenc  # noqa: E402
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402

GRID = [(per, T, wd) for per in (False, True) for T in (7, 24)
        for wd in ("float32", "bfloat16")]
IDS = [f"{'periodic' if p else 'ttfs'}-T{T}-{wd}" for p, T, wd in GRID]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("use_periods,T,wd", GRID, ids=IDS)
def test_encoded_input_matmul_matches_jax(use_periods, T, wd):
    B, F, H = 6, 20, 8
    rng = np.random.default_rng(1)
    lat = rng.integers(0, T + 2, size=(B, F)).astype(np.int32)
    w = rng.standard_normal((F, H)).astype(np.float32)
    cot = rng.standard_normal((T, B, H)).astype(np.float32)
    jw = jnp.asarray(w).astype(wd)
    jout = j_encode(jnp.asarray(lat), jw, T, use_periods, True)
    jg = jax.grad(lambda w_: jnp.sum(
        j_encode(jnp.asarray(lat), w_, T, use_periods, True) * cot))(jw)

    tw = torch.from_numpy(w).to(getattr(torch, wd)).requires_grad_(True)
    tfused.reset_launch_counts()
    tout = tenc.encoded_input_matmul(torch.from_numpy(lat), tw, T,
                                     use_periods)
    (tout * torch.from_numpy(cot)).sum().backward()
    assert not any(tfused.launch_counts().values())  # no kernel on the CPU
    assert tout.dtype == torch.float32 and tout.shape == (T, B, H)
    assert tw.grad.dtype == tw.dtype
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=1e-5, atol=1e-5)
    assert float(np.abs(_np(jg)).max()) > 0
    scale = float(np.abs(_np(jg)).max())
    tol = 1e-5 if wd == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(tw.grad) / scale, _np(jg) / scale,
                               atol=tol, rtol=0)


@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_degenerate_production_latencies(use_periods):
    """Quirk Q2: latency 0 (supra-threshold) and t_max (sub-threshold)."""
    n_steps = 5
    lat = np.asarray([[0, n_steps, 0, 2]], dtype=np.int32)
    w = np.eye(4, dtype=np.float32)
    want = j_encode(jnp.asarray(lat), jnp.asarray(w), n_steps, use_periods,
                    True)
    got = tenc.encoded_input_matmul(torch.from_numpy(lat),
                                    torch.from_numpy(w), n_steps,
                                    use_periods)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert torch.equal(got, tenc.encoded_input_matmul_reference(
        torch.from_numpy(lat), torch.from_numpy(w), n_steps, use_periods))
    assert tenc.encode_matmul_supported(n_steps, 4, n_features=4,
                                        device="cpu")
    assert not tenc.encode_matmul_supported(0, 4, n_features=4,
                                            device="cpu")
