"""The encoded product's plain forward in the CUDA kernel's order
(``ops/encode.py:_fwd_ordered_reference``) against the JAX Pallas kernel
(ops/pallas_encode.py) in interpret mode, on identical numpy latencies and
weights, and bit for bit against a scalar loop in the stated order.

``encode_matmul_fwd`` adds W's rows by key -- the TTFS step or the periodic
period ``clamp(L, 1, T - 1)`` -- in ascending f, then, periodic, each step's
current as the sum over the periods dividing it in ascending period.  On the
card ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel equal
to this plain version bit for bit; here it is held within 1e-5 relative of
the JAX kernel (float32 sums of the same terms in another order) at T = 1,
2, 7, 24 and 100 with latencies drawn from [-2, T + 2) (some never fire,
some fall before the first step), float32 and bfloat16 weights, and on the
production latencies of quirk Q2 (every latency 0 or t_max, rows where
nothing fires).  The scalar loop pins down the order itself.

At T = 1 under periodic encoding the period is 0 and, by the JAX package's
encoding (ops/encoding.py: ``x % 0 == 0``), every feature fires at t = 0;
the JAX Pallas kernel computes that spike as ``0 / 0`` in float32 and gives
no spike.  There the port follows the encoding: the case is held against
``einsum`` of the JAX raster, and the kernel's zeros are asserted beside it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import encoding as jenc  # noqa: E402
from snnimageclassification_tpu.ops.pallas_encode import (  # noqa: E402
    encoded_input_matmul as j_encode,
)
from snnimageclassification_tpu_torch.ops import encode as tenc  # noqa: E402

STEPS = (1, 2, 7, 24, 100)
GRID = [(per, T, wd) for per in (False, True) for T in STEPS
        for wd in ("float32", "bfloat16")]
IDS = [f"{'periodic' if p else 'ttfs'}-T{T}-{wd}" for p, T, wd in GRID]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _jax_raster_product(lat, w, T, use_periods):
    """einsum('tbf,fh->tbh') of the JAX package's own raster."""
    to_spikes = (jenc.firing_periods_to_spikes if use_periods
                 else jenc.firing_times_to_spikes)
    spikes = to_spikes(jnp.asarray(lat), T)
    return jnp.einsum("tbf,fh->tbh", spikes, w.astype(jnp.float32))


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("use_periods,T,wd", GRID, ids=IDS)
def test_ordered_forward_matches_jax(use_periods, T, wd):
    B, F, H = 6, 20, 8
    rng = np.random.default_rng(T + 100 * use_periods)
    lat = rng.integers(-2, T + 2, size=(B, F)).astype(np.int32)
    w = rng.standard_normal((F, H)).astype(np.float32)
    jw = jnp.asarray(w).astype(wd)
    got = tenc._fwd_ordered_reference(torch.from_numpy(lat),
                                      torch.from_numpy(w).to(getattr(torch,
                                                                     wd)),
                                      T, use_periods)
    assert got.dtype == torch.float32 and got.shape == (T, B, H)
    kernel = _np(j_encode(jnp.asarray(lat), jw, T, use_periods, True))
    if use_periods and T == 1:
        assert not kernel.any()  # the JAX kernel's 0 / 0: no spike
        want = _np(_jax_raster_product(lat, jw, T, use_periods))
        assert np.abs(want).max() > 0  # the encoding fires every feature
    else:
        want = kernel
    _close(_np(got), want)


@pytest.mark.parametrize("T", [24, 100])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_ordered_forward_production_latencies(use_periods, T):
    """Quirk Q2: at the production tau every latency is 0 or t_max; rows
    2 and 5 are all below threshold (TTFS: nothing fires)."""
    B, F, H = 7, 40, 16
    rng = np.random.default_rng(5)
    pixels = rng.random((B, F)).astype(np.float32)
    pixels[[2, 5]] *= 0.19
    lat = np.array(jenc.pixels_to_firing_periods(jnp.asarray(pixels),
                                                    t_max=float(T)))
    assert set(np.unique(lat)) <= {0, T}
    w = rng.standard_normal((F, H)).astype(np.float32)
    got = _np(tenc._fwd_ordered_reference(torch.from_numpy(lat),
                                          torch.from_numpy(w), T,
                                          use_periods))
    want = _np(j_encode(jnp.asarray(lat), jnp.asarray(w), T, use_periods,
                        True))
    _close(got, want)
    if not use_periods:
        assert not got[:, [2, 5]].any()


def _scalar_loop(lat, w, T, use_periods):
    """The stated order, one float32 rounding an add: W[f] into acc[row,
    key] in ascending f; TTFS currents(t) = acc[t]; periodic currents(t) =
    the sum of acc[p] over p = 1 .. t with t % p == 0 (t >= 1), ascending
    (T = 1: acc[0] at t = 0)."""
    B, F = lat.shape
    H = w.shape[1]
    out = np.zeros((T, B, H), np.float32)
    for b in range(B):
        acc = np.zeros((T + 1, H), np.float32)
        for f in range(F):
            L = int(lat[b, f])
            if use_periods:
                k = min(max(L, 1), T - 1)
            else:
                k = L if 0 <= L < T else T
            for h in range(H):
                acc[k, h] = np.float32(acc[k, h] + w[f, h])
        for t in range(T):
            if not use_periods:
                out[t, b] = acc[t]
                continue
            for h in range(H):
                s = np.float32(0.0)
                if T == 1:
                    s = np.float32(s + acc[0, h])
                for p in range(1, t + 1):
                    if t % p == 0:
                        s = np.float32(s + acc[p, h])
                out[t, b, h] = s
    return out


@pytest.mark.parametrize("T", [1, 6])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_ordered_forward_is_the_stated_order(use_periods, T):
    """Bit for bit a scalar loop.  The weights span eight decades, so the
    order shows: the same adds over the features in descending f give
    other bits."""
    B, F, H = 3, 16, 4
    rng = np.random.default_rng(11)
    lat = rng.integers(-1, T + 1, size=(B, F)).astype(np.int32)
    w = (rng.standard_normal((F, H))
         * 10.0 ** rng.integers(-4, 4, size=(F, 1))).astype(np.float32)

    def ordered(lat_, w_):
        return tenc._fwd_ordered_reference(torch.from_numpy(lat_),
                                           torch.from_numpy(w_), T,
                                           use_periods).numpy()

    got = ordered(lat, w)
    want = _scalar_loop(lat, w, T, use_periods)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    descending = ordered(lat[:, ::-1].copy(), w[::-1].copy())
    assert not np.array_equal(got, descending)
