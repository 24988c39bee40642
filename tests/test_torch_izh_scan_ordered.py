"""The Izhikevich scan's plain versions in its tensor-core bodies' own
summation order (``ops/izh.py``): ``_scan_ordered_reference``
(``csrc/head_mma_fwd.cuh:head_mma_kernel`` with the Izhikevich cell and the
currents as its input) and ``_scan_bwd_ordered_reference``
(``csrc/chain_mma.cuh`` with ``izh_chain.cuh:IzhScanChain``, then
``gbits_mma`` in its order).

On the card they are the kernels' witnesses (``tests/test_torch_cuda.py``:
the forward bit for bit, the backward at the small-shape bars).  Here, on
the CPU, at B = 37, H = 45 and 128, T = 24 and 100, float32 and bfloat16
W_rec, recurrent and feedforward:

* the ordered forward against the order-free plain forward
  (``_scan_reference``): at dt = 1e-3 (the JAX suite's scale, currents 3e6
  + 1e6 N(0, 1), W_rec 5e5 sqrt(20 / H) N(0, 1)) spikes equal and ``v``
  within 1e-6 relative (1e-3 mV: sums of ~1e8 in another order);
  feedforward at dt = 30 bit for bit (no product: the same arithmetic);
  recurrent at dt = 30 the first step bit for bit (between spikes the cell
  triples a last-bit difference of v each step, so the traces part
  later);
* the ordered backward against the order-free plain backward
  (``_scan_bwd_reference``) on the same residuals, FastSigmoid and Phi, at
  dt = 1e-3 and dt = 30 (a second layer's currents at init scale, W_rec of
  std 0.3 sqrt(20 / H), where the chain's u carry matters), two plans of
  ``gbits_mma``: g_i and g_W_rec within 2e-6 of max|g| (5e-6 at T = 100),
  bf16 2**-7;
* ``izh_scan``'s autograd function with the ordered versions in place of
  the plain ones against the JAX Pallas scan in interpret mode and
  ``jax.grad`` through it, one case each way, at ``tests/test_torch_izh.py``'s
  bars: spikes equal, ``v`` 1e-6 relative (1e-4 mV), the whole call's
  gradients 1e-4 of max|g|, the backward alone on the JAX forward's
  residuals 2e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_izh as jizh  # noqa: E402
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
from snnimageclassification_tpu_torch.ops import izh as tizh  # noqa: E402
from snnimageclassification_tpu_torch.ops.cells import (  # noqa: E402
    IzhikevichConfig,
)
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType,
)

B = 37
ORDERS = [dict(groups_rec=3), dict(groups_rec=2)]  # two plans of gbits_mma


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ordered plain versions run many small tensor ops: faster on one
    thread than on a thread pool that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dt):
    return IzhikevichConfig(input_size=1, output_size=1, dt=dt)


def _inputs(dt, rec, T, H, wdtype, rows=B, seed=23):
    """(currents (T, rows, H) float32, masked W_rec | None, kernel params):
    the JAX suite's scale at dt = 1e-3 (its W_rec, 5e5 at H = 20, scaled
    by sqrt(20 / H): at 5e5 the chain overflows at H = 128); at dt = 30 a
    second layer's currents, 0/1 spikes of 20 units firing a fifth of the
    steps times N(0, 1) weights, and W_rec of std 0.3 sqrt(20 / H)."""
    rng = np.random.default_rng(seed)
    if dt < 1:
        cur = 3e6 + 1e6 * rng.standard_normal((T, rows, H))
        s_rec = 5e5 * (20 / H) ** 0.5
    else:
        spikes = (rng.random((T, rows, 20)) < 0.2).astype(np.float32)
        cur = spikes @ rng.standard_normal((20, H))
        s_rec = 0.3 * (20 / H) ** 0.5
    w_rec = None
    if rec:
        w = (s_rec * rng.standard_normal((H, H))) * (1 - np.eye(H))
        w_rec = torch.from_numpy(w.astype(np.float32)).to(wdtype)
    return (torch.from_numpy(cur.astype(np.float32)).contiguous(), w_rec,
            tizh.izh_kernel_params(_cfg(dt)))


def _grad_err(got, want):
    worst = 0.0
    for g, p in zip(got, want):
        if p is None:
            assert g is None
            continue
        assert g.dtype == p.dtype and g.shape == p.shape
        scale = float(p.float().abs().max()) or 1.0
        worst = max(worst, float((g.float() - p.float()).abs().max()) / scale)
    return worst


def _bar(wdtype, T):
    if wdtype == torch.bfloat16:
        return 2.0 ** -7
    return 5e-6 if T >= 100 else 2e-6


WDTYPES = [torch.float32, torch.bfloat16]
FWD_CASES = [(dt, rec, T) for dt in (1e-3, 30.0) for rec in (True, False)
             for T in (24, 100)]


@pytest.mark.parametrize("wdtype", WDTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "dt,rec,T", FWD_CASES,
    ids=[f"dt{c[0]:g}-{'rec' if c[1] else 'ff'}-{c[2]}" for c in FWD_CASES])
def test_ordered_forward_matches_the_plain_forward(dt, rec, T, wdtype):
    for H in (45, 128):
        cur, w_rec, kp = _inputs(dt, rec, T, H, wdtype)
        z, v = tizh._scan_ordered_reference(cur, w_rec, kp, True)
        zp, vp = tizh._scan_reference(cur, w_rec, kp, True)
        assert z.dtype == v.dtype == torch.float32
        assert tuple(z.shape) == tuple(v.shape) == (T, B, H)
        assert 0 < float(z.mean()) < 1, f"H={H}: no unit fires"
        assert torch.equal(z, (v >= dict(kp)["v_peak"]).float())
        if not rec:  # no product: the plain loop's arithmetic
            assert torch.equal(z, zp) and torch.equal(v, vp)
        elif dt < 1:
            assert torch.equal(z, zp), f"H={H}"
            torch.testing.assert_close(v, vp, rtol=1e-6, atol=1e-3)
        else:
            assert torch.equal(v[0], vp[0]) and torch.equal(z[0], zp[0])


BWD_CASES = [(dt, rec, spike, T) for dt in (1e-3, 30.0)
             for rec in (True, False)
             for spike in (SpikeFuncType.FastSigmoid, SpikeFuncType.Phi)
             for T in (24, 100)]


@pytest.mark.parametrize("wdtype", WDTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "dt,rec,spike,T", BWD_CASES,
    ids=[f"dt{c[0]:g}-{'rec' if c[1] else 'ff'}-{c[2].name}-{c[3]}"
         for c in BWD_CASES])
def test_ordered_backward_matches_the_plain_backward(dt, rec, spike, T,
                                                     wdtype):
    gamma = _cfg(dt).gamma
    for H in (45, 128):
        cur, w_rec, kp = _inputs(dt, rec, T, H, wdtype)
        z, v = tizh._scan_reference(cur, w_rec, kp, True)
        g_z = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (T, B, H)).astype(np.float32)) / B
        args = (g_z, z, v, w_rec, kp, gamma, spike)
        want = tizh._scan_bwd_reference(*args)
        assert all(bool(torch.isfinite(g).all()) for g in want
                   if g is not None)
        for order in ORDERS if rec else ORDERS[:1]:
            keep = {}
            got = tizh._scan_bwd_ordered_reference(*args, order, keep=keep)
            err = _grad_err(got, want)
            assert err <= _bar(wdtype, T), f"H={H} {order}: {err:.3g}"
            if rec:
                assert keep["g_w_rec"].dtype == torch.float32
                assert torch.equal(keep["g_w_rec"].to(wdtype), got[1])
            else:
                assert got[1] is None and not keep


# ---------------------------------------------------------------------------
# The autograd function with the ordered versions against the JAX kernels
# ---------------------------------------------------------------------------
JB, JH, JT = 5, 20, 24
JCFG = IzhikevichConfig(input_size=JH, output_size=JH)
JKP = jizh.izh_kernel_params(JCFG)


@pytest.fixture
def ordered_scan(monkeypatch):
    """``izh_scan`` on the CPU with the ordered plain versions in place of
    the order-free ones (a plan of ``gbits_mma`` for the backward)."""
    monkeypatch.setattr(tizh, "_scan_reference",
                        tizh._scan_ordered_reference)
    monkeypatch.setattr(
        tizh, "_scan_bwd_reference",
        lambda *a: tizh._scan_bwd_ordered_reference(*a, ORDERS[0]))


def _jax_inputs(seed):
    rng = np.random.default_rng(seed)
    cur = (3e6 + 1e6 * rng.standard_normal((JT, JB, JH))).astype(np.float32)
    w = ((5e5 * rng.standard_normal((JH, JH))).astype(np.float32)
         * (1 - np.eye(JH, dtype=np.float32)))
    r = rng.standard_normal((JT, JB, JH)).astype(np.float32)
    return cur, w, r


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def test_ordered_forward_through_autograd_matches_the_jax_kernel(
        ordered_scan):
    cur, w, _ = _jax_inputs(3)
    jz, jv = jizh._fwd_call(jnp.asarray(cur), jnp.asarray(w), dict(JKP),
                            True)
    tc = torch.from_numpy(cur).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tz = tizh.izh_scan(tc, tw, tizh.izh_kernel_params(JCFG), JCFG.gamma)
    assert tz.grad_fn is not None
    np.testing.assert_array_equal(_np(tz), _np(jz))
    assert 0 < float(tz.detach().mean()) < 1
    tzz, tv = tizh._scan_reference(torch.from_numpy(cur), tw.detach(), JKP,
                                   True)
    np.testing.assert_array_equal(_np(tzz), _np(jz))
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-6, atol=1e-4)


def test_ordered_backward_through_autograd_matches_jax_grad(ordered_scan):
    cur, w, r = _jax_inputs(4)
    spike = "Phi"

    def jloss(c, w_rec):
        z = jizh.izh_scan(c, w_rec, JKP, JCFG.gamma, JSpike[spike], True)
        return jnp.sum(z * r)

    jg = jax.grad(jloss, (0, 1))(jnp.asarray(cur), jnp.asarray(w))
    tc = torch.from_numpy(cur).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tz = tizh.izh_scan(tc, tw, tizh.izh_kernel_params(JCFG), JCFG.gamma,
                       SpikeFuncType[spike])
    (tz * torch.from_numpy(r)).sum().backward()
    for got, want in ((tc.grad, jg[0]), (tw.grad, jg[1])):
        scale = float(np.abs(_np(want)).max())
        assert scale > 0
        np.testing.assert_allclose(_np(got) / scale, _np(want) / scale,
                                   atol=1e-4, rtol=0)
    # The backward alone on the JAX forward's residuals.
    jzz, jv = jizh._fwd_call(jnp.asarray(cur), jnp.asarray(w), dict(JKP),
                             True)
    jgi, jgw = jizh._bwd_call(jnp.asarray(r), jv, jzz, jnp.asarray(w),
                              dict(JKP), JCFG.gamma, JSpike[spike], True)
    tgi, tgw = tizh._scan_bwd_reference(
        torch.from_numpy(r), torch.from_numpy(_np(jzz)),
        torch.from_numpy(_np(jv)), tw.detach(), JKP, JCFG.gamma,
        SpikeFuncType[spike])
    for got, want in ((tgi, jgi), (tgw, jgw)):
        scale = float(np.abs(_np(want)).max())
        np.testing.assert_allclose(_np(got) / scale, _np(want) / scale,
                                   atol=2e-6, rtol=0)
