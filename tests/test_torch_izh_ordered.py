"""The Izhikevich head's plain versions in its tensor-core body's own
summation order (``ops/fused_izh.py``): ``_izh_head_train_ordered_reference``
(``csrc/head_mma_fwd.cuh:head_mma_kernel`` with the Izhikevich cell) and
``_izh_bwd_ordered_reference`` (``csrc/chain_mma.cuh`` with the Izhikevich
chain, then the gradient functions in their order).

On the card they are the kernels' witnesses (``tests/test_torch_cuda.py``:
the forward bit for bit, the backward at the small-shape bars).  Here, on
the CPU:

* the ordered backward against the order-free plain backward
  (``_bwd_reference``) on the same residuals, TTFS and periodic, T = 24 and
  100, at dt = 1e-3 (the JAX suite's scale, W_in 3e6, W_rec 5e5) and dt =
  30 (init-scale weights, where the chain's u carry matters), two kernel
  plans: 2e-6 of max|g| (5e-6 at T = 100), bf16 2**-7;
* the ordered forward against the order-free plain forward at dt = 1e-3:
  logits 1e-5, spikes, ``tstar`` and counts equal, ``v`` within 1e-6
  relative (1e-3 mV: input sums of ~1e8 in another order);
* both against the JAX Pallas Izhikevich pair in interpret mode at the JAX
  suite's scale, T = 24 and 100, at ``tests/test_torch_izh.py``'s bars:
  logits 1e-5, spikes equal, ``v`` 1e-6 relative (1e-4 mV), the backward on
  the JAX forward's residuals 2e-6 of max|g|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_fused_izh as jfi  # noqa: E402
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
from snnimageclassification_tpu_torch.ops import fused_izh as tfi  # noqa: E402
from snnimageclassification_tpu_torch.ops import izh as tizh  # noqa: E402
from snnimageclassification_tpu_torch.ops.cells import (  # noqa: E402
    IzhikevichConfig,
    ReadoutConfig,
)
from snnimageclassification_tpu_torch.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType,
)

B, F, H, O = 37, 30, 20, 10
KAPPA = ReadoutConfig(input_size=H, output_size=O).kappa
# Two plans of the gradient functions, as tests/test_torch_ordered.py.
ORDERS = [dict(groups_in=3, rows_in=4, groups_out=5, rows_out=4,
               groups_rec=3),
          dict(groups_in=7, rows_in=1, groups_out=2, rows_out=2,
               groups_rec=2)]


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


def _head(dt, T, use_periods, wdtype, rows=B, seed=11):
    """(lat, w_in, w_rec, w_out, b_out, T, use_periods, kp, kappa): the JAX
    suite's scale at dt = 1e-3, init-scale N(0, 1) weights at dt = 30."""
    rng = np.random.default_rng(seed)
    pixels = torch.from_numpy(rng.random((rows, F)).astype(np.float32))
    lat = pixels_to_firing_periods(pixels, t_max=float(T), tau=20.0)
    s_in, s_rec = (3e6, 5e5) if dt < 1 else (1.0, 1.0)

    def w(shape, std):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32))

    w_in = w((F, H), s_in).to(wdtype)
    w_rec = (w((H, H), s_rec) * (1 - torch.eye(H))).to(wdtype)
    return (lat.contiguous(), w_in, w_rec, w((H, O), 1.0).to(wdtype),
            w((O,), 0.1), T, use_periods,
            tizh.izh_kernel_params(_cfg(dt)), KAPPA)


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


def _rtz32(x: float) -> np.float32:
    """The float32 next to ``x`` toward zero (``x`` itself where it
    fits)."""
    with np.errstate(over="ignore"):
        y = np.float32(x)
    if abs(float(y)) > abs(x):
        y = np.nextafter(y, np.float32(0))
    return y


def test_mma_slice_model_matches_a_scalar_loop():
    """``ops/fused.py:_mma_slice``, the ordered versions' model of one
    tensor-core product (probed on the card by
    ``tests/test_torch_cuda.py::test_tensor_core_slice_sums_truncate``),
    against a scalar loop in exact rationals: each term (bf16 products and
    the float32 accumulator) truncated toward zero to a multiple of 2^(e -
    25), e the largest term's exponent, the sum truncated toward zero to
    float32.  Terms span 40 binades, so most sums do not fit float32."""
    from fractions import Fraction

    from snnimageclassification_tpu_torch.ops import fused

    rng = np.random.default_rng(3)

    def bf16(shape, lo, hi):
        x = rng.standard_normal(shape) * 2.0 ** rng.integers(lo, hi, shape)
        return torch.from_numpy(x).to(torch.bfloat16).double()

    a, w = bf16((4, 16), -4, 4), bf16((16, 5), -30, 6)
    c = bf16((4, 5), -20, 8).float()
    for acc in (None, c):
        got = fused._mma_slice(a, w, acc)
        for i in range(4):
            for n in range(5):
                terms = [Fraction(float(a[i, k])) * Fraction(float(w[k, n]))
                         for k in range(16)]
                if acc is not None:
                    terms.append(Fraction(float(acc[i, n])))
                top = max(abs(t) for t in terms)
                e = 0
                while Fraction(2) ** e <= top:
                    e += 1
                while Fraction(2) ** (e - 1) > top:
                    e -= 1
                grid = Fraction(2) ** (e - 26)
                kept = sum((1 if t > 0 else -1) * (abs(t) // grid) * grid
                           for t in terms if t)
                assert got[i, n] == _rtz32(float(kept)), (i, n)


@pytest.mark.parametrize("order", ORDERS, ids=["r4", "r1"])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [24, 100])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("dt", [1e-3, 30.0], ids=["dt1e-3", "dt30"])
def test_ordered_backward_matches_the_plain_backward(dt, use_periods, T,
                                                     wdtype, order):
    """On the same residuals (the plain forward's ``v`` and ``tstar``) the
    ordered backward is the order-free plain backward within the
    small-shape bars, with and without the counts' cotangent."""
    head = _head(dt, T, use_periods, wdtype)
    _, v, tstar, counts = tfi._head_reference(*head, True, True)
    assert 0 < float(counts.sum()) < B * T * H  # the units fire
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.standard_normal((B, O)).astype(np.float32))
    g_counts = torch.from_numpy(
        (0.01 * rng.standard_normal((B, H))).astype(np.float32))
    cfg = _cfg(dt)
    for gc in (None, g_counts):
        args = (g, gc, tstar, None, None, v, head[0], head[1], head[2],
                head[3], T, use_periods, head[7], cfg.gamma, KAPPA,
                SpikeFuncType.FastSigmoid)
        got = tfi._izh_bwd_ordered_reference(*args, order)
        assert _grad_err(got, tfi._bwd_reference(*args)) <= _bar(wdtype, T)
        assert float(got[0].float().abs().max()) > 0


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rec,use_periods,T", [
    (True, False, 24), (True, True, 100), (False, True, 24),
    (False, False, 100)], ids=["rec-ttfs-24", "rec-periodic-100",
                               "ff-periodic-24", "ff-ttfs-100"])
def test_ordered_forward_matches_the_plain_forward(rec, use_periods, T,
                                                   wdtype):
    """At dt = 1e-3 the tensor-core forward's ordered plain version is the
    order-free one within 1e-5 (logits) and the ``v`` bars, spikes equal;
    its training logits are its inference logits."""
    head = list(_head(1e-3, T, use_periods, wdtype))
    if not rec:
        head[2] = None
    got = tfi._izh_head_train_ordered_reference(*head, True, True)
    want = tfi._head_reference(*head, True, True)
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-6)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert float(got[3].sum()) > 0
    served = tfi._izh_head_train_ordered_reference(*head, False, False)
    assert torch.equal(served[0], got[0]) and served[1] is None


@pytest.mark.parametrize("use_periods,T", [(False, 24), (True, 100)],
                         ids=["ttfs-24", "periodic-100"])
def test_ordered_versions_match_pallas(use_periods, T):
    """Against the JAX Pallas Izhikevich pair in interpret mode: the
    ordered forward's logits within 1e-5, its ``v``, ``tstar`` and counts
    at tests/test_torch_izh.py's bars; the ordered backward fed the JAX
    forward's residuals (the counts' cotangent too) within 2e-6 of
    max|g|."""
    head = _head(1e-3, T, use_periods, torch.float32, rows=5, seed=8)
    lat, w_in, w_rec, w_out, b_out = head[:5]
    kp = dict(head[7])
    j = {k: jnp.asarray(t.numpy()) for k, t in
         (("w_in", w_in), ("w_rec", w_rec), ("w_out", w_out),
          ("b_out", b_out))}
    jv, jlat, jlog, jts, jcnt = jfi._izh_fwd_call(
        jnp.asarray(lat.numpy()), j["w_in"], j["w_rec"], kp, T=T,
        use_periods=use_periods, interpret=True, w_out=j["w_out"],
        b_out=j["b_out"], kappa=KAPPA, store_counts=True)
    logits, v, tstar, counts = tfi._izh_head_train_ordered_reference(
        *head, True, True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4,
                               rtol=1e-6)
    np.testing.assert_array_equal(tstar.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcnt))
    assert float(counts.sum()) > 0
    rng = np.random.default_rng(9)
    g_logits = rng.standard_normal((5, O)).astype(np.float32)
    g_counts = (0.05 * rng.standard_normal((5, H))).astype(np.float32)
    cfg = _cfg(1e-3)
    jgr = jfi._izh_bwd_call(
        None, jv, None, jlat, j["w_in"], j["w_rec"], kp, T=T,
        use_periods=use_periods, gamma=cfg.gamma,
        spike_func=JSpike.FastSigmoid, interpret=True,
        g_logits=jnp.asarray(g_logits), tstar=jts, w_out=j["w_out"],
        kappa=KAPPA, g_counts=jnp.asarray(g_counts))
    tgr = tfi._izh_bwd_ordered_reference(
        torch.from_numpy(g_logits), torch.from_numpy(g_counts),
        torch.from_numpy(np.array(jts)), None, None,
        torch.from_numpy(np.array(jv)), lat, w_in, w_rec, w_out, T,
        use_periods, head[7], cfg.gamma, KAPPA, SpikeFuncType.FastSigmoid,
        ORDERS[0])
    for name, g, want in zip(("w_in", "w_rec", "w_out", "b_out"), tgr, jgr):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   atol=2e-6, rtol=0, err_msg=name)
