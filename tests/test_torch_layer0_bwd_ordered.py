"""The first layers' backwards in their kernels' order
(``ops/fused.py:_layer0_bwd_ordered_reference``,
``ops/fused_izh.py:_izh_bwd_ordered_reference`` in its first-layer mode:
the chains with the tensor-core chain body's k16-sliced products, then the
gradient functions' ordered versions) on the CPU, on identical numpy
inputs from a seed:

* against the order-free plain versions (``fused._layer0_bwd_reference``,
  ``fused_izh._bwd_reference``; held against the JAX kernels by
  tests/test_torch_mid.py and tests/test_torch_izh.py) on the plain
  forward's residuals at B = 37, H = 45 and 128, T = 24 and 100, float32
  and bfloat16: ``g_W_in``, ``g_W_rec`` and the chain's rounded cotangent
  within 1e-5 of max|g| (float32) or 2**-7 (bfloat16); the Izhikevich one
  at dt = 1e-3 (the JAX suite's scale) and dt = 30 (init-scale weights,
  where the chain's u carry moves a gradient);
* one small case of each through the port's ``autograd.Function`` with the
  ordered backward in place of the plain one, against ``jax.grad``
  through the JAX kernel pair in interpret mode, at those files' bars;
* the composed gate's model: the ordered layer-0 backward fed ``g_z = dz0
  + g_cnt0`` on the two-layer pair's layer-0 residuals gives
  ``fused2._fused2_bwd_ordered_reference``'s ``dcur0``, ``g_W0`` and
  ``g_W0r`` bit for bit in float32 (on the card: ``fused2_bwd`` against
  ``fused_mid_bwd`` + ``fused_layer0_bwd``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused2 as tf2,
    fused_izh as tfi,
    izh as tizh,
)
from snnimageclassification_tpu_torch.ops.cells import (  # noqa: E402
    IzhikevichConfig,
)
from snnimageclassification_tpu_torch.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)
import test_torch_izh as izh_tests  # noqa: E402
import test_torch_mid as mid_tests  # noqa: E402
from test_torch_deep_bwd_ordered import (  # noqa: E402
    F2_CASES,
    F2_ORDER,
    _f2_args,
)

B, F = 37, 30
# Any plan is an order; these walk several blocks of rows for each
# gradient function (the card's come from the kernels' plans).
L0_ORDER = {"groups_in": 3, "rows_in": 4, "groups_rec": 2}
IZH_ORDER = dict(L0_ORDER, groups_out=0, rows_out=0)
CASES = F2_CASES  # name, alif, recurrent, surrogate, use_periods


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ordered plain versions run many small tensor ops: faster on one
    thread than on a thread pool that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bar(wd):
    return 1e-5 if wd == torch.float32 else 2.0 ** -7


def _close(got, want, wd, label):
    for i, (g, p) in enumerate(zip(got, want)):
        if p is None:
            assert g is None, f"{label} {i}"
            continue
        assert g.dtype == p.dtype and g.shape == p.shape, f"{label} {i}"
        scale = float(p.float().abs().max())
        assert scale > 0, f"{label} {i}: no gradient"
        err = float((g.float() - p.float()).abs().max()) / scale
        assert err <= _bar(wd), f"{label} {i}: {err:.3g} of max|g|"


def _latencies(rng, T):
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32))
    return pixels_to_firing_periods(pixels, t_max=float(T),
                                    tau=20.0).contiguous()


def _w(rng, shape, std, wd, mask=False):
    x = (std * rng.standard_normal(shape)).astype(np.float32)
    if mask:
        x = x * (1 - np.eye(shape[0], dtype=np.float32))
    return torch.from_numpy(x).to(wd)


def _l0_args(case, T, H, wd, seed=47):
    """``_layer0_bwd_reference``'s arguments on the plain forward's
    residuals (the JAX kernel's choice: ``delta`` for ALIF with
    FastSigmoid, else ``v``; ``a`` for ALIF with Phi): W_in 1.5 N(0, 1),
    W_rec 0.4 sqrt(20 / H) N(0, 1) eye-masked, g_z N(0, 1)."""
    _, alif, rec, spike_name, per = case
    rng = np.random.default_rng(seed)
    alif, alpha, rho, thr, gamma = mid_tests._scalars(alif, spike_name)
    spike = TSpike[spike_name]
    lat = _latencies(rng, T)
    w_in = _w(rng, (F, H), 1.5, wd)
    w_rec = _w(rng, (H, H), 0.4 * np.sqrt(20.0 / H), wd, True) if rec \
        else None
    beta = 1.6 if alif else 0.0
    res_is_v = tfused._residual_is_v(alif, spike)
    z, res, a_tr = tfused._layer0_reference(
        lat, w_in, w_rec, beta, T, per, alif, alpha, rho, thr, True,
        tfused._stores_a(alif, spike), res_is_v)
    assert 0 < float(z.float().mean()) < 1, "the layer fires"
    g_z = _w(rng, (T, B, H), 1.0, wd)
    return (g_z, z, res, a_tr, res_is_v, lat, w_in, w_rec, beta, T, per,
            alpha, thr, gamma, spike)


L0_GRID = ([(c, 24, H, wd) for c in CASES for H in (45, 128)
            for wd in (torch.float32, torch.bfloat16)]
           + [(c, 100, H, torch.float32) for c in CASES[:2]
              for H in (45, 128)]
           + [(CASES[3], 100, 128, torch.bfloat16)])
L0_IDS = [f"{c[0]}-T{T}-H{H}-{str(wd)[6:]}" for c, T, H, wd in L0_GRID]


@pytest.mark.parametrize("case,T,H,wd", L0_GRID, ids=L0_IDS)
def test_layer0_ordered_backward_matches_the_plain_version(case, T, H, wd):
    """``g_W_in``, ``g_W_rec`` and the chain's rounded ``dcur``."""
    args = _l0_args(case, T, H, wd)
    keep = {}
    got = tfused._layer0_bwd_ordered_reference(*args, L0_ORDER, keep=keep)
    _close(got, tfused._layer0_bwd_reference(*args), wd, case[0])
    dcur = torch.zeros_like(keep["dcur"])
    f32 = torch.float32
    tfused._bwd_loop(lambda t: torch.zeros((B, F), dtype=f32), None, None,
                     None, None, args[0], args[2], args[3], args[1], args[4],
                     args[7], args[8], None, T, *args[11:14], 0.0, args[14],
                     wd, dcur_out=dcur)
    _close([keep["dcur"]], [dcur], wd, f"{case[0]} dcur")


def _izh_args(dt, rec, per, T, H, wd, seed=53):
    """``fused_izh._bwd_reference``'s first-layer arguments on the plain
    forward's residuals: the JAX suite's scale at dt = 1e-3 (W_in 3e6,
    W_rec 5e5), init-scale N(0, 1) weights at dt = 30; g_z N(0, 1)."""
    rng = np.random.default_rng(seed)
    cfg = IzhikevichConfig(input_size=1, output_size=1, dt=dt)
    kp = tizh.izh_kernel_params(cfg)
    s_in, s_rec = (3e6, 5e5) if dt < 1 else (1.0, 1.0)
    lat = _latencies(rng, T)
    w_in = _w(rng, (F, H), s_in, wd)
    w_rec = _w(rng, (H, H), s_rec, wd, True) if rec else None
    z, v = tfi._layer0_reference(lat, w_in, w_rec, T, per, kp, True)
    assert 0 < float(z.mean()) < 1, "the layer fires"
    g_z = _w(rng, (T, B, H), 1.0, torch.float32)
    return (None, None, None, g_z, z, v, lat, w_in, w_rec, None, T, per, kp,
            cfg.gamma, 0.0, TSpike.FastSigmoid)


IZH_GRID = ([(dt, rec, per, 24, H, wd) for dt, rec, per in
             ((1e-3, True, False), (30.0, True, True), (30.0, False, False))
             for H in (45, 128) for wd in (torch.float32, torch.bfloat16)]
            + [(dt, True, False, 100, H, torch.float32)
               for dt in (1e-3, 30.0) for H in (45, 128)]
            + [(30.0, True, True, 100, 128, torch.bfloat16)])
IZH_IDS = [f"dt{dt:g}-{'rec' if rec else 'ff'}-"
           f"{'periodic' if per else 'ttfs'}-T{T}-H{H}-{str(wd)[6:]}"
           for dt, rec, per, T, H, wd in IZH_GRID]


@pytest.mark.parametrize("dt,rec,per,T,H,wd", IZH_GRID, ids=IZH_IDS)
def test_izh_layer0_ordered_backward_matches_the_plain_version(
        dt, rec, per, T, H, wd):
    """``g_W_in``, ``g_W_rec`` and the chain's rounded ``gi``."""
    args = _izh_args(dt, rec, per, T, H, wd)
    keep = {}
    got = tfi._izh_bwd_ordered_reference(*args, IZH_ORDER, keep=keep)
    assert got[2] is None and got[3] is None
    label = f"dt={dt} T={T} H={H}"
    _close(got[:2], tfi._bwd_reference(*args)[:2], wd, label)
    gi = torch.zeros_like(keep["dcur"])
    tizh._izh_bwd_loop(None, None, None, None, args[3], args[5], args[4],
                       args[8], None, args[12], args[13], 0.0, args[15], wd,
                       gi_out=gi)
    _close([keep["dcur"]], [gi], wd, f"{label} gi")


def test_layer0_ordered_backward_matches_the_jax_kernel(monkeypatch):
    """ALIF, recurrent, FastSigmoid, TTFS, T = 24, float32, through
    ``fused``'s ``_Layer0Fn`` with the ordered backward, against
    ``jax.grad`` of the JAX kernel pair (tests/test_torch_mid.py's bars)."""
    monkeypatch.setattr(tfused, "_layer0_bwd_reference",
                        lambda *a: tfused._layer0_bwd_ordered_reference(
                            *a, L0_ORDER))
    mid_tests.test_layer0_matches_the_jax_kernel(mid_tests.CASES[0], 24,
                                                 "float32", False)


def test_izh_layer0_ordered_backward_matches_the_jax_kernel(monkeypatch):
    """Recurrent, TTFS, FastSigmoid, T = 24, float32, through
    ``fused_izh``'s ``_Layer0Fn`` with the ordered backward, against
    ``jax.grad`` of the JAX kernel pair, and alone on the JAX forward's
    residuals (tests/test_torch_izh.py's bars)."""
    monkeypatch.setattr(tfi, "_bwd_reference",
                        lambda *a: tfi._izh_bwd_ordered_reference(
                            *a, IZH_ORDER))
    izh_tests.test_fused_layer0_matches_the_jax_kernel(
        *izh_tests.FUSED_CASES[0])


COMPOSED = [(c, T) for c in F2_CASES[:4] for T in (24,)] + [(F2_CASES[0],
                                                             100)]


@pytest.mark.parametrize("case,T", COMPOSED,
                         ids=[f"{c[0]}-T{T}" for c, T in COMPOSED])
def test_layer0_ordered_backward_is_the_two_layer_pairs_layer0(case, T):
    """Float32, H1 = H2 = 45: fed ``g_z = dz0 + g_cnt0`` and the pair's
    layer-0 residuals (``delta``, the stored ``z0 = delta >= 0``), the
    ordered layer-0 backward in the pair's plan gives the pair's ordered
    ``dcur0``, ``g_W0`` and ``g_W0r`` bit for bit."""
    args = _f2_args(case, T, 45, torch.float32)
    keep = {}
    pair = tf2._fused2_bwd_ordered_reference(*args, F2_ORDER, keep=keep)
    (_, _, _, _, d0, a0, _, _, lat, w0, w0r, b0, _, _, _, _, _, per, alpha,
     thr, gamma, _, spike) = args
    z0 = (d0 >= 0).to(torch.float32)
    order = {"groups_in": F2_ORDER["groups_in"],
             "rows_in": F2_ORDER["rows_in"],
             "groups_rec": F2_ORDER["groups_rec0"]}
    k0 = {}
    g_w0, g_w0r = tfused._layer0_bwd_ordered_reference(
        keep["dz0"], z0, d0, a0, False, lat, w0, w0r, b0, T, per, alpha,
        thr, gamma, spike, order, keep=k0)
    assert torch.equal(k0["dcur"], keep["dcur0"])
    assert torch.equal(g_w0, pair[0])
    assert (g_w0r is None) == (pair[1] is None)
    assert g_w0r is None or torch.equal(g_w0r, pair[1])
