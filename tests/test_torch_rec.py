"""The recurrent scan of the port on the CPU (``rec_{alif,lif}_scan`` through
their plain PyTorch versions, forward and backward) against the JAX Pallas
kernels (ops/pallas_rec.py) in interpret mode, on identical numpy inputs.

Every case runs T = 24 and T = 100 (several time blocks of the JAX
kernels): currents 0.3 + 0.6 N(0, 1), a masked W_rec of std 0.05 (10-20 %
of unit-steps fire).  Spikes must be equal bit for bit, the residuals
within 1e-5 (float32) or one bfloat16 rounding.  The backward fed the
JAX kernel's own residuals holds ``g_i`` and ``g_W_rec`` within 2e-6 of
max|g| (float32) and 2**-7 (bfloat16).  Through the whole call the
residuals differ in the last bit: XLA on the CPU contracts ``alpha v + i``,
``rho a + z`` and ``threshold + beta a`` into fused multiply-adds, the port
rounds twice, as its kernels do (``--fmad=false``; with those three
emulated the deltas are equal bit for bit).  The FastSigmoid surrogate's
slope at the threshold (2 gamma) turns that into up to 7e-6 of max|g|
(JAX's own float32 gradients differ from its float64 ones by 4.4e-6 here),
and ALIF's Phi surrogate divides by each element's dynamic threshold, one
of the three: the whole call holds FastSigmoid to 1e-5 of max|g|, ALIF with
Phi to 2e-5 (the bar of tests/test_torch_mid.py), LIF with Phi to 2e-6,
and bfloat16 to 2**-7 (2**-6 at T = 100: a delta a float32 ulp apart can
round to the other bfloat16 neighbour).  beta's cotangent is zero.

The CUDA kernels run only on the card: tests/test_torch_cuda.py and
``chip_smoke.py`` hold them against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_rec as jrec  # noqa: E402
from snnimageclassification_tpu.ops.cells import (  # noqa: E402
    ALIFConfig,
    LIFConfig,
)
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    rec_scan as trec,
)
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)

B, H, BETA = 5, 20, 1.6
CASES = [  # name, alif, surrogate
    ("alif-fs", True, "FastSigmoid"),
    ("alif-phi", True, "Phi"),
    ("lif-fs", False, "FastSigmoid"),
    ("lif-phi", False, "Phi"),
]
GRID = ([(c, T, "float32") for c in CASES for T in (24, 100)]
        + [(CASES[0], 24, "bfloat16"), (CASES[3], 100, "bfloat16")])
IDS = [f"{c[0]}-T{T}-{wd}" for c, T, wd in GRID]


def _scalars(alif, spike_name):
    cfg = (ALIFConfig if alif else LIFConfig)(
        input_size=1, output_size=H, spike_func=JSpike[spike_name])
    return cfg.alpha, cfg.rho if alif else 0.0, cfg.threshold, cfg.gamma


def _data(T, seed=0):
    rng = np.random.default_rng(seed)
    cur = (0.3 + 0.6 * rng.standard_normal((T, B, H))).astype(np.float32)
    w = ((0.05 * rng.standard_normal((H, H))).astype(np.float32)
         * (1 - np.eye(H, dtype=np.float32)))
    r = rng.standard_normal((T, B, H)).astype(np.float32)
    return cur, w, r


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, bar, label):
    scale = max(float(np.abs(want).max()), 1e-12)
    assert scale > 1e-9, f"{label}: no gradient"
    np.testing.assert_allclose(got / scale, want / scale, atol=bar, rtol=0,
                               err_msg=label)


def _jax_scan(alif, spike_name, alpha, rho, thr, gamma):
    sf = JSpike[spike_name]
    if alif:
        return lambda c, w: jrec.rec_alif_scan(c, w, BETA, alpha, rho, thr,
                                               gamma, sf, True)
    return lambda c, w: jrec.rec_lif_scan(c, w, alpha, thr, gamma, sf, True)


def _torch_scan(alif, spike_name, alpha, rho, thr, gamma, beta=BETA):
    sf = TSpike[spike_name]
    if alif:
        return lambda c, w: trec.rec_alif_scan(c, w, beta, alpha, rho, thr,
                                               gamma, sf)
    return lambda c, w: trec.rec_lif_scan(c, w, alpha, thr, gamma, sf)


@pytest.mark.parametrize("case,T,wd", GRID, ids=IDS)
def test_rec_scan_matches_jax(case, T, wd):
    name, alif, spike_name = case
    alpha, rho, thr, gamma = _scalars(alif, spike_name)
    cur, w, r = _data(T)
    jw = jnp.asarray(w).astype(wd)
    jscan = _jax_scan(alif, spike_name, alpha, rho, thr, gamma)

    def jloss(c, w_):
        return jnp.sum(jscan(c, w_).astype(jnp.float32) * r)

    jz = jscan(jnp.asarray(cur), jw)
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(cur), jw)

    tc = torch.from_numpy(cur).requires_grad_(True)
    tw = torch.from_numpy(w).to(getattr(torch, wd)).requires_grad_(True)
    beta = torch.tensor(BETA, requires_grad=True)
    tfused.reset_launch_counts()
    tz = _torch_scan(alif, spike_name, alpha, rho, thr, gamma,
                     beta=beta)(tc, tw)
    (tz.to(torch.float32) * torch.from_numpy(r)).sum().backward()
    assert not any(tfused.launch_counts().values())  # no kernel on the CPU

    assert tz.dtype == getattr(torch, wd)
    np.testing.assert_array_equal(_np(tz), _np(jz))
    assert 0.05 < float(_np(tz).mean()) < 0.3
    if wd == "bfloat16":
        bar = 2.0 ** -7 * (2.0 if T > 24 else 1.0)
    else:
        bar = (1e-5 if spike_name == "FastSigmoid"
               else 2e-5 if alif else 2e-6)
    _close(_np(tc.grad), _np(jg[0]), bar, f"{name} g_currents")
    _close(_np(tw.grad), _np(jg[1]), bar, f"{name} g_w_rec")
    assert tw.grad.dtype == tw.dtype
    if alif:
        assert beta.grad is not None and float(beta.grad) == 0.0


@pytest.mark.parametrize("case,T,wd", GRID, ids=IDS)
def test_rec_backward_on_the_same_residuals(case, T, wd):
    """The JAX forward's residuals into both backwards: the chain alone."""
    name, alif, spike_name = case
    alpha, rho, thr, gamma = _scalars(alif, spike_name)
    cur, w, r = _data(T, seed=1)
    jw = jnp.asarray(w).astype(wd)
    store_delta = jrec._use_delta_residual(JSpike[spike_name]) and alif
    outs = jrec._rec_fwd_call(
        jnp.asarray(cur), jw, BETA if alif else 0.0, alif=alif, alpha=alpha,
        rho=rho, threshold=thr, interpret=True, store_delta=store_delta)
    jz, res = outs[0], outs[1:]
    g_z = jnp.asarray(r).astype(wd)
    jg = jrec._rec_bwd_call(
        g_z, tuple(res), jz, jw, BETA if alif else 0.0, alif=alif,
        alpha=alpha, rho=rho, threshold=thr, gamma=gamma,
        spike_func=JSpike[spike_name], interpret=True,
        store_delta=store_delta)

    tdt = getattr(torch, wd)
    tw = torch.from_numpy(w).to(tdt)
    t_res = [torch.from_numpy(_np(x)).to(tdt) for x in res]
    res_is_v = tfused._residual_is_v(alif, TSpike[spike_name])
    a_tr = t_res[1] if len(t_res) == 2 else None
    # The port's plain forward keeps the same residual set, equal spikes
    # and residuals within 1e-5 (one bfloat16 rounding).
    z, p_res, p_a = trec._fwd_reference(
        torch.from_numpy(cur), tw, BETA, alif, alpha, rho, thr, True,
        a_tr is not None, res_is_v)
    np.testing.assert_array_equal(_np(z), _np(jz))
    tol = 1e-5 if wd == "float32" else 2.0 ** -7
    for got, want in ((p_res, res[0]), (p_a, res[1] if a_tr is not None
                                        else None)):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(_np(got), _np(want), atol=tol,
                                       rtol=tol)
    g_i, g_w = trec._bwd_reference(
        torch.from_numpy(_np(g_z)).to(tdt), torch.from_numpy(_np(jz)).to(tdt),
        t_res[0], a_tr, res_is_v, tw, BETA, alpha, thr, gamma,
        TSpike[spike_name])
    assert g_i.dtype == torch.float32 and g_w.dtype == tdt
    bar = 2e-6 if wd == "float32" else 2.0 ** -7
    _close(_np(g_i), _np(jg[0]), bar, f"{name} g_currents")
    _close(_np(g_w), _np(jg[1]), bar, f"{name} g_w_rec")


def test_rec_scan_supported_and_inference_path():
    """Every shape on the CPU; no residual leaves under ``no_grad``; the
    ``*_reference`` entry points equal the wrappers on CPU tensors."""
    assert trec.rec_scan_supported(100, 4096, device="cpu", training=True)
    assert not trec.rec_scan_supported(0, 20, device="cpu")
    cur, w, _ = _data(24, seed=2)
    tc, tw = torch.from_numpy(cur), torch.from_numpy(w)
    with torch.no_grad():
        z = trec.rec_alif_scan(tc, tw, BETA, 0.9, 0.95, 1.0, 10.0)
    assert not z.requires_grad
    assert torch.equal(z, trec.rec_alif_scan_reference(tc, tw, BETA, 0.9,
                                                       0.95, 1.0, 10.0))
    assert torch.equal(trec.rec_lif_scan(tc, tw, 0.9, 1.0, 10.0),
                       trec.rec_lif_scan_reference(tc, tw, 0.9, 1.0, 10.0))
