"""The recurrent scan's plain versions in the tensor-core cluster body's
summation order (``ops/rec_scan.py``: ``_fwd_ordered_reference``,
``_chain_ordered_reference``) on the CPU, against the JAX Pallas kernels
(ops/pallas_rec.py) in interpret mode and against the order-free plain
versions (``_fwd_reference``, ``_bwd_reference``), on identical numpy
inputs from a seed.

Cases: B = 5, H = 20 and 40, T = 24 and 100, LIF/ALIF x FastSigmoid/Phi,
float32 and bfloat16 (each case with both T and both types; H = 20 and 40
each with both T and both types).  Currents 0.3 + 0.6 N(0, 1), a masked
W_rec of std 0.05 (10-20 % of unit-steps fire).  The bars are those of
tests/test_torch_rec.py: spikes equal bit for bit, residuals within 1e-5
(float32) or one bfloat16 rounding; the chain on the JAX forward's own
residuals within 2e-6 of max|g| (float32) and 2**-7 (bfloat16), with the
tensor-core products rounded to nearest and as ``_mma_slice`` models the
card (``card=True``).

The CUDA body runs only on the card: tests/test_torch_cuda.py and
``chip_smoke.py`` hold its bits against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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

B, BETA = 5, 1.6
CASES = [  # name, alif, surrogate
    ("alif-fs", True, "FastSigmoid"),
    ("alif-phi", True, "Phi"),
    ("lif-fs", False, "FastSigmoid"),
    ("lif-phi", False, "Phi"),
]
# Every case at both T in both types; H = 20 and 40 each meet both T and
# both types.
GRID = [(c, T, wd, (20 if (T == 24) == (wd == "float32") else 40))
        for c in CASES for T in (24, 100) for wd in ("float32", "bfloat16")]
IDS = [f"{c[0]}-T{T}-{wd}-H{H}" for c, T, wd, H in GRID]


def _scalars(alif, spike_name, H):
    cfg = (ALIFConfig if alif else LIFConfig)(
        input_size=1, output_size=H, spike_func=JSpike[spike_name])
    return cfg.alpha, cfg.rho if alif else 0.0, cfg.threshold, cfg.gamma


def _data(T, H, seed):
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


@pytest.mark.parametrize("case,T,wd,H", GRID, ids=IDS)
def test_ordered_versions_match_jax_and_the_plain_versions(case, T, wd, H):
    name, alif, spike_name = case
    alpha, rho, thr, gamma = _scalars(alif, spike_name, H)
    cur, w, r = _data(T, H, seed=T + H)
    jw = jnp.asarray(w).astype(wd)
    store_delta = jrec._use_delta_residual(JSpike[spike_name]) and alif
    outs = jrec._rec_fwd_call(
        jnp.asarray(cur), jw, BETA if alif else 0.0, alif=alif, alpha=alpha,
        rho=rho, threshold=thr, interpret=True, store_delta=store_delta)
    jz, jres = outs[0], outs[1:]

    # The forward in the body's order: spikes bit for bit the JAX kernel's
    # and the order-free plain version's, residuals within the bars.
    tdt = getattr(torch, wd)
    tw = torch.from_numpy(w).to(tdt)
    res_is_v = tfused._residual_is_v(alif, TSpike[spike_name])
    store_a = tfused._stores_a(alif, TSpike[spike_name])
    fwd = (torch.from_numpy(cur), tw, BETA, alif, alpha, rho, thr, True,
           store_a, res_is_v)
    z, res, a_tr = trec._fwd_ordered_reference(*fwd)
    zp, resp, ap = trec._fwd_reference(*fwd)
    assert z.dtype == tdt and res.dtype == tdt
    assert 0.05 < float(_np(z).mean()) < 0.3
    np.testing.assert_array_equal(_np(z), _np(jz))
    assert torch.equal(z, zp)
    tol = 1e-5 if wd == "float32" else 2.0 ** -7
    want_a = jres[1] if len(jres) == 2 else None
    for got, jax_want, plain in ((res, jres[0], resp), (a_tr, want_a, ap)):
        assert (got is None) == (jax_want is None) == (plain is None)
        if got is not None:
            np.testing.assert_allclose(_np(got), _np(jax_want), atol=tol,
                                       rtol=tol)
            np.testing.assert_allclose(_np(got), _np(plain), atol=tol,
                                       rtol=tol)
    # The ordered inference forward fires the training forward's spikes.
    z_inf = trec._fwd_ordered_reference(*fwd[:7], False, False, False)[0]
    assert torch.equal(z_inf, z)

    # The chain in the body's order on the JAX forward's residuals.
    g_z = jnp.asarray(r).astype(wd)
    jg = jrec._rec_bwd_call(
        g_z, tuple(jres), jz, jw, BETA if alif else 0.0, alif=alif,
        alpha=alpha, rho=rho, threshold=thr, gamma=gamma,
        spike_func=JSpike[spike_name], interpret=True,
        store_delta=store_delta)
    t_res = [torch.from_numpy(_np(x)).to(tdt) for x in jres]
    bw = (torch.from_numpy(_np(g_z)).to(tdt),
          torch.from_numpy(_np(jz)).to(tdt), t_res[0],
          t_res[1] if len(t_res) == 2 else None, res_is_v, tw,
          BETA, alpha, thr, gamma, TSpike[spike_name])
    plain = _np(trec._bwd_reference(*bw)[0])
    bar = 2e-6 if wd == "float32" else 2.0 ** -7
    for card in (False, True):
        g_i = trec._chain_ordered_reference(*bw, card=card)
        assert g_i.dtype == torch.float32 and g_i.shape == (T, B, H)
        label = f"{name} g_i card={card}"
        _close(_np(g_i), _np(jg[0]), bar, f"{label} vs JAX")
        _close(_np(g_i), plain, bar, f"{label} vs the plain version")


@pytest.mark.parametrize("T", [24, 100])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cuda_core_chain_ordered_version(case, T):
    """``_rec_chain_ordered_reference`` (the float32 CUDA-core chain's
    order: one fused multiply-add a term, ascending j) on the residuals of
    the forward in the cluster body's order (the card's bits), at the card
    tests' inputs (``_rec_check``: B = 37, currents 0.3 + 0.6 N(0, 1),
    W_rec of std 1.3 / sqrt(H), seed 13), H = 20 (and H = 40 for LIF with
    Phi at T = 100, the card case this chain once missed its bar on):
    within float32 noise of ``_bwd_reference`` (2e-6 of max|g|, 5e-6 at T
    = 100), and against the float64 chain at most twice as far as the
    order-free plain version, which itself sits within that bar of it."""
    from snnimageclassification_tpu_torch.tools.chain_conditioning import (
        chain,
        share,
    )

    name, alif, spike_name = case
    spike = TSpike[spike_name]
    bar = 2e-6 if T < 100 else 5e-6
    for H in (20, 40) if (name, T) == ("lif-phi", 100) else (20,):
        alpha, rho, thr, gamma = _scalars(alif, spike_name, H)
        beta = BETA if alif else 0.0
        rng = np.random.default_rng(13)
        cur = torch.from_numpy(
            (0.3 + 0.6 * rng.standard_normal((T, 37, H))).astype(np.float32))
        w = (torch.from_numpy((1.3 / np.sqrt(H) * rng.standard_normal(
            (H, H))).astype(np.float32)) * (1 - torch.eye(H)))
        res_is_v = tfused._residual_is_v(alif, spike)
        z, res, a_tr = trec._fwd_ordered_reference(
            cur, w, beta, alif, alpha, rho, thr, True,
            tfused._stores_a(alif, spike), res_is_v)
        g_z = torch.from_numpy(
            rng.standard_normal((T, 37, H)).astype(np.float32))
        bw = (g_z, z, res, a_tr, res_is_v, w, beta, alpha, thr, gamma,
              spike)
        g_i = trec._rec_chain_ordered_reference(*bw)
        plain = trec._bwd_reference(*bw)[0]
        assert g_i.dtype == torch.float32 and g_i.shape == (T, 37, H)
        assert share(g_i, plain) <= bar, f"{name} H={H} vs plain"
        w64 = w.double()
        exact = chain(bw, lambda d: d @ w64.T, torch.float64)
        plain_err = share(plain, exact)
        assert plain_err <= bar, f"{name} H={H}: plain vs float64"
        assert share(g_i, exact) <= 2 * plain_err, f"{name} H={H}"
