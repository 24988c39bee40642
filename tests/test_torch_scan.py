"""The feedforward scan of the port on the CPU (``{alif,lif}_scan`` through
their plain PyTorch versions, forward and backward) against the JAX Pallas
kernels (ops/pallas_scan.py) in interpret mode, on identical numpy inputs.

Every case runs T = 23, 24 and 100: the JAX kernels take K = 1, 12 and 10
steps a grid step (the largest divisor of T up to 16), so one block, two
blocks and a prime T one step a block (a wrong z(t-1) at a block boundary
shows in all three).  Currents 0.3 + 0.6 N(0, 1), B = 5, H = 19 (odd, so
the JAX kernels pad both): 5-18 % of unit-steps fire.  Spikes must be
equal bit for bit, the residuals within 1e-5 (float32) or one bfloat16
rounding.  The backward fed the JAX kernel's own residuals holds ``g_i``
within 2e-6 of max|g| (float32) and 2**-7 (bfloat16).  Through the whole
call the residuals differ in the last bit: XLA on the CPU contracts
``alpha v + i``, ``rho a + z`` and ``threshold + beta a`` into fused
multiply-adds, the port rounds twice, as its kernels do (``--fmad=false``),
and the surrogate turns that into gradients apart by up to 7.6e-7 of
max|g| (FastSigmoid) and 1.1e-6 (ALIF with Phi, which divides by each
element's dynamic threshold) here.  The whole call holds them to the bars
of tests/test_torch_rec.py: FastSigmoid 1e-5 of max|g|, ALIF with Phi
2e-5, LIF with Phi 2e-6, bfloat16 2**-7 (2**-6 at T = 100: a delta a
float32 ulp apart can round to the other bfloat16 neighbour).  beta, a
tensor, gets a zero cotangent on both sides.

The CUDA kernels run only on the card: tests/test_torch_cuda.py and
``chip_smoke.py`` hold them against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_scan as jscan  # noqa: E402
from snnimageclassification_tpu.ops.cells import (  # noqa: E402
    ALIFConfig,
    LIFConfig,
)
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops import scan as tscan  # noqa: E402
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)

B, H, BETA = 5, 19, 1.6
CASES = [  # name, alif, surrogate
    ("alif-fs", True, "FastSigmoid"),
    ("alif-phi", True, "Phi"),
    ("lif-fs", False, "FastSigmoid"),
    ("lif-phi", False, "Phi"),
]
GRID = ([(c, T, "float32") for c in CASES for T in (23, 24, 100)]
        + [(CASES[0], 24, "bfloat16"), (CASES[1], 100, "bfloat16"),
           (CASES[2], 23, "bfloat16")])
IDS = [f"{c[0]}-T{T}-{td}" for c, T, td in GRID]


def _scalars(alif, spike_name):
    cfg = (ALIFConfig if alif else LIFConfig)(
        input_size=1, output_size=H, spike_func=JSpike[spike_name])
    return cfg.alpha, cfg.rho if alif else 0.0, cfg.threshold, cfg.gamma


def _data(T, seed=0):
    rng = np.random.default_rng(seed)
    cur = (0.3 + 0.6 * rng.standard_normal((T, B, H))).astype(np.float32)
    r = rng.standard_normal((T, B, H)).astype(np.float32)
    return cur, r


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, bar, label):
    scale = max(float(np.abs(want).max()), 1e-12)
    assert scale > 1e-9, f"{label}: no gradient"
    np.testing.assert_allclose(got / scale, want / scale, atol=bar, rtol=0,
                               err_msg=label)


@pytest.mark.parametrize("case,T,td", GRID, ids=IDS)
def test_scan_matches_jax(case, T, td):
    """The whole call: spikes, and the currents' (and a tensor beta's)
    gradients through ``jax.grad`` and ``torch.autograd``."""
    name, alif, spike_name = case
    alpha, rho, thr, gamma = _scalars(alif, spike_name)
    cur, r = _data(T)
    sf = JSpike[spike_name]

    def jfn(c, beta):
        if alif:
            return jscan.alif_scan(c, beta, alpha, rho, thr, gamma, sf, True,
                                   td)
        return jscan.lif_scan(c, alpha, thr, gamma, sf, True, td)

    def jloss(c, beta):
        return jnp.sum(jfn(c, beta).astype(jnp.float32) * r)

    jbeta = jnp.float32(BETA)
    jz = jfn(jnp.asarray(cur), jbeta)
    jg, jg_beta = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(cur), jbeta)

    tc = torch.from_numpy(cur).requires_grad_(True)
    beta = torch.tensor(BETA, requires_grad=True)
    tfused.reset_launch_counts()
    if alif:
        tz = tscan.alif_scan(tc, beta, alpha, rho, thr, gamma,
                             TSpike[spike_name], td)
    else:
        tz = tscan.lif_scan(tc, alpha, thr, gamma, TSpike[spike_name], td)
    (tz.to(torch.float32) * torch.from_numpy(r)).sum().backward()
    assert not any(tfused.launch_counts().values())  # no kernel on the CPU

    assert tz.dtype == getattr(torch, td)
    np.testing.assert_array_equal(_np(tz), _np(jz))
    assert 0.05 < float(_np(tz).mean()) < 0.3
    if td == "bfloat16":
        bar = 2.0 ** -7 * (2.0 if T > 24 else 1.0)
    else:
        bar = (1e-5 if spike_name == "FastSigmoid"
               else 2e-5 if alif else 2e-6)
    _close(_np(tc.grad), _np(jg), bar, f"{name} g_currents")
    if alif:
        assert float(jg_beta) == 0.0
        assert beta.grad is not None and float(beta.grad) == 0.0


@pytest.mark.parametrize("case,T,td", GRID, ids=IDS)
def test_scan_backward_on_the_same_residuals(case, T, td):
    """The JAX forward's residuals into both backwards; the port's plain
    training forward keeps the same residual set."""
    name, alif, spike_name = case
    alpha, rho, thr, gamma = _scalars(alif, spike_name)
    cur, r = _data(T, seed=1)
    sf = JSpike[spike_name]
    jc = jnp.asarray(cur)
    g_z = jnp.asarray(r).astype(td)
    if alif:
        outs = jscan._alif_scan_fwd_impl(jc, BETA, alpha, rho, thr, gamma,
                                         sf, True, td)
        (jg,) = jscan._alif_scan_bwd(alpha, rho, thr, gamma, sf, True, td,
                                     (*outs, BETA), g_z)[:1]
    else:
        outs = jscan._lif_scan_fwd_impl(jc, alpha, thr, gamma, sf, True, td)
        (jg,) = jscan._lif_scan_bwd(alpha, thr, gamma, sf, True, td, outs,
                                    g_z)
    jz, res = outs[0], outs[1:]

    tdt = getattr(torch, td)
    t_res = [torch.from_numpy(_np(x)).to(tdt) for x in res]
    res_is_v = tfused._residual_is_v(alif, TSpike[spike_name])
    a_tr = t_res[1] if len(t_res) == 2 else None
    z, p_res, p_a = tscan._fwd_reference(
        torch.from_numpy(cur), BETA, alif, alpha, rho, thr, True,
        a_tr is not None, res_is_v, tdt)
    np.testing.assert_array_equal(_np(z), _np(jz))
    tol = 1e-5 if td == "float32" else 2.0 ** -7
    for got, want in ((p_res, res[0]),
                      (p_a, res[1] if a_tr is not None else None)):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == tdt
            np.testing.assert_allclose(_np(got), _np(want), atol=tol,
                                       rtol=tol)
    g_i = tscan._bwd_reference(
        torch.from_numpy(_np(g_z)).to(tdt), torch.from_numpy(_np(jz)).to(tdt),
        t_res[0], a_tr, res_is_v, BETA, alpha, thr, gamma, TSpike[spike_name])
    assert g_i.dtype == torch.float32
    bar = 2e-6 if td == "float32" else 2.0 ** -7
    _close(_np(g_i), _np(jg), bar, f"{name} g_currents")


def test_scan_supported_and_inference_path():
    """Every shape on the CPU; no residual leaves under ``no_grad``; the
    ``*_reference`` entry points equal the wrappers on CPU tensors; the
    trace type takes a name or a dtype and refuses any other."""
    assert tscan.scan_supported(100, 4096, device="cpu", training=True)
    assert not tscan.scan_supported(0, 20, device="cpu")
    assert not tscan.scan_supported(24, 20, itemsize=8, device="cuda")
    cur, _ = _data(24, seed=2)
    tc = torch.from_numpy(cur)
    with torch.no_grad():
        z = tscan.alif_scan(tc, BETA, 0.9, 0.95, 1.0, 10.0)
    assert not z.requires_grad and z.dtype == torch.float32
    assert torch.equal(z, tscan.alif_scan_reference(tc, BETA, 0.9, 0.95,
                                                    1.0, 10.0))
    zb = tscan.lif_scan(tc, 0.9, 1.0, 10.0, trace_dtype=torch.bfloat16)
    assert zb.dtype == torch.bfloat16
    assert torch.equal(zb, tscan.lif_scan_reference(tc, 0.9, 1.0, 10.0,
                                                    trace_dtype="bfloat16"))
    with pytest.raises(ValueError, match="trace_dtype"):
        tscan.lif_scan(tc, 0.9, 1.0, 10.0, trace_dtype="float16")
