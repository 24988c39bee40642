"""The deep-network calls of the port on the CPU (their plain PyTorch
versions, forward and backward) against the JAX Pallas kernels in interpret
mode, on identical numpy inputs:

* ``fused_encode_{rec,ff}_scan`` (layer 0, spikes out);
* ``fused_mid_{rec,ff}_scan`` (a layer past the first);
* ``fused_mid_{rec,ff}_scan_head[_counts]`` (last hidden layer + readout).

Every case runs T = 24 and T = 100 (several time blocks of the JAX kernels)
with float32 and bfloat16 weights.  Spikes, ``tstar`` and counts must be
equal; logits within 1e-5; residuals within 1e-5 (float32) or one bfloat16
rounding.  Gradients of ``sum(out * r)`` for a fixed random ``r``, each
scaled by its max: float32 within 2e-6 (2e-5 for ALIF with Phi, whose
per-element denominators amplify reduction-order noise; the JAX suite's own
bars, set at T <= 24), bfloat16 within 2**-7; the cotangent of beta is
zero.  At T = 100 the chain is four times as long: ALIF with Phi reaches
2.7e-5 and one bfloat16 element in 400 reaches 1.16 * 2**-7 (a ``dcur``
that differs by float32 noise rounds to the other bfloat16 neighbour, and
the result is rounded once more), so those two bars are doubled there.

The CUDA kernels run only on the card: tests/test_torch_cuda.py and
``chip_smoke.py`` hold them against the plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_fused as jfused  # noqa: E402
from snnimageclassification_tpu.ops import (  # noqa: E402
    pallas_fused_mid as jmid,
)
from snnimageclassification_tpu.ops.cells import (  # noqa: E402
    ALIFConfig,
    LIFConfig,
    ReadoutConfig,
)
from snnimageclassification_tpu.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused_mid as tmid,
)
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)

B, F, HIN, H, O = 5, 30, 24, 20, 7
KAPPA = ReadoutConfig(input_size=H, output_size=O).kappa

CASES = [  # name, alif, recurrent, surrogate
    ("alif-rec-fs", True, True, "FastSigmoid"),
    ("alif-ff-phi", True, False, "Phi"),
    ("alif-rec-phi", True, True, "Phi"),
    ("lif-rec-phi", False, True, "Phi"),
    ("lif-ff-fs", False, False, "FastSigmoid"),
]
GRID = [(c, T, wd) for c in CASES for T in (24, 100)
        for wd in ("float32", "bfloat16")]
IDS = [f"{c[0]}-T{T}-{wd}" for c, T, wd in GRID]


def _scalars(alif, spike_name):
    cfg = (ALIFConfig if alif else LIFConfig)(
        input_size=HIN, output_size=H, spike_func=JSpike[spike_name])
    return alif, cfg.alpha, cfg.rho if alif else 0.0, cfg.threshold, cfg.gamma


def _weights(rng, n_in, rec):
    return dict(
        w_in=(0.5 * rng.standard_normal((n_in, H))).astype(np.float32),
        w_rec=((0.3 * rng.standard_normal((H, H))).astype(np.float32)
               * (1 - np.eye(H, dtype=np.float32))) if rec else None,
        w_out=rng.standard_normal((H, O)).astype(np.float32),
        b_out=(0.1 * rng.standard_normal((O,))).astype(np.float32),
    )


def _j(x, wd):
    return None if x is None else jnp.asarray(x).astype(wd)


def _t(x, wd, grad=False):
    if x is None:
        return None
    return torch.from_numpy(x).to(getattr(torch, wd)).requires_grad_(grad)


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_grads(got, want, spike_name, alif, wd, label, T):
    long = 2.0 if T > 24 else 1.0
    bar = (2.0 ** -7 * long if wd == "bfloat16"
           else 2e-5 * long if spike_name == "Phi" and alif else 2e-6)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[k] / scale, w / scale, atol=bar,
                                   rtol=0, err_msg=f"{label} {k}")


def _close_trace(got, want, wd, label):
    """A residual trace: float32 to 1e-5, bfloat16 to one rounding."""
    tol = 1e-5 if wd == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=label)


# ---------------------------------------------------------------------------
# Layer 0: fused_encode_{rec,ff}_scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("case,T,wd", GRID, ids=IDS)
def test_layer0_matches_the_jax_kernel(case, T, wd, use_periods):
    name, alif, rec, spike_name = case
    rng = np.random.default_rng(11)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(
        jnp.asarray(pixels), t_max=float(T), tau=20.0))
    w = _weights(rng, F, rec)
    r = rng.standard_normal((T, B, H)).astype(np.float32)
    alif, alpha, rho, thr, gamma = _scalars(alif, spike_name)
    beta = 1.6 if alif else 0.0
    tail = (T, use_periods, alif, alpha, rho, thr, gamma)

    def jloss(leaves, beta):
        args = ((leaves["w_in"], leaves["w_rec"]) if rec
                else (leaves["w_in"],))
        fn = (jfused.fused_encode_rec_scan if rec
              else jfused.fused_encode_ff_scan)
        z = fn(jnp.asarray(lat), *args, beta, *tail, JSpike[spike_name],
               True)  # interpret mode
        return jnp.sum(z.astype(jnp.float32) * r), z

    jleaves = {k: _j(w[k], wd) for k in ("w_in", "w_rec") if w[k] is not None}
    (_, jz), (jg, jg_beta) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jleaves, jnp.float32(beta))

    tleaves = {k: _t(w[k], wd, True) for k in jleaves}
    tbeta = torch.tensor(beta, requires_grad=True)
    targs = ((tleaves["w_in"], tleaves["w_rec"]) if rec
             else (tleaves["w_in"],))
    fn = tfused.fused_encode_rec_scan if rec else tfused.fused_encode_ff_scan
    tz = fn(torch.from_numpy(lat), *targs, tbeta, *tail, TSpike[spike_name])
    assert tz.dtype == getattr(torch, wd) and tuple(tz.shape) == (T, B, H)
    np.testing.assert_array_equal(_np(tz), _np(jz))
    (tz.to(torch.float32) * torch.from_numpy(r)).sum().backward()
    _close_grads({k: _np(v.grad) for k, v in tleaves.items()},
                 {k: _np(v) for k, v in jg.items()}, spike_name, alif, wd,
                 name, T)
    assert float(tbeta.grad) == 0.0 and float(jg_beta) == 0.0
    # Inference writes the same spikes and keeps no residual.
    with torch.no_grad():
        np.testing.assert_array_equal(
            _np(fn(torch.from_numpy(lat), *targs, tbeta, *tail,
                   TSpike[spike_name])), _np(jz))


# ---------------------------------------------------------------------------
# Mid layers and the mid head
# ---------------------------------------------------------------------------
def _mid_inputs(T, rec, seed=12):
    rng = np.random.default_rng(seed)
    z_in = (rng.random((T, B, HIN)) < 0.3).astype(np.float32)
    return rng, z_in, _weights(rng, HIN, rec)


def _mid_grads(kind, case, T, wd):
    """Outputs and gradients of one mid call, (jax, torch), as numpy."""
    name, alif, rec, spike_name = case
    rng, z_in, w = _mid_inputs(T, rec)
    alif, alpha, rho, thr, gamma = _scalars(alif, spike_name)
    beta = 1.6 if alif else 0.0
    head = kind != "mid"
    r = (rng.standard_normal((B, O)) if head
         else rng.standard_normal((T, B, H))).astype(np.float32)
    q = (0.05 * rng.standard_normal((B, H))).astype(np.float32)
    names = [k for k in ("w_in", "w_rec") + (("w_out", "b_out") if head
                                             else ()) if w[k] is not None]
    jfn = {("mid", True): jmid.fused_mid_rec_scan,
           ("mid", False): jmid.fused_mid_ff_scan,
           ("head", True): jmid.fused_mid_rec_scan_head,
           ("head", False): jmid.fused_mid_ff_scan_head,
           ("counts", True): jmid.fused_mid_rec_scan_head_counts,
           ("counts", False): jmid.fused_mid_ff_scan_head_counts}[kind, rec]
    tfn = getattr(tmid, jfn.__name__)
    tail = ((T, alif, alpha, rho, thr, gamma, KAPPA) if head
            else (T, alif, alpha, rho, thr, gamma))

    def order(leaves, beta):
        a = [leaves["z_in"], leaves["w_in"]]
        if rec:
            a.append(leaves["w_rec"])
        a.append(beta)
        if head:
            a += [leaves["w_out"], leaves["b_out"]]
        return a

    def jloss(leaves, beta):
        out = jfn(*order(leaves, beta), *tail, JSpike[spike_name], True)
        if kind == "counts":
            return jnp.sum(out[0] * r) + jnp.sum(out[1] * q), out
        return jnp.sum(out.astype(jnp.float32) * r), out

    jleaves = {k: _j(w[k], "float32" if k == "b_out" else wd) for k in names}
    jleaves["z_in"] = _j(z_in, wd)
    (_, jout), (jg, jg_beta) = jax.value_and_grad(
        jloss, (0, 1), has_aux=True)(jleaves, jnp.float32(beta))

    tleaves = {k: _t(w[k], "float32" if k == "b_out" else wd, True)
               for k in names}
    tleaves["z_in"] = _t(z_in, wd, True)
    tbeta = torch.tensor(beta, requires_grad=True)
    tout = tfn(*order(tleaves, tbeta), *tail, TSpike[spike_name])
    if kind == "counts":
        loss = ((tout[0] * torch.from_numpy(r)).sum()
                + (tout[1] * torch.from_numpy(q)).sum())
    else:
        loss = (tout.to(torch.float32) * torch.from_numpy(r)).sum()
    loss.backward()
    assert float(tbeta.grad) == 0.0 and float(jg_beta) == 0.0
    for k, v in tleaves.items():
        assert v.grad.dtype == v.dtype and v.grad.shape == v.shape, k
    return (jout, {k: _np(v) for k, v in jg.items()},
            tout, {k: _np(v.grad) for k, v in tleaves.items()})



def check_mid_gradients(case, T, wd, kind):
    """The body of the split files' ``test_mid_gradients_match_the_jax_kernel``
    (tests/test_torch_mid_grads.py, tests/test_torch_mid_head_grads.py):
    the outputs (z bit for bit; logits within 1e-5, counts equal) and the
    gradients at the bars of :func:`_close_grads`."""
    name, alif, _, spike_name = case
    jout, jg, tout, tg = _mid_grads(kind, case, T, wd)
    if kind == "mid":
        np.testing.assert_array_equal(_np(tout), _np(jout))
    else:
        jl, tl = (jout[0], tout[0]) if kind == "counts" else (jout, tout)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-5, rtol=1e-5)
        if kind == "counts":
            np.testing.assert_array_equal(_np(tout[1]), _np(jout[1]))
    _close_grads(tg, jg, spike_name, alif, wd, f"{name} {kind}", T)

def test_mid_inference_takes_no_autograd_path():
    """Without a gradient to compute the wrappers call the plain forward
    directly (no residual kept), under ``no_grad`` and for leaves that do
    not require one; the logits are the training forward's bits."""
    _, z_in, w = _mid_inputs(24, True)
    alif, alpha, rho, thr, gamma = _scalars(True, "FastSigmoid")
    args = (_t(z_in, "float32"), _t(w["w_in"], "float32"),
            _t(w["w_rec"], "float32"), 1.6, _t(w["w_out"], "float32"),
            _t(w["b_out"], "float32"), 24, alif, alpha, rho, thr, gamma,
            KAPPA)
    plain = tmid.fused_mid_rec_scan_head(*args)
    assert plain.grad_fn is None
    leaves = list(args)
    leaves[1] = leaves[1].clone().requires_grad_(True)
    train = tmid.fused_mid_rec_scan_head(*leaves)
    assert train.grad_fn is not None
    assert torch.equal(plain, train.detach())
    with torch.no_grad():
        logits, counts = tmid.fused_mid_rec_scan_head_counts(*leaves)
    assert logits.grad_fn is None and torch.equal(logits, plain)
    assert counts.shape == (B, H) and float(counts.sum()) > 0
    ref = tmid.fused_mid_rec_scan_head_reference(*args)
    assert torch.equal(ref, plain)


@pytest.mark.parametrize("device", ["cpu"])
def test_supported_gates_on_the_cpu(device):
    """The plain versions cover every positive shape; nonsense shapes are
    refused before any device is asked."""
    assert tmid.fused_mid_supported(24, 4096, 8, device=device)
    assert tmid.fused_mid_head_supported(24, 30, 20, 10, device=device,
                                         training=True)
    assert tfused.fused_supported(24, 784, 128, device=device, training=True)
    assert not tmid.fused_mid_supported(0, 30, 20, device=device)
    assert not tmid.fused_mid_head_supported(24, 30, 20, 0, device=device)
    assert not tfused.fused_supported(24, 0, 20, device=device)
