"""The Izhikevich calls of the port on the CPU (their plain PyTorch versions,
forward and backward) against the JAX Pallas kernels in interpret mode, on
identical numpy inputs:

* ``izh_scan`` (a layer's scan over precomputed currents);
* ``fused_encode_izh_scan`` (encode + input product + scan, spikes out);
* ``fused_encode_izh_scan_head[_counts]`` (the whole network).

Inputs are the JAX suite's (tests/test_pallas_izh.py,
tests/test_pallas_fused.py): currents 3e6 + 1e6 N(0, 1), ``W_in`` 3e6
N(0, 1), ``W_rec`` 5e5 N(0, 1) with its diagonal masked, default constants
(dt = 1e-3, C = 100), where units fire; every case asserts that some do.
Every case runs T = 24 or T = 100 (several time blocks of the JAX kernels).

Tolerances.  The JAX reference's own rounding of ``dt * dvdt / C`` is not
one formula: eager JAX and PyTorch divide, jitted XLA (and interpret mode,
whose kernel body is jitted) multiplies by a folded ``dt / C``, so the
membrane traces differ in the last bit on about half of the elements
(measured: max 7.6e-6 at |v| <= 94).  Hence: spikes, ``tstar`` and counts
equal; ``v`` within 1e-6 relative (atol 1e-4 mV); logits 1e-5; gradients of
the whole call within 1e-4 of max|g| (a last-bit difference of v feeds the
surrogate and the dv factor ``1 + dt k/C (2 v - v_rest - v_th)``; measured
<= 1.9e-5); the backward alone, fed the JAX forward's own residuals, within
2e-6 of max|g| float32 (measured <= 4.7e-7) and 2**-7 bfloat16 (one rounding
of ``gi`` before each product, then one of the result).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_fused_izh as jfi  # noqa: E402
from snnimageclassification_tpu.ops import pallas_izh as jizh  # noqa: E402
from snnimageclassification_tpu.ops.cells import (  # noqa: E402
    IzhikevichConfig,
    ReadoutConfig,
)
from snnimageclassification_tpu.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops import fused_izh as tfi  # noqa: E402
from snnimageclassification_tpu_torch.ops import izh as tizh  # noqa: E402
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)

B, F, H, O = 5, 30, 20, 7
CFG = IzhikevichConfig(input_size=F, output_size=H)
KP = jizh.izh_kernel_params(CFG)
KAPPA = ReadoutConfig(input_size=H, output_size=O).kappa
GRAD_BAR = 1e-4      # whole call against whole call
SAME_RES_BAR = 2e-6  # the backward alone on the same residuals, float32


def _np(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, bar, label):
    """Each gradient scaled by its max |want|."""
    assert set(got) == set(want), label
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, f"{label} {k}: no gradient"
        np.testing.assert_allclose(got[k] / scale, w / scale, atol=bar,
                                   rtol=0, err_msg=f"{label} {k}")


def _close_v(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-4)


def _weights(rng, rec):
    return dict(
        w_in=(3e6 * rng.standard_normal((F, H))).astype(np.float32),
        w_rec=((5e5 * rng.standard_normal((H, H))).astype(np.float32)
               * (1 - np.eye(H, dtype=np.float32))) if rec else None,
        w_out=rng.standard_normal((H, O)).astype(np.float32),
        b_out=(0.1 * rng.standard_normal((O,))).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# izh_scan
# ---------------------------------------------------------------------------
SCAN_CASES = [  # name, recurrent, T, W_rec dtype, surrogate
    ("rec-fs", True, 24, "float32", "FastSigmoid"),
    ("ff-phi", False, 24, "float32", "Phi"),
    ("rec-phi", True, 100, "float32", "Phi"),
    ("rec-fs-bf16", True, 100, "bfloat16", "FastSigmoid"),
]


@pytest.mark.parametrize("name,rec,T,wd,spike", SCAN_CASES,
                         ids=[c[0] for c in SCAN_CASES])
def test_izh_scan_matches_the_jax_kernel(name, rec, T, wd, spike):
    rng = np.random.default_rng(0)
    cur = (3e6 + 1e6 * rng.standard_normal((T, B, H))).astype(np.float32)
    w = _weights(rng, rec)["w_rec"]
    r = rng.standard_normal((T, B, H)).astype(np.float32)
    jw = None if w is None else jnp.asarray(w).astype(wd)

    def jloss(c, w_rec):
        z = jizh.izh_scan(c, w_rec, KP, CFG.gamma, JSpike[spike], True)
        return jnp.sum(z * r), z

    argnums = (0, 1) if rec else (0,)
    (_, jz), jg = jax.value_and_grad(jloss, argnums, has_aux=True)(
        jnp.asarray(cur), jw)
    tc = torch.from_numpy(cur).requires_grad_(True)
    tw = (None if w is None
          else torch.from_numpy(w).to(getattr(torch, wd)).requires_grad_(True))
    tz = tizh.izh_scan(tc, tw, tizh.izh_kernel_params(CFG), CFG.gamma,
                       TSpike[spike])
    assert tz.dtype == torch.float32 and tuple(tz.shape) == (T, B, H)
    np.testing.assert_array_equal(_np(tz), _np(jz))
    assert 0 < float(tz.detach().mean()) < 1
    (tz * torch.from_numpy(r)).sum().backward()
    got = {"currents": _np(tc.grad)}
    want = {"currents": _np(jg[0])}
    if rec:
        assert tw.grad.dtype == tw.dtype
        got["w_rec"], want["w_rec"] = _np(tw.grad), _np(jg[1])
    _close(got, want, GRAD_BAR, name)

    # The forward's residuals, and the backward alone on JAX's residuals.
    jzz, jv = jizh._fwd_call(jnp.asarray(cur), jw, dict(KP), True)
    tzz, tv = tizh._scan_reference(torch.from_numpy(cur), tw, KP, True)
    np.testing.assert_array_equal(_np(tzz), _np(jzz))
    _close_v(tv, jv)
    jgi, jgw = jizh._bwd_call(jnp.asarray(r), jv, jzz, jw, dict(KP),
                              CFG.gamma, JSpike[spike], True)
    tgi, tgw = tizh._scan_bwd_reference(
        torch.from_numpy(r), torch.from_numpy(_np(jzz)),
        torch.from_numpy(_np(jv)), None if tw is None else tw.detach(), KP,
        CFG.gamma, TSpike[spike])
    got, want = {"g_i": _np(tgi)}, {"g_i": _np(jgi)}
    if rec:
        got["w_rec"], want["w_rec"] = _np(tgw), _np(jgw)
    # g_i is never rounded; the recurrent product and g_W_rec round gi to
    # bfloat16 under bfloat16 weights.
    _close(got, want, SAME_RES_BAR if wd == "float32" else 2.0 ** -7, name)


def test_izh_scan_inference_takes_no_autograd_path():
    rng = np.random.default_rng(1)
    cur = torch.from_numpy(
        (3e6 + 1e6 * rng.standard_normal((24, B, H))).astype(np.float32))
    w = torch.from_numpy(_weights(rng, True)["w_rec"])
    kp = tizh.izh_kernel_params(CFG)
    tfused.reset_launch_counts()
    plain = tizh.izh_scan(cur, w, kp, CFG.gamma)
    assert plain.grad_fn is None
    train = tizh.izh_scan(cur, w.clone().requires_grad_(True), kp, CFG.gamma)
    assert train.grad_fn is not None and torch.equal(plain, train.detach())
    assert torch.equal(tizh.izh_scan_reference(cur, w, kp, CFG.gamma), plain)
    assert not any(tfused.launch_counts().values())  # no kernel on the CPU


# ---------------------------------------------------------------------------
# fused_encode_izh_scan[_head[_counts]]
# ---------------------------------------------------------------------------
FUSED_CASES = [  # name, recurrent, use_periods, T, weights' dtype, surrogate
    ("rec-ttfs-fs", True, False, 24, "float32", "FastSigmoid"),
    ("ff-periodic-phi", False, True, 24, "float32", "Phi"),
    ("rec-periodic-fs", True, True, 100, "float32", "FastSigmoid"),
    ("rec-periodic-phi-bf16", True, True, 24, "bfloat16", "Phi"),
]
FUSED_IDS = [c[0] for c in FUSED_CASES]


def _fused_inputs(T, rec, seed=7):
    rng = np.random.default_rng(seed)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(jnp.asarray(pixels),
                                            t_max=float(T), tau=20.0))
    return rng, lat, _weights(rng, rec)


@pytest.mark.parametrize("name,rec,per,T,wd,spike", FUSED_CASES,
                         ids=FUSED_IDS)
def test_fused_layer0_matches_the_jax_kernel(name, rec, per, T, wd, spike):
    rng, lat, w = _fused_inputs(T, rec)
    r = rng.standard_normal((T, B, H)).astype(np.float32)
    names = ["w_in"] + (["w_rec"] if rec else [])

    def jloss(leaves):
        z = jfi.fused_encode_izh_scan(
            jnp.asarray(lat), leaves["w_in"], leaves.get("w_rec"), KP, T,
            per, CFG.gamma, JSpike[spike], True)
        return jnp.sum(z * r), z

    jleaves = {k: jnp.asarray(w[k]).astype(wd) for k in names}
    (_, jz), jg = jax.value_and_grad(jloss, has_aux=True)(jleaves)
    tleaves = {k: torch.from_numpy(w[k]).to(getattr(torch, wd))
               .requires_grad_(True) for k in names}
    tz = tfi.fused_encode_izh_scan(
        torch.from_numpy(lat), tleaves["w_in"], tleaves.get("w_rec"),
        tizh.izh_kernel_params(CFG), T, per, CFG.gamma, TSpike[spike])
    assert tz.dtype == torch.float32 and tuple(tz.shape) == (T, B, H)
    np.testing.assert_array_equal(_np(tz), _np(jz))
    assert float(tz.detach().sum()) > 0
    (tz * torch.from_numpy(r)).sum().backward()
    for k, v in tleaves.items():
        assert v.grad.dtype == v.dtype, k
    bar = GRAD_BAR if wd == "float32" else 2.0 ** -7
    _close({k: _np(v.grad) for k, v in tleaves.items()},
           {k: _np(v) for k, v in jg.items()}, bar, name)
    with torch.no_grad():  # inference: the same spikes, no residual
        again = tfi.fused_encode_izh_scan(
            torch.from_numpy(lat), tleaves["w_in"], tleaves.get("w_rec"),
            tizh.izh_kernel_params(CFG), T, per, CFG.gamma, TSpike[spike])
    assert torch.equal(again, tz.detach())

    # The backward alone, on the JAX forward's residuals.
    jw = {k: jnp.asarray(w[k]).astype(wd) for k in names}
    jz2, jv, jlat = jfi._izh_fwd_call(
        jnp.asarray(lat), jw["w_in"], jw.get("w_rec"), dict(KP), T=T,
        use_periods=per, interpret=True)
    np.testing.assert_array_equal(_np(jz2), _np(jz))
    _, tv = tfi._layer0_reference(
        torch.from_numpy(lat), tleaves["w_in"].detach(),
        None if not rec else tleaves["w_rec"].detach(), T, per, KP, True)
    _close_v(tv, jv)
    jgr = jfi._izh_bwd_call(
        jnp.asarray(r), jv, jz2, jlat, jw["w_in"], jw.get("w_rec"), dict(KP),
        T=T, use_periods=per, gamma=CFG.gamma, spike_func=JSpike[spike],
        interpret=True)
    tgr = tfi._bwd_reference(
        None, None, None, torch.from_numpy(r), torch.from_numpy(_np(jz2)),
        torch.from_numpy(_np(jv)), torch.from_numpy(lat),
        tleaves["w_in"].detach(),
        None if not rec else tleaves["w_rec"].detach(), None, T, per, KP,
        CFG.gamma, 0.0, TSpike[spike])
    _close({k: _np(g) for k, g in zip(names, tgr)},
           {k: _np(g) for k, g in zip(names, jgr)},
           SAME_RES_BAR if wd == "float32" else 2.0 ** -7, f"{name} same-res")


@pytest.mark.parametrize("counts", [False, True], ids=["logits", "counts"])
@pytest.mark.parametrize("name,rec,per,T,wd,spike", FUSED_CASES,
                         ids=FUSED_IDS)
def test_fused_head_matches_the_jax_kernel(name, rec, per, T, wd, spike,
                                           counts):
    rng, lat, w = _fused_inputs(T, rec, seed=8)
    rl = rng.standard_normal((B, O)).astype(np.float32)
    rc = (0.05 * rng.standard_normal((B, H))).astype(np.float32)
    names = ["w_in"] + (["w_rec"] if rec else []) + ["w_out", "b_out"]
    jfn = (jfi.fused_encode_izh_scan_head_counts if counts
           else jfi.fused_encode_izh_scan_head)
    tfn = (tfi.fused_encode_izh_scan_head_counts if counts
           else tfi.fused_encode_izh_scan_head)

    def dt(k):
        return "float32" if k == "b_out" else wd

    def jloss(leaves):
        out = jfn(jnp.asarray(lat), leaves["w_in"], leaves.get("w_rec"),
                  leaves["w_out"], leaves["b_out"], KP, T, per, CFG.gamma,
                  KAPPA, JSpike[spike], True)
        if counts:
            return jnp.sum(out[0] * rl) + jnp.sum(out[1] * rc), out
        return jnp.sum(out * rl), out

    jleaves = {k: jnp.asarray(w[k]).astype(dt(k)) for k in names}
    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jleaves)
    tleaves = {k: torch.from_numpy(w[k]).to(getattr(torch, dt(k)))
               .requires_grad_(True) for k in names}
    tout = tfn(torch.from_numpy(lat), tleaves["w_in"], tleaves.get("w_rec"),
               tleaves["w_out"], tleaves["b_out"],
               tizh.izh_kernel_params(CFG), T, per, CFG.gamma, KAPPA,
               TSpike[spike])
    jl, tl = (jout[0], tout[0]) if counts else (jout, tout)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_np(tl).argmax(1), _np(jl).argmax(1))
    if counts:
        np.testing.assert_array_equal(_np(tout[1]), _np(jout[1]))
        assert float(tout[1].sum()) > 0
        loss = ((tout[0] * torch.from_numpy(rl)).sum()
                + (tout[1] * torch.from_numpy(rc)).sum())
    else:
        loss = (tout * torch.from_numpy(rl)).sum()
    loss.backward()
    for k, v in tleaves.items():
        assert v.grad.dtype == v.dtype and v.grad.shape == v.shape, k
    bar = GRAD_BAR if wd == "float32" else 2.0 ** -7
    _close({k: _np(v.grad) for k, v in tleaves.items()},
           {k: _np(v) for k, v in jg.items()}, bar, f"{name} head")
    with torch.no_grad():  # inference: the training forward's logits
        inf = tfn(torch.from_numpy(lat), tleaves["w_in"],
                  tleaves.get("w_rec"), tleaves["w_out"], tleaves["b_out"],
                  tizh.izh_kernel_params(CFG), T, per, CFG.gamma, KAPPA,
                  TSpike[spike])
    assert torch.equal(inf[0] if counts else inf, tl.detach())


def test_fused_head_residual_and_same_residual_backward():
    """The head keeps only the float32 ``v``; its backward alone, fed the
    JAX forward's ``v`` and ``tstar``, against the JAX backward (counts
    cotangent included)."""
    T, per = 24, True
    rng, lat, w = _fused_inputs(T, True, seed=9)
    jw = {k: jnp.asarray(w[k]) for k in w}
    jv, jlat, jlog, jts, jcnt = jfi._izh_fwd_call(
        jnp.asarray(lat), jw["w_in"], jw["w_rec"], dict(KP), T=T,
        use_periods=per, interpret=True, w_out=jw["w_out"],
        b_out=jw["b_out"], kappa=KAPPA, store_counts=True)
    tw = {k: torch.from_numpy(w[k]) for k in w}
    tlog, tv, tts, tcnt = tfi._head_reference(
        torch.from_numpy(lat), tw["w_in"], tw["w_rec"], tw["w_out"],
        tw["b_out"], T, per, KP, KAPPA, True, True)
    assert tv.dtype == torch.float32 and tuple(tv.shape) == (T, B, H)
    _close_v(tv, jv)
    np.testing.assert_allclose(_np(tlog), _np(jlog), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(_np(tcnt), _np(jcnt))
    g_logits = rng.standard_normal((B, O)).astype(np.float32)
    g_counts = (0.05 * rng.standard_normal((B, H))).astype(np.float32)
    jgr = jfi._izh_bwd_call(
        None, jv, None, jlat, jw["w_in"], jw["w_rec"], dict(KP), T=T,
        use_periods=per, gamma=CFG.gamma, spike_func=JSpike.FastSigmoid,
        interpret=True, g_logits=jnp.asarray(g_logits), tstar=jts,
        w_out=jw["w_out"], kappa=KAPPA, g_counts=jnp.asarray(g_counts))
    tgr = tfi._bwd_reference(
        torch.from_numpy(g_logits), torch.from_numpy(g_counts),
        torch.from_numpy(np.array(jts)), None, None,
        torch.from_numpy(_np(jv)), torch.from_numpy(lat), tw["w_in"],
        tw["w_rec"], tw["w_out"], T, per, KP, CFG.gamma, KAPPA,
        TSpike.FastSigmoid)
    names = ["w_in", "w_rec", "w_out", "b_out"]
    _close({k: _np(g) for k, g in zip(names, tgr)},
           {k: _np(g) for k, g in zip(names, jgr)}, SAME_RES_BAR, "head")


@pytest.mark.parametrize("device", ["cpu"])
def test_izh_supported_gates_on_the_cpu(device):
    """The plain versions cover every positive shape; nonsense shapes are
    refused before any device is asked."""
    assert tfi.fused_izh_supported(24, 784, 128, device=device,
                                   training=True)
    assert tfi.fused_izh_head_supported(24, 784, 128, 10, device=device,
                                        training=True)
    assert tizh.izh_scan_supported(24, 4096, device=device, training=True)
    assert not tfi.fused_izh_supported(0, 30, 20, device=device)
    assert not tfi.fused_izh_head_supported(24, 30, 20, 0, device=device)
    assert not tizh.izh_scan_supported(24, 0, device=device)
    assert tizh.izh_kernel_params(CFG) == KP
