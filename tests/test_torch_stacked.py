"""The stacked replica mode (an ensemble of S seeds on one batch) of both
head calls: the port's plain versions on the CPU (forward and backward
through autograd) against the JAX package's stacked kernels in interpret
mode (``w_in.ndim == 3``), on identical numpy inputs, and
``forward_logits_pixels_stacked`` against S per-replica JAX
``forward_logits_pixels``.

Cases cover LIF / ALIF x recurrent / feedforward x TTFS / periodic x
FastSigmoid / Phi at T = 24 and 100 (S = 3, beta an (S,) array for ALIF),
and the Izhikevich head recurrent / feedforward at T = 24.  The loss is
``sum(logits * r)`` for a fixed random ``r (S, B, O)``.  Tolerances are
those of the single calls' tests: logits within 1e-5; each gradient scaled
by its max within 2e-6 (5e-6 at T = 100; 2e-5 for ALIF with Phi, whose
per-element denominators amplify reduction-order noise; Izhikevich 1e-4,
tests/test_torch_izh.py), bfloat16 within 2**-7.  beta gets an exactly
zero gradient on both sides.

The CUDA kernels run only on the card: tests/test_torch_cuda.py holds the
stacked launches against single launches bit for bit there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu import models as jmodels  # noqa: E402
from snnimageclassification_tpu.data.datasets import (  # noqa: E402
    EncodeConfig as JEnc,
)
from snnimageclassification_tpu.models import snn as jsnn  # noqa: E402
from snnimageclassification_tpu.models.config import (  # noqa: E402
    SNNConfig as JConfig,
)
from snnimageclassification_tpu.ops import pallas_fused as jfused  # noqa: E402
from snnimageclassification_tpu.ops import pallas_fused_izh as jfi  # noqa: E402
from snnimageclassification_tpu.ops import pallas_izh as jizh  # noqa: E402
from snnimageclassification_tpu.ops.cells import (  # noqa: E402
    ALIFConfig,
    IzhikevichConfig,
    LIFConfig,
    ReadoutConfig,
)
from snnimageclassification_tpu.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import convert  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops import fused_izh as tfi  # noqa: E402
from snnimageclassification_tpu_torch.ops import izh as tizh  # noqa: E402
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)

S, B, F, H, O = 3, 5, 30, 20, 10
KAPPA = ReadoutConfig(input_size=H, output_size=O).kappa

CASES = [  # name, alif, recurrent, use_periods, surrogate, T, weights' dtype
    ("alif-rec-ttfs", True, True, False, "FastSigmoid", 24, "float32"),
    ("alif-ff-periodic", True, False, True, "FastSigmoid", 24, "float32"),
    ("lif-rec-periodic-phi", False, True, True, "Phi", 24, "float32"),
    ("alif-rec-phi", True, True, False, "Phi", 24, "float32"),
    ("lif-ff-ttfs", False, False, False, "FastSigmoid", 24, "bfloat16"),
    ("alif-rec-periodic-bf16", True, True, True, "FastSigmoid", 24,
     "bfloat16"),
    ("alif-rec-ttfs-T100", True, True, False, "FastSigmoid", 100, "float32"),
    ("lif-ff-periodic-phi-T100", False, False, True, "Phi", 100, "float32"),
]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _inputs(seed, T, rec, scale=(0.5, 0.3)):
    rng = np.random.default_rng(seed)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(jnp.asarray(pixels),
                                            t_max=float(T), tau=20.0))
    w = dict(
        w_in=(scale[0] * rng.standard_normal((S, F, H))).astype(np.float32),
        w_rec=((scale[1] * rng.standard_normal((S, H, H))).astype(np.float32)
               * (1 - np.eye(H, dtype=np.float32))) if rec else None,
        w_out=rng.standard_normal((S, H, O)).astype(np.float32),
        b_out=(0.1 * rng.standard_normal((S, O))).astype(np.float32),
    )
    r = rng.standard_normal((S, B, O)).astype(np.float32)
    beta = (1.6 + 0.3 * rng.standard_normal(S)).astype(np.float32)
    return lat, {k: v for k, v in w.items() if v is not None}, r, beta


def _close_grads(got, want, bar, label):
    assert set(got) == set(want), label
    for k, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, f"{label} {k}: no gradient"
        assert got[k].shape == w.shape, f"{label} {k}"
        np.testing.assert_allclose(got[k] / scale, w / scale, atol=bar,
                                   rtol=0, err_msg=f"{label} {k}")


def _bar(alif, spike, T, wd):
    if wd == "bfloat16":
        return 2.0 ** -7
    if alif and spike == "Phi":
        return 2e-5
    return 5e-6 if T == 100 else 2e-6


@pytest.mark.parametrize("name,alif,rec,per,spike,T,wd", CASES,
                         ids=[c[0] for c in CASES])
def test_stacked_head_matches_the_jax_stacked_kernel(name, alif, rec, per,
                                                     spike, T, wd):
    lat, w, r, beta_np = _inputs(11, T, rec)
    cfg = (ALIFConfig if alif else LIFConfig)(
        input_size=F, output_size=H, spike_func=JSpike[spike])
    scal = (T, per, alif, cfg.alpha, cfg.rho if alif else 0.0, cfg.threshold,
            cfg.gamma, KAPPA)

    def dt(k):
        return "float32" if k == "b_out" else wd

    def jloss(leaves, beta):
        args = (jnp.asarray(lat), leaves["w_in"]) + (
            (leaves["w_rec"],) if rec else ()) + (
            beta, leaves["w_out"], leaves["b_out"], *scal, JSpike[spike],
            True)
        fn = (jfused.fused_encode_rec_scan_head if rec
              else jfused.fused_encode_ff_scan_head)
        out = fn(*args)
        return jnp.sum(out * r), out

    jleaves = {k: jnp.asarray(v).astype(dt(k)) for k, v in w.items()}
    jbeta = jnp.asarray(beta_np) if alif else jnp.float32(0.0)
    (_, jout), (jg, jgb) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jleaves, jbeta)
    assert jout.shape == (S, B, O)

    tleaves = {k: torch.from_numpy(v).to(getattr(torch, dt(k)))
               .requires_grad_(True) for k, v in w.items()}
    tbeta = torch.from_numpy(beta_np if alif else np.zeros(1, np.float32)
                             ).requires_grad_(True)
    targs = (torch.from_numpy(lat), tleaves["w_in"]) + (
        (tleaves["w_rec"],) if rec else ()) + (
        tbeta if alif else 0.0, tleaves["w_out"], tleaves["b_out"], *scal,
        TSpike[spike])
    tfn = (tfused.fused_encode_rec_scan_head if rec
           else tfused.fused_encode_ff_scan_head)
    tout = tfn(*targs)
    assert tuple(tout.shape) == (S, B, O)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=1e-5, rtol=1e-5)
    (tout * torch.from_numpy(r)).sum().backward()
    for k, v in tleaves.items():
        assert v.grad.dtype == v.dtype and v.grad.shape == v.shape, k
    _close_grads({k: _np(v.grad) for k, v in tleaves.items()},
                 {k: _np(v) for k, v in jg.items()}, _bar(alif, spike, T, wd),
                 name)
    assert not np.any(np.asarray(jgb))  # beta's cotangent is exactly zero
    if alif:
        assert not bool(tbeta.grad.any())
    with torch.no_grad():  # inference: the training forward's logits
        assert torch.equal(tfn(*targs), tout.detach())


@pytest.mark.parametrize("rec", [True, False], ids=["rec", "ff"])
def test_stacked_izh_head_matches_the_jax_stacked_kernel(rec):
    """The Izhikevich head at the JAX tests' scale (W_in 3e6, W_rec 5e5,
    default constants, where units fire), T = 24, periodic."""
    T, per = 24, True
    rng = np.random.default_rng(8)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(jnp.asarray(pixels),
                                            t_max=float(T), tau=20.0))
    w = dict(w_in=(3e6 * rng.standard_normal((S, F, H))).astype(np.float32),
             w_out=rng.standard_normal((S, H, O)).astype(np.float32),
             b_out=(0.1 * rng.standard_normal((S, O))).astype(np.float32))
    if rec:
        w["w_rec"] = ((5e5 * rng.standard_normal((S, H, H))).astype(
            np.float32) * (1 - np.eye(H, dtype=np.float32)))
    r = rng.standard_normal((S, B, O)).astype(np.float32)
    cfg = IzhikevichConfig(input_size=F, output_size=H)
    kp = jizh.izh_kernel_params(cfg)

    def jloss(leaves):
        out = jfi.fused_encode_izh_scan_head(
            jnp.asarray(lat), leaves["w_in"], leaves.get("w_rec"),
            leaves["w_out"], leaves["b_out"], kp, T, per, cfg.gamma, KAPPA,
            cfg.spike_func, True)
        return jnp.sum(out * r), out

    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in w.items()})
    tleaves = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in w.items()}
    tout = tfi.fused_encode_izh_scan_head(
        torch.from_numpy(lat), tleaves["w_in"], tleaves.get("w_rec"),
        tleaves["w_out"], tleaves["b_out"], tizh.izh_kernel_params(cfg), T,
        per, cfg.gamma, KAPPA, TSpike[cfg.spike_func.name])
    assert tuple(tout.shape) == (S, B, O)
    np.testing.assert_allclose(_np(tout), _np(jout), atol=1e-5, rtol=1e-5)
    (tout * torch.from_numpy(r)).sum().backward()
    _close_grads({k: _np(v.grad) for k, v in tleaves.items()},
                 {k: _np(v) for k, v in jg.items()}, 1e-4, "izh stacked")


def test_stacked_modes_reject_counts_and_a_stacked_first_layer():
    lat, w, _, beta = _inputs(3, 12, True)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    args = (torch.from_numpy(lat), t["w_in"], t["w_rec"],
            torch.from_numpy(beta), t["w_out"], t["b_out"], 12, False, True,
            0.9, 0.9, 0.3, 2.0, KAPPA)
    with pytest.raises(ValueError, match="stacked"):
        tfused.fused_encode_rec_scan_head_counts(*args)
    kp = tizh.izh_kernel_params(IzhikevichConfig(input_size=F, output_size=H))
    with pytest.raises(ValueError, match="head only"):
        tfi.fused_encode_izh_scan(torch.from_numpy(lat), t["w_in"], None, kp,
                                  12, False, 2.0)
    with pytest.raises(ValueError, match="stacked"):
        tfi.fused_encode_izh_scan_head_counts(
            torch.from_numpy(lat), t["w_in"], None, t["w_out"], t["b_out"],
            kp, 12, False, 2.0, KAPPA)


def _ensemble_cfgs(layer, matmul_dtype="float32"):
    kw = dict(input_size=F, output_size=O, n_hidden_neurons=H,
              hidden_layer_type=layer, use_recurrent_connection=True,
              int_time_steps=16, matmul_dtype=matmul_dtype)
    if layer == "ALIF":
        kw["learn_beta"] = True
    if layer == "Izhikevich":
        kw["dt"] = 30.0
    return JConfig(**kw), tst.SNNConfig(**kw)


@pytest.mark.parametrize("layer,per,md", [
    ("ALIF", True, "float32"), ("LIF", False, "bfloat16"),
    ("Izhikevich", False, "float32")], ids=["alif-periodic", "lif-bf16",
                                            "izh-dt30"])
def test_forward_logits_pixels_stacked_matches_per_replica_jax(layer, per,
                                                               md):
    """Stacked params of three JAX seeds carried across by
    ``params_from_jax`` (a leading axis is a plain copy) give, in one
    stacked call, each replica's JAX ``forward_logits_pixels`` (logits
    within 1e-5 of max|logit|, argmax equal)."""
    jcfg, tcfg = _ensemble_cfgs(layer, md)
    per_seed = [jmodels.init(jcfg, jax.random.PRNGKey(s)) for s in range(S)]
    stacked_np = jax.tree.map(lambda *xs: np.stack([np.asarray(x)
                                                    for x in xs]), *per_seed)
    tparams = convert.params_from_jax(stacked_np, device="cpu")
    for name, group in stacked_np.items():
        for leaf, arr in group.items():
            assert np.array_equal(tparams[name][leaf].numpy(), arr)
    pixels = np.random.default_rng(4).random((B, F)).astype(np.float32)
    enc_kw = dict(n_steps=16, use_periods=per)
    assert tsnn.stacked_head_fusible(tcfg, tst.EncodeConfig(**enc_kw),
                                     device="cpu")
    got = tsnn.forward_logits_pixels_stacked(
        tcfg, tparams, torch.from_numpy(pixels), tst.EncodeConfig(**enc_kw),
        device="cpu")
    assert tuple(got.shape) == (S, B, O)
    for s in range(S):
        want = np.asarray(jsnn.forward_logits_pixels(
            jcfg, per_seed[s], jnp.asarray(pixels), JEnc(**enc_kw)))
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(_np(got[s]) / scale, want / scale,
                                   atol=1e-5, rtol=0, err_msg=f"seed {s}")
        np.testing.assert_array_equal(_np(got[s]).argmax(1), want.argmax(1))
    explained = tsnn.explain_dispatch(tcfg, tst.EncodeConfig(**enc_kw),
                                      device="cpu", stacked=True)
    want_path = ("torch:fused_izh_head_stacked_reference"
                 if layer == "Izhikevich"
                 else "torch:fused_head_stacked_reference")
    assert [e["path"] for e in explained] == [want_path]


def test_forward_logits_pixels_stacked_gates_like_the_head():
    """A config the stacked call does not cover (two hidden layers) raises;
    the stacked explain_dispatch lists the per-replica dispatch."""
    cfg = tst.SNNConfig(input_size=F, output_size=O, n_hidden_neurons=[H, H],
                        hidden_layer_type="ALIF", int_time_steps=8)
    enc = tst.EncodeConfig(n_steps=8)
    assert not tsnn.stacked_head_fusible(cfg, enc, device="cpu")
    params = tsnn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    stacked = {n: {k: v[None] for k, v in g.items()}
               for n, g in params.items()}
    with pytest.raises(ValueError, match="stacked-head-fusible"):
        tsnn.forward_logits_pixels_stacked(cfg, stacked, torch.zeros(2, F),
                                           enc, device="cpu")
    rows = tsnn.explain_dispatch(cfg, enc, device="cpu", stacked=True)
    assert rows and all(r["reason"].endswith("(per replica)") for r in rows)
