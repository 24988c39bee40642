"""The two-layer pair of the port (``ops/fused2.py``) on the CPU, through its
plain PyTorch versions:

* the forward against the JAX kernel (``pallas_fused2._fused2_fwd_call`` in
  interpret mode) on identical numpy inputs: LIF/ALIF x rec/ff x
  FastSigmoid/Phi, TTFS and periodic, T = 24 and 100, float32 and bfloat16
  weights.  Spikes (the sign of each layer's residual), ``tstar`` and both
  layers' counts equal; logits within 1e-5; residuals within 1e-5 (float32)
  or one bfloat16 rounding;
* the forward against the port's composed plain path (layer 0 + mid head,
  ``fused._layer0_reference`` + ``fused_mid._mid_reference``) bit for bit:
  logits, ``tstar``, counts and both layers' residuals; the gradients of the
  public functions against the composed public functions' (the composed
  backward keeps LIF's membrane, not delta, and rounds ``g_z0`` to the
  weights' dtype: 2e-6 of max|g| float32, 2**-7 bfloat16);
* the inference path (no residual, bitwise the training forward's logits),
  the ``_reference`` twins, ``fused2_head_supported`` on the CPU;
* the model's gate ``_twolayer_head_fusible`` (the JAX suite's matrix,
  tests/test_pallas_fused2.py, plus a per-layer scalar override, which
  takes the composed dispatch) and its ``explain_dispatch`` row.

The gradients against the JAX kernel pair: tests/test_torch_fused2_grads.py.
The CUDA kernels run only on the card: tests/test_torch_cuda.py and
``chip_smoke.py`` hold them against these plain versions there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import (  # noqa: E402
    pallas_fused2 as jf2,
)
from snnimageclassification_tpu.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused2 as tf2,
    fused_mid as tmid,
)
from snnimageclassification_tpu_torch.ops.cells import (  # noqa: E402
    ALIFConfig,
    LIFConfig,
    ReadoutConfig,
)
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)

B, F, H1, H2, O = 5, 30, 16, 12, 7
KAPPA = ReadoutConfig(input_size=H2, output_size=O).kappa
FUSED2 = "torch:fused2_reference"

CASES = [  # name, alif, recurrent, surrogate, use_periods
    ("alif-rec-fs-ttfs", True, True, "FastSigmoid", False),
    ("alif-rec-phi-periodic", True, True, "Phi", True),
    ("alif-ff-fs-periodic", True, False, "FastSigmoid", True),
    ("alif-ff-phi-ttfs", True, False, "Phi", False),
    ("lif-rec-fs-periodic", False, True, "FastSigmoid", True),
    ("lif-rec-phi-ttfs", False, True, "Phi", False),
    ("lif-ff-fs-ttfs", False, False, "FastSigmoid", False),
    ("lif-ff-phi-periodic", False, False, "Phi", True),
]
GRID = [(c, T, wd) for c in CASES for T in (24, 100)
        for wd in ("float32", "bfloat16")]
IDS = [f"{c[0]}-T{T}-{wd}" for c, T, wd in GRID]


def _scalars(alif):
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H1)
    return cfg.alpha, cfg.rho if alif else 0.0, cfg.threshold, cfg.gamma


def inputs(T, alif, rec, seed=21):
    """(latencies, weights as numpy float32, betas): tau=20 latencies and
    weights at a scale where both layers fire."""
    rng = np.random.default_rng(seed)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(jnp.asarray(pixels),
                                            t_max=float(T), tau=20.0))

    def w(shape, std, mask=False):
        x = (std * rng.standard_normal(shape)).astype(np.float32)
        return x * (1 - np.eye(shape[0], dtype=np.float32)) if mask else x

    weights = dict(w0=w((F, H1), 1.5), w0r=w((H1, H1), 0.4, True) if rec
                   else None, w1=w((H1, H2), 1.0),
                   w1r=w((H2, H2), 0.4, True) if rec else None,
                   w_out=w((H2, O), 1.0), b_out=w((O,), 0.1))
    return lat, weights, ((1.6, 1.2) if alif else (0.0, 0.0))


def _t(x, wd, grad=False):
    if x is None:
        return None
    return torch.from_numpy(x).to(getattr(torch, wd)).requires_grad_(grad)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_trace(got, want, wd, label):
    """A residual trace: float32 to 1e-5, bfloat16 to one rounding."""
    tol = 1e-5 if wd == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=label)


def _plain_forward(lat, w, betas, T, alif, per, wd, spike_name):
    """The port's plain training forward with counts, on torch tensors."""
    alpha, rho, thr, _ = _scalars(alif)
    return tf2._fused2_reference(
        torch.from_numpy(lat), _t(w["w0"], wd), _t(w["w0r"], wd), betas[0],
        _t(w["w1"], wd), _t(w["w1r"], wd), betas[1], _t(w["w_out"], wd),
        _t(w["b_out"], "float32"), T, per, alif, alpha, rho, thr, KAPPA,
        True, alif and spike_name == "Phi", True)


@pytest.mark.parametrize("case,T,wd", GRID, ids=IDS)
def test_forward_matches_the_jax_kernel(case, T, wd):
    name, alif, rec, spike_name, per = case
    lat, w, betas = inputs(T, alif, rec)
    alpha, rho, thr, _ = _scalars(alif)

    def j(x):
        return None if x is None else jnp.asarray(x).astype(wd)

    traces, _, jlogits, jtstar, (jc0, jc1) = jf2._fused2_fwd_call(
        jnp.asarray(lat), j(w["w0"]), j(w["w0r"]), betas[0], j(w["w1"]),
        j(w["w1r"]), betas[1], j(w["w_out"]), jnp.asarray(w["b_out"]), T=T,
        use_periods=per, alif=alif, alpha=alpha, rho=rho, threshold=thr,
        store_delta=alif and spike_name == "FastSigmoid", kappa=KAPPA,
        interpret=True, store_counts=True)
    logits, d0, a0, d1, a1, tstar, c0, c1 = _plain_forward(
        lat, w, betas, T, alif, per, wd, spike_name)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(_np(logits).argmax(1),
                                  _np(jlogits).argmax(1))
    np.testing.assert_array_equal(tstar.numpy(), np.asarray(jtstar))
    np.testing.assert_array_equal(_np(c0), _np(jc0))
    np.testing.assert_array_equal(_np(c1), _np(jc1))
    assert float(c0.sum()) > 0 and float(c1.sum()) > 0  # both layers fire
    n_res = len(traces) // 2
    assert n_res == (2 if a0 is not None else 1) and (a0 is None) == (
        a1 is None)
    for label, got, want, h in (("d0", d0, traces[0], H1),
                                ("d1", d1, traces[n_res], H2),
                                ("a0", a0, traces[1] if n_res == 2 else None,
                                 H1),
                                ("a1", a1, traces[3] if n_res == 2 else None,
                                 H2)):
        if got is None:
            continue
        want = want[:, :B, :h]
        if label[0] == "d":  # spikes: the sign survives the rounding
            np.testing.assert_array_equal(_np(got) >= 0, _np(want) >= 0)
        _close_trace(got, want, wd, f"{name} {label}")


FULL = [(alif, rec, spike, per) for alif in (True, False)
        for rec in (True, False) for spike in ("FastSigmoid", "Phi")
        for per in (False, True)]
FULL_GRID = [(c, T, wd) for c in FULL for T in (24, 100)
             for wd in ("float32", "bfloat16")]


def _full_id(c, T, wd):
    alif, rec, spike, per = c
    return (f"{'alif' if alif else 'lif'}-{'rec' if rec else 'ff'}-"
            f"{'fs' if spike == 'FastSigmoid' else 'phi'}-"
            f"{'periodic' if per else 'ttfs'}-T{T}-{wd}")


@pytest.mark.parametrize("case,T,wd", FULL_GRID,
                         ids=[_full_id(*g) for g in FULL_GRID])
def test_plain_version_equals_the_composed_plain_path(case, T, wd):
    """Layer 0 + mid head, each through its plain version, against the
    two-layer plain version: every output bit for bit."""
    alif, rec, spike_name, per = case
    lat, w, betas = inputs(T, alif, rec)
    alpha, rho, thr, _ = _scalars(alif)
    store_a = alif and spike_name == "Phi"
    logits, d0, a0, d1, a1, tstar, c0, c1 = _plain_forward(
        lat, w, betas, T, alif, per, wd, spike_name)
    z0, r0, ra0 = tfused._layer0_reference(
        torch.from_numpy(lat), _t(w["w0"], wd), _t(w["w0r"], wd), betas[0],
        T, per, alif, alpha, rho, thr, True, store_a, False)
    m = tmid._mid_reference(
        z0, _t(w["w1"], wd), _t(w["w1r"], wd), betas[1], _t(w["w_out"], wd),
        _t(w["b_out"], "float32"), T, alif, alpha, rho, thr, KAPPA, True,
        store_a, True, False)
    assert torch.equal(logits, m[0]) and torch.equal(tstar, m[4])
    assert torch.equal(c1, m[5]) and torch.equal(c0, z0.float().sum(0))
    assert torch.equal(d0, r0) and torch.equal(d1, m[2])
    assert torch.equal((d0.float() >= 0).to(z0.dtype), z0)
    if store_a:
        assert torch.equal(a0, ra0) and torch.equal(a1, m[3])
    else:
        assert a0 is None and a1 is None


@pytest.mark.parametrize("wd", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES[:4] + CASES[5:6],
                         ids=[c[0] for c in CASES[:4] + CASES[5:6]])
def test_gradients_equal_the_composed_public_functions(case, wd):
    """``fused2_{rec,ff}_head_counts`` against ``fused_encode_*_scan`` +
    ``fused_mid_*_scan_head_counts`` through autograd, T = 24: the same
    loss (logits, both layers' counts), every weight's gradient, the betas'
    zero."""
    name, alif, rec, spike_name, per = case
    T = 24
    lat, w, betas = inputs(T, alif, rec, seed=4)
    alpha, rho, thr, gamma = _scalars(alif)
    spike = TSpike[spike_name]
    rng = np.random.default_rng(5)
    r = torch.from_numpy(rng.standard_normal((B, O)).astype(np.float32))
    q0, q1 = (torch.from_numpy((0.05 * rng.standard_normal((B, h)))
                               .astype(np.float32)) for h in (H1, H2))
    kind = "rec" if rec else "ff"
    grads, outs = [], []
    for composed in (False, True):
        leaves = {k: _t(v, "float32" if k == "b_out" else wd, True)
                  for k, v in w.items() if v is not None}
        b0, b1 = (torch.tensor(b, requires_grad=True) for b in betas)
        layer0 = (leaves["w0"], leaves["w0r"], b0) if rec else (
            leaves["w0"], b0)
        layer1 = (leaves["w1"], leaves["w1r"], b1) if rec else (
            leaves["w1"], b1)
        lt = torch.from_numpy(lat)
        if composed:
            z0 = getattr(tfused, f"fused_encode_{kind}_scan")(
                lt, *layer0, T, per, alif, alpha, rho, thr, gamma, spike)
            logits, cnt1 = getattr(tmid, f"fused_mid_{kind}_scan_head_counts")(
                z0, *layer1, leaves["w_out"], leaves["b_out"], T, alif,
                alpha, rho, thr, gamma, KAPPA, spike)
            cnt0 = z0.to(torch.float32).sum(0)
        else:
            logits, (cnt0, cnt1) = getattr(tf2, f"fused2_{kind}_head_counts")(
                lt, *layer0, *layer1, leaves["w_out"], leaves["b_out"], T,
                per, alif, alpha, rho, thr, gamma, KAPPA, spike)
        ((logits * r).sum() + (cnt0 * q0).sum()
         + (cnt1 * q1).sum()).backward()
        assert float(b0.grad) == 0.0 and float(b1.grad) == 0.0
        grads.append({k: _np(v.grad) for k, v in leaves.items()})
        outs.append((logits.detach(), cnt0.detach(), cnt1.detach()))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    bar = 2.0 ** -7 if wd == "bfloat16" else 2e-6
    for k, want in grads[1].items():
        scale = max(float(np.abs(want).max()), 1e-12)
        assert scale > 1e-9, f"{name} {k}: no gradient reaches this leaf"
        np.testing.assert_allclose(grads[0][k] / scale, want / scale,
                                   atol=bar, rtol=0, err_msg=f"{name} {k}")


def _public_args(lat, w, betas, T, alif, per, wd, grad=False):
    alpha, rho, thr, gamma = _scalars(alif)
    leaves = [_t(w["w0"], wd, grad), _t(w["w0r"], wd, grad), betas[0],
              _t(w["w1"], wd, grad), _t(w["w1r"], wd, grad), betas[1],
              _t(w["w_out"], wd, grad), _t(w["b_out"], "float32", grad)]
    return [torch.from_numpy(lat), *leaves, T, per, alif, alpha, rho, thr,
            gamma, KAPPA]


def test_inference_takes_no_autograd_path():
    """Without a gradient to compute the wrappers call the plain forward
    directly (no residual kept), under ``no_grad`` and for leaves that do
    not require one; the logits are the training forward's bits; the
    ``_counts`` variants change no logit; the ``_reference`` twins equal
    the public functions on the CPU."""
    lat, w, betas = inputs(24, True, True)
    args = _public_args(lat, w, betas, 24, True, False, "float32")
    plain = tf2.fused2_rec_head(*args)
    assert plain.grad_fn is None
    leaves = list(args)
    leaves[1] = leaves[1].clone().requires_grad_(True)
    train = tf2.fused2_rec_head(*leaves)
    assert train.grad_fn is not None
    assert torch.equal(plain, train.detach())
    with torch.no_grad():
        logits, (c0, c1) = tf2.fused2_rec_head_counts(*leaves)
    assert logits.grad_fn is None and torch.equal(logits, plain)
    assert c0.shape == (B, H1) and c1.shape == (B, H2)
    assert float(c0.sum()) > 0 and float(c1.sum()) > 0
    assert torch.equal(tf2.fused2_rec_head_reference(*args), plain)
    ref_l, ref_c = tf2.fused2_rec_head_counts_reference(*args)
    assert torch.equal(ref_l, plain) and torch.equal(ref_c[1], c1)
    lat_ff, w_ff, _ = inputs(24, True, False)
    ff = _public_args(lat_ff, w_ff, betas, 24, True, False, "float32")
    ff = [a for i, a in enumerate(ff) if i not in (2, 5)]
    assert torch.equal(tf2.fused2_ff_head(*ff),
                       tf2.fused2_ff_head_reference(*ff))
    assert torch.equal(tf2.fused2_ff_head_counts(*ff)[1][0],
                       tf2.fused2_ff_head_counts_reference(*ff)[1][0])


def test_supported_gates_on_the_cpu():
    """The plain versions cover every positive shape; nonsense shapes are
    refused before any device is asked."""
    assert tf2.fused2_head_supported(100, 784, 128, 128, 10, device="cpu",
                                     training=True)
    assert tf2.fused2_head_supported(24, 4096, 1024, 2048, 64, False, 2,
                                     device="cpu")
    for bad in ((0, 30, 16, 12, 7), (24, 0, 16, 12, 7), (24, 30, 0, 12, 7),
                (24, 30, 16, 0, 7), (24, 30, 16, 12, 0)):
        assert not tf2.fused2_head_supported(*bad, device="cpu")


# ---------------------------------------------------------------------------
# The model's two-layer gate
# ---------------------------------------------------------------------------
def _cfg(hidden=(H1, H2), **kw):
    kw.setdefault("hidden_layer_type", "ALIF")
    kw.setdefault("use_recurrent_connection", True)
    return tst.SNNConfig(input_size=F, output_size=O, n_hidden_neurons=hidden,
                         int_time_steps=10, **kw)


class _Override(tst.SNNConfig):
    """A hand-built config: hidden layer 1 with its own ``scalar``."""

    def __init__(self, scalar, value, **kw):
        super().__init__(**kw)
        object.__setattr__(self, "_over", (scalar, value))

    @property
    def layer_configs(self):
        (n0, c0), (n1, c1), last = super().layer_configs
        return ((n0, c0), (n1, dataclasses.replace(c1, **dict([self._over]))),
                last)


def test_gate_shapes_and_types():
    enc = tst.EncodeConfig(n_steps=10)
    cpu = torch.device("cpu")

    def ok(cfg, e=enc, **kw):
        return tsnn._twolayer_head_fusible(cfg, e, cpu, **kw)

    assert ok(_cfg()) and ok(_cfg(), training=True)
    assert ok(_cfg(hidden_layer_type="LIF"))
    assert ok(_cfg(use_recurrent_connection=False, spike_func="Phi"))
    # exactly two hidden layers
    assert not ok(_cfg(hidden=H1))
    assert not ok(_cfg(hidden=(H1, H1, H2)))
    # Izhikevich has no two-layer pair
    assert not ok(_cfg(hidden_layer_type="Izhikevich"))
    # non-max readout / mismatched encoding length / a spike tensor input
    assert not ok(_cfg(readout_mth=tst.ReadoutMth.TEMPORAL_FILTER))
    assert not ok(_cfg(), tst.EncodeConfig(n_steps=7))
    # compute_dtype and use_kernels gates
    assert not ok(_cfg(compute_dtype="bfloat16"))
    assert not ok(_cfg(use_kernels=False))
    # bf16 matmul operands keep the pair
    assert ok(_cfg(matmul_dtype="bfloat16"))


@pytest.mark.parametrize("scalar,value", [
    ("threshold", 0.05), ("gamma", 0.5), ("tau_m", 0.03), ("tau_a", 0.3),
    ("spike_func", TSpike.Phi), ("learn_beta", True),
], ids=lambda v: str(v))
def test_gate_per_layer_override_takes_the_composed_dispatch(scalar, value):
    """One scalar set for both layers or no pair: a config whose second
    hidden layer differs runs layer 0 + mid head, with that layer's own
    scalar, and still equals the per-step loop."""
    enc = tst.EncodeConfig(n_steps=10, tau=5.0)
    base = dict(input_size=F, output_size=O, n_hidden_neurons=(H1, H2),
                hidden_layer_type="ALIF", int_time_steps=10)
    cfg = _Override(scalar, value, **base)
    assert tsnn._twolayer_head_fusible(tst.SNNConfig(**base), enc,
                                       torch.device("cpu"))
    assert not tsnn._twolayer_head_fusible(cfg, enc, torch.device("cpu"))
    names = [n for n, _ in cfg.layer_configs]
    rows = [(r["layer"], r["path"])
            for r in tsnn.explain_dispatch(cfg, enc, device="cpu")]
    assert rows == [(names[0], "torch:fused_layer0_reference"),
                    ((names[1], names[2]), "torch:fused_mid_reference[head]")]
    params = tsnn.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name in names[:2]:
        params[name]["w_in"] = params[name]["w_in"] * 30.0
    x = np.random.default_rng(2).random((B, F)).astype(np.float32)
    loop_cfg = _Override(scalar, value, **base, use_kernels=False)
    with torch.no_grad():
        got = tsnn.forward_logits_pixels(cfg, params, x, enc, device="cpu")
        want = tsnn.forward_logits_pixels(loop_cfg, params, x, enc,
                                          device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_explain_dispatch_names_the_pair():
    enc = tst.EncodeConfig(n_steps=10)
    cfg = _cfg()
    names = tuple(n for n, _ in cfg.layer_configs)
    for training in (False, True):
        rows = tsnn.explain_dispatch(cfg, enc, device="cpu",
                                     training=training)
        assert [(r["layer"], r["path"]) for r in rows] == [(names, FUSED2)]
        assert "both hidden scans" in rows[0]["reason"]
    assert "BPTT" in tsnn.explain_dispatch(cfg, enc, device="cpu",
                                           training=True)[0]["reason"]
    # Without an encoding (apply) the layers keep their own rows.
    assert len(tsnn.explain_dispatch(cfg, None, device="cpu")) == 3


def test_model_forward_and_counts_take_the_pair():
    """``forward_logits_pixels`` and ``forward_logits_counts_pixels`` of a
    two-hidden config go through the two-layer pair (its reference on the
    CPU) and equal the per-step loop; both layers' counts come from it."""
    enc = tst.EncodeConfig(n_steps=10, tau=5.0)
    cfg = _cfg(learn_beta=True)
    loop_cfg = _cfg(learn_beta=True, use_kernels=False)
    params = tsnn.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    for name in ("input", "hidden_0"):
        params[name]["w_in"] = params[name]["w_in"] * 30.0
    x = np.random.default_rng(3).random((B, F)).astype(np.float32)
    calls = []
    real = tf2._fused2_reference

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    tf2._fused2_reference = spy
    try:
        with torch.no_grad():
            logits = tsnn.forward_logits_pixels(cfg, params, x, enc,
                                                device="cpu")
            logits2, counts = tsnn.forward_logits_counts_pixels(
                cfg, params, x, enc, device="cpu")
    finally:
        tf2._fused2_reference = real
    assert len(calls) == 2
    with torch.no_grad():
        want, want_counts = tsnn.forward_logits_counts_pixels(
            loop_cfg, params, x, enc, device="cpu")
    assert torch.equal(logits, logits2)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert set(counts) == set(want_counts) == {"input", "hidden_0"}
    for k in counts:
        assert torch.equal(counts[k], want_counts[k])
    assert float(counts["hidden_0"].sum()) > 0
