"""Whole-network head backward: the port's ``autograd.Function`` on the
CPU (plain PyTorch versions of the training forward and of the
reverse-time backward) against ``jax.grad`` through the JAX Pallas kernel
pair in interpret mode, on identical numpy inputs.

Cases: the JAX suite's seven head cases (T=12 and T=24, so several time
blocks) in float32 and bfloat16 weights.  The loss is ``sum(logits * r)``
for a fixed random ``r`` (plus ``sum(counts * q)`` for the ``_counts``
variants).  Each gradient is scaled by its max: float32 within 2e-6 (2e-5
for ALIF + Phi, whose per-element denominators amplify reduction-order
noise), the JAX suite's own bars; bfloat16 within 2**-7, one bf16
rounding of the result.

The CUDA kernels run only on the card: tests/test_torch_cuda.py holds
them against the plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_fused as jfused  # noqa: E402
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
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)

B, F, H, O = 5, 30, 20, 10
KAPPA = ReadoutConfig(input_size=H, output_size=O).kappa
LEAVES = ("w_in", "w_rec", "w_out", "b_out")

# tests/test_pallas_fused.py:HEAD_CASES
HEAD_CASES = [
    ("alif-rec-ttfs", True, True, False, "FastSigmoid", 12),
    ("alif-ff-periodic", True, False, True, "FastSigmoid", 12),
    ("lif-rec-phi", False, True, True, "Phi", 12),
    ("alif-rec-phi", True, True, False, "Phi", 12),
    ("alif-rec-2blocks", True, True, False, "FastSigmoid", 24),
    ("lif-ff-2blocks", False, False, True, "FastSigmoid", 24),
    ("alif-ff-phi-2blocks", True, False, True, "Phi", 24),
]
IDS = [c[0] for c in HEAD_CASES]


def _inputs(seed, n_steps, rec, tau=20.0):
    """Latencies spread over the window (tau=20) and the JAX suite's
    weight scales, as numpy."""
    rng = np.random.default_rng(seed)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(
        jnp.asarray(pixels), t_max=float(n_steps), tau=tau))
    w = dict(
        w_in=(0.5 * rng.standard_normal((F, H))).astype(np.float32),
        w_rec=((0.3 * rng.standard_normal((H, H))).astype(np.float32)
               * (1 - np.eye(H, dtype=np.float32))) if rec else None,
        w_out=rng.standard_normal((H, O)).astype(np.float32),
        b_out=(0.1 * rng.standard_normal((O,))).astype(np.float32),
    )
    r = rng.standard_normal((B, O)).astype(np.float32)
    q = (0.05 * rng.standard_normal((B, H))).astype(np.float32)
    return lat, w, r, q


def _scalars(alif, spike_name, n_steps, use_periods):
    cfg = (ALIFConfig if alif else LIFConfig)(
        input_size=F, output_size=H, spike_func=JSpike[spike_name])
    return (n_steps, use_periods, alif, cfg.alpha,
            cfg.rho if alif else 0.0, cfg.threshold, cfg.gamma, KAPPA)


def _jax_grads(lat, w, r, q, scalars, spike_name, wdtype, beta, counts):
    rec = w["w_rec"] is not None
    names = [k for k in LEAVES if w[k] is not None]
    cast = {k: jnp.asarray(w[k]).astype("float32" if k == "b_out" else wdtype)
            for k in names}

    def loss(leaves, beta):
        tail = (*scalars, JSpike[spike_name], True)  # interpret mode
        if rec:
            fn = (jfused.fused_encode_rec_scan_head_counts if counts
                  else jfused.fused_encode_rec_scan_head)
            out = fn(jnp.asarray(lat), leaves["w_in"], leaves["w_rec"], beta,
                     leaves["w_out"], leaves["b_out"], *tail)
        else:
            fn = (jfused.fused_encode_ff_scan_head_counts if counts
                  else jfused.fused_encode_ff_scan_head)
            out = fn(jnp.asarray(lat), leaves["w_in"], beta, leaves["w_out"],
                     leaves["b_out"], *tail)
        if counts:
            return jnp.sum(out[0] * r) + jnp.sum(out[1] * q)
        return jnp.sum(out * r)

    g, g_beta = jax.grad(loss, (0, 1))(cast, jnp.float32(beta))
    return ({k: np.asarray(v.astype(jnp.float32)) for k, v in g.items()},
            float(g_beta))


def _torch_grads(lat, w, r, q, scalars, spike_name, wdtype, beta, counts):
    rec = w["w_rec"] is not None
    leaves = {
        k: torch.from_numpy(w[k]).to(
            torch.float32 if k == "b_out" else getattr(torch, wdtype)
        ).requires_grad_(True)
        for k in LEAVES if w[k] is not None}
    beta_t = torch.tensor(beta, requires_grad=True)
    tail = (*scalars, TSpike[spike_name])
    lat_t = torch.from_numpy(lat)
    if rec:
        fn = (tfused.fused_encode_rec_scan_head_counts if counts
              else tfused.fused_encode_rec_scan_head)
        out = fn(lat_t, leaves["w_in"], leaves["w_rec"], beta_t,
                 leaves["w_out"], leaves["b_out"], *tail)
    else:
        fn = (tfused.fused_encode_ff_scan_head_counts if counts
              else tfused.fused_encode_ff_scan_head)
        out = fn(lat_t, leaves["w_in"], beta_t, leaves["w_out"],
                 leaves["b_out"], *tail)
    if counts:
        loss = (out[0] * torch.from_numpy(r)).sum() \
            + (out[1] * torch.from_numpy(q)).sum()
    else:
        loss = (out * torch.from_numpy(r)).sum()
    loss.backward()
    for k, v in leaves.items():
        assert v.grad.dtype == v.dtype and v.grad.shape == v.shape
    return ({k: v.grad.float().numpy() for k, v in leaves.items()},
            float(beta_t.grad))


def _bar(alif, spike_name, wdtype):
    if wdtype == "bfloat16":
        return 2.0 ** -7  # one bf16 rounding of the result
    return 2e-5 if (alif and spike_name == "Phi") else 2e-6


def _assert_grads_close(got, want, bar, label):
    assert set(got) == set(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=bar,
                                   rtol=0, err_msg=f"{label} {k}")


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,alif,rec,use_periods,spike_name,n_steps", HEAD_CASES, ids=IDS)
def test_head_grads_match_pallas(name, alif, rec, use_periods, spike_name,
                                 n_steps, wdtype):
    lat, w, r, q = _inputs(11, n_steps, rec)
    scalars = _scalars(alif, spike_name, n_steps, use_periods)
    beta = 1.6 if alif else 0.0
    want, want_beta = _jax_grads(lat, w, r, q, scalars, spike_name, wdtype,
                                 beta, False)
    got, got_beta = _torch_grads(lat, w, r, q, scalars, spike_name, wdtype,
                                 beta, False)
    _assert_grads_close(got, want, _bar(alif, spike_name, wdtype), name)
    assert got_beta == 0.0 and want_beta == 0.0  # exactly zero, both sides


COUNT_CASES = [HEAD_CASES[i] for i in (0, 1, 3, 5)]


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,alif,rec,use_periods,spike_name,n_steps", COUNT_CASES,
    ids=[c[0] for c in COUNT_CASES])
def test_counts_grads_match_pallas(name, alif, rec, use_periods, spike_name,
                                   n_steps, wdtype):
    """The ``_counts`` variants with a cotangent on both outputs."""
    lat, w, r, q = _inputs(7, n_steps, rec)
    scalars = _scalars(alif, spike_name, n_steps, use_periods)
    beta = 1.6 if alif else 0.0
    want, _ = _jax_grads(lat, w, r, q, scalars, spike_name, wdtype, beta,
                         True)
    got, got_beta = _torch_grads(lat, w, r, q, scalars, spike_name, wdtype,
                                 beta, True)
    _assert_grads_close(got, want, _bar(alif, spike_name, wdtype), name)
    assert got_beta == 0.0


@pytest.mark.parametrize("rec", [True, False], ids=["rec", "ff"])
def test_counts_forward_matches_pallas(rec):
    lat, w, _, _ = _inputs(5, 24, rec)
    scalars = _scalars(True, "FastSigmoid", 24, False)
    jt = (*scalars, JSpike.FastSigmoid, True)
    tt = (*scalars, TSpike.FastSigmoid)
    jw = {k: None if v is None else jnp.asarray(v) for k, v in w.items()}
    tw = {k: None if v is None else torch.from_numpy(v) for k, v in w.items()}
    if rec:
        want = jfused.fused_encode_rec_scan_head_counts(
            jnp.asarray(lat), jw["w_in"], jw["w_rec"], 1.6, jw["w_out"],
            jw["b_out"], *jt)
        got = tfused.fused_encode_rec_scan_head_counts(
            torch.from_numpy(lat), tw["w_in"], tw["w_rec"], 1.6, tw["w_out"],
            tw["b_out"], *tt)
    else:
        want = jfused.fused_encode_ff_scan_head_counts(
            jnp.asarray(lat), jw["w_in"], 1.6, jw["w_out"], jw["b_out"], *jt)
        got = tfused.fused_encode_ff_scan_head_counts(
            torch.from_numpy(lat), tw["w_in"], 1.6, tw["w_out"], tw["b_out"],
            *tt)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_tie_routes_cotangent_to_first_maximal_step():
    """No hidden spikes and kappa = 1, b = 0 after one kick is impossible
    here, so build the tie directly: zero input weights make the readout
    a per-class bias ramp; with b_out = 0 every step ties at 0 and the
    strict > keeps step 0, so g_b = sum_t kappa^0 [t == 0] = g_logits
    summed over rows -- not T times that."""
    T = 6
    lat = torch.zeros((3, 4), dtype=torch.int32)
    w_in = torch.zeros((4, 5), requires_grad=True)
    w_out = torch.ones((5, 2), requires_grad=True)
    b = torch.zeros(2, requires_grad=True)
    out = tfused.fused_encode_ff_scan_head(
        lat, w_in, 0.0, w_out, b, T, False, False, 0.9, 0.0, 1.0, 1.0, 0.9)
    g = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]])
    (out * g).sum().backward()
    np.testing.assert_allclose(b.grad.numpy(), [9.0, 12.0], rtol=1e-6)
    _, _, _, tstar, _ = tfused._head_train_reference(
        lat, w_in.detach(), None, 0.0, w_out.detach(), b.detach(), T, False,
        False, 0.9, 0.0, 1.0, 0.9, True, False, False)
    assert int(tstar.abs().sum()) == 0


@pytest.mark.parametrize(
    "name,alif,rec,use_periods,spike_name,n_steps", HEAD_CASES, ids=IDS)
def test_training_forward_logits_equal_inference_bitwise(
        name, alif, rec, use_periods, spike_name, n_steps):
    lat, w, _, _ = _inputs(3, n_steps, rec)
    scalars = _scalars(alif, spike_name, n_steps, use_periods)
    tw = {k: None if v is None else torch.from_numpy(v) for k, v in w.items()}
    args = (torch.from_numpy(lat), tw["w_in"], tw["w_rec"],
            1.6 if alif else 0.0, tw["w_out"], tw["b_out"], *scalars[:6],
            KAPPA)
    infer = tfused._head_reference(*args)
    store_a = alif and spike_name == "Phi"
    logits, delta, a_tr, tstar, counts = tfused._head_train_reference(
        *args, True, store_a, True)
    assert torch.equal(logits, infer)
    assert delta.shape == (n_steps, B, H) and (a_tr is not None) == store_a
    assert tstar.dtype == torch.int32 and tstar.shape == (B, O)
    np.testing.assert_array_equal(
        counts.numpy(), (delta >= 0).float().sum(0).numpy())


LOOP_CASES = [
    ("alif-rec-learnbeta", dict(hidden_layer_type="ALIF", learn_beta=True),
     dict()),
    ("alif-ff-periodic", dict(hidden_layer_type="ALIF",
                              use_recurrent_connection=False),
     dict(use_periods=True)),
    ("lif-rec-phi", dict(hidden_layer_type="LIF", threshold=0.05,
                         spike_func="Phi"), dict(use_periods=True)),
    ("alif-rec-phi-noeye", dict(hidden_layer_type="ALIF", spike_func="Phi",
                                use_rec_eye_mask=False), dict()),
]


@pytest.mark.parametrize("name,ckw,ekw", LOOP_CASES,
                         ids=[c[0] for c in LOOP_CASES])
def test_explicit_backward_equals_autograd_through_the_loop(name, ckw, ekw):
    """``_head_bwd_reference`` (the head path) against PyTorch autograd
    through ``apply`` + ``prediction_logits`` (the loop path), float32."""
    cfg = tst.SNNConfig(input_size=F, output_size=O, n_hidden_neurons=H,
                        int_time_steps=24, **ckw)
    loop_cfg = tst.SNNConfig(**{**cfg.__dict__, "use_kernels": False})
    enc = tst.EncodeConfig(n_steps=24, tau=20.0, **ekw)
    x = np.random.default_rng(9).random((B, F)).astype(np.float32)
    r = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (B, O)).astype(np.float32))
    base = tsnn.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    base["input"]["w_in"] = base["input"]["w_in"] * 8  # make it spike
    grads = []
    for c in (cfg, loop_cfg):
        params = {n: {k: v.clone().requires_grad_(True)
                      for k, v in g.items()} for n, g in base.items()}
        assert tsnn.explain_dispatch(c, enc, device="cpu")[0]["path"] == (
            "torch:loop" if c is loop_cfg else "torch:fused_head_reference")
        logits = tsnn.forward_logits_pixels(c, params, x, enc, device="cpu")
        (logits * r).sum().backward()
        grads.append({f"{n}.{k}": v.grad for n, g in params.items()
                      for k, v in g.items()})
    head, loop = grads
    bar = 2e-5 if "phi" in name and "alif" in name else 2e-6
    for k, want in loop.items():
        if k.endswith("beta"):
            assert float(head[k]) == 0.0 and float(want) == 0.0
            continue
        scale = max(float(want.abs().max()), 1e-12)
        np.testing.assert_allclose(head[k].numpy() / scale,
                                   want.numpy() / scale, atol=bar, rtol=0,
                                   err_msg=f"{name} {k}")
