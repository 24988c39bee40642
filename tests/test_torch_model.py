"""The port's model against the JAX package's on the CPU: the same params
(carried across by ``params_from_jax``) and the same numpy pixels through
``forward_logits_pixels`` of both.  On the CPU the JAX package takes its
XLA scan path and the port its head's plain version (or its time loop),
so these hold the slice end to end.  Small sizes at atol=rtol=1e-5, one
flagship-width case at 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import snnimageclassification_tpu as jst  # noqa: E402
from snnimageclassification_tpu.data.datasets import (  # noqa: E402
    EncodeConfig as JEnc,
)
from snnimageclassification_tpu.models import snn as jsnn  # noqa: E402
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
)


def _pair(matmul_dtype=None, **kw):
    kw.setdefault("input_size", 30)
    kw.setdefault("output_size", 10)
    kw.setdefault("n_hidden_neurons", 20)
    jcfg = jst.SNNConfig(matmul_dtype=matmul_dtype, **kw)
    tkw = dict(kw)
    for k, enum_cls in (("hidden_layer_type", tst.LayerType),
                        ("readout_mth", tst.ReadoutMth)):
        if k in tkw and not isinstance(tkw[k], str):
            tkw[k] = enum_cls[tkw[k].name]
    tcfg = tst.SNNConfig(matmul_dtype=matmul_dtype, **tkw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = jsnn.init(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jax.device_get(jp)),
                               device="cpu")


def _logits(jcfg, tcfg, jp, tp, x, **enc):
    want = np.asarray(jsnn.forward_logits_pixels(jcfg, jp, x, JEnc(**enc)))
    got = tsnn.forward_logits_pixels(tcfg, tp, x, tst.EncodeConfig(**enc),
                                     device="cpu")
    return got.numpy(), want


SMALL = [
    # id, cfg kwargs, encoding kwargs (T follows int_time_steps)
    ("alif-rec-learnbeta-ttfs", dict(hidden_layer_type="ALIF",
                                     learn_beta=True), dict()),
    ("alif-rec-periodic", dict(hidden_layer_type="ALIF"),
     dict(use_periods=True)),
    ("alif-ff-ttfs", dict(hidden_layer_type="ALIF",
                          use_recurrent_connection=False), dict()),
    ("lif-rec-periodic", dict(hidden_layer_type="LIF", threshold=0.05),
     dict(use_periods=True)),
    ("lif-ff-ttfs", dict(hidden_layer_type="LIF", threshold=0.05,
                         use_recurrent_connection=False), dict()),
    ("alif-phi-noeye", dict(hidden_layer_type="ALIF", spike_func="Phi",
                            use_rec_eye_mask=False), dict()),
]


@pytest.mark.parametrize("matmul_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("n_steps", [12, 24])
@pytest.mark.parametrize("name,ckw,ekw", SMALL, ids=[s[0] for s in SMALL])
def test_head_slice_matches_jax(name, ckw, ekw, n_steps, matmul_dtype):
    jcfg, tcfg = _pair(matmul_dtype, int_time_steps=n_steps, **ckw)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(0).random((5, 30)).astype(np.float32)
    enc = dict(n_steps=n_steps, tau=20.0, **ekw)
    assert tsnn.explain_dispatch(tcfg, tst.EncodeConfig(**enc),
                                 device="cpu")[0]["path"] == \
        "torch:fused_head_reference"
    got, want = _logits(jcfg, tcfg, jp, tp, x, **enc)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


L0_REF = "torch:fused_layer0_reference"
LOOP = [  # name, config, encoding, layer 0's path
    # Two hidden layers take the two-layer pair (ops/fused2.py).
    ("deep-alif", dict(hidden_layer_type="ALIF", n_hidden_neurons=[16, 12]),
     dict(tau=20.0), "torch:fused2_reference"),
    ("izhikevich", dict(hidden_layer_type="Izhikevich"), dict(tau=20.0),
     "torch:fused_izh_head_reference"),
    ("temporal-filter", dict(hidden_layer_type="ALIF",
                             readout_mth=jst.ReadoutMth.TEMPORAL_FILTER),
     dict(tau=20.0), L0_REF),
    # Raster input: the recurrent layer scans its currents in one call.
    ("not-timeseries", dict(hidden_layer_type="ALIF"),
     dict(as_timeseries=False), "torch:rec_scan_reference"),
    ("short-encoding", dict(hidden_layer_type="LIF", threshold=0.05),
     dict(n_steps=8, tau=20.0, use_periods=True), "torch:rec_scan_reference"),
    # The same for feedforward layers: the feedforward scan.
    ("ff-not-timeseries", dict(hidden_layer_type="ALIF",
                               use_recurrent_connection=False),
     dict(as_timeseries=False), "torch:scan_reference"),
    ("ff-short-encoding", dict(hidden_layer_type="LIF", threshold=0.05,
                               use_recurrent_connection=False),
     dict(n_steps=8, tau=20.0, use_periods=True), "torch:scan_reference"),
    # No hidden layer: the readout's currents come from the latencies.
    ("no-hidden", dict(hidden_layer_type="LIF", n_hidden_neurons=None),
     dict(tau=20.0), "torch:encode_matmul_reference"),
]


@pytest.mark.parametrize("name,ckw,ekw,path", LOOP,
                         ids=[s[0] for s in LOOP])
def test_loop_path_matches_jax(name, ckw, ekw, path):
    """Configs off the LIF/ALIF whole-network head: the Izhikevich head,
    the deep dispatch, the unfused tier (a recurrent or feedforward layer's
    scan over its currents, the first layer's currents from the latencies),
    or the loop for every layer the kernels do not cover."""
    jcfg, tcfg = _pair(int_time_steps=12, **ckw)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(1).random((4, 30)).astype(np.float32)
    enc = {"n_steps": 12, **ekw}
    assert tsnn.explain_dispatch(tcfg, tst.EncodeConfig(**enc),
                                 device="cpu")[0]["path"] == path
    got, want = _logits(jcfg, tcfg, jp, tp, x, **enc)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_flagship_width_matches_jax():
    """784 -> ALIF-128 recurrent (learn_beta) -> 10, T=100, B=8, at the
    serving encoding (TTFS, production tau)."""
    jcfg, tcfg = _pair(input_size=784, n_hidden_neurons=128,
                       hidden_layer_type="ALIF", learn_beta=True,
                       int_time_steps=100)
    jp, tp = _params(jcfg, seed=3)
    x = np.random.default_rng(2).random((8, 784)).astype(np.float32)
    got, want = _logits(jcfg, tcfg, jp, tp, x, n_steps=100)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_apply_hidden_states_match_jax():
    jcfg, tcfg = _pair(hidden_layer_type="ALIF", int_time_steps=10)
    jp, tp = _params(jcfg)
    x = (np.random.default_rng(3).random((3, 10, 30)) > 0.7).astype(
        np.float32)
    jtrace, jhid = jsnn.apply(jcfg, jp, x, return_hidden=True)
    ttrace, thid = tsnn.apply(tcfg, tp, x, return_hidden=True, device="cpu")
    np.testing.assert_allclose(ttrace.numpy(), np.asarray(jtrace),
                               atol=1e-5, rtol=1e-5)
    assert set(thid) == set(jhid)
    for name in jhid:
        for a, b in zip(thid[name], jhid[name]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
    np.testing.assert_allclose(
        tsnn.forward_logits(tcfg, tp, x, device="cpu").numpy(),
        np.asarray(jsnn.forward_logits(jcfg, jp, x)), atol=1e-5, rtol=1e-5)


def test_format_inputs():
    _, tcfg = _pair(int_time_steps=6)
    x = torch.ones((2, 4, 30))
    out = tsnn.format_inputs(tcfg, x)
    assert out.shape == (2, 6, 30) and float(out[:, 4:].abs().sum()) == 0
    assert tsnn.format_inputs(tcfg, torch.ones((2, 30))).shape == (2, 6, 30)
    with pytest.raises(ValueError, match="time steps"):
        tsnn.format_inputs(tcfg, torch.ones((2, 7, 30)))
    with pytest.raises(ValueError, match="batch"):
        tsnn.format_inputs(tcfg, torch.ones((1, 2, 3, 4)))


def test_params_from_jax_copies_values_and_dtypes():
    jcfg, _ = _pair(hidden_layer_type="ALIF", learn_beta=True)
    jp = jsnn.init(jcfg, jax.random.PRNGKey(1))
    jp["readout"]["w_in"] = jp["readout"]["w_in"].astype("bfloat16")
    tp = params_from_jax(jax.tree.map(np.asarray, jax.device_get(jp)),
                         device="cpu")
    assert set(tp) == set(jp)
    assert tp["readout"]["w_in"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["readout"]["w_in"].float().numpy(),
        np.asarray(jp["readout"]["w_in"].astype("float32")))
    assert tp["input"]["beta"].shape == ()
    np.testing.assert_array_equal(tp["input"]["w_rec"].numpy(),
                                  np.asarray(jp["input"]["w_rec"]))


def test_init_layout_matches_jax():
    jcfg, tcfg = _pair(hidden_layer_type="ALIF", learn_beta=True,
                       n_hidden_neurons=[16, 12])
    jp = jsnn.init(jcfg, jax.random.PRNGKey(0))
    tp = tsnn.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {n: {k: tuple(v.shape) for k, v in g.items()}
            for n, g in tp.items()} == \
        {n: {k: tuple(v.shape) for k, v in g.items()} for n, g in jp.items()}
    states = tsnn.init_state(tcfg, 3, device="cpu")
    assert [len(s) for s in states] == [3, 3, 1]


def test_layer_configs_match_jax():
    jcfg, tcfg = _pair(hidden_layer_type="ALIF", n_hidden_neurons=[16, 12],
                       tau_m=0.03, tau_a=0.5, beta=1.2, tau_out=0.02)
    for (jn, jl), (tn, tl) in zip(jcfg.layer_configs, tcfg.layer_configs):
        assert jn == tn and type(jl).__name__ == type(tl).__name__
        for attr in ("input_size", "output_size", "alpha", "rho", "kappa",
                     "beta", "threshold", "gamma"):
            assert getattr(jl, attr, None) == getattr(tl, attr, None)
    assert tcfg.matmul_dtype_eff == "float32"


ENTRY_POINTS = [
    ("init", lambda c, p: tsnn.init(c, torch.Generator())),
    ("init_state", lambda c, p: tsnn.init_state(c, 2)),
    ("apply", lambda c, p: tsnn.apply(c, p, np.zeros((2, 30), np.float32))),
    ("apply_pixels", lambda c, p: tsnn.apply_pixels(
        c, p, np.zeros((2, 30), np.float32), tst.EncodeConfig(n_steps=12))),
    ("forward_logits", lambda c, p: tsnn.forward_logits(
        c, p, np.zeros((2, 30), np.float32))),
    ("forward_logits_pixels", lambda c, p: tsnn.forward_logits_pixels(
        c, p, np.zeros((2, 30), np.float32), tst.EncodeConfig(n_steps=12))),
    ("explain_dispatch", lambda c, p: tsnn.explain_dispatch(c)),
    ("InferenceServer", lambda c, p: tst.InferenceServer(c, p)),
    ("params_from_jax", lambda c, p: params_from_jax(
        {"input": {"w_in": np.zeros((2, 2), np.float32)}})),
    ("ToSpikes", lambda c, p: tst.ToSpikes(12)),
]


@pytest.mark.parametrize("name,call", ENTRY_POINTS,
                         ids=[e[0] for e in ENTRY_POINTS])
def test_entry_points_raise_without_cuda(name, call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg = _pair(hidden_layer_type="ALIF", int_time_steps=12)
    tp = tsnn.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(tcfg, tp)


def test_fallback_is_logged_once_on_card_only(caplog, monkeypatch):
    """Gates log only for the card (as the JAX package logs only on a
    TPU); on the CPU the plain paths are the expected ones.  The gate here,
    float32 compute, is decided before any kernel is asked."""
    _, tcfg = _pair(hidden_layer_type="ALIF", int_time_steps=12,
                    compute_dtype="bfloat16")
    enc = tst.EncodeConfig(n_steps=12)
    with caplog.at_level("INFO"):
        assert not tsnn._head_fusible(tcfg, enc, torch.device("cpu"))
    assert not caplog.records
    monkeypatch.setattr(tsnn, "_fallback_logged", set())
    with caplog.at_level("INFO"):
        for _ in range(2):
            assert not tsnn._head_fusible(tcfg, enc, torch.device("cuda"))
    assert len(caplog.records) == 1
    assert "compute_dtype != float32" in caplog.records[0].getMessage()


def test_use_kernels_false_takes_the_loop():
    """``use_kernels=False`` (the JAX package's ``use_pallas=False``)
    routes a head-fusible config through the time loop, same logits."""
    jcfg, tcfg = _pair(hidden_layer_type="ALIF", int_time_steps=12)
    loop_cfg = tst.SNNConfig(**{**tcfg.__dict__, "use_kernels": False})
    jp, tp = _params(jcfg)
    x = np.random.default_rng(4).random((4, 30)).astype(np.float32)
    enc = tst.EncodeConfig(n_steps=12, tau=20.0)
    assert tsnn.explain_dispatch(loop_cfg, enc, device="cpu") == [
        {"layer": name, "path": "torch:loop", "reason": "use_kernels=False"}
        for name in ("input", "readout")]
    got = tsnn.forward_logits_pixels(loop_cfg, tp, x, enc, device="cpu")
    want = tsnn.forward_logits_pixels(tcfg, tp, x, enc, device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
