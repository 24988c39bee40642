"""Feedforward LIF/ALIF layers on the feedforward scan through the port's
dispatch on the CPU, against the JAX package on identical numpy parameters
and inputs.

A feedforward layer whose currents come from a product scans them in one
call (``{alif,lif}_scan``; on the CPU their plain versions): constant-pixel
input (``EncodeConfig(as_timeseries=False)``, the pixels repeated over T),
a spike raster through ``forward_logits`` (the reference's
``SNN.forward``), an encoding shorter than the simulation, and any layer
the fused kernels do not take (forced here, as tests/test_torch_wide.py
forces it, by monkeypatching the fused gates of ``models/snn.py`` to
False).  The JAX side runs its own CPU path (a ``lax.scan`` per layer).

Sizes: F = 24, hidden 12-40, O = 4, T = 24, B = 6; the first layer's
weights scaled up (as tests/test_torch_wide.py) so that every hidden layer
spikes.  Logits and losses within 1e-5, spike counts bitwise, parameters
after three Trainer steps within 1e-5 of max|p| (bfloat16 operands: 1e-4;
the products of bf16 values are exact in float32 on both sides, the sums
in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import snnimageclassification_tpu as jst  # noqa: E402
from snnimageclassification_tpu.data.datasets import (  # noqa: E402
    EncodeConfig as JEnc,
)
from snnimageclassification_tpu.models import snn as jsnn  # noqa: E402
from snnimageclassification_tpu.train import trainer as jtrainer  # noqa: E402
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
    params_to_numpy,
)
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.train import trainer as ttrainer  # noqa: E402

B, F, O, T = 6, 24, 4, 24
SCAN, ENC, LOOP = ("torch:scan_reference", "torch:encode_matmul_reference",
                   "torch:loop")
CONST = dict(as_timeseries=False)
# name, hidden widths, config, encoding, expected paths
CONFIGS = [
    ("alif-40-const", 40, dict(hidden_layer_type="ALIF"), CONST,
     [SCAN, LOOP]),
    ("lif-20-const", 20, dict(hidden_layer_type="LIF", threshold=0.05),
     CONST, [SCAN, LOOP]),
    ("alif-phi-40-const-bf16", 40, dict(hidden_layer_type="ALIF",
                                        spike_func="Phi",
                                        matmul_dtype="bfloat16"),
     CONST, [SCAN, LOOP]),
    ("lif-20-short", 20, dict(hidden_layer_type="LIF", threshold=0.05),
     dict(n_steps=T // 2, tau=20.0, use_periods=True), [SCAN, LOOP]),
    # Layer 0 scans, the last hidden layer and the readout are one mid-head
    # call (as in the JAX package, whose CPU path scans both).
    ("alif-12-40-const", [12, 40], dict(hidden_layer_type="ALIF"), CONST,
     [SCAN, "torch:fused_mid_reference[head]"]),
]
IDS = [c[0] for c in CONFIGS]
TRAIN = CONFIGS[:3]


@pytest.fixture
def unfused(monkeypatch):
    """Every fused gate says no, as for a layer past their limits."""
    for gate in ("_head_fusible", "_layer0_fusible", "_twolayer_head_fusible",
                 "_deep_head_fusible", "_mid_layer_fusible"):
        monkeypatch.setattr(tsnn, gate, lambda *a, **k: False)


def _pair(widths, ckw):
    kw = dict(input_size=F, output_size=O, int_time_steps=T,
              n_hidden_neurons=widths, use_recurrent_connection=False, **ckw)
    return jst.SNNConfig(**kw), tst.SNNConfig(**kw)


def _params(jcfg, seed=0):
    jp = jsnn.init(jcfg, jax.random.PRNGKey(seed))
    for i, (name, _) in enumerate(jcfg.layer_configs[:-1]):
        jp[name]["w_in"] = jp[name]["w_in"] * (8.0 if i == 0 else 3.0)
    return jp, jax.tree.map(np.asarray, jax.device_get(jp))


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((B, F)).astype(np.float32),
             rng.integers(0, O, B).astype(np.int32)) for _ in range(n)]


def _bar(ckw):
    return 1e-4 if ckw.get("matmul_dtype") == "bfloat16" else 1e-5


def _paths(tcfg, enc, training=False):
    return [r["path"] for r in tsnn.explain_dispatch(
        tcfg, enc, device="cpu", training=training)]


@pytest.mark.parametrize("name,widths,ckw,ekw,paths", CONFIGS, ids=IDS)
def test_ff_logits_and_counts_match_jax(name, widths, ckw, ekw, paths):
    jcfg, tcfg = _pair(widths, ckw)
    jp, np_p = _params(jcfg)
    enc = {"n_steps": T, "tau": 20.0, **ekw}
    tenc = tst.EncodeConfig(**enc)
    assert _paths(tcfg, tenc) == paths
    x = _batches(1, seed=5)[0][0]
    tp = params_from_jax(np_p, device="cpu")
    tfused.reset_launch_counts()
    with torch.no_grad():
        tl, tc = tsnn.forward_logits_counts_pixels(tcfg, tp, x, tenc,
                                                   device="cpu")
    assert not any(tfused.launch_counts().values())  # no kernel on the CPU
    jl, jc = jsnn.forward_logits_counts_pixels(jcfg, jp, x, JEnc(**enc))
    bar = _bar(ckw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=bar,
                               rtol=bar)
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        assert float(tc[k].sum()) > 0, f"{k} does not spike"


@pytest.mark.parametrize("widths", [40, [12, 40]], ids=["one", "two"])
def test_ff_raster_forward_logits_match_jax(widths):
    """``forward_logits`` on a spike raster ``(B, T, F)``: the first layer's
    currents are one product on the raster, then the scan (a second layer
    is a mid call)."""
    jcfg, tcfg = _pair(widths, dict(hidden_layer_type="ALIF"))
    jp, np_p = _params(jcfg)
    assert _paths(tcfg, None)[0] == SCAN
    x = (np.random.default_rng(6).random((B, T, F)) < 0.3).astype(np.float32)
    got = tsnn.forward_logits(tcfg, params_from_jax(np_p, device="cpu"), x,
                              device="cpu")
    want = jsnn.forward_logits(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_ff_two_layers_on_the_unfused_tier_match_jax(unfused):
    """A two-layer feedforward network the fused kernels do not take:
    layer 0's currents from the latencies (``encode_matmul``), layer 1's
    from one product, both scanned; TTFS and periodic."""
    jcfg, tcfg = _pair([16, 40], dict(hidden_layer_type="LIF",
                                      threshold=0.05))
    jp, np_p = _params(jcfg)
    tp = params_from_jax(np_p, device="cpu")
    x = _batches(1, seed=7)[0][0]
    for per in (False, True):
        enc = dict(n_steps=T, tau=20.0, use_periods=per)
        assert _paths(tcfg, tst.EncodeConfig(**enc)) == [ENC, SCAN, SCAN,
                                                          LOOP]
        with torch.no_grad():
            tl, tc = tsnn.forward_logits_counts_pixels(
                tcfg, tp, x, tst.EncodeConfig(**enc), device="cpu")
        jl, jc = jsnn.forward_logits_counts_pixels(jcfg, jp, x, JEnc(**enc))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        for k in jc:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
            assert float(tc[k].sum()) > 0, f"{k} does not spike"


@pytest.mark.parametrize("name,widths,ckw,ekw,paths", TRAIN,
                         ids=[c[0] for c in TRAIN])
def test_ff_train_steps_match_the_jax_trainer(name, widths, ckw, ekw, paths,
                                              tmp_path):
    jcfg, tcfg = _pair(widths, ckw)
    jp, np_p = _params(jcfg)
    enc = {"n_steps": T, "tau": 20.0, **ekw}
    jt = jtrainer.Trainer(jcfg, checkpoint_folder=str(tmp_path))
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp))
    train_step = jt._build_steps(JEnc(**enc), tx)[0]
    opt_state = tx.init(jp)
    tt = ttrainer.Trainer(tcfg, params=params_from_jax(np_p, device="cpu"),
                          encode_config=tst.EncodeConfig(**enc),
                          device="cpu")
    assert _paths(tcfg, tt.enc, training=True) == paths
    w = np.ones(B, np.float32)
    w[-1] = 0.0  # a padding row
    bar = _bar(ckw)
    for i, (x, y) in enumerate(_batches(3, seed=8)):
        jp, opt_state, jloss = train_step(jp, opt_state, jnp.asarray(x),
                                          jnp.asarray(y), jnp.asarray(w))
        tloss = tt.train_step(x, y, w)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=bar,
                                   rtol=bar, err_msg=f"step {i}")
    want = jax.tree.map(np.asarray, jax.device_get(jp))
    got = params_to_numpy(tt.params)
    for n in want:
        for k in want[n]:
            scale = np.abs(want[n][k]).max()
            np.testing.assert_allclose(got[n][k] / scale, want[n][k] / scale,
                                       atol=bar, rtol=0,
                                       err_msg=f"{name} {n}.{k}")
            assert not np.array_equal(got[n][k], np_p[n][k]), f"{n}.{k}"
