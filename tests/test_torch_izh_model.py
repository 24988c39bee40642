"""Izhikevich networks through the port's dispatch on the CPU -- the whole
network as one head call (``fused_encode_izh_scan_head``), or layer 0 as one
encode + scan call and a further layer as one ``izh_scan`` call on its
currents, all through their plain PyTorch versions -- against the JAX
package's composition of the same layers on identical numpy parameters and
inputs.

Sizes: 30 -> 16 (-> 12) -> 10, B = 6, dt = 30 with the init weights, where
about a third of the unit-steps fire (at the default dt = 1e-3 no unit
fires at the init scale).  At dt = 30 the cell is unstable between spikes:
a last-bit difference of v grows about threefold a step until a reset
erases it.  JAX's jitted step multiplies by a folded dt/C where the port
divides, so the two part after about 20 silent steps (at T = 24 one spike
in 4000 flips and the logits part by 1.3 of 16); T = 16 keeps them
together: logits and losses within 1e-5, parameters after three Trainer
steps within 1e-4 of max|p| (bfloat16
matmul operands: 2e-3, as tests/test_torch_train.py).  One case runs the
full width, 784 -> 128 -> 10 at T = 100 and B = 256, to compare how much of
each layer one Adam step moves in the two trainers.
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

B, F, O, T, DT = 6, 30, 10, 16, 30.0
HEAD = "torch:fused_izh_head_reference"
L0, SCAN = "torch:fused_izh_layer0_reference", "torch:izh_scan_reference"

CONFIGS = [  # name, config, encoding
    ("izh-rec-ttfs", dict(n_hidden_neurons=16), dict()),
    ("izh-rec-periodic", dict(n_hidden_neurons=16), dict(use_periods=True)),
    ("izh-ff-phi", dict(n_hidden_neurons=16, use_recurrent_connection=False,
                        spike_func="Phi"), dict()),
    ("izh-rec-bf16", dict(n_hidden_neurons=16, matmul_dtype="bfloat16"),
     dict()),
    ("izh-deep-ttfs", dict(n_hidden_neurons=[16, 12]), dict()),
    ("izh-deep-periodic", dict(n_hidden_neurons=[16, 12]),
     dict(use_periods=True)),
]
IDS = [c[0] for c in CONFIGS]


def _pair(**kw):
    kw = {**dict(input_size=F, output_size=O, int_time_steps=T, dt=DT,
                 hidden_layer_type="Izhikevich"), **kw}
    return jst.SNNConfig(**kw), tst.SNNConfig(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _params(jcfg, seed=0):
    jp = jsnn.init(jcfg, jax.random.PRNGKey(seed))
    return jp, _np_tree(jp)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((B, F)).astype(np.float32),
             rng.integers(0, O, B).astype(np.int32)) for _ in range(n)]


def _expected_paths(tcfg):
    if len(tcfg.layer_configs) == 2:
        return [HEAD]
    return [L0] + [SCAN] * (len(tcfg.layer_configs) - 2) + ["torch:loop"]


@pytest.mark.parametrize("name,ckw,ekw", CONFIGS, ids=IDS)
def test_izh_forward_logits_match_jax(name, ckw, ekw):
    jcfg, tcfg = _pair(**ckw)
    jp, np_p = _params(jcfg)
    tp = params_from_jax(np_p, device="cpu")
    x = _batches(1, seed=5)[0][0]
    enc = dict(n_steps=T, tau=20.0, **ekw)
    tenc = tst.EncodeConfig(**enc)
    for training in (False, True):
        rows = tsnn.explain_dispatch(tcfg, tenc, device="cpu",
                                     training=training)
        assert [r["path"] for r in rows] == _expected_paths(tcfg)
    tfused.reset_launch_counts()
    with torch.no_grad():
        tl = tsnn.forward_logits_pixels(tcfg, tp, x, tenc, device="cpu")
        tl2, tc = tsnn.forward_logits_counts_pixels(tcfg, tp, x, tenc,
                                                    device="cpu")
        _, hidden = tsnn.apply_pixels(tcfg, tp, x, tenc, return_hidden=True,
                                      device="cpu")
    assert not any(tfused.launch_counts().values())  # no kernel on the CPU
    jl = jsnn.forward_logits_pixels(jcfg, jp, x, JEnc(**enc))
    jl2, jc = jsnn.forward_logits_counts_pixels(jcfg, jp, x, JEnc(**enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(tl.numpy().argmax(1),
                                  np.asarray(jl).argmax(1))
    assert torch.equal(tl, tl2)
    # The reference counts LIF/ALIF layers only (snn.py:268): none here,
    # and the head keeps its kernel.
    assert tc == {} and jc == {}
    for layer, _ in tcfg.layer_configs[:-1]:  # (v, u, z) traces
        rate = float(hidden[layer][2].mean())
        assert 0.05 < rate < 0.95, f"{layer} fires on {rate:.3f}"


@pytest.mark.parametrize("name,ckw,ekw", CONFIGS, ids=IDS)
def test_izh_train_steps_match_the_jax_trainer(name, ckw, ekw, tmp_path):
    jcfg, tcfg = _pair(**ckw)
    jp, np_p = _params(jcfg)
    enc = dict(n_steps=T, tau=20.0, **ekw)
    jt = jtrainer.Trainer(jcfg, checkpoint_folder=str(tmp_path))
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp))
    train_step = jt._build_steps(JEnc(**enc), tx)[0]
    opt_state = tx.init(jp)
    tt = ttrainer.Trainer(tcfg, params=params_from_jax(np_p, device="cpu"),
                          encode_config=tst.EncodeConfig(**enc),
                          device="cpu")
    w = np.ones(B, np.float32)
    w[-1] = 0.0  # a padding row
    p_tol = 2e-3 if ckw.get("matmul_dtype") == "bfloat16" else 1e-4
    for i, (x, y) in enumerate(_batches(3, seed=8)):
        jp, opt_state, jloss = train_step(jp, opt_state, jnp.asarray(x),
                                          jnp.asarray(y), jnp.asarray(w))
        tloss = tt.train_step(x, y, w)
        assert np.isfinite(float(tloss))
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {i}")
    want, got = _np_tree(jp), params_to_numpy(tt.params)
    for n in want:
        for k in want[n]:
            scale = np.abs(want[n][k]).max()
            np.testing.assert_allclose(got[n][k] / scale, want[n][k] / scale,
                                       atol=p_tol, rtol=0,
                                       err_msg=f"{name} {n}.{k}")
            assert not np.array_equal(got[n][k], np_p[n][k]), f"{n}.{k}"


def test_izh_dispatch_gradients_equal_autograd_through_the_loop():
    """The explicit backwards (the head's, and layer 0's with the scan's)
    against PyTorch autograd through the port's own per-step loop, float32,
    on the same CPU arithmetic: every leaf's gradient within 1e-4 of its
    max (the loop takes its currents from one product over all steps, the
    calls step by step, so their sums differ in the last bit and the cell
    amplifies it)."""
    for ckw in (CONFIGS[0][1], CONFIGS[4][1]):
        _, tcfg = _pair(**ckw)
        loop_cfg = tst.SNNConfig(**{**tcfg.__dict__, "use_kernels": False})
        _, np_p = _params(_pair(**ckw)[0], seed=1)
        enc = tst.EncodeConfig(n_steps=T, tau=20.0)
        x = _batches(1, seed=9)[0][0]
        r = torch.from_numpy(np.random.default_rng(10).standard_normal(
            (B, O)).astype(np.float32))
        grads = []
        for c in (tcfg, loop_cfg):
            params = {n: {k: v.requires_grad_(True) for k, v in g.items()}
                      for n, g in params_from_jax(np_p, device="cpu").items()}
            logits = tsnn.forward_logits_pixels(c, params, x, enc,
                                                device="cpu")
            (logits * r).sum().backward()
            grads.append({f"{n}.{k}": v.grad for n, g in params.items()
                          for k, v in g.items()})
        calls, loop = grads
        for k, want in loop.items():
            scale = float(want.abs().max())
            assert scale > 0, f"{k}: no gradient reaches this leaf"
            np.testing.assert_allclose(calls[k].numpy() / scale,
                                       want.numpy() / scale, atol=1e-4,
                                       rtol=0, err_msg=k)


def test_full_width_dt30_hidden_gradients_overflow_adam_in_both_trainers(
        tmp_path):
    """784 -> Izhikevich-128 recurrent -> 10 at T = 100, dt = 30, the
    trained configuration, B = 256: the hidden weights' BPTT gradients
    pass sqrt(float32 max) = 1.8e19 for most elements in the JAX trainer
    as in the port (the cell amplifies between spikes), Adam's second
    moment overflows there and the step of such a weight is 0, so after
    one step the readout has moved everywhere and the hidden weights almost
    nowhere, in optax as in torch.optim.Adam.  (The two part at T = 100,
    see the module docstring, so the shares are compared, not the
    values.  torch.optim.Adam forms (1 - b2) g g and overflows only past
    5.8e20, optax's (1 - b2) g**2 past 1.8e19, so the port moves more
    hidden weights than the JAX trainer.)"""
    B, T, big = 256, 100, float(np.sqrt(np.finfo(np.float32).max))
    jcfg, tcfg = _pair(input_size=784, n_hidden_neurons=128,
                       int_time_steps=T)
    jp, np_p = _params(jcfg)
    enc = dict(n_steps=T)
    jt = jtrainer.Trainer(jcfg, checkpoint_folder=str(tmp_path))
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp))
    tt = ttrainer.Trainer(tcfg, params=params_from_jax(np_p, device="cpu"),
                          encode_config=tst.EncodeConfig(**enc),
                          device="cpu")
    rng = np.random.default_rng(0)
    x = rng.random((B, 784)).astype(np.float32)
    y = rng.integers(0, O, B).astype(np.int32)
    w = np.ones(B, np.float32)
    jg = _np_tree(jax.grad(lambda p: jt.criterion(
        jsnn.forward_logits_pixels(jcfg, p, jnp.asarray(x), JEnc(**enc)),
        jnp.asarray(y), jnp.asarray(w)))(jp))
    tg = {n: {k: v.numpy() for k, v in g.items()}
          for n, g in tt.loss_and_grads(x, y, w)[1].items()}
    train_step = jt._build_steps(JEnc(**enc), tx)[0]
    jp, _, _ = train_step(jp, tx.init(jp), jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(w))
    tt.train_step(x, y, w)
    moved = {"jax": _np_tree(jp), "port": params_to_numpy(tt.params)}
    grads = {"jax": jg, "port": tg}
    for side in ("jax", "port"):
        for k in ("w_in", "b"):
            assert (moved[side]["readout"][k] != np_p["readout"][k]).all()
        for k in ("w_in", "w_rec"):
            g = np.abs(grads[side]["input"][k])
            share = float((moved[side]["input"][k]
                           != np_p["input"][k]).mean())
            print(f"{side} input.{k}: max|g| {g.max():.3g}, share of "
                  f"|g| > 1.8e19 {(g > big).mean():.4f}, share moved "
                  f"{share:.4f}")
            assert np.isfinite(g).all() and (g > big).mean() > 0.9
            assert share < 0.25, f"{side} input.{k} moved on {share:.3f}"
