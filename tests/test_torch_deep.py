"""Deep networks (two and three hidden layers) through the port's
dispatch on the CPU -- two hidden layers as one call of the two-layer pair,
three as layer 0 in one encode + scan call, further layers as mid calls,
the last hidden layer with the readout as one mid-head call, all through
their plain PyTorch versions -- against the JAX package's composition of the
same layers on identical numpy parameters and inputs.

Sizes: 30 -> 16 -> 12 (-> 10) -> 10, T = 24, B = 6.  Tolerances as in
tests/test_torch_train.py: logits and losses 1e-5, spike counts equal,
parameters after five steps 1e-5 of max|p| (bfloat16 matmul operands:
three steps, 2e-3), beta of every layer bitwise.
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
from snnimageclassification_tpu.train import losses as jlosses  # noqa: E402
from snnimageclassification_tpu.train import trainer as jtrainer  # noqa: E402
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
    params_to_numpy,
)
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.train import losses as tlosses  # noqa: E402
from snnimageclassification_tpu_torch.train import trainer as ttrainer  # noqa: E402

B, F, O, T = 6, 30, 10, 24
L0, MID, MID_HEAD = ("torch:fused_layer0_reference",
                     "torch:fused_mid_reference",
                     "torch:fused_mid_reference[head]")
FUSED2 = "torch:fused2_reference"

CONFIGS = [  # name, config, encoding
    ("alif-rec-2", dict(hidden_layer_type="ALIF", learn_beta=True,
                        n_hidden_neurons=[16, 12]), dict()),
    ("alif-rec-3", dict(hidden_layer_type="ALIF", learn_beta=True,
                        n_hidden_neurons=[16, 12, 10]), dict()),
    ("lif-ff-3-periodic", dict(hidden_layer_type="LIF",
                               use_recurrent_connection=False,
                               n_hidden_neurons=[16, 12, 10]),
     dict(use_periods=True)),
    ("alif-rec-3-phi", dict(hidden_layer_type="ALIF", spike_func="Phi",
                            n_hidden_neurons=[16, 12, 10]), dict()),
    ("alif-rec-3-bf16", dict(hidden_layer_type="ALIF", learn_beta=True,
                             n_hidden_neurons=[16, 12, 10],
                             matmul_dtype="bfloat16"), dict()),
]
IDS = [c[0] for c in CONFIGS]


def _pair(**kw):
    kw = {**dict(input_size=F, output_size=O, int_time_steps=T), **kw}
    return jst.SNNConfig(**kw), tst.SNNConfig(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _params(jcfg, seed=0):
    """JAX-initialised params with every hidden layer's input weights
    scaled up so that the small network spikes down to its last layer."""
    jp = jsnn.init(jcfg, jax.random.PRNGKey(seed))
    for i, (name, _) in enumerate(jcfg.layer_configs[:-1]):
        jp[name]["w_in"] = jp[name]["w_in"] * (8.0 if i == 0 else 3.0)
    return jp, _np_tree(jp)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((B, F)).astype(np.float32),
             rng.integers(0, O, B).astype(np.int32)) for _ in range(n)]


def _expected_paths(tcfg):
    n_hidden = len(tcfg.layer_configs) - 1
    if n_hidden == 2:  # one call of the two-layer pair
        return [FUSED2]
    return [L0] + [MID] * (n_hidden - 2) + [MID_HEAD]


@pytest.mark.parametrize("name,ckw,ekw", CONFIGS, ids=IDS)
def test_deep_forward_logits_and_counts_match_jax(name, ckw, ekw):
    jcfg, tcfg = _pair(**ckw)
    jp, np_p = _params(jcfg)
    tp = params_from_jax(np_p, device="cpu")
    x = _batches(1, seed=5)[0][0]
    enc = dict(n_steps=T, tau=20.0, **ekw)
    rows = tsnn.explain_dispatch(tcfg, tst.EncodeConfig(**enc), device="cpu")
    assert [r["path"] for r in rows] == _expected_paths(tcfg)
    tfused.reset_launch_counts()
    with torch.no_grad():
        tl = tsnn.forward_logits_pixels(tcfg, tp, x, tst.EncodeConfig(**enc),
                                        device="cpu")
        tl2, tc = tsnn.forward_logits_counts_pixels(
            tcfg, tp, x, tst.EncodeConfig(**enc), device="cpu")
    assert not any(tfused.launch_counts().values())  # no kernel on the CPU
    jl = jsnn.forward_logits_pixels(jcfg, jp, x, JEnc(**enc))
    jl2, jc = jsnn.forward_logits_counts_pixels(jcfg, jp, x, JEnc(**enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(tl.numpy().argmax(1),
                                  np.asarray(jl).argmax(1))
    assert torch.equal(tl, tl2)  # the counts variant changes no logit
    assert set(tc) == set(jc) == {n for n, _ in tcfg.layer_configs[:-1]}
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    assert float(tc[tcfg.layer_configs[-2][0]].sum()) > 0  # it spikes
    # The loop path of the port (no kernel, no plain version) agrees too.
    loop_cfg = tst.SNNConfig(**{**tcfg.__dict__, "use_kernels": False})
    with torch.no_grad():
        ll = tsnn.forward_logits_pixels(loop_cfg, tp, x,
                                        tst.EncodeConfig(**enc), device="cpu")
    np.testing.assert_allclose(ll.numpy(), tl.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,ckw,ekw", CONFIGS[:4], ids=IDS[:4])
def test_deep_dispatch_gradients_equal_autograd_through_the_loop(name, ckw,
                                                                 ekw):
    """The chained explicit backwards (three ``autograd.Function``s) against
    PyTorch autograd through the per-step loop, float32: every weight's
    gradient within 2e-6 of its max (2e-5 with Phi), beta's zero."""
    _, tcfg = _pair(**ckw)
    loop_cfg = tst.SNNConfig(**{**tcfg.__dict__, "use_kernels": False})
    _, np_p = _params(_pair(**ckw)[0], seed=1)
    enc = tst.EncodeConfig(n_steps=T, tau=20.0, **ekw)
    x = _batches(1, seed=9)[0][0]
    r = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (B, O)).astype(np.float32))
    grads = []
    for c in (tcfg, loop_cfg):
        params = {n: {k: v.requires_grad_(True) for k, v in g.items()}
                  for n, g in params_from_jax(np_p, device="cpu").items()}
        logits, counts = tsnn.forward_logits_counts_pixels(c, params, x, enc,
                                                           device="cpu")
        reg = sum((v ** 2).sum() for v in counts.values())
        ((logits * r).sum() + 1e-3 * reg).backward()
        grads.append({f"{n}.{k}": v.grad for n, g in params.items()
                      for k, v in g.items()})
    deep, loop = grads
    bar = 2e-5 if "phi" in name else 2e-6
    for k, want in loop.items():
        if k.endswith("beta"):
            assert float(deep[k]) == 0.0 and float(want) == 0.0
            continue
        scale = max(float(want.abs().max()), 1e-12)
        assert scale > 1e-9, f"{k}: no gradient reaches this leaf"
        np.testing.assert_allclose(deep[k].numpy() / scale,
                                   want.numpy() / scale, atol=bar, rtol=0,
                                   err_msg=f"{name} {k}")


STEP_CASES = [  # name, config index, regularizer
    ("alif-rec-2", 0, None),
    ("alif-rec-2-l2counts", 0, "L2SpikesPerNeuron"),
    ("alif-rec-3", 1, None),
    ("alif-rec-3-l2counts", 1, "L2SpikesPerNeuron"),
    ("lif-ff-3-periodic", 2, None),
    ("alif-rec-3-bf16", 4, None),
]


@pytest.mark.parametrize("name,idx,reg", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_deep_train_steps_match_the_jax_trainer(name, idx, reg, tmp_path):
    _, ckw, ekw = CONFIGS[idx]
    jcfg, tcfg = _pair(**ckw)
    jp, np_p = _params(jcfg)
    enc = dict(n_steps=T, tau=20.0, **ekw)
    jreg = None if reg is None else getattr(jlosses, reg)(scale=1e-4)
    treg = None if reg is None else getattr(tlosses, reg)(scale=1e-4)
    jt = jtrainer.Trainer(jcfg, checkpoint_folder=str(tmp_path), reg_fn=jreg)
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp))
    train_step = jt._build_steps(JEnc(**enc), tx)[0]
    opt_state = tx.init(jp)
    tt = ttrainer.Trainer(tcfg, params=params_from_jax(np_p, device="cpu"),
                          reg_fn=treg, encode_config=tst.EncodeConfig(**enc),
                          device="cpu")
    rows = tsnn.explain_dispatch(tcfg, tt.enc, device="cpu", training=True)
    assert [r["path"] for r in rows] == _expected_paths(tcfg)
    w = np.ones(B, np.float32)
    w[-2:] = 0.0  # padding rows
    bf16 = ckw.get("matmul_dtype") == "bfloat16"
    # bfloat16 operands: three steps, as tests/test_torch_train.py, and
    # 2e-3 of max|p|: Adam's step is the gradient over its running scale,
    # so an element whose bfloat16 gradient came out one rounding apart
    # moves up to a learning rate (1e-3) further in a step; with three
    # layers one element in 256 reaches 1.7e-3 (the losses still agree to
    # 1e-5 at every step).
    p_tol, n_steps = (2e-3, 3) if bf16 else (1e-5, 5)
    for i, (x, y) in enumerate(_batches(n_steps, seed=8)):
        jp, opt_state, jloss = train_step(jp, opt_state, jnp.asarray(x),
                                          jnp.asarray(y), jnp.asarray(w))
        tloss = tt.train_step(x, y, w)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {i}")
    want, got = _np_tree(jp), params_to_numpy(tt.params)
    for n in want:
        for k in want[n]:
            if k == "beta":  # frozen in every layer, bit for bit
                np.testing.assert_array_equal(got[n][k], np_p[n][k])
                np.testing.assert_array_equal(want[n][k], np_p[n][k])
                continue
            scale = np.abs(want[n][k]).max()
            np.testing.assert_allclose(got[n][k] / scale, want[n][k] / scale,
                                       atol=p_tol, rtol=0,
                                       err_msg=f"{name} {n}.{k}")
            assert not np.array_equal(got[n][k], np_p[n][k]), f"{n}.{k}"
    labels = tsnn.param_labels(tcfg, tt.params)
    assert all(labels[n].get("beta", "beta") == "beta" for n in labels)


def _rows(cfg, enc=None, **kw):
    return [(r["layer"], r["path"])
            for r in tsnn.explain_dispatch(cfg, enc, device="cpu", **kw)]


def test_deep_explain_dispatch_rows():
    enc = tst.EncodeConfig(n_steps=T)
    two = tst.SNNConfig(input_size=F, output_size=O, int_time_steps=T,
                        hidden_layer_type="ALIF", n_hidden_neurons=[16, 12])
    three = tst.SNNConfig(input_size=F, output_size=O, int_time_steps=T,
                          hidden_layer_type="LIF",
                          n_hidden_neurons=[16, 12, 10])
    n2 = [n for n, _ in two.layer_configs]
    n3 = [n for n, _ in three.layer_configs]
    assert _rows(two, enc) == [(tuple(n2), FUSED2)]
    assert _rows(two, enc, training=True) == [(tuple(n2), FUSED2)]
    assert _rows(three, enc, training=True) == [
        (n3[0], L0), (n3[1], MID), ((n3[2], n3[3]), MID_HEAD)]
    note = tsnn.explain_dispatch(two, enc, device="cpu")[-1]["reason"]
    assert "encode + both hidden scans + readout + max in one call" in note
    assert "BPTT" in tsnn.explain_dispatch(three, enc, device="cpu",
                                           training=True)[1]["reason"]
    # apply() without an encoding: the first layer scans its currents (one
    # product on the raster) in one call, the rest are mid calls, the
    # readout loops.
    rec = "torch:rec_scan_reference"
    assert _rows(three) == [(n3[0], rec), (n3[1], MID), (n3[2], MID),
                            (n3[3], "torch:loop")]
    # An encoding shorter than the simulation: layer 0 scans its raster
    # currents, the rest hold.
    short = tst.EncodeConfig(n_steps=T // 2)
    assert _rows(three, short) == [(n3[0], rec), (n3[1], MID),
                                   ((n3[2], n3[3]), MID_HEAD)]
    # A temporal-filter readout has no head: every hidden layer is a call
    # of its own and the readout loops.
    filt = tst.SNNConfig(**{**three.__dict__,
                            "readout_mth": tst.ReadoutMth.TEMPORAL_FILTER})
    assert _rows(filt, enc) == [(n3[0], L0), (n3[1], MID), (n3[2], MID),
                                (n3[3], "torch:loop")]
    # Izhikevich layers take the encoded first-layer call and one scan call
    # a layer after it (no mid head: the readout loops); use_kernels=False
    # takes the loop everywhere.
    izh = tst.SNNConfig(**{**three.__dict__,
                           "hidden_layer_type": tst.LayerType.Izhikevich})
    off = tst.SNNConfig(**{**three.__dict__, "use_kernels": False})
    assert [p for _, p in _rows(izh, enc)] == [
        "torch:fused_izh_layer0_reference", "torch:izh_scan_reference",
        "torch:izh_scan_reference", "torch:loop"]
    assert [p for _, p in _rows(off, enc)] == ["torch:loop"] * 4


def test_params_round_trip_on_a_deep_config():
    jcfg, tcfg = _pair(**CONFIGS[1][1])
    _, np_p = _params(jcfg)
    tp = params_from_jax(np_p, device="cpu")
    assert set(tp) == {n for n, _ in tcfg.layer_configs}  # jax sorts keys
    own = tsnn.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert {n: set(g) for n, g in tp.items()} == {
        n: set(g) for n, g in own.items()}
    back = params_to_numpy(tp)
    for n in np_p:
        for k in np_p[n]:
            assert tuple(tp[n][k].shape) == tuple(own[n][k].shape)
            np.testing.assert_array_equal(back[n][k], np_p[n][k])


def test_apply_first_layer_output_and_upto():
    """``apply(first_layer_output=z0)`` continues from layer 0's trace and
    ``_upto`` stops at a trunk layer with the time-major trace."""
    _, tcfg = _pair(**CONFIGS[1][1])
    _, np_p = _params(_pair(**CONFIGS[1][1])[0])
    tp = params_from_jax(np_p, device="cpu")
    x = _batches(1, seed=3)[0][0]
    enc = tst.EncodeConfig(n_steps=T, tau=20.0)
    with torch.no_grad():
        z0 = tsnn.apply_pixels(tcfg, tp, x, enc, _upto=0, device="cpu")
        z1, counts = tsnn.apply_pixels(tcfg, tp, x, enc, _upto=1,
                                       return_spike_counts=True, device="cpu")
        trace, _ = tsnn.apply_pixels(tcfg, tp, x, enc, device="cpu")
        again, _ = tsnn.apply(tcfg, tp, None, first_layer_output=z0,
                              device="cpu")
        direct = tsnn.forward_logits_pixels(tcfg, tp, x, enc, device="cpu")
    names = [n for n, _ in tcfg.layer_configs]
    assert tuple(z0.shape) == (T, B, 16) and tuple(z1.shape) == (T, B, 12)
    assert set(counts) == set(names[:2])
    assert torch.equal(counts[names[0]], z0.sum(0))
    assert torch.equal(trace, again)
    np.testing.assert_allclose(tsnn.prediction_logits(tcfg, trace).numpy(),
                               direct.numpy(), atol=1e-5, rtol=1e-5)
