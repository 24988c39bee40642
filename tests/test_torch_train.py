"""The port's training slice against the JAX package's on the CPU, at a
small size (30-20-10, T=12, B=16): the loss, the spike regularizers, the
count-emitting forward, the masked Adam, and five whole training steps
from the same parameters on the same batches.

Tolerances: losses 1e-5 and parameters 1e-5 of max|p| over five steps
(float32 sums in another order; Adam divides by sqrt(v)), with bf16 matmul
operands 1e-3 of max|p| over three; the optimizer alone on identical
gradients 1e-6; beta bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

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
    adam_state_from_optax,
    adam_state_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from snnimageclassification_tpu_torch.train import losses as tlosses  # noqa: E402
from snnimageclassification_tpu_torch.train import trainer as ttrainer  # noqa: E402

B, F, H, O, T = 16, 30, 20, 10, 12


def _pair(**kw):
    kw = {**dict(input_size=F, output_size=O, n_hidden_neurons=H,
                 int_time_steps=T), **kw}
    return jst.SNNConfig(**kw), tst.SNNConfig(**kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _params(jcfg, seed=0, scale=8.0):
    """JAX-initialised params with the input weights scaled up so that the
    small network spikes; as a JAX tree and as numpy."""
    jp = jsnn.init(jcfg, jax.random.PRNGKey(seed))
    jp["input"]["w_in"] = jp["input"]["w_in"] * scale
    return jp, _np_tree(jp)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((B, F)).astype(np.float32),
             rng.integers(0, O, B).astype(np.int32)) for _ in range(n)]


# ---------------------------------------------------------------------------
# nll_loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("weights", ["none", "ones", "padded", "all-zero"])
def test_nll_loss_matches_jax(weights):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((B, O))).astype(np.float32)
    y = rng.integers(0, O, B).astype(np.int32)
    w = {"none": None, "ones": np.ones(B, np.float32),
         "padded": (np.arange(B) < 11).astype(np.float32),
         "all-zero": np.zeros(B, np.float32)}[weights]
    want = jtrainer.nll_loss(jnp.asarray(logits), jnp.asarray(y),
                             None if w is None else jnp.asarray(w))
    got = ttrainer.nll_loss(torch.from_numpy(logits), torch.from_numpy(y),
                            None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)
    assert ttrainer.default_criterion is ttrainer.nll_loss


def test_nll_loss_gradient_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((B, O)).astype(np.float32)
    y = rng.integers(0, O, B).astype(np.int32)
    w = (np.arange(B) % 3 > 0).astype(np.float32)
    want = jax.grad(lambda l: jtrainer.nll_loss(l, jnp.asarray(y),
                                                jnp.asarray(w)))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    ttrainer.nll_loss(lt, torch.from_numpy(y), torch.from_numpy(w)).backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want), atol=1e-7)


# ---------------------------------------------------------------------------
# Regularizers
# ---------------------------------------------------------------------------
def _hidden(seed=3):
    rng = np.random.default_rng(seed)
    z = lambda *s: (rng.random(s) > 0.7).astype(np.float32)  # noqa: E731
    v = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"input": (v(B, T, H), v(B, T, H), z(B, T, H)),
            "hidden_0": (v(B, T, 8), z(B, T, 8)),
            "readout": (v(B, T, O),)}


REG_FNS = ["l1_total_spike_count", "l2_spikes_per_neuron",
           "mean_spike_count_per_neuron"]


@pytest.mark.parametrize("with_cfg", [False, True], ids=["nocfg", "cfg"])
@pytest.mark.parametrize("fn", REG_FNS)
def test_trace_regularizers_match_jax(fn, with_cfg):
    hid = _hidden()
    jcfg, tcfg = _pair(hidden_layer_type="ALIF", n_hidden_neurons=[H, 8])
    jh = {k: tuple(jnp.asarray(a) for a in v) for k, v in hid.items()}
    th = {k: tuple(torch.from_numpy(a) for a in v) for k, v in hid.items()}
    want = getattr(jlosses, fn)(jh, cfg=jcfg if with_cfg else None)
    got = getattr(tlosses, fn)(th, cfg=tcfg if with_cfg else None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(getattr(tlosses, fn)({"readout": th["readout"]})) == 0.0


@pytest.mark.parametrize("cls", ["L1TotalSpikeCount", "L2SpikesPerNeuron"])
def test_count_regularizers_match_jax_and_their_trace_form(cls):
    hid = _hidden(4)
    w = (np.arange(B) < 13).astype(np.float32)
    jreg, treg = getattr(jlosses, cls)(scale=1e-3), getattr(tlosses, cls)(
        scale=1e-3)
    assert treg.kind == jreg.kind
    counts = {k: hid[k][-1].sum(1) for k in ("input", "hidden_0")}
    want = jreg.from_counts({k: jnp.asarray(c) for k, c in counts.items()},
                            jnp.asarray(w))
    got = treg.from_counts({k: torch.from_numpy(c) for k, c in counts.items()},
                           torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    masked = {k: tuple(torch.from_numpy(a * w[:, None, None]) for a in v)
              for k, v in hid.items()}
    np.testing.assert_allclose(float(treg(masked)), float(got), rtol=1e-6)
    assert float(treg.from_counts({}, torch.from_numpy(w))) == 0.0


# ---------------------------------------------------------------------------
# param_labels, forward_logits_counts_pixels
# ---------------------------------------------------------------------------
def test_param_labels_match_jax():
    jcfg, tcfg = _pair(hidden_layer_type="ALIF", learn_beta=True,
                       n_hidden_neurons=[H, 8])
    jp, np_p = _params(jcfg)
    tp = params_from_jax(np_p, device="cpu")
    want = jsnn.param_labels(jcfg, jp)
    assert tsnn.param_labels(tcfg, tp) == want
    assert want["input"]["beta"] == "beta" and want["input"]["w_in"] == "weight"


COUNT_CFGS = [
    ("alif-rec-head", dict(hidden_layer_type="ALIF", learn_beta=True),
     dict(), "torch:fused_head_reference"),
    ("lif-ff-periodic-head", dict(hidden_layer_type="LIF", threshold=0.05,
                                  use_recurrent_connection=False),
     dict(use_periods=True), "torch:fused_head_reference"),
    # Two hidden layers: both layers' counts from the two-layer pair.
    ("deep-loop", dict(hidden_layer_type="ALIF", n_hidden_neurons=[H, 8]),
     dict(), "torch:fused2_reference"),
    # The Izhikevich head keeps its call and returns no counts (the
    # reference counts LIF/ALIF layers only).
    ("izhikevich-loop", dict(hidden_layer_type="Izhikevich"), dict(),
     "torch:fused_izh_head_reference"),
]


@pytest.mark.parametrize("name,ckw,ekw,path", COUNT_CFGS,
                         ids=[c[0] for c in COUNT_CFGS])
def test_forward_logits_counts_pixels_matches_jax(name, ckw, ekw, path):
    jcfg, tcfg = _pair(**ckw)
    jp, np_p = _params(jcfg)
    tp = params_from_jax(np_p, device="cpu")
    x = _batches(1, seed=5)[0][0]
    enc = dict(n_steps=T, tau=20.0, **ekw)
    assert tsnn.explain_dispatch(tcfg, tst.EncodeConfig(**enc), device="cpu",
                                 training=True)[0]["path"] == path
    jl, jc = jsnn.forward_logits_counts_pixels(jcfg, jp, x, JEnc(**enc))
    tl, tc = tsnn.forward_logits_counts_pixels(
        tcfg, tp, x, tst.EncodeConfig(**enc), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
    # apply(return_spike_counts=True) gives the same counts by the loop.
    _, _, loop_counts = tsnn.apply_pixels(
        tcfg, tp, x, tst.EncodeConfig(**enc), return_spike_counts=True,
        device="cpu")
    for k in jc:
        np.testing.assert_array_equal(loop_counts[k].numpy(),
                                      np.asarray(jc[k]))


def test_explain_dispatch_training_view():
    _, tcfg = _pair(hidden_layer_type="ALIF")
    enc = tst.EncodeConfig(n_steps=T)
    entry = tsnn.explain_dispatch(tcfg, enc, device="cpu", training=True)[0]
    assert entry["path"] == "torch:fused_head_reference"
    assert "reverse-time" in entry["reason"]
    assert "reverse-time" not in tsnn.explain_dispatch(
        tcfg, enc, device="cpu")[0]["reason"]


# ---------------------------------------------------------------------------
# The optimizer alone
# ---------------------------------------------------------------------------
def _adam_state(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _moments(tree):
    """optax moment tree -> numpy dict without the masked leaves."""
    return {name: {leaf: np.asarray(v) for leaf, v in group.items()
                   if hasattr(v, "shape")} for name, group in tree.items()}


def _random_grads(np_p, rng):
    return {n: {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
                for k, v in g.items()} for n, g in np_p.items()}


OPT_CASES = [("plain", {}), ("clip", dict(max_grad_norm=0.5)),
             ("accum", dict(grad_accum=2)),
             ("clip-accum", dict(max_grad_norm=0.5, grad_accum=3))]


@pytest.mark.parametrize("name,kw", OPT_CASES, ids=[c[0] for c in OPT_CASES])
def test_optimizer_matches_optax_on_identical_gradients(name, kw):
    """Six steps on the same random gradients: parameters within 1e-6
    (Adam's divisions round differently), beta bitwise untouched though
    its gradient is not zero here."""
    jcfg, tcfg = _pair(hidden_layer_type="ALIF", learn_beta=True)
    jp, np_p = _params(jcfg, scale=1.0)
    tp = {n: {k: v.requires_grad_(k != "beta") for k, v in g.items()}
          for n, g in params_from_jax(np_p, device="cpu").items()}
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp), lr=1e-2,
                                 weight_decay=1e-3, **kw)
    opt_state = tx.init(jp)
    topt = ttrainer.make_optimizer(tp, tsnn.param_labels(tcfg, tp), lr=1e-2,
                                   weight_decay=1e-3, **kw)
    rng = np.random.default_rng(6)
    for _ in range(6):
        g = _random_grads(np_p, rng)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step({n: {k: torch.as_tensor(v) for k, v in grp.items()}
                   for n, grp in g.items()})
    got, want = params_to_numpy(tp), _np_tree(jp)
    for n in want:
        for k in want[n]:
            np.testing.assert_allclose(got[n][k], want[n][k], atol=1e-6,
                                       rtol=0, err_msg=f"{n}.{k}")
    np.testing.assert_array_equal(got["input"]["beta"],
                                  np_p["input"]["beta"])


def test_optimizer_from_a_carried_optax_state():
    """Three optax steps, the Adam state carried across, three more steps
    on both: parameters and moments agree to 1e-6."""
    jcfg, tcfg = _pair(hidden_layer_type="ALIF", learn_beta=True)
    jp, np_p = _params(jcfg, scale=1.0)
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp))
    opt_state = tx.init(jp)
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = jax.tree.map(jnp.asarray, _random_grads(np_p, rng))
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
    adam = _adam_state(opt_state)
    tp = {n: {k: v.requires_grad_(k != "beta") for k, v in g.items()}
          for n, g in params_from_jax(_np_tree(jp), device="cpu").items()}
    topt = ttrainer.make_optimizer(tp, tsnn.param_labels(tcfg, tp))
    assert adam_state_to_numpy(topt)["count"] == 0
    adam_state_from_optax(topt, int(adam.count), _moments(adam.mu),
                          _moments(adam.nu))
    for _ in range(3):
        g = _random_grads(np_p, rng)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step({n: {k: torch.as_tensor(v) for k, v in grp.items()}
                   for n, grp in g.items()})
    adam = _adam_state(opt_state)
    state = adam_state_to_numpy(topt)
    assert state["count"] == int(adam.count) == 6
    want_p, got_p = _np_tree(jp), params_to_numpy(tp)
    for n, group in _moments(adam.mu).items():
        assert set(state["mu"][n]) == set(group)  # the "weight" leaves only
        for k in group:
            np.testing.assert_allclose(state["mu"][n][k], group[k],
                                       atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(
                state["nu"][n][k], _moments(adam.nu)[n][k], atol=1e-6,
                rtol=1e-6)
            np.testing.assert_allclose(got_p[n][k], want_p[n][k], atol=1e-6,
                                       rtol=0)


# ---------------------------------------------------------------------------
# Five training steps
# ---------------------------------------------------------------------------
STEP_CASES = [
    ("alif-rec-learnbeta", dict(hidden_layer_type="ALIF", learn_beta=True),
     dict(), None),
    ("alif-rec-learnbeta-l2counts",
     dict(hidden_layer_type="ALIF", learn_beta=True), dict(),
     "L2SpikesPerNeuron"),
    ("lif-ff-periodic-l1counts",
     dict(hidden_layer_type="LIF", threshold=0.05,
          use_recurrent_connection=False), dict(use_periods=True),
     "L1TotalSpikeCount"),
    ("alif-rec-trace-reg", dict(hidden_layer_type="ALIF", learn_beta=True),
     dict(), "l2_spikes_per_neuron"),
    ("alif-rec-bf16", dict(hidden_layer_type="ALIF", learn_beta=True,
                           matmul_dtype="bfloat16"), dict(), None),
]


def _reg(module, name):
    if name is None:
        return None
    obj = getattr(module, name)
    return obj(scale=1e-4) if isinstance(obj, type) else obj


@pytest.mark.parametrize("name,ckw,ekw,reg", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_five_train_steps_match_the_jax_trainer(name, ckw, ekw, reg,
                                                tmp_path):
    jcfg, tcfg = _pair(**ckw)
    jp, np_p = _params(jcfg)
    enc = dict(n_steps=T, tau=20.0, **ekw)
    jt = jtrainer.Trainer(jcfg, checkpoint_folder=str(tmp_path),
                          reg_fn=_reg(jlosses, reg))
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp))
    train_step = jt._build_steps(JEnc(**enc), tx)[0]
    opt_state = tx.init(jp)
    tt = ttrainer.Trainer(tcfg, params=params_from_jax(np_p, device="cpu"),
                          reg_fn=_reg(tlosses, reg),
                          encode_config=tst.EncodeConfig(**enc), device="cpu")
    w = np.ones(B, np.float32)
    w[-3:] = 0.0  # padding rows
    bf16 = ckw.get("matmul_dtype") == "bfloat16"
    # bf16 operands: both round the weights' gradients to bf16 (2**-8
    # relative) where their float32 sums differ in the last bits, so the
    # parameters drift apart faster (1e-3 of max|p|), and once a parameter
    # straddles a bf16 rounding boundary the two forwards part for good:
    # three steps are held, not five.
    p_tol, n_steps = (1e-3, 3) if bf16 else (1e-5, 5)
    loss_tol = 1e-5
    batches = _batches(n_steps, seed=8)
    for i, (x, y) in enumerate(batches):
        jp, opt_state, jloss = train_step(jp, opt_state, jnp.asarray(x),
                                          jnp.asarray(y), jnp.asarray(w))
        tloss = tt.train_step(x, y, w)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=loss_tol,
                                   rtol=loss_tol, err_msg=f"step {i}")
    want, got = _np_tree(jp), params_to_numpy(tt.params)
    changed = 0
    for n in want:
        for k in want[n]:
            scale = np.abs(want[n][k]).max()
            np.testing.assert_allclose(got[n][k] / scale, want[n][k] / scale,
                                       atol=p_tol, rtol=0,
                                       err_msg=f"{name} {n}.{k}")
            changed += int(not np.array_equal(got[n][k], np_p[n][k]))
    if "beta" in np_p["input"]:
        np.testing.assert_array_equal(got["input"]["beta"],
                                      np_p["input"]["beta"])
        np.testing.assert_array_equal(want["input"]["beta"],
                                      np_p["input"]["beta"])
        assert changed == sum(len(g) for g in want.values()) - 1
    # eval_step agrees on the last batch.
    x, y = batches[-1]
    jloss, jpreds = jt._build_steps(JEnc(**enc), tx)[1](
        jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    tloss, tpreds = tt.eval_step(x, y, w)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=10 * loss_tol,
                               rtol=10 * loss_tol)
    assert (tpreds.numpy() == np.asarray(jpreds)).mean() >= 0.9


# ---------------------------------------------------------------------------
# Trainer surface
# ---------------------------------------------------------------------------
def _task(n, seed=0):
    """10 class prototypes plus noise: learnable."""
    rng = np.random.default_rng(seed)
    protos = rng.random((O, F)).astype(np.float32)
    y = rng.integers(0, O, n).astype(np.int32)
    x = np.clip(protos[y] + 0.1 * rng.standard_normal((n, F)), 0, 1)
    return x.astype(np.float32), y


def test_fit_learns_and_reports_epoch_means():
    _, tcfg = _pair(hidden_layer_type="ALIF", learn_beta=True)
    x, y = _task(64)
    loader = [(x[i:i + B], y[i:i + B]) for i in range(0, 64, B)]
    tr = ttrainer.Trainer(tcfg, seed=0, lr=5e-3,
                          encode_config=tst.EncodeConfig(n_steps=T, tau=20.0),
                          device="cpu")
    tr.params["input"]["w_in"].data.mul_(8.0)
    beta0 = tr.params["input"]["beta"].clone()
    history = tr.fit(loader, nb_epochs=6)
    assert len(history) == 6 and all(np.isfinite(history))
    assert history[-1] < history[0]
    assert torch.equal(tr.params["input"]["beta"], beta0)
    acc = tr.compute_classification_accuracy(loader)
    assert 0.0 <= acc <= 1.0
    logits = tr.predict_logits(x[:7])
    assert logits.shape == (7, O) and not logits.requires_grad
    with pytest.raises(ValueError, match="no batch"):
        tr.fit([], nb_epochs=1)


def test_trainer_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tcfg = _pair(hidden_layer_type="ALIF")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.Trainer(tcfg)


def test_loss_and_grads_leave_the_parameters_alone():
    _, tcfg = _pair(hidden_layer_type="ALIF", learn_beta=True)
    tr = ttrainer.Trainer(tcfg, seed=1, device="cpu",
                          encode_config=tst.EncodeConfig(n_steps=T, tau=20.0))
    before = params_to_numpy(tr.params)
    x, y = _task(B, seed=2)
    loss, grads = tr.loss_and_grads(x, y)
    assert np.isfinite(float(loss))
    assert set(grads["input"]) == {"w_in", "w_rec"}  # beta is not trained
    assert set(grads["readout"]) == {"w_in", "b"}
    after = params_to_numpy(tr.params)
    for n in before:
        for k in before[n]:
            np.testing.assert_array_equal(before[n][k], after[n][k])
