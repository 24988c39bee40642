"""Port ops vs the JAX package on identical numpy inputs: surrogate spike
functions (forward and backward), cell steps, encoding (latencies and
rasters bitwise, the golden fixture included) and temporal reductions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import cells as jcells  # noqa: E402
from snnimageclassification_tpu.ops import encoding as jenc  # noqa: E402
from snnimageclassification_tpu.ops import surrogate as jsur  # noqa: E402
from snnimageclassification_tpu.ops import temporal as jtemp  # noqa: E402
from snnimageclassification_tpu_torch.ops import cells as tcells  # noqa: E402
from snnimageclassification_tpu_torch.ops import encoding as tenc  # noqa: E402
from snnimageclassification_tpu_torch.ops import surrogate as tsur  # noqa: E402
from snnimageclassification_tpu_torch.ops import temporal as ttemp  # noqa: E402


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# Surrogates
# ---------------------------------------------------------------------------
SURROGATES = [
    ("sigmoid", jsur.heaviside_sigmoid, tsur.heaviside_sigmoid),
    ("phi", jsur.heaviside_phi, tsur.heaviside_phi),
]


@pytest.mark.parametrize("name,jfn,tfn", SURROGATES,
                         ids=[s[0] for s in SURROGATES])
def test_surrogate_forward_and_backward_match_jax(name, jfn, tfn):
    rng = np.random.default_rng(0)
    v = rng.normal(scale=0.1, size=(7, 9)).astype(np.float32)
    thr = (0.03 + 0.02 * rng.random((7, 9))).astype(np.float32)
    g = rng.normal(size=(7, 9)).astype(np.float32)
    gamma = 0.3
    out_j, vjp = jax.vjp(lambda a, b: jfn(a, b, gamma), jnp.asarray(v),
                         jnp.asarray(thr))
    dv_j, dthr_j = vjp(jnp.asarray(g))
    vt = _t(v).requires_grad_(True)
    tt = _t(thr).requires_grad_(True)
    out_t = tfn(vt, tt, gamma)
    out_t.backward(_t(g))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(dv_j), rtol=1e-6,
                               atol=1e-7)
    assert np.all(np.asarray(dthr_j) == 0)
    assert torch.equal(tt.grad, torch.zeros_like(tt))


@pytest.mark.parametrize("name,jfn,tfn", SURROGATES,
                         ids=[s[0] for s in SURROGATES])
def test_surrogate_gamma_and_scalar_threshold_cotangents(name, jfn, tfn):
    v = torch.linspace(-1.0, 2.0, 31, requires_grad=True)
    gamma = torch.tensor(0.7, requires_grad=True)
    beta = torch.tensor(1.6, requires_grad=True)  # enters via the threshold
    out = tfn(v, 0.5 + beta * 0.1, gamma)
    out.sum().backward()
    assert torch.equal(gamma.grad, torch.zeros(()))
    assert torch.equal(beta.grad, torch.zeros(()))
    # A Python-number threshold and gamma get no gradient slot at all.
    w = torch.linspace(-1.0, 2.0, 31, requires_grad=True)
    tfn(w, 0.5, 0.7).sum().backward()
    kind = (tsur.SpikeFuncType.Phi if name == "phi"
            else tsur.SpikeFuncType.FastSigmoid)
    expected = tsur.surrogate_grad(kind, w.detach(), 0.5, 0.7)
    torch.testing.assert_close(w.grad, expected)


@pytest.mark.parametrize("kind", list(tsur.SpikeFuncType))
def test_surrogate_grad_closed_forms_match_jax(kind):
    rng = np.random.default_rng(1)
    v = rng.normal(size=50).astype(np.float32)
    jkind = jsur.SpikeFuncType[kind.name]
    got = tsur.surrogate_grad(kind, _t(v), 0.4, 0.3).numpy()
    want = np.asarray(jsur.surrogate_grad(jkind, jnp.asarray(v), 0.4, 0.3))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    d = v - np.float32(0.4)
    got = tsur.surrogate_grad_from_delta(kind, _t(d), 0.4, 0.3).numpy()
    want = np.asarray(jsur.surrogate_grad_from_delta(jkind, jnp.asarray(d),
                                                     0.4, 0.3))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_resolve_spike_fn():
    assert tsur.resolve_spike_fn("Phi") is tsur.heaviside_phi
    assert (tsur.resolve_spike_fn(tsur.SpikeFuncType.FastSigmoid)
            is tsur.heaviside_sigmoid)
    with pytest.raises(TypeError):
        tsur.resolve_spike_fn(3)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
def _cell_cfgs(kind, rec, learn_beta=False):
    kw = dict(input_size=6, output_size=5, use_recurrent_connection=rec)
    if kind == "alif":
        kw["learn_beta"] = learn_beta
        return jcells.ALIFConfig(**kw), tcells.ALIFConfig(**kw)
    if kind == "lif":
        return jcells.LIFConfig(**kw), tcells.LIFConfig(**kw)
    return jcells.IzhikevichConfig(**kw), tcells.IzhikevichConfig(**kw)


CELL_CASES = [("lif", True, False), ("lif", False, False),
              ("alif", True, False), ("alif", True, True),
              ("alif", False, False), ("izh", True, False)]


@pytest.mark.parametrize("kind,rec,learn_beta", CELL_CASES,
                         ids=[f"{k}-rec{r}-lb{b}" for k, r, b in CELL_CASES])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_cell_steps_match_jax(kind, rec, learn_beta, wdtype):
    jcfg, tcfg = _cell_cfgs(kind, rec, learn_beta)
    rng = np.random.default_rng(2)
    scale = 1.0 if kind == "izh" else 0.1
    p = {"w_in": (scale * rng.normal(size=(6, 5))).astype(np.float32)}
    if rec:
        p["w_rec"] = (scale * rng.normal(size=(5, 5))).astype(np.float32)
    if learn_beta:
        p["beta"] = np.float32(0.02)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jw = jcells.masked_recurrent(jcfg, jp)
    tw = tcells.masked_recurrent(tcfg, tp)
    if rec:
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        jw, tw = jw.astype(wdtype), tw.to(getattr(torch, wdtype))
    jstep = {"lif": jcells.lif_step, "alif": jcells.alif_step,
             "izh": jcells.izhikevich_step}[kind]
    tstep = {"lif": tcells.lif_step, "alif": tcells.alif_step,
             "izh": tcells.izhikevich_step}[kind]
    jinit = {"lif": jcells.lif_init_state, "alif": jcells.alif_init_state,
             "izh": jcells.izhikevich_init_state}[kind]
    tinit = {"lif": tcells.lif_init_state, "alif": tcells.alif_init_state,
             "izh": tcells.izhikevich_init_state}[kind]
    js, ts = jinit(jcfg, 4), tinit(tcfg, 4)
    for leaf_j, leaf_t in zip(js, ts):
        np.testing.assert_array_equal(leaf_t.numpy(), np.asarray(leaf_j))
    for step in range(6):
        x = (3.0 * rng.random((4, 6))).astype(np.float32)
        zj, js = jstep(jcfg, jp, js, jnp.asarray(x), w_rec_eff=jw)
        zt, ts = tstep(tcfg, tp, ts, _t(x), w_rec_eff=tw)
        np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
        for leaf_j, leaf_t in zip(js, ts):
            np.testing.assert_allclose(leaf_t.numpy(), np.asarray(leaf_j),
                                       rtol=1e-5, atol=1e-5)


def test_readout_step_matches_jax():
    jcfg = jcells.ReadoutConfig(input_size=5, output_size=3)
    tcfg = tcells.ReadoutConfig(input_size=5, output_size=3)
    rng = np.random.default_rng(3)
    p = {"w_in": rng.normal(size=(5, 3)).astype(np.float32),
         "b": rng.normal(size=3).astype(np.float32)}
    js = jcells.readout_init_state(jcfg, 2)
    ts = tcells.readout_init_state(tcfg, 2)
    for _ in range(4):
        x = rng.random((2, 5)).astype(np.float32)
        vj, js = jcells.readout_step(jcfg, {k: jnp.asarray(v) for k, v in
                                            p.items()}, js, jnp.asarray(x))
        vt, ts = tcells.readout_step(tcfg, {k: _t(v) for k, v in p.items()},
                                     ts, _t(x))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6,
                                   atol=1e-6)


def test_alif_step_order_uses_previous_spike():
    """The recurrent current and the adaptation both read z_{t-1}."""
    cfg = tcells.ALIFConfig(input_size=2, output_size=2)
    w_rec = torch.tensor([[0.0, 5.0], [0.0, 0.0]])
    state = tcells.ALIFState(v=torch.zeros(1, 2), a=torch.zeros(1, 2),
                             z=torch.tensor([[1.0, 0.0]]))
    z, new = tcells.alif_step(cfg, {}, state, torch.zeros(1, 2),
                              w_rec_eff=w_rec,
                              precomputed_input_current=True)
    assert float(new.v[0, 1]) == 5.0       # unit 0's previous spike drove it
    assert float(new.a[0, 0]) == 1.0       # a' = rho*0 + z_prev
    assert float(new.v[0, 0]) == 0.0       # reset by its own previous spike
    assert z.tolist() == [[0.0, 1.0]]


def test_init_params_shapes_and_beta_quirk():
    cfg = tcells.ALIFConfig(input_size=50, output_size=40, learn_beta=True)
    g = torch.Generator().manual_seed(0)
    p = tcells.alif_init_params(cfg, g)
    assert p["w_in"].shape == (50, 40) and p["w_rec"].shape == (40, 40)
    assert p["beta"].shape == ()
    assert abs(float(p["beta"])) < 5 * cfg.threshold  # N(0, thr^2), not 1.6
    assert abs(float(p["w_in"].std()) - cfg.threshold) < 0.2 * cfg.threshold
    again = tcells.alif_init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)
    ro = tcells.readout_init_params(
        tcells.ReadoutConfig(input_size=40, output_size=10), g)
    assert torch.equal(ro["b"], torch.zeros(10))


def test_config_constants_match_jax():
    for jc, tc in (_cell_cfgs("lif", True), _cell_cfgs("alif", True),
                   _cell_cfgs("izh", True)):
        assert tc.alpha == jc.alpha and tc.threshold == jc.threshold
        assert tc.gamma == jc.gamma
    jr = jcells.ReadoutConfig(input_size=3, output_size=2, tau_out=0.02)
    tr = tcells.ReadoutConfig(input_size=3, output_size=2, tau_out=0.02)
    assert tr.kappa == jr.kappa
    assert _cell_cfgs("alif", True)[1].rho == _cell_cfgs("alif", True)[0].rho


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tau", [20.0, 20e-3, 3.7])
@pytest.mark.parametrize("t_max", [10.0, 100.0])
def test_latencies_bitwise(tau, t_max):
    rng = np.random.default_rng(4)
    x = rng.random(4000).astype(np.float32)
    x[:5] = [0.0, 0.2, 0.2000001, 1.0, 0.19999999]
    want = np.asarray(jenc.pixels_to_firing_periods(jnp.asarray(x),
                                                    t_max=t_max, tau=tau))
    got = tenc.pixels_to_firing_periods(_t(x), t_max=t_max, tau=tau)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_latency_truncation_flips_are_rare():
    """PyTorch's float32 log and XLA's differ by an ulp on ~15 % of inputs;
    a latency moves only when tau*log(...) lies within that ulp of an
    integer.  Measured: 1 latency of 2,000,000 random pixels at tau=20
    (seed 0), 0 at the production tau, whose latencies all truncate to 0."""
    x = np.random.default_rng(0).random(2_000_000).astype(np.float32)
    for tau, most in ((20.0, 3), (20e-3, 0)):
        want = np.asarray(jenc.pixels_to_firing_periods(
            jnp.asarray(x), t_max=100.0, tau=tau))
        got = tenc.pixels_to_firing_periods(_t(x), t_max=100.0,
                                            tau=tau).numpy()
        diff = got != want
        assert diff.sum() <= most, f"tau={tau}: {diff.sum()} latencies differ"
        assert np.all(np.abs(got[diff] - want[diff]) == 1)


@pytest.mark.parametrize("n_steps", [1, 5, 12, 100])
def test_rasters_bitwise(n_steps):
    lat = np.array([-3, 0, 1, 2, 3, 4, 5, 7, 11, 12, 99, 100, 250],
                   dtype=np.int32)
    for jfn, tfn in (
        (jenc.firing_times_to_spikes, tenc.firing_times_to_spikes),
        (jenc.firing_periods_to_spikes, tenc.firing_periods_to_spikes),
        (jenc.firing_periods_to_spikes_loop,
         tenc.firing_periods_to_spikes_loop),
        (jenc.firing_periods_to_spikes_clip,
         tenc.firing_periods_to_spikes_clip),
    ):
        want = np.asarray(jfn(jnp.asarray(lat), n_steps))
        got = tfn(_t(lat), n_steps)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=jfn.__name__)


@pytest.mark.parametrize("use_periods", [False, True])
def test_spike_row_is_one_raster_slice(use_periods):
    lat = _t(np.arange(-2, 30, dtype=np.int32).reshape(4, 8))
    full = (tenc.firing_periods_to_spikes if use_periods
            else tenc.firing_times_to_spikes)(lat, 24)
    for t in range(24):
        row = tenc.spike_row(lat, t, 24, use_periods)
        assert torch.equal(row.to(torch.float32), full[t])


@pytest.mark.parametrize("use_periods", [False, True])
def test_encode_spikes_bitwise(use_periods):
    x = np.random.default_rng(5).random((3, 2, 49)).astype(np.float32)
    want = np.asarray(jenc.encode_spikes(jnp.asarray(x), n_steps=20,
                                         use_periods=use_periods, tau=20.0))
    got = tenc.encode_spikes(_t(x), n_steps=20, use_periods=use_periods,
                             tau=20.0)
    assert got.shape == (3, 2, 20, 49)
    np.testing.assert_array_equal(got.numpy(), want)


def test_golden_fixture(fixtures_dir):
    """The reference's golden file (test_to_spikes.py:75-83)."""
    x_dict = np.load(fixtures_dir / "test_x_to_spikes.npy",
                     allow_pickle=True).item()
    x = (np.asarray(x_dict["x"], dtype=np.float64) / 255.0).reshape(-1)
    x = x.astype(np.float32)
    transform = tenc.ToSpikes(100, 100, tau=20.0, thr=0.2, epsilon=1e-7,
                              device="cpu")
    got = transform(x).numpy()
    np.testing.assert_array_equal(got, x_dict["spikes"])
    want_lat = np.asarray(jenc.pixels_to_firing_periods(
        jnp.asarray(x), t_max=100.0, tau=20.0))
    np.testing.assert_array_equal(
        transform.pixels_to_firing_periods(x).numpy(), want_lat)


def test_tospikes_reference_values():
    """Values of the reference's test_to_spikes.py:15-30."""
    tr = tenc.ToSpikes(100, 100, tau=20.0, device="cpu")
    pix = np.array([0.82352941, 0.82745098, 0.83529412, 0.8745098, 0.8627451,
                    0.95294118, 0.79215686, 0.0, 0.0, 0.0])
    np.testing.assert_array_equal(tr.pixels_to_firing_periods(pix).numpy(),
                                  [5, 5, 5, 5, 5, 4, 5, 100, 100, 100])
    tr5 = tenc.ToSpikes(5, 5, device="cpu")
    got = tr5.firing_periods_to_spikes(np.array([1, 2, 6])).numpy()
    np.testing.assert_array_equal(
        got, [[0, 0, 0], [1, 0, 0], [1, 1, 0], [1, 0, 0], [1, 1, 1]])
    assert tr5.firing_times_to_spikes(np.array([0, 9])).shape == (5, 2)
    assert tr5.firing_periods_to_spikes_loop(np.array([2])).shape == (5, 1)
    assert tr5.firing_periods_to_spikes_clip(np.array([0])).sum() == 5


def test_degenerate_production_tau():
    """Quirk Q2: the default tau truncates supra-threshold latencies to 0."""
    x = torch.tensor([[0.9, 0.5, 0.1]])
    spikes = tenc.encode_spikes(x, n_steps=4)
    expected = torch.zeros(1, 4, 3)
    expected[0, 0, 0] = expected[0, 0, 1] = 1.0
    assert torch.equal(spikes, expected)


# ---------------------------------------------------------------------------
# Temporal reductions
# ---------------------------------------------------------------------------
def test_temporal_max_first_argmax_ties():
    x = np.zeros((3, 6, 4), np.float32)
    x[0, [1, 4], 0] = 2.0        # tie between steps 1 and 4
    x[1, :, 1] = 0.5             # constant trace: every step ties
    x[2, 5, 2] = -1.0
    want = np.asarray(jtemp.temporal_max(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    got = ttemp.temporal_max(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    g = xt.grad.numpy()
    assert g[0, 1, 0] == 1.0 and g[0, 4, 0] == 0.0   # the first max wins
    assert g[1, 0, 1] == 1.0 and g[1, 1:, 1].sum() == 0.0
    _, jgrad = jax.value_and_grad(
        lambda a: jnp.sum(jtemp.temporal_max(a)))(jnp.asarray(x))
    np.testing.assert_array_equal(g, np.asarray(jgrad))


@pytest.mark.parametrize("decay", [0.9, 0.5])
def test_batchwise_temporal_filter_matches_jax(decay):
    x = np.random.default_rng(6).normal(size=(2, 7, 3)).astype(np.float32)
    want = np.asarray(jtemp.batchwise_temporal_filter(jnp.asarray(x), decay))
    got = ttemp.batchwise_temporal_filter(_t(x), decay).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
