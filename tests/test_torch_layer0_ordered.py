"""The first layers' plain forwards in the tensor-core body's summation order
(``ops/fused.py:_layer0_ordered_reference``,
``ops/fused_izh.py:_izh_layer0_ordered_reference``: the card's bitwise
witnesses for ``fused_layer0_fwd`` and ``fused_izh_layer0_fwd`` on
``csrc/head_mma_fwd.cuh``'s body without the readout) on the CPU, on
identical numpy inputs from a seed (B = 37, F = 30, H = 20 and 40):

* against the order-free plain version ``_layer0_reference``: ff/rec x
  LIF/ALIF x FastSigmoid/Phi, TTFS and periodic, float32 and bfloat16 at T
  = 24 (and two cases at T = 100), the residual ``v`` and ``delta``
  (``res_is_v`` both ways): spikes equal, residuals within 1e-5 (float32)
  or one bfloat16 rounding;
* against the JAX kernel ``pallas_fused._fused_fwd_call`` (``head=False``)
  in interpret mode, as ``tests/test_torch_mid.py`` runs it: spikes equal,
  the JAX kernel's residuals (``v``, or ``delta`` for ALIF with
  FastSigmoid, and ``a`` for ALIF with Phi) within the same bars;
* bit for bit the two-layer pair's layer 0 in its plain version in the same
  order (``ops/fused2.py:_fused2_fwd_ordered_reference``: its residual
  ``delta``, ``a``, the spike counts), and with the mid head's ordered
  version on top (``ops/fused_mid.py:_mid_fwd_ordered_reference``) the
  pair's logits, ``tstar``, both counts and layer 1's residuals: the CPU
  model of the composed gate on the card (``fused_layer0_fwd`` +
  ``fused_mid_fwd[head]`` against ``fused2_fwd``);
* the Izhikevich one against ``pallas_fused_izh._izh_fwd_call`` in
  interpret mode and the order-free plain version at the JAX suite's scale
  (spikes equal, ``v`` 1e-6 relative and 1e-3 mV: input sums of ~1e8 in
  another order, ``tests/test_torch_izh_ordered.py``'s bar), and its ``z``
  and ``v`` bit for bit those of the head's ordered version
  (``_izh_head_train_ordered_reference``);
* ``layer0_bodies`` and ``explain_dispatch`` on the CPU (the plain
  versions; the card names the bodies: tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_fused as jfused  # noqa: E402
from snnimageclassification_tpu.ops import (  # noqa: E402
    pallas_fused_izh as jfi,
)
from snnimageclassification_tpu.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused2 as tf2,
    fused_izh as tfi,
    fused_mid as tmid,
    izh as tizh,
)
from snnimageclassification_tpu_torch.ops.cells import (  # noqa: E402
    ALIFConfig,
    IzhikevichConfig,
    LIFConfig,
    ReadoutConfig,
)

B, F, O = 37, 30, 10
KAPPA = ReadoutConfig(input_size=1, output_size=O).kappa

CASES = [  # name, alif, recurrent, Phi
    ("alif-rec-fs", True, True, False),
    ("alif-ff-phi", True, False, True),
    ("alif-rec-phi", True, True, True),
    ("lif-rec-phi", False, True, True),
    ("lif-ff-fs", False, False, False),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ordered plain versions run many small tensor ops: faster on one
    thread than on a thread pool that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_trace(got, want, wd, label):
    """A residual trace: float32 to 1e-5, bfloat16 to one rounding."""
    tol = 1e-5 if wd == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol,
                               err_msg=label)


def _inputs(T, alif, rec, H, seed=11):
    """Latencies (tau = 20 steps: spread over the window) and weights at a
    scale where the layer fires: W_in 0.5 N(0, 1), W_rec 0.3 N(0, 1) with
    its diagonal masked, as tests/test_torch_mid.py's layer 0."""
    rng = np.random.default_rng(seed)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(jnp.asarray(pixels),
                                            t_max=float(T), tau=20.0))
    w_in = (0.5 * rng.standard_normal((F, H))).astype(np.float32)
    w_rec = ((0.3 * rng.standard_normal((H, H))).astype(np.float32)
             * (1 - np.eye(H, dtype=np.float32))) if rec else None
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H)
    sc = (alif, cfg.alpha, cfg.rho if alif else 0.0, cfg.threshold)
    return lat, w_in, w_rec, 1.6 if alif else 0.0, sc, rng


def _t(x, wd):
    return None if x is None else torch.from_numpy(x).to(getattr(torch, wd))


def _layer0_args(T, per, alif, rec, H, wd):
    lat, w_in, w_rec, beta, sc, rng = _inputs(T, alif, rec, H)
    return (torch.from_numpy(lat), _t(w_in, wd), _t(w_rec, wd), beta, T,
            per, *sc), (lat, w_in, w_rec, beta, sc, rng)


# Every case at T = 24, TTFS and periodic, in both types; T = 100 (the
# JAX kernel's four time blocks) on two.
GRID = ([(c, 24, per, wd) for c in CASES for per in (False, True)
         for wd in ("float32", "bfloat16")]
        + [(CASES[0], 100, per, "float32") for per in (False, True)]
        + [(CASES[3], 100, per, "bfloat16") for per in (False, True)])
IDS = [f"{c[0]}-T{T}-{'periodic' if per else 'ttfs'}-{wd}"
       for c, T, per, wd in GRID]


@pytest.mark.parametrize("case,T,per,wd", GRID, ids=IDS)
def test_ordered_version_matches_the_plain_version(case, T, per, wd):
    name, alif, rec, phi = case
    for H in (20, 40) if T == 24 and wd == "float32" else (20,):
        args, _ = _layer0_args(T, per, alif, rec, H, wd)
        for res_is_v in (False, True):
            tail = (True, alif and phi, res_is_v)
            z, res, a_tr = tfused._layer0_ordered_reference(*args, *tail)
            zp, resp, ap = tfused._layer0_reference(*args, *tail)
            label = f"{name} H={H} res_is_v={res_is_v}"
            assert z.dtype == getattr(torch, wd) and z.shape == (T, B, H)
            assert torch.equal(z, zp), label
            assert 0 < float(z.float().mean()) < 0.6, label
            _close_trace(res, resp, wd, f"{label} residual")
            assert (a_tr is None) == (ap is None)
            if a_tr is not None:
                _close_trace(a_tr, ap, wd, f"{label} a")
        # Inference: the same spikes, no residual.
        inf = tfused._layer0_ordered_reference(*args, False, False, False)
        assert torch.equal(inf[0], z) and inf[1] is None and inf[2] is None


# The JAX kernel in interpret mode (a compile per case): every case at T =
# 24, TTFS and periodic, float32 and bfloat16 taken in turn, and two at T =
# 100 (four time blocks).
JAX_GRID = ([(c, 24, i % 2 == 1, ("float32", "bfloat16")[i // 2 % 2])
             for i, c in enumerate(CASES)]
            + [(CASES[0], 100, True, "float32"),
               (CASES[3], 100, False, "bfloat16")])
JAX_IDS = [f"{c[0]}-T{T}-{'periodic' if per else 'ttfs'}-{wd}"
           for c, T, per, wd in JAX_GRID]


@pytest.mark.parametrize("case,T,per,wd", JAX_GRID, ids=JAX_IDS)
def test_ordered_version_matches_the_jax_kernel(case, T, per, wd):
    name, alif, rec, phi = case
    H = 20
    args, (lat, w_in, w_rec, beta, sc, _) = _layer0_args(T, per, alif, rec,
                                                         H, wd)
    store_delta = alif and not phi  # the JAX kernel's residual choice
    traces, _ = jfused._fused_fwd_call(
        jnp.asarray(lat), jnp.asarray(w_in).astype(wd),
        None if w_rec is None else jnp.asarray(w_rec).astype(wd), beta, T=T,
        use_periods=per, alif=alif, alpha=sc[1], rho=sc[2],
        threshold=sc[3], store_delta=store_delta, interpret=True)
    z, res, a_tr = tfused._layer0_ordered_reference(
        *args, True, alif and phi, not store_delta)
    np.testing.assert_array_equal(_np(z), _np(traces[0]))
    _close_trace(res, traces[1], wd, f"{name} residual")
    assert (a_tr is None) == (len(traces) == 2)
    if a_tr is not None:
        _close_trace(a_tr, traces[2], wd, f"{name} a")


F2_GRID = ([(c, 24, per, wd) for c in CASES[:4] for per, wd in
            ((False, "float32"), (True, "bfloat16"))]
           + [(c, 100, False, "float32") for c in CASES[2:4]])
F2_IDS = [f"{c[0]}-T{T}-{'periodic' if per else 'ttfs'}-{wd}"
          for c, T, per, wd in F2_GRID]


@pytest.mark.parametrize("case,T,per,wd", F2_GRID, ids=F2_IDS)
def test_ordered_version_is_the_two_layer_pairs_layer0(case, T, per, wd):
    """Layer 0 of the pair's ordered plain version and, with the mid head's
    ordered version fed its spikes, the whole pair, bit for bit."""
    name, alif, rec, phi = case
    H1, H2 = 20, 24
    args, (_, _, _, beta, sc, rng) = _layer0_args(T, per, alif, rec, H1, wd)
    lat, w0, w0r = args[:3]

    def w(shape, std, mask=False):
        x = (std * rng.standard_normal(shape)).astype(np.float32)
        return _t(x * (1 - np.eye(shape[0], dtype=np.float32)) if mask
                  else x, wd)

    w1, w1r = w((H1, H2), 1.0), w((H2, H2), 0.3, True) if rec else None
    w_out, b_out = w((H2, O), 1.0), _t(
        (0.1 * rng.standard_normal(O)).astype(np.float32), "float32")
    store_a = alif and phi
    pair = tf2._fused2_fwd_ordered_reference(
        lat, w0, w0r, beta, w1, w1r, beta, w_out, b_out, T, per, *sc, KAPPA,
        True, store_a, True)
    logits, d0, a0, d1, a1, tstar, c0, c1 = pair
    z, res, a_tr = tfused._layer0_ordered_reference(*args, True, store_a,
                                                    False)
    assert torch.equal(res, d0) and torch.equal(c0, z.float().sum(0))
    assert (a_tr is None) == (a0 is None)
    assert a_tr is None or torch.equal(a_tr, a0)
    assert float(c1.sum()) > 0
    m = tmid._mid_fwd_ordered_reference(
        z, w1, w1r, beta, w_out, b_out, T, *sc, KAPPA, True, store_a, True,
        False)
    assert torch.equal(logits, m[0]) and torch.equal(tstar, m[4])
    assert torch.equal(c1, m[5]) and torch.equal(d1, m[2]), name
    assert (a1 is None) == (m[3] is None)
    assert a1 is None or torch.equal(a1, m[3])


IZH = IzhikevichConfig(input_size=1, output_size=1)
IZH_KP = tizh.izh_kernel_params(IZH)
IZH_CASES = [  # name, recurrent, use_periods, T, weights' dtype
    ("rec-ttfs", True, False, 24, "float32"),
    ("ff-periodic", False, True, 24, "float32"),
    ("rec-periodic", True, True, 100, "float32"),
    ("rec-ttfs-bf16", True, False, 24, "bfloat16"),
    ("ff-ttfs-bf16", False, False, 100, "bfloat16"),
]


def _izh_inputs(T, rec, H, seed=7):
    """The JAX suite's scale: W_in 3e6 N(0, 1), W_rec 5e5 N(0, 1) with its
    diagonal masked, default constants (tests/test_torch_izh.py)."""
    rng = np.random.default_rng(seed)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(jnp.asarray(pixels),
                                            t_max=float(T), tau=20.0))
    w_in = (3e6 * rng.standard_normal((F, H))).astype(np.float32)
    w_rec = ((5e5 * rng.standard_normal((H, H))).astype(np.float32)
             * (1 - np.eye(H, dtype=np.float32))) if rec else None
    return lat, w_in, w_rec, rng


@pytest.mark.parametrize("name,rec,per,T,wd", IZH_CASES,
                         ids=[c[0] for c in IZH_CASES])
def test_izh_ordered_version_matches_the_jax_kernel_and_the_head(
        name, rec, per, T, wd):
    H = 20
    lat, w_in, w_rec, rng = _izh_inputs(T, rec, H)
    jz, jv, _ = jfi._izh_fwd_call(
        jnp.asarray(lat), jnp.asarray(w_in).astype(wd),
        None if w_rec is None else jnp.asarray(w_rec).astype(wd),
        dict(IZH_KP), T=T, use_periods=per, interpret=True)
    args = (torch.from_numpy(lat), _t(w_in, wd), _t(w_rec, wd), T, per,
            IZH_KP)
    z, v = tfi._izh_layer0_ordered_reference(*args, True)
    assert z.dtype == torch.float32 and v.dtype == torch.float32
    np.testing.assert_array_equal(_np(z), _np(jz))
    assert 0 < float(z.mean()) < 1
    # v: 1e-6 relative, and 1e-3 mV for input sums of ~1e8 added in another
    # order (the bars of tests/test_torch_izh_ordered.py against the
    # order-free plain version).
    np.testing.assert_allclose(_np(v), _np(jv), rtol=1e-6, atol=1e-3)
    zp, vp = tfi._layer0_reference(*args, True)
    assert torch.equal(z, zp)
    np.testing.assert_allclose(_np(v), _np(vp), rtol=1e-6, atol=1e-3)
    inf = tfi._izh_layer0_ordered_reference(*args, False)
    assert torch.equal(inf[0], z) and inf[1] is None
    # The head's ordered version on the same layer: its v bit for bit, its
    # counts the layer's spikes.
    w_out = _t(rng.standard_normal((H, O)).astype(np.float32), wd)
    b_out = _t((0.1 * rng.standard_normal(O)).astype(np.float32), "float32")
    _, hv, _, counts = tfi._izh_head_train_ordered_reference(
        args[0], args[1], args[2], w_out, b_out, T, per, IZH_KP, KAPPA, True,
        True)
    assert torch.equal(v, hv) and torch.equal(counts, z.sum(0))


def test_layer0_bodies_and_explain_dispatch_on_the_cpu():
    """The plain versions on the CPU: ``layer0_bodies`` names them, and
    ``explain_dispatch`` names no card body for a first layer."""
    for bodies in (tfused.layer0_bodies, tfi.layer0_bodies):
        assert bodies(100, 784, 128, device="cpu") == ("plain",)
        assert bodies(100, 784, 128, device="cpu",
                      training=True) == ("plain", "plain")
    enc = tst.EncodeConfig(n_steps=100)
    for layer, widths, path in (
            ("ALIF", [128, 128, 96], "torch:fused_layer0_reference"),
            ("Izhikevich", [128, 128], "torch:fused_izh_layer0_reference")):
        cfg = tst.SNNConfig(input_size=784, output_size=10,
                            n_hidden_neurons=widths,
                            hidden_layer_type=layer,
                            use_recurrent_connection=True,
                            int_time_steps=100)
        for training in (False, True):
            row = tsnn.explain_dispatch(cfg, enc, device="cpu",
                                        training=training)[0]
            assert row["path"] == path and "body" not in row["reason"]
