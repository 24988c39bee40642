"""The two-layer pair's plain forward in its tensor-core body's summation
order (``ops/fused2.py:_fused2_fwd_ordered_reference``, the card's bitwise
witness for ``csrc/fused2.cu:fused2_mma_kernel``) on the CPU, on identical
numpy inputs from a seed (tests/test_torch_fused2.py's cases and inputs):

* against the order-free plain version ``_fused2_reference`` (held against
  the JAX kernel in tests/test_torch_fused2.py): LIF/ALIF x rec/ff x
  FastSigmoid/Phi, TTFS and periodic, T = 24 and 100, float32 and
  bfloat16: spikes (each layer's residual sign), ``tstar`` and both counts
  equal, logits within 1e-5, residuals within 1e-5 (float32) or one
  bfloat16 rounding;
* one small case against the JAX kernel ``pallas_fused2._fused2_fwd_call``
  in interpret mode, TTFS at the production tau (every supra-threshold
  pixel fires at t = 0, so layer 0 takes the dense product): both layers'
  spikes equal on at least 99 % of rows, logits and residuals within the
  same bars;
* ``fused2_bodies`` and ``explain_dispatch`` on the CPU (the plain
  versions; the card names the bodies: tests/test_torch_cuda.py).
"""
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
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused2 as tf2,
)
from test_torch_fused2 import (  # noqa: E402
    FUSED2,
    GRID,
    IDS,
    KAPPA,
    _cfg,
    _close_trace,
    _np,
    _scalars,
    _t,
    inputs,
)
import snnimageclassification_tpu_torch as tst  # noqa: E402


def _args(lat, w, betas, T, alif, per, wd):
    alpha, rho, thr, _ = _scalars(alif)
    return (torch.from_numpy(np.asarray(lat)), _t(w["w0"], wd),
            _t(w["w0r"], wd), betas[0], _t(w["w1"], wd), _t(w["w1r"], wd),
            betas[1], _t(w["w_out"], wd), _t(w["b_out"], "float32"), T, per,
            alif, alpha, rho, thr, KAPPA)


@pytest.mark.parametrize("case,T,wd", GRID, ids=IDS)
def test_ordered_version_matches_the_plain_version(case, T, wd):
    name, alif, rec, spike_name, per = case
    lat, w, betas = inputs(T, alif, rec)
    args = _args(lat, w, betas, T, alif, per, wd)
    store_a = alif and spike_name == "Phi"
    plain = tf2._fused2_reference(*args, True, store_a, True)
    got = tf2._fused2_fwd_ordered_reference(*args, True, store_a, True)
    logits, d0, a0, d1, a1, tstar, c0, c1 = got
    np.testing.assert_allclose(_np(logits), _np(plain[0]), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(tstar, plain[5])
    assert torch.equal(c0, plain[6]) and torch.equal(c1, plain[7])
    assert float(c0.sum()) > 0 and float(c1.sum()) > 0
    for label, g, p in (("d0", d0, plain[1]), ("a0", a0, plain[2]),
                        ("d1", d1, plain[3]), ("a1", a1, plain[4])):
        assert (g is None) == (p is None)
        if g is None:
            continue
        if label[0] == "d":
            np.testing.assert_array_equal(_np(g) >= 0, _np(p) >= 0)
        _close_trace(g, p, wd, f"{name} {label}")
    # Inference: the same logits.
    inf = tf2._fused2_fwd_ordered_reference(*args, False, False, False)
    assert torch.equal(inf[0], logits)


@pytest.mark.parametrize("wd", ["float32", "bfloat16"])
def test_ordered_version_matches_the_jax_kernel(wd):
    """ALIF, recurrent, FastSigmoid, TTFS at the production tau, T = 24."""
    T, alif = 24, True
    _, w, betas = inputs(T, alif, True)
    pixels = np.random.default_rng(5).random((5, 30)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(jnp.asarray(pixels),
                                            t_max=float(T)))
    alpha, rho, thr, _ = _scalars(alif)

    def j(x):
        return None if x is None else jnp.asarray(x).astype(wd)

    traces, _, jlogits, jtstar, (jc0, jc1) = jf2._fused2_fwd_call(
        jnp.asarray(lat), j(w["w0"]), j(w["w0r"]), betas[0], j(w["w1"]),
        j(w["w1r"]), betas[1], j(w["w_out"]), jnp.asarray(w["b_out"]), T=T,
        use_periods=False, alif=alif, alpha=alpha, rho=rho, threshold=thr,
        store_delta=True, kappa=KAPPA, interpret=True, store_counts=True)
    logits, d0, _, d1, _, tstar, c0, c1 = tf2._fused2_fwd_ordered_reference(
        *_args(lat, w, betas, T, alif, False, wd), True, False, True)
    rows = ((_np(c0) == _np(jc0)).all(1) & (_np(c1) == _np(jc1)).all(1))
    assert rows.mean() >= 0.99
    assert float(c0.sum()) > 0 and float(c1.sum()) > 0
    np.testing.assert_allclose(_np(logits)[rows], _np(jlogits)[rows],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tstar.numpy()[rows],
                                  np.asarray(jtstar)[rows])
    n = d0.shape[1]
    for got, want in ((d0, traces[0]), (d1, traces[1])):
        want = np.asarray(_np(want))[:, :n, :got.shape[2]]
        _close_trace(got[:, rows], want[:, rows], wd, "delta")


def test_fused2_bodies_and_explain_dispatch_on_the_cpu():
    assert tf2.fused2_bodies(24, 784, 128, 128, 10,
                             device="cpu") == ("plain",)
    assert tf2.fused2_bodies(24, 784, 128, 128, 10, device="cpu",
                             training=True) == ("plain", "plain")
    enc = tst.EncodeConfig(n_steps=10)
    for training in (False, True):
        row, = tsnn.explain_dispatch(_cfg(), enc, device="cpu",
                                     training=training)
        assert row["path"] == FUSED2 and "body" not in row["reason"]
