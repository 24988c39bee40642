"""The mid layer's plain forward in its tensor-core body's summation order
(``ops/fused_mid.py:_mid_fwd_ordered_reference``, the card's bitwise
witness for ``csrc/fused_mid.cu:mid_mma_kernel``) on the CPU, on identical
numpy inputs from a seed (tests/test_torch_mid.py's cases and inputs):

* against the order-free plain version ``_mid_reference`` (held against the
  JAX kernel in tests/test_torch_mid_fwd.py), both modes, every case at T
  = 24 and two at T = 100, float32 and bfloat16: spikes, ``tstar`` and
  counts equal, logits within 1e-5, residuals within 1e-5 (float32) or one
  bfloat16 rounding;
* one small case against the JAX kernel ``pallas_fused_mid._mid_fwd_call``
  in interpret mode: spikes equal on at least 99 % of rows, logits and
  residuals within the same bars;
* ``mid_bodies`` and ``explain_dispatch`` on the CPU (the plain versions;
  the card names the bodies: tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import (  # noqa: E402
    pallas_fused_mid as jmid,
)
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused_mid as tmid,
)
from test_torch_mid import (  # noqa: E402
    CASES,
    KAPPA,
    _close_trace,
    _j,
    _mid_inputs,
    _np,
    _scalars,
    _t,
)


def _both(case, T, wd, head):
    """(order-free, ordered) training forwards of one mode with counts."""
    name, alif, rec, spike_name = case
    _, z_in, w = _mid_inputs(T, rec)
    alif, alpha, rho, thr, _ = _scalars(alif, spike_name)
    store_a = alif and spike_name == "Phi"
    res_is_v = not head and not (alif and spike_name == "FastSigmoid")
    args = (_t(z_in, wd), _t(w["w_in"], wd), _t(w["w_rec"], wd),
            1.6 if alif else 0.0, _t(w["w_out"], wd) if head else None,
            _t(w["b_out"], "float32") if head else None, T, alif, alpha,
            rho, thr, KAPPA if head else 0.0, True, store_a, head, res_is_v)
    return tmid._mid_reference(*args), tmid._mid_fwd_ordered_reference(*args)


# Every case at T = 24 in both types; T = 100 (four time blocks) on two.
GRID = ([(c, 24, wd) for c in CASES for wd in ("float32", "bfloat16")]
        + [(CASES[0], 100, "float32"), (CASES[3], 100, "bfloat16")])
IDS = [f"{c[0]}-T{T}-{wd}" for c, T, wd in GRID]


@pytest.mark.parametrize("case,T,wd", GRID, ids=IDS)
def test_ordered_version_matches_the_plain_version(case, T, wd):
    for head in (False, True):
        plain, ordered = _both(case, T, wd, head)
        logits, z, res, a_tr, tstar, counts = ordered
        label = f"{case[0]} {'head' if head else 'z'}"
        if head:
            np.testing.assert_allclose(_np(logits), _np(plain[0]),
                                       atol=1e-5, rtol=1e-5, err_msg=label)
            assert torch.equal(tstar, plain[4]) and torch.equal(counts,
                                                                plain[5])
            assert float(counts.sum()) > 0
            np.testing.assert_array_equal(_np(res) >= 0, _np(plain[2]) >= 0)
        else:
            assert z.dtype == plain[1].dtype and torch.equal(z, plain[1])
            assert 0.01 < float(z.float().mean()) < 0.6
        _close_trace(res, plain[2], wd, f"{label} residual")
        assert (a_tr is None) == (plain[3] is None)
        if a_tr is not None:
            _close_trace(a_tr, plain[3], wd, f"{label} a")


@pytest.mark.parametrize("wd", ["float32", "bfloat16"])
def test_ordered_version_matches_the_jax_kernel(wd):
    """ALIF, recurrent, FastSigmoid, T = 24, both modes."""
    T = 24
    _, z_in, w = _mid_inputs(T, True)
    alif, alpha, rho, thr, _ = _scalars(True, "FastSigmoid")
    jkw = dict(T=T, alif=alif, alpha=alpha, rho=rho, threshold=thr,
               store_delta=True, interpret=True)
    jargs = (_j(z_in, wd), _j(w["w_in"], wd), _j(w["w_rec"], wd), 1.6)
    targs = (_t(z_in, wd), _t(w["w_in"], wd), _t(w["w_rec"], wd), 1.6)
    jtraces, _ = jmid._mid_fwd_call(*jargs, **jkw)
    _, z, res, _, _, _ = tmid._mid_fwd_ordered_reference(
        *targs, None, None, T, alif, alpha, rho, thr, 0.0, True, False,
        False, False)
    rows = (_np(z) == _np(jtraces[0])).all(axis=(0, 2))
    assert rows.mean() >= 0.99
    _close_trace(res[:, rows], np.asarray(_np(jtraces[1]))[:, rows], wd,
                 "z-mode delta")
    jtraces, _, jlogits, jtstar, jcounts = jmid._mid_fwd_call(
        *jargs, **jkw, w_out=_j(w["w_out"], wd),
        b_out=jnp.asarray(w["b_out"]), kappa=KAPPA, store_counts=True)
    logits, _, res, _, tstar, counts = tmid._mid_fwd_ordered_reference(
        *targs, _t(w["w_out"], wd), _t(w["b_out"], "float32"), T, alif,
        alpha, rho, thr, KAPPA, True, False, True, False)
    rows = (_np(counts) == _np(jcounts)).all(axis=1)
    assert rows.mean() >= 0.99
    np.testing.assert_allclose(_np(logits)[rows], _np(jlogits)[rows],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tstar.numpy()[rows],
                                  np.asarray(jtstar)[rows])
    _close_trace(res[:, rows], np.asarray(_np(jtraces[0]))[:, rows], wd,
                 "head delta")


def test_mid_bodies_and_explain_dispatch_on_the_cpu():
    """The plain versions on the CPU: ``mid_bodies`` names them, and
    ``explain_dispatch`` names no card body for the deep network's mid
    layers."""
    assert tmid.mid_bodies(24, 128, 128, 0, device="cpu") == ("plain",)
    assert tmid.mid_bodies(24, 128, 96, 10, device="cpu",
                           training=True) == ("plain", "plain")
    cfg = tst.SNNConfig(input_size=784, output_size=10,
                        n_hidden_neurons=[128, 128, 96],
                        hidden_layer_type=tst.LayerType.ALIF,
                        use_recurrent_connection=True, int_time_steps=100)
    enc = tst.EncodeConfig(n_steps=100)
    for training in (False, True):
        rows = tsnn.explain_dispatch(cfg, enc, device="cpu",
                                     training=training)
        assert [r["path"] for r in rows[1:]] == [
            "torch:fused_mid_reference", "torch:fused_mid_reference[head]"]
        assert not any("body" in r["reason"] for r in rows)
