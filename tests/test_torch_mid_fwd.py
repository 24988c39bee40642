"""The mid layer's forward, z-emitting and head modes (``fused_mid_{rec,ff}_
scan[_head]``, the port's plain version on the CPU), against the JAX kernel
``pallas_fused_mid._mid_fwd_call`` in interpret mode, on identical numpy
inputs: spikes, ``tstar`` and counts equal, logits within 1e-5, residuals
within 1e-5 (float32) or one bfloat16 rounding.  Cases, inputs and bars:
tests/test_torch_mid.py, whose helpers this file shares; it stands apart so
that the test runner's workers, which take whole files, spread the mid
tests.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import (  # noqa: E402
    pallas_fused_mid as jmid,
)
from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused_mid as tmid,
)
from test_torch_mid import (  # noqa: E402
    GRID,
    IDS,
    KAPPA,
    _close_trace,
    _j,
    _mid_inputs,
    _np,
    _scalars,
    _t,
)


@pytest.mark.parametrize("case,T,wd", GRID, ids=IDS)
def test_mid_forward_matches_the_jax_kernel(case, T, wd):
    """Spikes and residuals of the z-emitting mode, and logits, ``tstar``,
    counts and residuals of the head mode, against the JAX forward call."""
    name, alif, rec, spike_name = case
    _, z_in, w = _mid_inputs(T, rec)
    alif, alpha, rho, thr, gamma = _scalars(alif, spike_name)
    beta = 1.6 if alif else 0.0
    store_delta = alif and spike_name == "FastSigmoid"
    store_a = alif and spike_name == "Phi"
    jkw = dict(T=T, alif=alif, alpha=alpha, rho=rho, threshold=thr,
               store_delta=store_delta, interpret=True)
    jargs = (_j(z_in, wd), _j(w["w_in"], wd), _j(w["w_rec"], wd), beta)
    targs = (_t(z_in, wd), _t(w["w_in"], wd), _t(w["w_rec"], wd), beta)

    jtraces, _ = jmid._mid_fwd_call(*jargs, **jkw)
    _, tz, tres, ta, _, _ = tmid._mid_reference(
        *targs, None, None, T, alif, alpha, rho, thr, 0.0, True, store_a,
        False, not store_delta)
    np.testing.assert_array_equal(_np(tz), _np(jtraces[0]))
    _close_trace(tres, jtraces[1], wd, f"{name} residual")
    assert (ta is not None) == (len(jtraces) == 3)
    if ta is not None:
        _close_trace(ta, jtraces[2], wd, f"{name} a")

    jtraces, _, jlogits, jtstar, jcounts = jmid._mid_fwd_call(
        *jargs, **jkw, w_out=_j(w["w_out"], wd),
        b_out=jnp.asarray(w["b_out"]), kappa=KAPPA, store_counts=True)
    tlogits, _, tres, ta, ttstar, tcounts = tmid._mid_reference(
        *targs, _t(w["w_out"], wd), _t(w["b_out"], "float32"), T, alif,
        alpha, rho, thr, KAPPA, True, store_a, True, False)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(_np(tlogits).argmax(1),
                                  _np(jlogits).argmax(1))
    np.testing.assert_array_equal(ttstar.numpy(), np.asarray(jtstar))
    np.testing.assert_array_equal(_np(tcounts), _np(jcounts))
    _close_trace(tres, jtraces[0], wd, f"{name} head delta")
    assert (ta is not None) == (len(jtraces) == 2)
    if ta is not None:
        _close_trace(ta, jtraces[1], wd, f"{name} head a")
