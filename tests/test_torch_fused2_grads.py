"""Gradients of the port's two-layer pair (``ops/fused2.py``, its plain
PyTorch versions on the CPU) against ``jax.grad`` through the JAX kernel pair
(``ops/pallas_fused2.py``) in interpret mode, on identical numpy inputs.

Cases: LIF/ALIF x rec/ff x FastSigmoid/Phi x TTFS/periodic (five
combinations), T = 24 and 100, float32 and bfloat16 weights, through
``fused2_{rec,ff}_head_counts`` (loss ``sum(logits r) + sum(cnt0 q0) +
sum(cnt1 q1)``: the counts' cotangent enters both layers) and, float32,
``fused2_{rec,ff}_head``.  Logits within 1e-5, counts equal; each gradient
scaled by its max: float32 2e-6 (2e-5 for ALIF with Phi), bfloat16 2**-7,
both doubled at T = 100 (tests/test_torch_mid.py's bars for the mid head,
which this pair's layer 1 is); both betas' cotangents are zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import (  # noqa: E402
    pallas_fused2 as jf2,
)
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
from snnimageclassification_tpu_torch.ops import fused2 as tf2  # noqa: E402
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)
from test_torch_fused2 import (  # noqa: E402
    B,
    H1,
    H2,
    KAPPA,
    O,
    _np,
    _scalars,
    _t,
    inputs,
)

CASES = [  # name, alif, recurrent, surrogate, use_periods
    ("alif-rec-fs-ttfs", True, True, "FastSigmoid", False),
    ("alif-ff-phi-periodic", True, False, "Phi", True),
    ("alif-rec-phi-ttfs", True, True, "Phi", False),
    ("lif-rec-phi-periodic", False, True, "Phi", True),
    ("lif-ff-fs-ttfs", False, False, "FastSigmoid", False),
]
GRID = [(c, T, wd, kind) for c in CASES for T in (24, 100)
        for wd in ("float32", "bfloat16") for kind in ("counts", "head")
        if kind == "counts" or wd == "float32"]
IDS = [f"{c[0]}-T{T}-{wd}-{kind}" for c, T, wd, kind in GRID]
LEAVES = ("w0", "w0r", "w1", "w1r", "w_out", "b_out")


def _bar(spike_name, alif, wd, T):
    long = 2.0 if T > 24 else 1.0
    if wd == "bfloat16":
        return 2.0 ** -7 * long
    return (2e-5 if spike_name == "Phi" and alif else 2e-6) * long


@pytest.mark.parametrize("case,T,wd,kind", GRID, ids=IDS)
def test_gradients_match_the_jax_kernel(case, T, wd, kind):
    name, alif, rec, spike_name, per = case
    lat, w, betas = inputs(T, alif, rec, seed=31)
    alpha, rho, thr, gamma = _scalars(alif)
    rng = np.random.default_rng(32)
    r = rng.standard_normal((B, O)).astype(np.float32)
    q0 = (0.05 * rng.standard_normal((B, H1))).astype(np.float32)
    q1 = (0.05 * rng.standard_normal((B, H2))).astype(np.float32)
    names = [k for k in LEAVES if w[k] is not None]
    counts = kind == "counts"
    tail = (T, per, alif, alpha, rho, thr, gamma, KAPPA)
    sfx = "_counts" if counts else ""
    jfn = getattr(jf2, f"fused2_{'rec' if rec else 'ff'}_head{sfx}")
    tfn = getattr(tf2, jfn.__name__)

    def order(leaves, b0, b1):
        if rec:
            return (leaves["w0"], leaves["w0r"], b0, leaves["w1"],
                    leaves["w1r"], b1, leaves["w_out"], leaves["b_out"])
        return (leaves["w0"], b0, leaves["w1"], b1, leaves["w_out"],
                leaves["b_out"])

    def jloss(leaves, b0, b1):
        out = jfn(jnp.asarray(lat), *order(leaves, b0, b1), *tail,
                  JSpike[spike_name], True)  # interpret mode
        if counts:
            lg, (c0, c1) = out
            return (jnp.sum(lg * r) + jnp.sum(c0 * q0)
                    + jnp.sum(c1 * q1)), out
        return jnp.sum(out * r), out

    jleaves = {k: jnp.asarray(w[k]).astype("float32" if k == "b_out" else wd)
               for k in names}
    (_, jout), (jg, jg0, jg1) = jax.value_and_grad(
        jloss, (0, 1, 2), has_aux=True)(jleaves, jnp.float32(betas[0]),
                                        jnp.float32(betas[1]))

    tleaves = {k: _t(w[k], "float32" if k == "b_out" else wd, True)
               for k in names}
    tb0, tb1 = (torch.tensor(b, requires_grad=True) for b in betas)
    tout = tfn(torch.from_numpy(lat), *order(tleaves, tb0, tb1), *tail,
               TSpike[spike_name])
    if counts:
        tl, (tc0, tc1) = tout
        jl, (jc0, jc1) = jout
        np.testing.assert_array_equal(_np(tc0), _np(jc0))
        np.testing.assert_array_equal(_np(tc1), _np(jc1))
        assert float(tc1.detach().sum()) > 0
        loss = ((tl * torch.from_numpy(r)).sum()
                + (tc0 * torch.from_numpy(q0)).sum()
                + (tc1 * torch.from_numpy(q1)).sum())
    else:
        tl, jl = tout, jout
        loss = (tl * torch.from_numpy(r)).sum()
    np.testing.assert_allclose(_np(tl), _np(jl), atol=1e-5, rtol=1e-5)
    loss.backward()
    assert float(tb0.grad) == 0.0 and float(tb1.grad) == 0.0
    assert float(jg0) == 0.0 and float(jg1) == 0.0
    bar = _bar(spike_name, alif, wd, T)
    for k, v in tleaves.items():
        assert v.grad.dtype == v.dtype and v.grad.shape == v.shape, k
        want = _np(jg[k])
        scale = max(float(np.abs(want).max()), 1e-12)
        assert scale > 1e-9, f"{name} {k}: no gradient reaches this leaf"
        np.testing.assert_allclose(_np(v.grad) / scale, want / scale,
                                   atol=bar, rtol=0, err_msg=f"{name} {k}")
