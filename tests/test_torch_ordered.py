"""The plain versions in the head kernels' own summation order
(``ops/fused.py``): ``_gwin_ordered_reference`` and
``_gout_ordered_reference`` (``bwd_gwin``, ``bwd_gout`` of
``csrc/bwd_common.cuh``), the backward built on them
(``_head_bwd_ordered_reference``) and the tensor-core forward's
(``_head_train_ordered_reference``, ``csrc/head_mma_fwd.cuh:head_mma_kernel``).

On the card they are the kernels' witnesses (``tests/test_torch_cuda.py``:
the gradient functions bit for bit, the forward at the small-shape bars).
Here, on the CPU:

* each against a scalar loop of the same order, bit for bit (the periodic
  table's eight running sums, the blocks' walk over the rows);
* the ordered backward against the order-free plain backward
  (``_head_bwd_reference``) on the same residuals, TTFS and periodic, T = 24
  and 100, tau = 20 and the production tau, two kernel plans: the small-shape
  bars (2e-6 of max|g|, 5e-6 at T = 100; bf16 2**-7);
* the ordered forward against the order-free plain forward: logits and
  residuals 1e-5, spikes equal, where the function is not ill-conditioned;
* both against the JAX Pallas kernel pair in interpret mode (forward and
  ``jax.grad``) at the JAX suite's bars.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_fused as jfused  # noqa: E402
from snnimageclassification_tpu.ops.cells import (  # noqa: E402
    ALIFConfig,
    LIFConfig,
    ReadoutConfig,
)
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
from snnimageclassification_tpu_torch.ops import fused  # noqa: E402
from snnimageclassification_tpu_torch.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType,
)

PROD_TAU = 20e-3
FAST = SpikeFuncType.FastSigmoid
# Two plans of the gradient functions: (groups, rows a batch) of bwd_gwin
# and of bwd_gout -- several batches a block, and one row a batch -- and the
# row groups of gbits_mma (g_W_rec).
ORDERS = [dict(groups_in=3, rows_in=4, groups_out=5, rows_out=4,
               groups_rec=3),
          dict(groups_in=7, rows_in=1, groups_out=2, rows_out=2,
               groups_rec=2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ordered plain versions run many small tensor ops: faster on one
    thread than on a thread pool that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(B, F, H, O, T, alif, rec, use_periods, wdtype, tau, seed=11):
    rng = np.random.default_rng(seed)
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32))
    lat = pixels_to_firing_periods(pixels, t_max=float(T), tau=tau)

    def w(shape, std):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32))

    w_in = w((F, H), 0.5).to(wdtype)
    w_rec = ((w((H, H), 0.3) * (1 - torch.eye(H))).to(wdtype)
             if rec else None)
    return dict(lat=lat.contiguous(), w_in=w_in, w_rec=w_rec,
                beta=1.6 if alif else 0.0, w_out=w((H, O), 1.0).to(wdtype),
                b_out=w((O,), 0.1), n_steps=T, use_periods=use_periods,
                alif=alif, alpha=cfg.alpha, rho=cfg.rho if alif else 0.0,
                threshold=cfg.threshold, gamma=cfg.gamma,
                kappa=ReadoutConfig(input_size=H, output_size=O).kappa)


def _fwd(a):
    return (a["lat"], a["w_in"], a["w_rec"], a["beta"], a["w_out"],
            a["b_out"], a["n_steps"], a["use_periods"], a["alif"],
            a["alpha"], a["rho"], a["threshold"], a["kappa"])


def _bwd(a, g_logits, delta, tstar):
    return (g_logits, None, tstar, delta, None, a["lat"], a["w_in"],
            a["w_rec"], a["beta"], a["w_out"], a["n_steps"],
            a["use_periods"], a["alpha"], a["threshold"], a["gamma"],
            a["kappa"], FAST)


def _grad_err(got, want):
    worst = 0.0
    for g, p in zip(got, want):
        if p is None:
            assert g is None
            continue
        assert g.dtype == p.dtype and g.shape == p.shape
        scale = float(p.float().abs().max()) or 1.0
        worst = max(worst, float((g.float() - p.float()).abs().max()) / scale)
    return worst


def test_period_table_sums_in_the_kernels_order():
    """S[p] = sum of d(j p): eight running sums over j = 1 .. 8 mod 8, then
    ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)), bit for bit a
    float32 scalar loop of bwd_common.cuh:period_sum; row 1 is d(0) at
    T = 1; only the periods in use are built."""
    rng = np.random.default_rng(0)
    for T in (1, 2, 7, 24, 100):
        d = (rng.standard_normal((3, T, 4))
             * 2.0 ** rng.integers(-8, 9, (3, T, 4))).astype(np.float32)
        keys = torch.from_numpy(rng.integers(0, T + 1, (3, 9)))
        table = fused._period_table(torch.from_numpy(d), keys).numpy()
        used = set((keys[keys > 0] - 1).tolist())
        for p in range(T):
            want = np.zeros((3, 4), np.float32)
            if T == 1 and p == 0:
                want = d[:, 0]
            elif p in used and p > 0:
                s8 = np.zeros((8, 3, 4), np.float32)
                for j in range(1, (T - 1) // p + 1):
                    s8[(j - 1) % 8] = s8[(j - 1) % 8] + d[:, j * p]
                want = ((s8[0] + s8[1]) + (s8[2] + s8[3])) + \
                    ((s8[4] + s8[5]) + (s8[6] + s8[7]))
            np.testing.assert_array_equal(table[:, p + 1], want)
        assert not table[:, 0].any()


@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_gradient_functions_walk_rows_as_the_kernels(use_periods):
    """Block j walks the batches j, j + groups, .. of `rows` rows, rows
    ascending, adding one gathered table row a (row, feature) (bwd_gwin)
    and z(t) round(s(t)) in ascending t (bwd_gout) into its slab; the
    slabs are summed in order.  Bit for bit a float32 scalar loop."""
    rng = np.random.default_rng(1)
    B, F, H, O, T, groups, rows = 11, 5, 3, 2, 7, 2, 2
    lat = torch.from_numpy(rng.integers(-1, T + 2, (B, F)).astype(np.int32))
    dcur = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    got = fused._gwin_ordered_reference(dcur, lat, T, use_periods, groups,
                                        rows).numpy()
    key = fused.spike_keys(lat, T, use_periods).numpy() + 1
    table = (fused._period_table(dcur, torch.from_numpy(key)).numpy()
             if use_periods else np.concatenate(
                 [np.zeros((B, 1, H), np.float32), dcur.numpy()], 1))
    slabs = np.zeros((groups, F, H), np.float32)
    for j in range(groups):
        for q in range(j, -(-B // rows), groups):
            for b in range(q * rows, min(q * rows + rows, B)):
                for f in range(F):
                    slabs[j, f] = slabs[j, f] + table[b, key[b, f]]
    np.testing.assert_array_equal(got, fused.slab_sums(
        torch.from_numpy(slabs).view(groups, -1), None).view(F, H).numpy())

    z = torch.from_numpy((rng.random((T, B, H)) < 0.5).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, O)).astype(np.float32))
    tstar = torch.from_numpy(rng.integers(0, T, (B, O)).astype(np.int32))
    kappa = np.float32(0.9)
    g_w, g_b = fused._gout_ordered_reference(z, g, tstar, float(kappa),
                                             torch.bfloat16, groups, rows)
    sw = np.zeros((groups, H, O), np.float32)
    sb = np.zeros((groups, O), np.float32)
    for j in range(groups):
        for q in range(j, -(-B // rows), groups):
            for b in range(q * rows, min(q * rows + rows, B)):
                s = np.zeros(O, np.float32)
                rs = np.zeros(O, np.float32)
                sr = np.zeros((T, O), np.float32)
                for t in range(T - 1, -1, -1):
                    s = kappa * s + g[b].numpy() * (
                        tstar[b].numpy() == t).astype(np.float32)
                    sr[t] = torch.from_numpy(s).to(torch.bfloat16).float() \
                        .numpy()
                    rs = rs + s
                sb[j] = sb[j] + rs
                for t in range(T):
                    sw[j] = sw[j] + z[t, b].numpy()[:, None] * sr[t][None]
    out = fused.slab_sums(torch.from_numpy(
        np.concatenate([sw.reshape(groups, -1), sb], 1)), None)
    np.testing.assert_array_equal(g_w.numpy(), out[:H * O].view(H, O))
    np.testing.assert_array_equal(g_b.numpy(), out[H * O:])


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tensor_core_gout_order_forms_the_same_product(wdtype):
    """tools/gout_mma_probe.py's plain version of the tensor-core bwd_gout
    (k16 slices of a row's steps, s_r as its bf16 pieces) sums z^T s_r over
    the rows and steps, partial slices included: within 2e-6 of max|g| of
    the exact sum and of bwd_gout's ordered plain version."""
    from snnimageclassification_tpu_torch.tools import gout_mma_probe

    rng = np.random.default_rng(2)
    B, H, O, T, groups, rows = 11, 20, 10, 37, 2, 2
    z = torch.from_numpy((rng.random((T, B, H)) < 0.5).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, O)).astype(np.float32))
    tstar = torch.from_numpy(rng.integers(0, T, (B, O)).astype(np.int32))
    s_r, _ = fused._s_chains(g, tstar, 0.9, wdtype, T)
    got = gout_mma_probe.mma_ordered(z, s_r, wdtype, groups, rows)
    exact = torch.einsum("tbh,tbo->ho", z.double(), s_r.double())
    fma, _ = fused._gout_ordered_reference(z, g, tstar, 0.9, wdtype, groups,
                                           rows)
    scale = float(exact.abs().max())
    assert float((got.double() - exact).abs().max()) <= 2e-6 * scale
    assert _grad_err([got], [fma]) <= 2e-6


@pytest.mark.parametrize("order", ORDERS, ids=["r4", "r1"])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps,tau", [(24, 20.0), (100, PROD_TAU),
                                         (100, 20.0)],
                         ids=["24", "100-prod", "100"])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_ordered_backward_matches_the_plain_backward(use_periods, n_steps,
                                                     tau, wdtype, order):
    """On the same residuals the ordered backward is the order-free plain
    backward within the small-shape bars."""
    a = _args(37, 30, 45, 10, n_steps, True, True, use_periods, wdtype, tau)
    _, delta, _, tstar, _ = fused._head_train_reference(*_fwd(a), True,
                                                        False, False)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (37, 10)).astype(np.float32))
    args = _bwd(a, g, delta, tstar)
    got = fused._head_bwd_ordered_reference(*args, order)
    want = fused._head_bwd_reference(*args)
    bar = (2.0 ** -7 if wdtype == torch.bfloat16
           else 5e-6 if n_steps >= 100 else 2e-6)
    assert _grad_err(got, want) <= bar
    assert float(got[0].float().abs().max()) > 0


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("alif,rec,use_periods,n_steps,tau", [
    (True, True, False, 24, PROD_TAU),  # the dense input product
    (True, True, True, 24, PROD_TAU),   # the every-step run
    (False, True, True, 100, 20.0),     # many periods a step
    (True, False, False, 100, 20.0),
], ids=["alif-rec-ttfs-prod", "alif-rec-periodic-prod", "lif-rec-periodic",
        "alif-ff-ttfs"])
def test_ordered_forward_matches_the_plain_forward(alif, rec, use_periods,
                                                   n_steps, tau, wdtype):
    """The tensor-core forward's ordered plain version against the
    order-free one: logits and residuals within 1e-5 (bf16 2**-7), tstar
    and counts equal."""
    a = _args(37, 30, 128, 10, n_steps, alif, rec, use_periods, wdtype, tau)
    got = fused._head_train_ordered_reference(*_fwd(a), True, False, True)
    want = fused._head_train_reference(*_fwd(a), True, False, True)
    tol = 1e-5 if wdtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1].float(), want[1].float(), atol=tol,
                               rtol=tol)
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
    assert float(got[4].sum()) > 0


@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_ordered_versions_match_pallas(use_periods):
    """Against the JAX kernel pair in interpret mode (T = 24, two time
    blocks): the ordered forward's logits within 1e-5, the ordered
    backward's gradients (fed the plain forward's residuals, cotangent r
    of sum(logits * r)) within the JAX suite's 2e-6 of max|g|."""
    a = _args(5, 30, 20, 10, 24, True, True, use_periods, torch.float32,
              20.0, seed=3)
    r = np.random.default_rng(4).standard_normal((5, 10)).astype(np.float32)
    lat = jnp.asarray(a["lat"].numpy())
    leaves = {k: jnp.asarray(a[k].numpy())
              for k in ("w_in", "w_rec", "w_out", "b_out")}
    tail = (24, use_periods, True, a["alpha"], a["rho"], a["threshold"],
            a["gamma"], a["kappa"], JSpike.FastSigmoid, True)

    def logits(lv):
        return jfused.fused_encode_rec_scan_head(
            lat, lv["w_in"], lv["w_rec"], jnp.float32(1.6), lv["w_out"],
            lv["b_out"], *tail)

    want = logits(leaves)
    jg = jax.grad(lambda lv: jnp.sum(logits(lv) * r))(leaves)
    got = fused._head_train_ordered_reference(*_fwd(a), True, False, False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    _, delta, _, tstar, _ = fused._head_train_reference(*_fwd(a), True,
                                                        False, False)
    order = ORDERS[0]
    grads = fused._head_bwd_ordered_reference(
        *_bwd(a, torch.from_numpy(r), delta, tstar), order)
    for k, g in zip(("w_in", "w_rec", "w_out"), grads):
        want_g = np.asarray(jg[k])
        scale = float(np.abs(want_g).max())
        np.testing.assert_allclose(g.numpy() / scale, want_g / scale,
                                   atol=2e-6, rtol=0, err_msg=k)
