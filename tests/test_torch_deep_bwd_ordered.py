"""The deep and two-layer backwards' plain versions in their kernels' order
(``ops/fused_mid.py:_mid_bwd_ordered_reference``,
``ops/fused2.py:_fused2_bwd_ordered_reference``: the chains with the
tensor-core chain body's k16-sliced products, ``g_z_in`` in ``gzin_mma``'s
order, the gradient functions' ordered versions) on the CPU, on identical
numpy inputs from a seed:

* against the order-free plain versions (``_mid_bwd_reference`` in both
  modes, ``_fused2_bwd_reference``; held against the JAX kernels by
  tests/test_torch_mid_grads.py, test_torch_mid_head_grads.py and
  test_torch_fused2_grads.py) at B = 37, H = 45 and 128, T = 24 (and one
  case at T = 100), float32 and bfloat16: ``g_z_in`` and every weight
  gradient within 1e-5 of max|g| (float32) or 2**-7 (bfloat16), and the
  chains' rounded ``dcur`` within the same bars;
* one small case of each through the port's ``autograd.Function`` with the
  ordered backward in place of the plain one, against ``jax.grad`` through
  the JAX kernel pair in interpret mode, at those files' bars;
* the ordered model of ``g_z_in`` (``fused._gzin_ordered_reference``, both
  accumulation models) against a float64 product, and ``fused_mid.gzin``'s
  plain version on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.ops import fused2 as tf2  # noqa: E402
from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused_mid as tmid,
)
from snnimageclassification_tpu_torch.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType as TSpike,
)
import test_torch_fused2_grads as f2_grads  # noqa: E402
from test_torch_fused2 import _scalars as f2_scalars  # noqa: E402
from test_torch_mid import (  # noqa: E402
    CASES,
    _scalars,
    check_mid_gradients,
)

B = 37
# Any plan is an order; these walk several blocks of rows for each
# gradient function (the card's come from the kernels' plans).
MID_ORDER = {"groups_in": 3, "groups_rec": 2, "groups_out": 4, "rows_out": 3}
F2_ORDER = {"groups_in": 3, "rows_in": 4, "groups_rec0": 2, "groups_w1": 3,
            "groups_rec1": 2, "groups_out": 4, "rows_out": 3}
F2_CASES = f2_grads.CASES  # name, alif, recurrent, surrogate, use_periods


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The ordered plain versions run many small tensor ops: faster on one
    thread than on a thread pool that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bar(wd):
    return 1e-5 if wd == torch.float32 else 2.0 ** -7


def _close(got, want, wd, label):
    for i, (g, p) in enumerate(zip(got, want)):
        if p is None:
            assert g is None, f"{label} {i}"
            continue
        assert g.dtype == p.dtype and g.shape == p.shape, f"{label} {i}"
        scale = float(p.float().abs().max()) or 1.0
        err = float((g.float() - p.float()).abs().max()) / scale
        assert err <= _bar(wd), f"{label} {i}: {err:.3g} of max|g|"


def _mid_args(case, T, H, wd, head, seed=41):
    """``_mid_bwd_reference``'s arguments on the plain forward's residuals:
    z_in 0/1 at 25 %, W_in of std 2 / sqrt(H), W_rec 1 / sqrt(H)
    eye-masked, the head 128 -> 96 -> 10 at H = 128 (45 -> 45 -> 10 at H =
    45)."""
    _, alif, rec, spike_name = case
    rng = np.random.default_rng(seed)
    Hin, Hl = (H, 96 if head and H == 128 else H)
    O = 10 if head else 0
    alif, alpha, rho, thr, gamma = _scalars(alif, spike_name)
    spike = TSpike[spike_name]

    def w(shape, std, mask=False):
        x = (std * rng.standard_normal(shape)).astype(np.float32)
        if mask:
            x = x * (1 - np.eye(shape[0], dtype=np.float32))
        return torch.from_numpy(x).to(wd)

    z_in = torch.from_numpy((rng.random((T, B, Hin)) < 0.25)
                            .astype(np.float32)).to(wd)
    w_in = w((Hin, Hl), 2.0 / np.sqrt(Hin))
    w_rec = w((Hl, Hl), 1.0 / np.sqrt(Hl), True) if rec else None
    w_out = w((Hl, O), 1.0) if head else None
    b_out = torch.from_numpy((0.1 * rng.standard_normal(O))
                             .astype(np.float32)) if head else None
    beta = 1.6 if alif else 0.0
    kappa = 0.9 if head else 0.0
    res_is_v = not head and tfused._residual_is_v(alif, spike)
    store_a = tfused._stores_a(alif, spike)
    _, z, res, a_tr, tstar, _ = tmid._mid_reference(
        z_in, w_in, w_rec, beta, w_out, b_out, T, alif, alpha, rho, thr,
        kappa, True, store_a, head, res_is_v)
    g_logits = g_counts = g_z = None
    if head:
        g_logits = torch.from_numpy(rng.standard_normal((B, O))
                                    .astype(np.float32))
        g_counts = torch.from_numpy((0.01 * rng.standard_normal((B, Hl)))
                                    .astype(np.float32))
    else:
        g_z = torch.from_numpy(rng.standard_normal((T, B, Hl))
                               .astype(np.float32)).to(wd)
    return (g_logits, g_counts, tstar, g_z, z, res, a_tr, res_is_v, z_in,
            w_in, w_rec, beta, w_out, T, alpha, thr, gamma, kappa, spike)


MID_GRID = ([(c, 24, H, wd) for c in CASES for H in (45, 128)
             for wd in (torch.float32, torch.bfloat16)]
            + [(CASES[0], 100, 45, torch.float32)])
MID_IDS = [f"{c[0]}-T{T}-H{H}-{str(wd)[6:]}" for c, T, H, wd in MID_GRID]


@pytest.mark.parametrize("case,T,H,wd", MID_GRID, ids=MID_IDS)
def test_mid_ordered_backward_matches_the_plain_version(case, T, H, wd):
    """Both modes: ``g_z_in``, ``g_W_in``, ``g_W_rec``, ``g_W_out``, ``g_b``
    and the chain's ``dcur``."""
    for head in (False, True):
        args = _mid_args(case, T, H, wd, head)
        label = f"{case[0]} {'head' if head else 'z'}"
        keep = {}
        ordered = tmid._mid_bwd_ordered_reference(*args, MID_ORDER,
                                                  keep=keep)
        plain = tmid._mid_bwd_reference(*args)
        _close(ordered, plain, wd, label)
        assert ordered[0].dtype == wd and float(ordered[0].abs().max()) > 0
        # The chain alone: dcur of the plain loop against the ordered one.
        f32 = torch.float32
        dcur = torch.zeros_like(keep["dcur"])
        tfused._bwd_loop(lambda t: args[8][t].to(f32), None, *args[:4],
                         args[5], args[6], args[4], args[7], args[10],
                         args[11], args[12], T, *args[14:], wd,
                         dcur_out=dcur)
        _close([keep["dcur"]], [dcur], wd, f"{label} dcur")


def _f2_args(case, T, H, wd, seed=43, F=30):
    """``_fused2_bwd_reference``'s arguments (both counts' cotangents) on
    the plain forward's residuals, at a scale where both layers fire."""
    _, alif, rec, spike_name, per = case
    rng = np.random.default_rng(seed)
    alpha, rho, thr, gamma = f2_scalars(alif)
    spike = TSpike[spike_name]
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32))
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   tau=20.0).contiguous()

    def w(shape, std, mask=False):
        x = (std * rng.standard_normal(shape)).astype(np.float32)
        if mask:
            x = x * (1 - np.eye(shape[0], dtype=np.float32))
        return torch.from_numpy(x).to(wd)

    w0, w1 = w((F, H), 1.5), w((H, H), 1.0 * np.sqrt(20.0 / H))
    w0r = w((H, H), 0.4 * np.sqrt(20.0 / H), True) if rec else None
    w1r = w((H, H), 0.4 * np.sqrt(20.0 / H), True) if rec else None
    w_out = w((H, 10), 1.0)
    b_out = torch.from_numpy((0.1 * rng.standard_normal(10))
                             .astype(np.float32))
    b0, b1 = (1.6, 1.2) if alif else (0.0, 0.0)
    store_a = alif and spike == TSpike.Phi
    out = tf2._fused2_reference(lat, w0, w0r, b0, w1, w1r, b1, w_out, b_out,
                                T, per, alif, alpha, rho, thr, 0.9, True,
                                store_a, True)
    _, d0, a0, d1, a1, tstar, c0, c1 = out
    assert float(c0.sum()) > 0 and float(c1.sum()) > 0
    g_logits = torch.from_numpy(rng.standard_normal((B, 10))
                                .astype(np.float32))
    g_c0, g_c1 = (torch.from_numpy((0.01 * rng.standard_normal(c.shape))
                                   .astype(np.float32)) for c in (c0, c1))
    return (g_logits, g_c0, g_c1, tstar, d0, a0, d1, a1, lat, w0, w0r, b0,
            w1, w1r, b1, w_out, T, per, alpha, thr, gamma, 0.9, spike)


F2_GRID = ([(c, 24, H, wd) for c in F2_CASES for H in (45, 128)
            for wd in (torch.float32, torch.bfloat16)]
           + [(F2_CASES[0], 100, 45, torch.float32)])
F2_IDS = [f"{c[0]}-T{T}-H{H}-{str(wd)[6:]}" for c, T, H, wd in F2_GRID]


@pytest.mark.parametrize("case,T,H,wd", F2_GRID, ids=F2_IDS)
def test_fused2_ordered_backward_matches_the_plain_version(case, T, H, wd):
    """The six gradients, and ``dz0 = dcur1 @ W1^T`` (float32, as the
    kernel's scratch) against the plain loop's."""
    args = _f2_args(case, T, H, wd)
    keep = {}
    ordered = tf2._fused2_bwd_ordered_reference(*args, F2_ORDER, keep=keep)
    plain = tf2._fused2_bwd_reference(*args)
    _close(ordered, plain, wd, case[0])
    f32 = torch.float32
    z0 = (args[4].to(f32) >= 0).to(f32)
    dz0, _, _, _, _ = tfused._bwd_loop(
        lambda t: z0[t], args[12].to(f32).T, args[0], args[2], args[3],
        None, args[6], args[7], None, False, args[13], args[14], args[15], T,
        *args[18:], wd)
    _close([keep["dz0"]], [dz0 + args[1]], wd, f"{case[0]} dz0")


def test_mid_ordered_backward_matches_the_jax_kernel(monkeypatch):
    """ALIF, recurrent, FastSigmoid, T = 24, float32, both modes (the
    head with counts) through ``fused_mid``'s ``autograd.Function`` with the
    ordered backward, against ``jax.grad`` of the JAX kernel pair."""
    monkeypatch.setattr(tmid, "_mid_bwd_reference",
                        lambda *a: tmid._mid_bwd_ordered_reference(
                            *a, MID_ORDER))
    for kind in ("mid", "counts"):
        check_mid_gradients(CASES[0], 24, "float32", kind)


def test_fused2_ordered_backward_matches_the_jax_kernel(monkeypatch):
    """ALIF, recurrent, FastSigmoid, TTFS, T = 24, float32, with both
    counts' cotangents, through ``fused2``'s ``autograd.Function`` with the
    ordered backward, against ``jax.grad`` of the JAX kernel pair."""
    monkeypatch.setattr(tf2, "_fused2_bwd_reference",
                        lambda *a: tf2._fused2_bwd_ordered_reference(
                            *a, F2_ORDER))
    f2_grads.test_gradients_match_the_jax_kernel(F2_CASES[0], 24, "float32",
                                                 "counts")


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N", [(45, 45), (128, 128), (96, 128)])
def test_gzin_ordered_model_against_a_float64_product(K, N, wd):
    """Each element within 2**-18 of sum_k |dcur| |w| of the float64 product
    of the same (rounded) operands, under both accumulation models (a few
    float32 roundings of the k16 slices' sums; the float32 pieces' dropped
    products below 2**-24 of a term); and ``fused_mid.gzin``'s plain
    version on the CPU (a float32 product: 2**-16)."""
    rng = np.random.default_rng(K + N)
    dcur = torch.from_numpy(rng.standard_normal((5, 7, K))
                            .astype(np.float32)).to(wd)
    w = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)) \
        .to(wd)
    f64 = torch.float64
    exact = torch.einsum("btk,nk->tbn", dcur.to(f64), w.to(f64))
    mag = torch.einsum("btk,nk->tbn", dcur.to(f64).abs(), w.to(f64).abs())
    for card in (False, True):
        got = tfused._gzin_ordered_reference(dcur, w, wd, card)
        assert got.dtype == torch.float32 and got.shape == (7, 5, N)
        assert bool(((got.to(f64) - exact).abs() <= 2.0 ** -18 * mag).all())
    plain = tmid.gzin(dcur, w, torch.float32)
    assert bool(((plain.to(f64) - exact).abs() <= 2.0 ** -16 * mag).all())
    assert tmid.gzin(dcur, w).dtype == wd
