"""The head kernels against their plain PyTorch versions on a CUDA card.

Needs the card and no JAX, so on the card it runs without the suite's
conftest (which imports JAX)::

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Elsewhere every case skips.  Shapes are the JAX suite's head cases
(B=5, 30-20-10, T=12 and T=24) plus one at the flagship width.

* ``fused_head_fwd``: logits to atol=rtol=1e-5 (the kernel and cuBLAS sum
  in different orders).
* ``fused_head_fwd_train``: logits bitwise equal to ``fused_head_fwd``'s;
  ``tstar`` and counts equal to the plain version's, residuals within 1e-5.
* ``fused_head_bwd``: fed the training kernel's own residuals and
  ``tstar``, as its plain version is, so no spike flip stands between
  them; each gradient scaled by its max, within 2e-6 (sums of a few
  hundred float32 terms in another order), bf16 within one rounding of the
  result (2**-7); two runs give equal bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snnimageclassification_tpu_torch.ops import fused  # noqa: E402
from snnimageclassification_tpu_torch.ops.cells import (  # noqa: E402
    ALIFConfig,
    LIFConfig,
    ReadoutConfig,
)
from snnimageclassification_tpu_torch.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
from snnimageclassification_tpu_torch.ops.surrogate import (  # noqa: E402
    SpikeFuncType,
)

CASES = [  # name, alif, recurrent, use_periods, n_steps
    ("alif-rec-ttfs", True, True, False, 12),
    ("alif-ff-periodic", True, False, True, 12),
    ("lif-rec-periodic", False, True, True, 12),
    ("alif-rec-2blocks", True, True, False, 24),
    ("lif-ff-2blocks", False, False, True, 24),
    ("alif-ff-periodic-2blocks", True, False, True, 24),
]
FAST, PHI = SpikeFuncType.FastSigmoid, SpikeFuncType.Phi
BWD_CASES = [(*c, FAST) for c in CASES] + [
    ("alif-rec-phi", True, True, False, 12, PHI),
    ("lif-rec-phi-periodic", False, True, True, 24, PHI),
    ("alif-ff-phi-2blocks", True, False, True, 24, PHI),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(dev, B, F, H, O, T, alif, rec, use_periods, wdtype,
          spike_func=FAST, seed=11, w_scale=(0.5, 0.3)):
    rng = np.random.default_rng(seed)
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(dev)
    lat = pixels_to_firing_periods(pixels, t_max=float(T), tau=20.0)

    def w(shape, std):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    w_in = w((F, H), w_scale[0]).to(wdtype)
    w_rec = ((w((H, H), w_scale[1]) * (1 - torch.eye(H, device=dev)))
             .to(wdtype) if rec else None)
    w_out = w((H, O), 1.0).to(wdtype)
    b_out = w((O,), 0.1)
    common = dict(n_steps=T, use_periods=use_periods, alif=alif,
                  alpha=cfg.alpha, rho=cfg.rho if alif else 0.0,
                  threshold=cfg.threshold, gamma=cfg.gamma,
                  kappa=ReadoutConfig(input_size=H, output_size=O).kappa,
                  spike_func=spike_func)
    return dict(latencies=lat.contiguous(), w_in=w_in, w_rec=w_rec,
                beta=1.6 if alif else 0.0, w_out=w_out, b_out=b_out,
                **common)


def _call(args, plain=False, counts=False):
    a = dict(args)
    w_rec = a.pop("w_rec")
    name = ("fused_encode_{}_scan_head" + ("_counts" if counts else "")
            + ("_reference" if plain else "")).format(
                "ff" if w_rec is None else "rec")
    fn = getattr(fused, name)
    return fn(**a) if w_rec is None else fn(w_rec=w_rec, **a)


def _train_args(args):
    """Positional arguments of the training forward and its plain version."""
    k = args
    return (k["latencies"], k["w_in"], k["w_rec"], k["beta"], k["w_out"],
            k["b_out"], k["n_steps"], k["use_periods"], k["alif"],
            k["alpha"], k["rho"], k["threshold"], k["kappa"])


def _bwd_args(args, g_logits, g_counts, delta, a_tr, tstar):
    k = args
    return (g_logits, g_counts, tstar, delta, a_tr, k["latencies"],
            k["w_in"], k["w_rec"], k["beta"], k["w_out"], k["n_steps"],
            k["use_periods"], k["alpha"], k["threshold"], k["gamma"],
            k["kappa"], k["spike_func"])


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,alif,rec,use_periods,n_steps", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version(card, name, alif, rec, use_periods,
                                      n_steps, wdtype):
    args = _args(card, 5, 30, 20, 10, n_steps, alif, rec, use_periods,
                 wdtype)
    fused.reset_launch_counts()
    got, want = _call(args), _call(args, plain=True)
    torch.cuda.synchronize()
    assert fused.launch_counts()[fused.KERNEL] == 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_flagship_width(card):
    args = _args(card, 256, 784, 128, 10, 100, True, True, False,
                 torch.float32)
    got, want = _call(args), _call(args, plain=True)
    assert bool(torch.isfinite(got).all())
    agree = float((got.argmax(1) == want.argmax(1)).float().mean())
    assert agree >= 0.995


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(card):
    lat = torch.zeros((2, 4), dtype=torch.int64, device=card)
    w = torch.zeros((4, 3), device=card)
    with pytest.raises(ValueError, match="latencies"):
        fused.fused_encode_ff_scan_head(
            lat, w, 0.0, torch.zeros((3, 2), device=card),
            torch.zeros(2, device=card), 6, False, False, 0.9, 0.0, 1.0,
            1.0, 0.9)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,alif,rec,use_periods,n_steps,spike_func",
                         BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_train_and_backward_kernels_match_plain_versions(
        card, name, alif, rec, use_periods, n_steps, spike_func, wdtype):
    args = _args(card, 37, 30, 20, 10, n_steps, alif, rec, use_periods,
                 wdtype, spike_func)
    store_a = alif and spike_func == PHI
    fused.reset_launch_counts()
    infer = _call(args)
    got = fused._head_train_cuda(*_train_args(args), True, store_a, True)
    want = fused._head_train_reference(*_train_args(args), True, store_a,
                                       True)
    torch.cuda.synchronize()
    logits, delta, a_tr, tstar, counts = got
    assert torch.equal(logits, infer)  # same arithmetic, same order
    torch.testing.assert_close(logits, want[0], atol=1e-5, rtol=1e-5)
    assert torch.equal(tstar, want[3]) and torch.equal(counts, want[4])
    # bf16 residuals: one rounding apart where the f32 values differ in
    # their last bits.
    tol = 1e-5 if wdtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(delta.float(), want[1].float(), atol=tol,
                               rtol=tol)
    assert (a_tr is None) == (not store_a)
    if store_a:
        torch.testing.assert_close(a_tr.float(), want[2].float(), atol=tol,
                                   rtol=tol)
    rng = np.random.default_rng(5)
    g_logits = torch.from_numpy(
        rng.standard_normal(logits.shape).astype(np.float32)).to(card)
    g_counts = torch.from_numpy(
        (0.01 * rng.standard_normal(counts.shape)).astype(np.float32)
    ).to(card)
    for gc in (None, g_counts):
        bargs = _bwd_args(args, g_logits, gc, delta, a_tr, tstar)
        grads = fused._head_bwd_cuda(*bargs)
        again = fused._head_bwd_cuda(*bargs)
        plain = fused._head_bwd_reference(*bargs)
        torch.cuda.synchronize()
        for gname, g, g2, p in zip(("w_in", "w_rec", "w_out", "b"), grads,
                                   again, plain):
            if p is None:
                assert g is None
                continue
            assert g.dtype == p.dtype and g.shape == p.shape
            assert torch.equal(g, g2), f"{gname}: not reproducible"
            scale = float(p.float().abs().max()) or 1.0
            err = float((g.float() - p.float()).abs().max()) / scale
            bar = 2e-6 if g.dtype == torch.float32 else 2.0 ** -7
            assert err <= bar, f"{gname}: {err:.3g} of max|g|"
    counts_now = fused.launch_counts()
    assert counts_now[fused.KERNEL_TRAIN] == 1
    assert counts_now[fused.KERNEL_BWD] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [False, True], ids=["logits", "counts"])
def test_autograd_runs_the_kernel_pair(card, counts):
    """The public wrappers under autograd launch one training forward and
    one backward and agree with the plain versions' gradients."""
    args = _args(card, 16, 30, 20, 10, 24, True, True, False, torch.float32)
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16, 10)).astype(np.float32)).to(card)

    def grads(plain):
        a = dict(args)
        leaves = {k: a[k].clone().requires_grad_(True)
                  for k in ("w_in", "w_rec", "w_out", "b_out")}
        a.update(leaves)
        a["beta"] = torch.tensor(1.6, device=card, requires_grad=True)
        out = _call(a, plain=plain, counts=counts)
        loss = (out[0] * r).sum() + 1e-3 * (out[1] ** 2).sum() if counts \
            else (out * r).sum()
        loss.backward()
        assert float(a["beta"].grad) == 0.0
        return [leaves[k].grad for k in leaves]

    fused.reset_launch_counts()
    got = grads(False)
    assert fused.launch_counts() == {fused.KERNEL: 0, fused.KERNEL_TRAIN: 1,
                                     fused.KERNEL_BWD: 1}
    for g, p in zip(got, grads(True)):
        scale = float(p.abs().max()) or 1.0
        assert float((g - p).abs().max()) / scale <= 2e-6
    with torch.no_grad():
        _call(args)
    assert fused.launch_counts()[fused.KERNEL] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_backward_flagship_width(card, use_periods, wdtype):
    """784-128-10, T=100, 256 rows, init-scale weights: 25,600 terms a
    weight gradient, summed in another order than cuBLAS: 1e-4 of max|g|
    (float32), one rounding of the result (bfloat16)."""
    args = _args(card, 256, 784, 128, 10, 100, True, True, use_periods,
                 wdtype, w_scale=(0.03, 0.03))
    logits, delta, a_tr, tstar, _ = fused._head_train_cuda(
        *_train_args(args), True, False, False)
    assert torch.equal(logits, _call(args))
    g_logits = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (256, 10)).astype(np.float32)).to(card)
    bargs = _bwd_args(args, g_logits, None, delta, a_tr, tstar)
    grads = fused._head_bwd_cuda(*bargs)
    plain = fused._head_bwd_reference(*bargs)
    bar = 1e-4 if wdtype == torch.float32 else 2.0 ** -7
    for g, p in zip(grads, plain):
        assert bool(torch.isfinite(g.float()).all())
        scale = float(p.float().abs().max()) or 1.0
        assert float((g.float() - p.float()).abs().max()) / scale <= bar


ODD_SHAPES = [  # B, F, H, O, T: padded H, several feature chunks, wide O
    (1, 7, 5, 3, 1),
    (3, 300, 33, 40, 7),
    (9, 64, 64, 10, 24),
    (130, 150, 96, 12, 50),
]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("shape", ODD_SHAPES, ids=lambda s: "x".join(
    str(v) for v in s))
def test_kernel_pair_odd_shapes(card, shape, use_periods, wdtype):
    """Shapes off the fast paths: H below and between warp multiples (the
    element-wise staging), T=1 (the clamped period is 0), more features
    than one chunk, more outputs than a warp.  Same bars as the small
    cases."""
    B, F, H, O, T = shape
    args = _args(card, B, F, H, O, T, True, True, use_periods, wdtype)
    res = fused._head_train_cuda(*_train_args(args), True, False, True)
    ref = fused._head_train_reference(*_train_args(args), True, False, True)
    assert torch.equal(res[0], _call(args))
    torch.testing.assert_close(res[0], ref[0], atol=1e-5, rtol=1e-5)
    assert torch.equal(res[3], ref[3]) and torch.equal(res[4], ref[4])
    rng = np.random.default_rng(7)
    g_logits = torch.from_numpy(
        rng.standard_normal((B, O)).astype(np.float32)).to(card)
    g_counts = torch.from_numpy(
        (0.01 * rng.standard_normal((B, H))).astype(np.float32)).to(card)
    bargs = _bwd_args(args, g_logits, g_counts, res[1], res[2], res[3])
    grads = fused._head_bwd_cuda(*bargs)
    again = fused._head_bwd_cuda(*bargs)
    plain = fused._head_bwd_reference(*bargs)
    bar = 2e-6 if wdtype == torch.float32 else 2.0 ** -7
    for g, g2, p in zip(grads, again, plain):
        assert g.shape == p.shape and torch.equal(g, g2)
        scale = float(p.float().abs().max()) or 1.0
        assert float((g.float() - p.float()).abs().max()) / scale <= bar
