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
* the deep-network kernels (``fused_layer0_fwd/bwd``, ``fused_mid_fwd/bwd``)
  as a chain layer 0 -> mid -> mid head through the public functions,
  forward and backward, against the same chain of ``*_reference``
  functions, at T = 24 and T = 100: spikes and counts equal, logits 1e-5,
  gradients 2e-6 of max|g| (5e-6 at T = 100, 2e-5 for ALIF with Phi; bf16
  2**-6: a chain of three roundings), launches counted.
* the Izhikevich kernels (``izh_scan_fwd/bwd``, ``fused_izh_fwd[_train]``,
  ``fused_izh_layer0_fwd``, ``fused_izh_bwd``, ``fused_izh_layer0_bwd``) at
  the JAX suite's weight scale (W_in 3e6, W_rec 5e5, currents 3e6 + 1e6
  N(0, 1)), T = 24 and 100: spikes, ``tstar`` and counts equal, ``v``
  bitwise where no recurrent sum differs in order (ff) and within 1e-6
  relative and 1e-3 mV otherwise (input sums of ~1e8 in another order move
  v by ~1e-4 mV a step), logits 1e-5; each backward on the forward kernel's
  own residuals within 2e-6 of max|g| (5e-6 at T = 100, bf16 2**-7), equal
  bits on a second run; the three backward kernels again at dt = 30 with
  init-scale weights, where the chain's u carry matters (1e-4 of max|g|,
  bf16 2**-7); the models' dispatch names the kernels and launches each
  once.  The head's tensor-core body (``test_izh_mma_body_*``, ff/rec x
  TTFS/periodic x FastSigmoid/Phi x T = 1, 2, 24, 100 x f32/bf16 at dt =
  1e-3 and dt = 30): logits, ``v``, ``tstar`` and counts bit for bit the
  plain version in its order (``fused_izh._izh_head_train_ordered_reference``),
  a row's bits independent of its batch, the backward against both plain
  versions at the bars above, the stacked mode bitwise S single launches;
  shapes past its limits run the per-unit body (``head_bodies``); layer 0
  runs the same body without the readout, its ``v`` the head's bit for
  bit.
* the first layers on the tensor-core body (``fused_layer0_fwd``,
  ``fused_izh_layer0_fwd``) bit for bit their plain versions in its order
  (``_layer0_ordered_reference``, ``_izh_layer0_ordered_reference``),
  their spikes the heads'; their backwards' chains on the tensor-core chain
  body (``fused_layer0_bwd``, ``fused_izh_layer0_bwd``) against their plain
  versions in its order (``_layer0_bwd_ordered_reference``,
  ``_izh_bwd_ordered_reference``'s first-layer mode: dcur / gi and both
  gradients at the chain's bars, the Izhikevich one at dt = 1e-3 and 30);
  past their limits the per-unit bodies against the order-free plain
  versions; ``explain_dispatch`` names both.
* the two-layer pair (``fused2_fwd[_train]``, ``fused2_bwd``) at T = 24 and
  100: logits 1e-5, ``tstar``, counts and spikes equal to the plain
  version's, residuals 1e-5 (bf16 2**-7), training logits bitwise the
  inference kernel's; the backward on the forward kernel's residuals within
  2e-6 of max|g| (5e-6 at T = 100, 2e-5 ALIF with Phi, bf16 2**-7), equal
  bits on a second run; logits, ``tstar``, counts and residuals bitwise
  those of the composed kernels (``fused_layer0_fwd`` +
  ``fused_mid_fwd[head]``, on the tensor-core bodies and past them), its
  six gradients bitwise those of ``fused_mid_bwd`` + ``fused_layer0_bwd``
  in float32 (2**-6 bf16); the public functions under autograd and the
  model's dispatch launch the pair once.
* the feedforward scan (``scan_fwd[_train]``, ``scan_bwd``) at T = 23, 24
  and 100, small and at B = 8192: spikes equal to the plain version's,
  residuals 1e-5 (bf16 2**-7), the backward on the training kernel's
  residuals within 2e-6 of max|g| (bf16 2**-7), equal
  bits twice; 784-ALIF256-10 and 784-LIF128-10 on constant-pixel input
  served (one ``scan_fwd`` a batch, bitwise a direct forward) and trained
  (one ``scan_fwd_train`` and one ``scan_bwd`` a step, gradients against
  the per-step loop's).
* the recurrent scan's tensor-core cluster body (``csrc/rec_mma.cuh``) at
  H = 20, 40, 200, 300, 512, 1024, B = 37, T = 100, LIF/ALIF x
  FastSigmoid/Phi: spikes and residuals bit for bit
  ``rec_scan._fwd_ordered_reference``, the bf16 chain's g_i within 2**-7
  of max|g| of ``_chain_ordered_reference``, a row's bits independent of
  its batch; float32 chains and float32 H = 1024 keep the CUDA-core
  body.  Where the chain runs the cluster body, the unfused
  tier's backward is held against its plain version in that order as well
  as the order-free one (``_rec_check``).
* ``gbits_mma`` (every g_W_rec and a mid layer's g_W_in) in each caller
  (the head over ``GRAD_SHAPES``, layer 0 and the mid layers, the two-layer
  pair, the Izhikevich head, first layer and scan, the stacked head at S =
  6, the wide net's ``rec_scan_bwd``) and alone: bit for bit its ordered
  plain version below 300 rows of a batch, from 300 rows within twice the
  error of the bit walk it replaced against the float64 sum of the same
  operands (``_gbits_check``; the bitwise share recorded).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused,
    fused2,
    fused_izh,
    fused_mid,
    gbits,
    head_mma,
    izh,
)
from snnimageclassification_tpu_torch.ops.cells import (  # noqa: E402
    ALIFConfig,
    IzhikevichConfig,
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
          spike_func=FAST, seed=11, w_scale=(0.5, 0.3), tau=20.0):
    rng = np.random.default_rng(seed)
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(dev)
    lat = pixels_to_firing_periods(pixels, t_max=float(T), tau=tau)

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


def _launched():
    """The kernels launched since the last reset, with their counts."""
    return {k: n for k, n in fused.launch_counts().items() if n}


def _functions_launched():
    """The ``__global__`` functions counted inside the calls (``gbits_mma``,
    ``gzin_mma``) launched since the last reset, with their counts."""
    return {k: n for k, n in fused.function_launch_counts().items() if n}


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
    assert _launched() == {fused.KERNEL_TRAIN: 1, fused.KERNEL_BWD: 1}
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


# The head pair's tensor-core body: H below, between and at multiples of
# 32 (padded units), B not a multiple of 16 (padded rows), F = 30 (a
# partial k16 slice), T = 1, 2, 24 and 100.  At the production tau
# (20e-3) every supra-threshold pixel fires at t = 0, so TTFS rows take the
# dense input product and the periodic ones a long every-step run; at
# tau = 20 steps the spikes spread over the window and the rows gather.
# Every case is held against the plain versions in the body's own
# summation order (fused._head_train_ordered_reference,
# fused._head_bwd_ordered_reference) at the bars below.  Periodic at the
# production tau and T = 100 (the main path's configuration) is
# ill-conditioned at these weights: a period-1 run of ~24 features a step
# drives v far past the threshold, and the order-free plain float32
# version, or one with its features and units permuted, misses the
# residual bar (by 1.1e-5-1.4e-5 past 1e-5) and the backward's (up to
# 8.6e-5 of max|g|); those cases are held against the ordered versions
# only, the others against the order-free plain versions too.  The ordered
# backward's chain takes each tensor-core k16 slice's exact sum rounded to
# nearest; the card truncates inside a slice, which stays within these bars.
PROD_TAU = 20e-3
MMA_STEPS = [(1, PROD_TAU), (2, PROD_TAU), (24, 20.0), (24, PROD_TAU),
             (100, 20.0), (100, PROD_TAU)]
MMA_NETS = [  # name, alif, recurrent, use_periods, surrogate
    (f"{'alif' if alif else 'lif'}-{'rec' if rec else 'ff'}-"
     f"{'periodic' if per else 'ttfs'}", alif, rec, per,
     PHI if alif and rec and not per else FAST)
    for alif in (True, False) for rec in (True, False)
    for per in (False, True)]
MMA_CASES = [(*net, n, tau) for net in MMA_NETS for n, tau in MMA_STEPS]


def _ill_conditioned(use_periods, n_steps, tau):
    return use_periods and n_steps == 100 and tau == PROD_TAU


def _bwd_bar(wdtype, n_steps):
    """The backward's bar at small shapes: 2e-6 of max|g| (5e-6 at
    T = 100, a few hundred float32 terms in another order a weight), bf16
    one rounding of the result."""
    if wdtype != torch.float32:
        return 2.0 ** -7
    return 5e-6 if n_steps >= 100 else 2e-6


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


@pytest.mark.cuda
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("n_steps", [1, 2, 23, 24, 100])
def test_head_lists_match_their_twin(card, n_steps, use_periods):
    """head_sort_kernel's per-row lists equal head_mma.head_lists word for
    word, latencies in and out of the window."""
    rng = np.random.default_rng(n_steps)
    lat = rng.integers(-2, n_steps + 3, (37, 300)).astype(np.int32)
    lat[0] = 0
    lat[1] = n_steps
    lat = torch.from_numpy(lat).to(card)
    got = fused._head_lists_cuda(lat, n_steps, use_periods)
    want = head_mma.head_lists(lat.cpu(), n_steps, use_periods)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [20, 45, 128])
@pytest.mark.parametrize(
    "name,alif,rec,use_periods,spike,n_steps,tau", MMA_CASES,
    ids=[f"{c[0]}-{c[5]}{'-prod' if c[6] == PROD_TAU else ''}"
         for c in MMA_CASES])
def test_mma_body_matches_plain_versions(card, name, alif, rec, use_periods,
                                         spike, H, n_steps, tau, wdtype):
    """The tensor-core body of the forward, the training forward (with
    counts) and the backward against their plain versions in the body's
    order (and, where the function is not ill-conditioned, the order-free
    ones): logits 1e-5, spikes (``tstar``, counts) equal, residuals 1e-5
    (bf16 2**-7), the backward on the same residuals within the small-shape
    bars; training logits bitwise the inference kernel's; equal bits on a
    second run."""
    B = 37
    args = _args(card, B, 30, H, 10, n_steps, alif, rec, use_periods,
                 wdtype, spike, tau=tau)
    assert fused.head_bodies(n_steps, 30, H, 10, rec, wdtype.itemsize,
                             card, True, use_periods) == ("mma", "mma")
    ill = _ill_conditioned(use_periods, n_steps, tau)
    store_a = alif and spike == PHI
    fused.reset_launch_counts()
    infer = _call(args)
    assert torch.equal(infer, _call(args))
    got = fused._head_train_cuda(*_train_args(args), True, store_a, True)
    wants = [fused._head_train_ordered_reference(*_train_args(args), True,
                                                 store_a, True)]
    if not ill:
        wants.append(fused._head_train_reference(*_train_args(args), True,
                                                 store_a, True))
    torch.cuda.synchronize()
    assert fused.launch_counts()[fused.KERNEL] == 2
    logits, delta, a_tr, tstar, counts = got
    assert torch.equal(logits, infer)
    assert float(counts.sum()) > 0  # the units fire
    tol = 1e-5 if wdtype == torch.float32 else 2.0 ** -7
    assert (a_tr is None) == (not store_a)
    for want in wants:
        torch.testing.assert_close(logits, want[0], atol=1e-5, rtol=1e-5)
        assert torch.equal(tstar, want[3]) and torch.equal(counts, want[4])
        torch.testing.assert_close(delta.float(), want[1].float(), atol=tol,
                                   rtol=tol)
        if store_a:
            torch.testing.assert_close(a_tr.float(), want[2].float(),
                                       atol=tol, rtol=tol)
    rng = np.random.default_rng(5)
    g_logits = torch.from_numpy(
        rng.standard_normal((B, 10)).astype(np.float32)).to(card)
    g_counts = torch.from_numpy(
        (0.01 * rng.standard_normal((B, H))).astype(np.float32)).to(card)
    order = fused.gradient_plan(card, B, 30, H, 10, n_steps, rec,
                                wdtype == torch.bfloat16, use_periods)
    for gc in (None, g_counts):
        bargs = _bwd_args(args, g_logits, gc, delta, a_tr, tstar)
        grads = fused._head_bwd_cuda(*bargs)
        again = fused._head_bwd_cuda(*bargs)
        plain = [fused._head_bwd_ordered_reference(*bargs, order)]
        if not ill:
            plain.append(fused._head_bwd_reference(*bargs))
        torch.cuda.synchronize()
        for g, g2 in zip(grads, again):
            assert g is None or torch.equal(g, g2)
        for p in plain:
            assert _grad_err(grads, p) <= _bwd_bar(wdtype, n_steps)


# Weight columns of one k16 slice (every unit firing) whose sums the card's
# m16n8k16 accumulation keeps in part: terms below the largest term's
# exponent less 25 dropped, the sum truncated toward zero; the last six
# are float32 weights whose lo pieces reach the chained accumulator of the
# mid pieces' product.
_E = [2.0 ** -k for k in range(64)]
SLICE_COLUMNS = [
    [1, -_E[30]], [1, 3 * _E[25]], [-1, -3 * _E[25]], [1, _E[30]],
    [2] + [_E[25]] * 15, [1, _E[24], _E[24]], [1] + [_E[25]] * 4,
    [1] + [_E[24]] * 3, [1] + [_E[25]] * 3, [-1] + [-_E[24]] * 3,
    [1.5, 1.5] + [_E[23]] * 3, [1, _E[23], _E[24]], [1, -_E[24]],
    [1, -_E[25]], [1, -_E[26]], [_E[10]] * 16, [1] + [_E[24]] * 15,
    [1] + [_E[26]] * 15, [1, -_E[24], -_E[24]], [1, 1, 1, -_E[23]],
    [1, 1, _E[23]], [1, 1, 1, _E[23], _E[23]], [-1, _E[24]],
    [_E[3]] * 4 + [1, _E[24], _E[24]]]
_LO = _E[17] + _E[26] - _E[35]  # hi 2^-17, mid 2^-26, lo -2^-35
SPLIT_COLUMNS = [
    [1 + _E[9], -1, _LO], [1 + _E[9], -1, _LO, _LO],
    [1 + _E[9], -1, _E[17] + _E[26] + _E[35]], [1 + _E[9], -1, -_LO],
    [1 + _E[9] + _E[18], -1, _LO], [-(1 + _E[9]), 1, -_LO]]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tensor_core_slice_sums_truncate(card, wdtype):
    """The plain versions' model of a tensor-core product
    (``ops/fused.py:_mma_slice``) is the card's: at T = 1 the head's
    logits are one k16 slice of z(0) @ W_out with every unit firing, on
    weight columns whose exact sums float32 does not hold (bits below the
    largest term's exponent less 25 dropped term by term, the sum
    truncated toward zero, the chained accumulator a term); rounding the
    exact sum to nearest gives other bits."""
    B, F, H = 16, 2, 16
    cols = SLICE_COLUMNS + (SPLIT_COLUMNS if wdtype == torch.float32
                            else [])
    lat = torch.tensor([[0, 5]] * B, dtype=torch.int32, device=card)
    w_in = torch.zeros((F, H))
    w_in[0] = 10.0  # every unit fires at t = 0
    got, nearest = [], []
    for c0 in range(0, len(cols), 16):
        chunk = cols[c0:c0 + 16]
        w = torch.zeros((H, len(chunk)), dtype=torch.float64)
        for o, col in enumerate(chunk):
            w[:len(col), o] = torch.tensor(col, dtype=torch.float64)
        assert torch.equal(w.to(wdtype).double(), w)
        args = dict(_args(card, B, F, H, len(chunk), 1, False, False, False,
                          wdtype), latencies=lat,
                    w_in=w_in.to(card, wdtype), w_out=w.to(card, wdtype),
                    b_out=torch.zeros(len(chunk), device=card))
        logits = _call(args)[0].cpu()
        w32 = w.float()
        pieces = ([w32] if wdtype == torch.bfloat16
                  else head_mma.split_pieces(w32))
        want = fused._slice_product(torch.ones((1, H)), pieces)[0]
        assert torch.equal(logits, want), (c0, logits.tolist(),
                                           want.tolist())
        got.append(logits)
        nearest.append(w.sum(0).float())
    assert not torch.equal(torch.cat(got), torch.cat(nearest))


GRAD_SHAPES = [  # B, F, H: one batch a block; the ring's turns; two
    (37, 30, 20),  # feature chunks (F past 1024); H off the TMA strides
    (37, 30, 45),
    (37, 30, 128),
    (3000, 784, 128),
    (300, 1100, 40),
]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps,tau", [(24, 20.0), (24, PROD_TAU),
                                         (100, 20.0), (100, PROD_TAU)],
                         ids=["24", "24-prod", "100", "100-prod"])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=lambda s: "x".join(
    str(v) for v in s))
def test_gradient_functions_match_their_ordered_versions(
        card, shape, use_periods, n_steps, tau, wdtype):
    """bwd_gwin's g_W_in and bwd_gout's g_W_out and g_b (their float32
    sums) equal their plain versions in the kernels' order bit for bit,
    fed the chain's rounded dcur and the forward's residuals (ALIF,
    recurrent; Phi under TTFS, whose surrogate keeps the chain finite at
    T = 100, as in MMA_NETS)."""
    B, F, H = shape
    args = _args(card, B, F, H, 10, n_steps, True, True, use_periods,
                 wdtype, FAST if use_periods else PHI, tau=tau)
    _, delta, _, tstar, _ = fused._head_train_cuda(
        *_train_args(args), True, False, False)
    g_logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, 10)).astype(np.float32)).to(card)
    keep = {}
    grads = fused._head_bwd_cuda(
        *_bwd_args(args, g_logits, None, delta, None, tstar), keep=keep)
    order = fused.gradient_plan(card, B, F, H, 10, n_steps, True,
                                wdtype == torch.bfloat16, use_periods)
    assert order["gwin_ring"] == (H * wdtype.itemsize % 16 == 0)
    g_in = fused._gwin_ordered_reference(
        keep["dcur"], args["latencies"], n_steps, use_periods,
        order["groups_in"], order["rows_in"])
    g_out, g_b = fused._gout_ordered_reference(
        (delta >= 0).float(), g_logits, tstar, args["kappa"], wdtype,
        order["groups_out"], order["rows_out"])
    for g in grads:
        assert bool(torch.isfinite(g.float()).all())
    assert float(keep["g_w_in"].abs().max()) > 0
    assert torch.equal(keep["g_w_in"], g_in)
    assert torch.equal(keep["g_w_out"], g_out)
    assert torch.equal(grads[3], g_b)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rec", [True, False], ids=["rec", "ff"])
def test_mma_body_rows_do_not_depend_on_their_batch(card, rec, wdtype):
    """A row's logits are the same bits whichever rows share its 16-row
    tile: rows firing 0 to 7 of F = 48 features at t = 0 (the dense input
    product takes a row from F / 16 = 3 on; a tile of the whole batch fires
    56 in all) and the rest spread over the window, served whole and as a
    shuffled subset; both against the plain version at 1e-5."""
    B, F, H, T = 37, 48, 45, 24
    rng = np.random.default_rng(9)
    lat = rng.integers(1, T + 4, (B, F)).astype(np.int32)
    for r in range(B):
        lat[r, rng.choice(F, r % 8, replace=False)] = 0
    args = _args(card, B, F, H, 10, T, True, rec, False, wdtype)
    args["latencies"] = torch.from_numpy(lat).to(card)
    whole = _call(args)
    torch.testing.assert_close(whole, _call(args, plain=True), atol=1e-5,
                               rtol=1e-5)
    idx = torch.from_numpy(rng.permutation(B)[:23]).to(card)
    sub = dict(args, latencies=args["latencies"][idx].contiguous())
    part = _call(sub)
    assert torch.equal(part, whole[idx])
    torch.testing.assert_close(part, _call(sub, plain=True), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [20, 128])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_mma_body_stacked_is_three_single_launches(card, use_periods, H,
                                                   wdtype):
    """S = 3 replicas in one launch of each kernel equal three single
    launches bit for bit: logits, residuals, tstar and gradients."""
    S, B, T = 3, 37, 24
    reps = [_args(card, B, 30, H, 10, T, True, True, use_periods, wdtype,
                  seed=20 + s) for s in range(S)]
    lat = reps[0]["latencies"]
    for r in reps:
        r["latencies"] = lat
    stacked = dict(reps[0])
    for k in ("w_in", "w_rec", "w_out", "b_out"):
        stacked[k] = torch.stack([r[k] for r in reps]).contiguous()
    stacked["beta"] = torch.tensor([1.6, 1.2, 2.0], device=card)
    betas = [1.6, 1.2, 2.0]
    fused.reset_launch_counts()
    res = fused._head_train_cuda(*_train_args(stacked), True, False, False)
    assert torch.equal(res[0], _call(stacked))
    g_logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (S, B, 10)).astype(np.float32)).to(card)
    grads = fused._head_bwd_cuda(*_bwd_args(stacked, g_logits, None, res[1],
                                            None, res[3]))
    counts = fused.launch_counts()
    assert counts[fused.KERNEL_TRAIN_STACKED] == 1
    assert counts[fused.KERNEL_BWD_STACKED] == 1
    for s, r in enumerate(reps):
        r["beta"] = betas[s]
        one = fused._head_train_cuda(*_train_args(r), True, False, False)
        assert torch.equal(res[0][s], one[0])
        assert torch.equal(res[1][s], one[1])
        assert torch.equal(res[3][s], one[3])
        g1 = fused._head_bwd_cuda(*_bwd_args(r, g_logits[s], None, one[1],
                                             None, one[3]))
        for g, want in zip(grads, g1):
            assert torch.equal(g[s], want)


@pytest.mark.cuda
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("H,O,wdtype", [(200, 10, torch.float32),
                                        (33, 40, torch.bfloat16),
                                        (288, 10, torch.bfloat16)],
                         ids=["f32-H200", "bf16-O40", "bf16-H288"])
def test_per_unit_body_takes_the_rest(card, H, O, wdtype, use_periods):
    """Shapes past the tensor-core body's limits (float32 W_rec's pieces
    past shared memory, O > 16, H > 256) run the per-unit body, which
    explain_dispatch names, against the plain versions at the small bars."""
    T, B = 24, 21
    assert fused.fused_head_supported(T, 30, H, O, True, wdtype.itemsize,
                                      card, True, use_periods)
    assert "per-unit" in fused.head_bodies(T, 30, H, O, True,
                                           wdtype.itemsize, card, True,
                                           use_periods)
    args = _args(card, B, 30, H, O, T, True, True, use_periods, wdtype,
                 w_scale=(0.5, 0.05))
    res = fused._head_train_cuda(*_train_args(args), True, False, True)
    ref = fused._head_train_reference(*_train_args(args), True, False, True)
    assert torch.equal(res[0], _call(args))
    torch.testing.assert_close(res[0], ref[0], atol=1e-5, rtol=1e-5)
    assert torch.equal(res[3], ref[3]) and torch.equal(res[4], ref[4])
    g_logits = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, O)).astype(np.float32)).to(card)
    bargs = _bwd_args(args, g_logits, None, res[1], res[2], res[3])
    assert _grad_err(fused._head_bwd_cuda(*bargs),
                     fused._head_bwd_reference(*bargs)) <= _bwd_bar(wdtype, T)


@pytest.mark.cuda
def test_explain_dispatch_names_the_per_unit_body(card):
    import snnimageclassification_tpu_torch as pt
    from snnimageclassification_tpu_torch.models import snn as model_lib

    enc = pt.EncodeConfig(n_steps=100)
    flagship = pt.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=128,
        hidden_layer_type=pt.LayerType.ALIF, learn_beta=True,
        int_time_steps=100)
    wide_o = pt.SNNConfig(
        input_size=784, output_size=40, n_hidden_neurons=128,
        hidden_layer_type=pt.LayerType.ALIF, int_time_steps=100)
    for training in (False, True):
        path = model_lib.explain_dispatch(flagship, enc, device="cuda",
                                          training=training)[0]["path"]
        assert "per-unit" not in path
        entry = model_lib.explain_dispatch(wide_o, enc, device="cuda",
                                           training=training)[0]
        assert entry["path"].endswith("[per-unit]")
        assert "per-unit body" in entry["reason"]
    # bwd_gwin's rows cross by TMA where H * itemsize is a multiple of 16
    # bytes; H = 45 float32 (180 bytes) takes the stage the threads copy.
    odd_h = pt.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=45,
        hidden_layer_type=pt.LayerType.ALIF, int_time_steps=100)
    for cfg, copied in ((flagship, False), (odd_h, True)):
        reason = model_lib.explain_dispatch(cfg, enc, device="cuda",
                                            training=True)[0]["reason"]
        assert ("no TMA ring" in reason) == copied
    # Every backward of an encoded first layer launches bwd_gwin and says so:
    # the two-layer pair, a deep network's layer 0, the Izhikevich head.
    for hidden, kind in (([45, 64], "ALIF"), ([45, 64, 64], "ALIF"),
                         (45, "Izhikevich")):
        extra = {"dt": 30.0} if kind == "Izhikevich" else {}
        cfg = pt.SNNConfig(input_size=784, output_size=10,
                           n_hidden_neurons=hidden, hidden_layer_type=kind,
                           int_time_steps=100, **extra)
        entries = model_lib.explain_dispatch(cfg, enc, device="cuda",
                                             training=True)
        assert ("(H * itemsize not a multiple of 16 bytes, no TMA ring)"
                in entries[0]["reason"]), entries
        assert not any("no TMA ring" in e["reason"] for e in
                       model_lib.explain_dispatch(cfg, enc, device="cuda",
                                                  training=False)), entries


DEEP_CASES = [  # name, alif, recurrent, use_periods, surrogate
    ("alif-rec-fs", True, True, False, FAST),
    ("alif-ff-phi-periodic", True, False, True, PHI),
    ("lif-rec-phi", False, True, False, PHI),
    ("lif-ff-fs-periodic", False, False, True, FAST),
]


def _deep_chain(dev, T, alif, rec, use_periods, spike, wdtype, plain, seed=5,
                backward=True, B=9):
    """Layer 0 -> mid -> mid head with counts on fresh leaves; returns
    (z0, z1, logits, counts, gradients of every weight)."""
    F, H0, H1, H2, O = 30, 20, 24, 18, 10
    rng = np.random.default_rng(seed)
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H0)
    kappa = ReadoutConfig(input_size=H2, output_size=O).kappa
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(dev)
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   tau=20.0).contiguous()

    def w(shape, std, dtype=wdtype, mask=False):
        t = torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        if mask:
            t = t * (1 - torch.eye(shape[0], device=dev))
        return t.to(dtype).requires_grad_(True)

    leaves = {}
    for i, (n_in, n) in enumerate(((F, H0), (H0, H1), (H1, H2))):
        leaves[f"w_in{i}"] = w((n_in, n), 0.5)
        if rec:
            leaves[f"w_rec{i}"] = w((n, n), 0.3, mask=True)
    leaves["w_out"] = w((H2, O), 1.0)
    leaves["b_out"] = w((O,), 0.1, torch.float32)
    r = torch.from_numpy(rng.standard_normal((B, O)).astype(np.float32)).to(
        dev)
    beta = torch.tensor(1.6 if alif else 0.0, device=dev, requires_grad=True)
    sfx = "_reference" if plain else ""
    kind = "rec" if rec else "ff"
    sc = (alif, cfg.alpha, cfg.rho if alif else 0.0, cfg.threshold,
          cfg.gamma)

    def weights(i):
        return ((leaves[f"w_in{i}"], leaves[f"w_rec{i}"], beta) if rec
                else (leaves[f"w_in{i}"], beta))

    z0 = getattr(fused, f"fused_encode_{kind}_scan{sfx}")(
        lat, *weights(0), T, use_periods, *sc, spike)
    z1 = getattr(fused_mid, f"fused_mid_{kind}_scan{sfx}")(
        z0, *weights(1), T, *sc, spike)
    logits, counts = getattr(
        fused_mid, f"fused_mid_{kind}_scan_head_counts{sfx}")(
            z1, *weights(2), leaves["w_out"], leaves["b_out"], T, *sc, kappa,
            spike)
    if not backward:
        return z0, z1, logits, counts, None
    loss = ((logits * r).sum() + 1e-3 * (counts ** 2).sum()
            + 1e-3 * (z0.float().sum(0) ** 2).sum())
    loss.backward()
    assert float(beta.grad) == 0.0
    return z0, z1, logits, counts, {k: v.grad for k, v in leaves.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("name,alif,rec,use_periods,spike", DEEP_CASES,
                         ids=[c[0] for c in DEEP_CASES])
def test_deep_chain_matches_plain_versions(card, name, alif, rec,
                                           use_periods, spike, n_steps,
                                           wdtype):
    fused.reset_launch_counts()
    got = _deep_chain(card, n_steps, alif, rec, use_periods, spike, wdtype,
                      plain=False)
    assert _launched() == {fused.KERNEL_L0: 1, fused.KERNEL_L0_BWD: 1,
                           fused.KERNEL_MID: 2, fused.KERNEL_MID_BWD: 2}
    want = _deep_chain(card, n_steps, alif, rec, use_periods, spike, wdtype,
                       plain=True)
    assert _launched()[fused.KERNEL_MID] == 2  # the plain chain launches none
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[1].float().sum()) > 0
    assert torch.allclose(got[2], want[2], atol=1e-5, rtol=1e-5)
    assert torch.equal(got[3], want[3])
    if wdtype == torch.bfloat16:
        bar = 2.0 ** -6
    elif spike == PHI and alif:
        bar = 2e-5
    else:
        bar = 2e-6 if n_steps < 100 else 5e-6
    for k, p in want[4].items():
        g = got[4][k]
        assert g.dtype == p.dtype and bool(torch.isfinite(g.float()).all())
        scale = float(p.float().abs().max()) or 1.0
        err = float((g.float() - p.float()).abs().max()) / scale
        assert err <= bar, f"{name} {k}: {err:.3g} of max|g|"


@pytest.mark.cuda
def test_deep_inference_launches_one_kernel_a_layer(card):
    """Under ``no_grad`` the chain writes no residual, launches three
    forward kernels, and gives the training forward's bits."""
    with torch.no_grad():
        fused.reset_launch_counts()
        z0, z1, logits, counts, _ = _deep_chain(
            card, 24, True, True, False, FAST, torch.float32, plain=False,
            backward=False)
        assert _launched() == {fused.KERNEL_L0: 1, fused.KERNEL_MID: 2}
    train = _deep_chain(card, 24, True, True, False, FAST, torch.float32,
                        plain=False)
    assert torch.equal(z0, train[0]) and torch.equal(z1, train[1])
    assert torch.equal(logits, train[2]) and torch.equal(counts, train[3])


# ---------------------------------------------------------------------------
# First layers on the tensor-core body
# ---------------------------------------------------------------------------
L0_STEPS = [(1, PROD_TAU), (24, 20.0), (24, PROD_TAU), (100, 20.0),
            (100, PROD_TAU)]
L0_CASES = [(*net, n, tau) for net in MMA_NETS for n, tau in L0_STEPS]


def _layer0_args(a):
    """``fused._layer0_cuda``'s arguments up to ``threshold`` from
    :func:`_args`'s dict."""
    return (a["latencies"], a["w_in"], a["w_rec"], a["beta"], a["n_steps"],
            a["use_periods"], a["alif"], a["alpha"], a["rho"],
            a["threshold"])


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "name,alif,rec,use_periods,spike,n_steps,tau", L0_CASES,
    ids=[f"{c[0]}-{c[5]}{'-prod' if c[6] == PROD_TAU else ''}"
         for c in L0_CASES])
def test_layer0_mma_body_matches_ordered_versions(card, name, alif, rec,
                                                  use_periods, spike,
                                                  n_steps, tau, wdtype):
    """``fused_layer0_fwd`` on its tensor-core body (the head's body without
    the readout) equals ``_layer0_ordered_reference`` bit for bit at B = 37
    and H = 20, 45, 128: spikes and residuals (``v`` and ``delta``:
    ``res_is_v`` both ways; ``a`` for ALIF with Phi), equal bits on a
    repeated call, inference's spikes training's; the spikes are the head
    kernel's on the same inputs."""
    store_a = alif and spike == PHI
    for H in (20, 45, 128):
        a = _args(card, 37, 30, H, 10, n_steps, alif, rec, use_periods,
                  wdtype, spike, tau=tau)
        assert fused.layer0_bodies(n_steps, 30, H, rec, wdtype.itemsize,
                                   card, True, use_periods) == ("mma",
                                                                "mma")
        l0 = _layer0_args(a)
        fused.reset_launch_counts()
        for res_is_v in (False, True):
            got = fused._layer0_cuda(*l0, True, store_a, res_is_v)
            again = fused._layer0_cuda(*l0, True, store_a, res_is_v)
            want = fused._layer0_ordered_reference(*l0, True, store_a,
                                                   res_is_v)
            torch.cuda.synchronize()
            for k, (g, g2, w) in enumerate(zip(got, again, want)):
                assert (g is None) == (w is None)
                assert g is None or (torch.equal(g, g2)
                                     and torch.equal(g, w)), (H, res_is_v, k)
        inf = fused._layer0_cuda(*l0, False, False, False)
        assert inf[1] is None and torch.equal(inf[0], got[0])
        assert _launched() == {fused.KERNEL_L0: 5}
        assert float(got[0].float().sum()) > 0  # the units fire
        delta = fused._head_train_cuda(*_train_args(a), True, False,
                                       False)[1]
        assert torch.equal(got[0], (delta.float() >= 0).to(wdtype))


IZH_L0_CASES = [(dt, rec, per, T) for dt in (1e-3, 30.0)
                for rec in (True, False) for per in (False, True)
                for T in (1, 24, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "dt,rec,use_periods,n_steps", IZH_L0_CASES,
    ids=[f"dt{c[0]:g}-{'rec' if c[1] else 'ff'}-"
         f"{'periodic' if c[2] else 'ttfs'}-{c[3]}" for c in IZH_L0_CASES])
def test_izh_layer0_mma_body_matches_ordered_versions(card, dt, rec,
                                                      use_periods, n_steps,
                                                      wdtype):
    """``fused_izh_layer0_fwd`` on its tensor-core body equals
    ``_izh_layer0_ordered_reference`` bit for bit (``z``, ``v``) at dt =
    1e-3 (the JAX suite's scale) and dt = 30, equal bits on a repeated
    call, inference's spikes training's; its ``v`` is the head kernel's on
    the same inputs."""
    head = _izh_head(card, dt, rec, use_periods, n_steps, wdtype)
    lat, w_in, w_rec = head[:3]
    F, H = w_in.shape
    assert fused_izh.layer0_bodies(n_steps, F, H, rec, wdtype.itemsize,
                                   card, True, use_periods) == ("mma",
                                                                "mma")
    l0 = (lat, w_in, w_rec, n_steps, use_periods, head[7])
    fused.reset_launch_counts()
    got = fused_izh._layer0_cuda(*l0, True)
    again = fused_izh._layer0_cuda(*l0, True)
    inf = fused_izh._layer0_cuda(*l0, False)
    want = fused_izh._izh_layer0_ordered_reference(*l0, True)
    v_head = fused_izh._head_cuda(*head, True, False)[1]
    torch.cuda.synchronize()
    assert _launched() == {fused.KERNEL_IZH_L0: 3,
                           fused.KERNEL_IZH_TRAIN: 1}
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2) and torch.equal(g, w)
    assert inf[1] is None and torch.equal(inf[0], got[0])
    assert torch.equal(got[1], v_head)
    if n_steps > 2:
        assert float(got[0].sum()) > 0  # the units fire


@pytest.mark.cuda
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("H,wdtype,rec", [(192, torch.float32, True),
                                          (288, torch.bfloat16, True),
                                          (288, torch.float32, False)],
                         ids=["f32-rec-H192", "bf16-rec-H288",
                              "f32-ff-H288"])
def test_layer0_per_unit_body_takes_the_rest(card, H, wdtype, rec,
                                             use_periods):
    """Shapes past the tensor-core bodies' limits (float32 W_rec's pieces
    past a block's shared memory from H = 161, H > 256) run the first
    layers' per-unit body and per-unit chain, which ``layer0_bodies``
    (training too) and ``explain_dispatch`` name, against the order-free
    plain versions: spikes equal, residuals 1e-5 (bf16 2**-7); the
    Izhikevich ``v`` 1e-6 relative and 1e-3 mV."""
    import snnimageclassification_tpu_torch as pt
    from snnimageclassification_tpu_torch.models import snn as model_lib

    T, B, it = 24, 21, wdtype.itemsize
    assert fused.fused_supported(T, 30, H, rec, it, card, True, use_periods)
    assert fused.layer0_bodies(T, 30, H, rec, it, card) == ("per-unit",)
    assert fused.layer0_bodies(T, 30, H, rec, it, card, True,
                               use_periods) == ("per-unit", "per-unit")
    assert not fused.layer0_gradient_plan(card, B, 30, H, T, rec,
                                          wdtype == torch.bfloat16,
                                          use_periods)["mma"]
    a = _args(card, B, 30, H, 10, T, True, rec, use_periods, wdtype, PHI,
              w_scale=(0.5, 0.05))
    got = fused._layer0_cuda(*_layer0_args(a), True, True, True)
    want = fused._layer0_reference(*_layer0_args(a), True, True, True)
    assert torch.equal(got[0], want[0]) and float(got[0].float().sum()) > 0
    tol = 1e-5 if wdtype == torch.float32 else 2.0 ** -7
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)
    head = _izh_head(card, 1e-3, rec, use_periods, T, wdtype, B=B, H=H)
    assert fused_izh.layer0_bodies(T, 30, H, rec, it, card) == ("per-unit",)
    assert fused_izh.layer0_bodies(T, 30, H, rec, it, card, True,
                                   use_periods) == ("per-unit", "per-unit")
    l0 = (*head[:3], T, use_periods, head[7], True)
    (z, v), (zp, vp) = fused_izh._layer0_cuda(*l0), \
        fused_izh._layer0_reference(*l0)
    assert torch.equal(z, zp) and float(z.sum()) > 0
    torch.testing.assert_close(v, vp, rtol=1e-6, atol=1e-3)
    for kind in ("ALIF", "Izhikevich"):
        cfg = pt.SNNConfig(input_size=30, output_size=10,
                           n_hidden_neurons=[H, 32, 16],
                           hidden_layer_type=kind,
                           use_recurrent_connection=rec, int_time_steps=T,
                           matmul_dtype=str(wdtype)[6:])
        row = model_lib.explain_dispatch(
            cfg, pt.EncodeConfig(n_steps=T, use_periods=use_periods),
            device="cuda")[0]
        assert row["path"].endswith("[per-unit]"), row
        assert "per-unit body" in row["reason"], row


@pytest.mark.cuda
def test_explain_dispatch_names_the_layer0_bodies(card):
    """The first layers of the deep network (784-128-128-96-10) and of the
    deep Izhikevich network (784-Izh128-Izh128-10) name the tensor-core body
    of their forward, f32 and bf16, and training that of their backward's
    chain; their paths carry no ``[per-unit]``."""
    import snnimageclassification_tpu_torch as pt
    from snnimageclassification_tpu_torch.models import snn as model_lib

    enc = pt.EncodeConfig(n_steps=100)
    for kind, widths, extra in (("ALIF", [128, 128, 96], {}),
                                ("Izhikevich", [128, 128], {"dt": 30.0})):
        for md in ("float32", "bfloat16"):
            cfg = pt.SNNConfig(input_size=784, output_size=10,
                               n_hidden_neurons=widths,
                               hidden_layer_type=kind,
                               use_recurrent_connection=True,
                               int_time_steps=100, matmul_dtype=md, **extra)
            for training in (False, True):
                row = model_lib.explain_dispatch(cfg, enc, device="cuda",
                                                 training=training)[0]
                assert "[per-unit]" not in row["path"], row
                assert ("the tensor-core body (mma) in the forward"
                        in row["reason"]), row
                assert ("the tensor-core body (mma) in the backward's "
                        "chain" in row["reason"]) == training, row
                assert "per-unit" not in row["reason"], row


L0_BWD_STEPS = [(24, 20.0), (24, PROD_TAU), (100, 20.0), (100, PROD_TAU)]
L0_BWD_CASES = [(*net, n, tau) for net in MMA_NETS for n, tau in L0_BWD_STEPS]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "name,alif,rec,use_periods,spike,n_steps,tau", L0_BWD_CASES,
    ids=[f"{c[0]}-{c[5]}{'-prod' if c[6] == PROD_TAU else ''}"
         for c in L0_BWD_CASES])
def test_layer0_bwd_mma_chain_matches_ordered_versions(
        card, name, alif, rec, use_periods, spike, n_steps, tau, wdtype):
    """``fused_layer0_bwd`` with its chain on the tensor-core chain body
    (``lif_chain.cuh:ZChain``, z as stored) against
    ``_layer0_bwd_ordered_reference`` at B = 37 and H = 20, 45, 128 on the
    forward kernel's residuals (``res_is_v`` both ways; ``a`` for ALIF with
    Phi; W_rec of std 0.3 sqrt(20 / H), whose chain neither dies nor
    overflows over T = 100): the chain's rounded dcur and both gradients
    within the chain's bars, equal bits twice, one launch a call; its plan
    and ``layer0_bodies`` name the body."""
    store_a = alif and spike == PHI
    bar = _bwd_bar(wdtype, n_steps)
    bf16 = wdtype == torch.bfloat16
    rng = np.random.default_rng(15)
    for H in (20, 45, 128):
        a = _args(card, 37, 30, H, 10, n_steps, alif, rec, use_periods,
                  wdtype, spike, tau=tau,
                  w_scale=(0.5, 0.3 * np.sqrt(20.0 / H)))
        assert fused.layer0_bodies(n_steps, 30, H, rec, wdtype.itemsize,
                                   card, True, use_periods) == ("mma", "mma")
        order = fused.layer0_gradient_plan(card, 37, 30, H, n_steps, rec,
                                           bf16, use_periods)
        assert order["mma"]
        l0 = _layer0_args(a)
        for res_is_v in (False, True):
            z, res, a_tr = fused._layer0_cuda(*l0, True, store_a, res_is_v)
            g_z = torch.from_numpy(rng.standard_normal(tuple(z.shape)).astype(
                np.float32)).to(card).to(wdtype)
            bargs = (g_z, z, res, a_tr, res_is_v, a["latencies"], a["w_in"],
                     a["w_rec"], a["beta"], n_steps, use_periods, a["alpha"],
                     a["threshold"], a["gamma"], spike)
            keep, okeep = {}, {}
            fused.reset_launch_counts()
            got = fused._layer0_bwd_cuda(*bargs, keep=keep)
            again = fused._layer0_bwd_cuda(*bargs)
            assert _launched() == {fused.KERNEL_L0_BWD: 2}
            want = fused._layer0_bwd_ordered_reference(*bargs, order,
                                                       keep=okeep)
            torch.cuda.synchronize()
            label = f"H={H} res_is_v={res_is_v}"
            for g, g2 in zip(got, again):
                assert g is None or torch.equal(g, g2), f"{label}: not " \
                    "reproducible"
            for g in got:
                assert g is None or bool(torch.isfinite(g.float()).all())
            err = _rel_err(keep["dcur"], okeep["dcur"])
            assert err <= bar, f"{label} dcur: {err:.3g} of max|dcur|"
            err = _grad_err(got, want)
            assert err <= bar, f"{label}: gradients {err:.3g} of max|g|"


IZH_L0_BWD_CASES = [(dt, rec, per, spike, T) for dt in (1e-3, 30.0)
                    for rec in (True, False) for per in (False, True)
                    for spike, T in ((FAST, 24), (PHI, 100))]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "dt,rec,use_periods,spike,n_steps", IZH_L0_BWD_CASES,
    ids=[f"dt{c[0]:g}-{'rec' if c[1] else 'ff'}-"
         f"{'periodic' if c[2] else 'ttfs'}-{c[3].name}-{c[4]}"
         for c in IZH_L0_BWD_CASES])
def test_izh_layer0_bwd_mma_chain_matches_ordered_versions(
        card, dt, rec, use_periods, spike, n_steps, wdtype):
    """``fused_izh_layer0_bwd`` with its chain on the tensor-core chain body
    (``izh_chain.cuh:IzhZChain``) against
    ``_izh_bwd_ordered_reference``'s first-layer mode at B = 37 and H = 20,
    128 on the forward kernel's residuals, at dt = 1e-3 (the JAX suite's
    scale) and dt = 30 (init-scale weights, where the u carry moves the
    chain): the chain's rounded gi and both gradients within 2e-6 of max|g|
    (5e-6 at T = 100) at dt = 1e-3, 1e-4 at dt = 30, bf16 2**-7; equal bits
    twice; its plan and ``layer0_bodies`` name the body."""
    bf16 = wdtype == torch.bfloat16
    bar = _izh_bar(n_steps, wdtype) if dt < 1 else (
        2.0 ** -7 if bf16 else 1e-4)
    gamma = IzhikevichConfig(input_size=1, output_size=1).gamma
    rng = np.random.default_rng(16)
    for H in (20, 128):
        head = _izh_head(card, dt, rec, use_periods, n_steps, wdtype, H=H)
        lat, w_in, w_rec = head[:3]
        B, F = lat.shape
        assert fused_izh.layer0_bodies(n_steps, F, H, rec, wdtype.itemsize,
                                       card, True, use_periods) == ("mma",
                                                                    "mma")
        order = fused_izh.gradient_plan(card, B, F, H, 0, n_steps, rec, bf16,
                                        use_periods)
        assert order["mma"]
        z, v = fused_izh._layer0_cuda(lat, w_in, w_rec, n_steps, use_periods,
                                      head[7], True)
        assert float(z.sum()) > 0  # the units fire
        g_z = torch.from_numpy(rng.standard_normal(tuple(z.shape)).astype(
            np.float32)).to(card) / B
        bargs = (None, None, None, g_z, z, v, lat, w_in, w_rec, None,
                 n_steps, use_periods, head[7], gamma, 0.0, spike)
        keep, okeep = {}, {}
        fused.reset_launch_counts()
        got = fused_izh._bwd_cuda(*bargs, keep=keep)
        again = fused_izh._bwd_cuda(*bargs)
        assert _launched() == {fused.KERNEL_IZH_L0_BWD: 2}
        want = fused_izh._izh_bwd_ordered_reference(*bargs, order,
                                                    keep=okeep)
        torch.cuda.synchronize()
        _grads_close(got, again, want, bar)
        err = _rel_err(keep["dcur"], okeep["dcur"])
        assert err <= bar, f"H={H} gi: {err:.3g} of max|gi|"


# ---------------------------------------------------------------------------
# Izhikevich
# ---------------------------------------------------------------------------
IZH = IzhikevichConfig(input_size=1, output_size=1)
IZH_KP = izh.izh_kernel_params(IZH)
IZH_CASES = [  # name, recurrent, use_periods, n_steps, surrogate
    ("rec-ttfs-fs", True, False, 24, FAST),
    ("ff-periodic-phi", False, True, 24, PHI),
    ("rec-periodic-fs-100", True, True, 100, FAST),
    ("ff-ttfs-phi-100", False, False, 100, PHI),
]


def _izh_weights(dev, rng, F, H, O, rec, wdtype):
    def w(shape, std):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    w_rec = ((w((H, H), 5e5) * (1 - torch.eye(H, device=dev))).to(wdtype)
             if rec else None)
    return (w((F, H), 3e6).to(wdtype), w_rec, w((H, O), 1.0).to(wdtype),
            w((O,), 0.1))


def _izh_bar(n_steps, wdtype):
    """Backward against its plain version on the same residuals, of max|g|:
    float32 2e-6, 5e-6 at T = 100 (four times the terms in another order);
    bfloat16 one rounding."""
    if wdtype == torch.bfloat16:
        return 2.0 ** -7
    return 2e-6 if n_steps < 100 else 5e-6


def _grads_close(got, again, want, bar):
    for g, g2, p in zip(got, again, want):
        if p is None:
            assert g is None
            continue
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.equal(g, g2), "not reproducible bit for bit"
        assert bool(torch.isfinite(g.float()).all())
        scale = float(p.float().abs().max()) or 1.0
        err = float((g.float() - p.float()).abs().max()) / scale
        assert err <= bar, f"{err:.3g} of max|g|"


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,rec,use_periods,n_steps,spike", IZH_CASES,
                         ids=[c[0] for c in IZH_CASES])
def test_izh_scan_kernels_match_plain_versions(card, name, rec, use_periods,
                                               n_steps, spike, wdtype):
    B, H = 37, 20
    rng = np.random.default_rng(3)
    cur = torch.from_numpy((3e6 + 1e6 * rng.standard_normal(
        (n_steps, B, H))).astype(np.float32)).to(card)
    w_rec = _izh_weights(card, rng, 1, H, 1, rec, wdtype)[1]
    # Both kernels on the first layers' tensor-core bodies at this shape.
    assert izh.scan_bodies(n_steps, H, rec, wdtype.itemsize, card,
                           True) == ("mma", "mma")
    fused.reset_launch_counts()
    z, v = izh._scan_cuda(cur, w_rec, IZH_KP, True)
    z_inf, v_inf = izh._scan_cuda(cur, w_rec, IZH_KP, False)
    zp, vp = izh._scan_reference(cur, w_rec, IZH_KP, True)
    torch.cuda.synchronize()
    assert v_inf is None and torch.equal(z, z_inf)
    assert torch.equal(z, zp) and 0 < float(z.mean()) < 1
    if rec:
        torch.testing.assert_close(v, vp, rtol=1e-6, atol=1e-3)
    else:  # the same expression in the same order, IEEE division
        assert torch.equal(v, vp)
    g_z = torch.from_numpy(rng.standard_normal(
        (n_steps, B, H)).astype(np.float32)).to(card)
    args = (g_z, z, v, w_rec, IZH_KP, IZH.gamma, spike)
    _grads_close(izh._scan_bwd_cuda(*args), izh._scan_bwd_cuda(*args),
                 izh._scan_bwd_reference(*args), _izh_bar(n_steps, wdtype))
    assert _launched() == {fused.KERNEL_IZH_SCAN: 2,
                           fused.KERNEL_IZH_SCAN_BWD: 2}


def _scan_inputs(dev, dt, rec, T, wdtype, H, B=37, seed=41):
    """(currents (T, B, H) float32, masked W_rec | None, kernel params) of
    ``izh_scan``: at dt = 1e-3 the JAX suite's scale (currents 3e6 + 1e6
    N(0, 1), W_rec 5e5 N(0, 1) at H = 20, scaled by sqrt(20 / H): at 5e5
    the chain overflows at H = 128); at dt = 30 a second layer's currents
    ``z0 @ W1`` (z0 from ``fused_izh_layer0_fwd`` at init scale, W1 N(0,
    1)) and W_rec of std 0.3 sqrt(20 / H) (0.3 at H = 128 overflows the
    float32 chain at T = 100)."""
    rng = np.random.default_rng(seed)

    def w(shape, std=1.0):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    eye = 1 - torch.eye(H, device=dev)
    if dt < 1:
        cur = 3e6 + w((T, B, H), 1e6)
        w_rec = ((w((H, H), 5e5 * (20 / H) ** 0.5) * eye).to(wdtype) if rec
                 else None)
        return cur.contiguous(), w_rec, IZH_KP
    head = _izh_head(dev, dt, rec, False, T, wdtype, B=B, H=H, seed=seed)
    z0 = fused_izh._layer0_cuda(head[0], head[1], head[2], T, False, head[7],
                                False)[0]
    cur = (z0 @ w((H, H))).contiguous()
    w_rec = ((w((H, H), 0.3 * (20 / H) ** 0.5) * eye).to(wdtype) if rec
             else None)
    return cur, w_rec, head[7]


IZH_SCAN_CASES = [(dt, rec, T) for dt in (1e-3, 30.0) for rec in (True, False)
                  for T in (1, 24, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "dt,rec,n_steps", IZH_SCAN_CASES,
    ids=[f"dt{c[0]:g}-{'rec' if c[1] else 'ff'}-{c[2]}"
         for c in IZH_SCAN_CASES])
def test_izh_scan_mma_body_matches_ordered_versions(card, dt, rec, n_steps,
                                                    wdtype):
    """``izh_scan_fwd`` on the first layers' tensor-core body (the currents
    as its input) equals ``izh._scan_ordered_reference`` bit for bit (z,
    v) at H = 20 and 128, dt = 1e-3 and dt = 30; equal bits on a repeated
    call, inference's spikes training's; ``scan_bodies`` names the
    body."""
    for H in (20, 128):
        cur, w_rec, kp = _scan_inputs(card, dt, rec, n_steps, wdtype, H)
        assert izh.scan_bodies(n_steps, H, rec, wdtype.itemsize,
                               card) == ("mma",)
        fused.reset_launch_counts()
        got = izh._scan_cuda(cur, w_rec, kp, True)
        again = izh._scan_cuda(cur, w_rec, kp, True)
        inf = izh._scan_cuda(cur, w_rec, kp, False)
        want = izh._scan_ordered_reference(cur, w_rec, kp, True)
        torch.cuda.synchronize()
        assert _launched() == {fused.KERNEL_IZH_SCAN: 3}
        for g, g2, w in zip(got, again, want):
            assert torch.equal(g, g2) and torch.equal(g, w), f"H={H}"
        assert inf[1] is None and torch.equal(inf[0], got[0])
        if n_steps > 2:
            assert 0 < float(got[0].mean()) < 1  # the units fire


IZH_SCAN_BWD_CASES = [(dt, rec, spike, T) for dt in (1e-3, 30.0)
                      for rec in (True, False)
                      for spike, T in ((FAST, 24), (PHI, 100))]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "dt,rec,spike,n_steps", IZH_SCAN_BWD_CASES,
    ids=[f"dt{c[0]:g}-{'rec' if c[1] else 'ff'}-{c[2].name}-{c[3]}"
         for c in IZH_SCAN_BWD_CASES])
def test_izh_scan_bwd_mma_chain_matches_ordered_versions(card, dt, rec, spike,
                                                         n_steps, wdtype):
    """``izh_scan_bwd`` with its chain on the tensor-core chain body
    (``izh_chain.cuh:IzhScanChain``) against
    ``izh._scan_bwd_ordered_reference`` at H = 20 and 128 on the forward
    kernel's residuals: g_i, g_W_rec and its float32 sum within 2e-6 of
    max|g| (5e-6 at T = 100) at dt = 1e-3, 1e-4 at dt = 30, bf16 2**-7;
    equal bits twice; the feedforward scan takes no scratch; its plan and
    ``scan_bodies`` name the chain's body."""
    bf16 = wdtype == torch.bfloat16
    bar = _izh_bar(n_steps, wdtype) if dt < 1 else (
        2.0 ** -7 if bf16 else 1e-4)
    gamma = IzhikevichConfig(input_size=1, output_size=1).gamma
    rng = np.random.default_rng(17)
    for H in (20, 128):
        cur, w_rec, kp = _scan_inputs(card, dt, rec, n_steps, wdtype, H)
        B = cur.shape[1]
        assert izh.scan_bodies(n_steps, H, rec, wdtype.itemsize, card,
                               True) == ("mma", "mma")
        order = izh.gradient_plan(card, B, H, n_steps, rec, bf16)
        assert order["mma"] and (order["groups_rec"] > 0) == rec
        z, v = izh._scan_cuda(cur, w_rec, kp, True)
        assert float(z.sum()) > 0  # the units fire
        g_z = torch.from_numpy(rng.standard_normal(tuple(z.shape)).astype(
            np.float32)).to(card) / B
        sargs = (g_z, z, v, w_rec, kp, gamma, spike)
        keep, okeep = {}, {}
        fused.reset_launch_counts()
        got = izh._scan_bwd_cuda(*sargs, keep=keep)
        again = izh._scan_bwd_cuda(*sargs)
        assert _launched() == {fused.KERNEL_IZH_SCAN_BWD: 2}
        want = izh._scan_bwd_ordered_reference(*sargs, order, keep=okeep)
        torch.cuda.synchronize()
        _grads_close(got, again, want, bar)
        if rec:
            err = _rel_err(keep["g_w_rec"], okeep["g_w_rec"])
            assert err <= bar, f"H={H} g_W_rec sum: {err:.3g} of max|g|"
        else:
            assert keep["zmask"] is None


@pytest.mark.cuda
@pytest.mark.parametrize("H,wdtype,rec", [(192, torch.float32, True),
                                          (288, torch.bfloat16, True),
                                          (288, torch.float32, False)],
                         ids=["f32-rec-H192", "bf16-rec-H288",
                              "f32-ff-H288"])
def test_izh_scan_per_unit_body_takes_the_rest(card, H, wdtype, rec):
    """Shapes past the tensor-core bodies' limits (float32 W_rec's pieces
    past a block's shared memory from H = 161, H > 256) run the scan's
    per-unit kernels, which ``scan_bodies`` (training too),
    ``gradient_plan`` and ``explain_dispatch`` name, against the
    order-free plain versions: spikes equal, ``v`` 1e-6 relative and 1e-3
    mV (bitwise feedforward), gradients at the small bars, equal bits
    twice."""
    import snnimageclassification_tpu_torch as pt
    from snnimageclassification_tpu_torch.models import snn as model_lib

    T, it = 24, wdtype.itemsize
    assert izh.izh_scan_supported(T, H, rec, it, card, True)
    assert izh.scan_bodies(T, H, rec, it, card, True) == ("per-unit",
                                                          "per-unit")
    cur, w_rec, kp = _scan_inputs(card, 1e-3, rec, T, wdtype, H, B=21)
    assert not izh.gradient_plan(card, 21, H, T, rec,
                                 wdtype == torch.bfloat16)["mma"]
    z, v = izh._scan_cuda(cur, w_rec, kp, True)
    zp, vp = izh._scan_reference(cur, w_rec, kp, True)
    torch.cuda.synchronize()
    assert torch.equal(z, zp) and 0 < float(z.mean()) < 1
    if rec:
        torch.testing.assert_close(v, vp, rtol=1e-6, atol=1e-3)
    else:
        assert torch.equal(v, vp)
    g_z = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (T, 21, H)).astype(np.float32)).to(card) / 21
    sargs = (g_z, z, v, w_rec, kp, IZH.gamma, FAST)
    _grads_close(izh._scan_bwd_cuda(*sargs), izh._scan_bwd_cuda(*sargs),
                 izh._scan_bwd_reference(*sargs), _izh_bar(T, wdtype))
    cfg = pt.SNNConfig(input_size=784, output_size=10,
                       n_hidden_neurons=[128, H],
                       hidden_layer_type="Izhikevich",
                       use_recurrent_connection=rec, int_time_steps=100,
                       dt=30.0, matmul_dtype=str(wdtype)[6:])
    row = model_lib.explain_dispatch(cfg, pt.EncodeConfig(n_steps=100),
                                     device="cuda", training=True)[1]
    assert row["path"] == (f"cuda:{fused.KERNEL_IZH_SCAN}+"
                           f"{fused.KERNEL_IZH_SCAN_BWD}[per-unit]"), row
    assert "(mma)" not in row["reason"]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,rec,use_periods,n_steps,spike", IZH_CASES,
                         ids=[c[0] for c in IZH_CASES])
def test_fused_izh_kernels_match_plain_versions(card, name, rec, use_periods,
                                                n_steps, spike, wdtype):
    B, F, H, O = 37, 30, 20, 10
    rng = np.random.default_rng(4)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(card)
    lat = pixels_to_firing_periods(pixels, t_max=float(n_steps),
                                   tau=20.0).contiguous()
    w_in, w_rec, w_out, b_out = _izh_weights(card, rng, F, H, O, rec, wdtype)
    kappa = ReadoutConfig(input_size=H, output_size=O).kappa
    head = (lat, w_in, w_rec, w_out, b_out, n_steps, use_periods, IZH_KP,
            kappa)
    fused.reset_launch_counts()
    infer = fused_izh._head_cuda(*head, False, False)[0]
    logits, v, tstar, counts = fused_izh._head_cuda(*head, True, True)
    want = fused_izh._head_reference(*head, True, True)
    z0, v0 = fused_izh._layer0_cuda(lat, w_in, w_rec, n_steps, use_periods,
                                    IZH_KP, True)
    z0p, v0p = fused_izh._layer0_reference(lat, w_in, w_rec, n_steps,
                                           use_periods, IZH_KP, True)
    torch.cuda.synchronize()
    assert torch.equal(logits, infer)  # same arithmetic, same order
    torch.testing.assert_close(logits, want[0], atol=1e-5, rtol=1e-5)
    assert torch.equal(tstar, want[2]) and torch.equal(counts, want[3])
    assert float(counts.sum()) > 0
    assert v.dtype == torch.float32  # whatever the weights' type
    torch.testing.assert_close(v, want[1], rtol=1e-6, atol=1e-3)
    # The first layer runs the head's tensor-core body without the readout:
    # its v is the head's, bit for bit.
    assert fused_izh.head_bodies(n_steps, F, H, O, rec, wdtype.itemsize,
                                 card, True, use_periods) == ("mma", "mma")
    assert fused_izh.layer0_bodies(n_steps, F, H, rec, wdtype.itemsize,
                                   card)[0] == "mma"
    assert torch.equal(v0, v)
    assert torch.equal(z0, (v0 >= IZH.v_peak).float())
    assert torch.equal(z0, (v >= IZH.v_peak).float())
    assert torch.equal(z0, z0p)
    torch.testing.assert_close(v0, v0p, rtol=1e-6, atol=1e-3)
    bar = _izh_bar(n_steps, wdtype)
    g_logits = torch.from_numpy(
        rng.standard_normal((B, O)).astype(np.float32)).to(card)
    g_counts = torch.from_numpy(
        (0.01 * rng.standard_normal((B, H))).astype(np.float32)).to(card)
    for gc in (None, g_counts):
        bargs = (g_logits, gc, tstar, None, None, v, lat, w_in, w_rec, w_out,
                 n_steps, use_periods, IZH_KP, IZH.gamma, kappa, spike)
        _grads_close(fused_izh._bwd_cuda(*bargs), fused_izh._bwd_cuda(*bargs),
                     fused_izh._bwd_reference(*bargs), bar)
    g_z = torch.from_numpy(rng.standard_normal(
        (n_steps, B, H)).astype(np.float32)).to(card)
    bargs = (None, None, None, g_z, z0, v0, lat, w_in, w_rec, None, n_steps,
             use_periods, IZH_KP, IZH.gamma, 0.0, spike)
    _grads_close(fused_izh._bwd_cuda(*bargs), fused_izh._bwd_cuda(*bargs),
                 fused_izh._bwd_reference(*bargs), bar)
    assert _launched() == {fused.KERNEL_IZH: 1, fused.KERNEL_IZH_TRAIN: 1,
                           fused.KERNEL_IZH_L0: 1, fused.KERNEL_IZH_BWD: 4,
                           fused.KERNEL_IZH_L0_BWD: 2}


IZH30 = IzhikevichConfig(input_size=1, output_size=1, dt=30.0)
IZH30_KP = izh.izh_kernel_params(IZH30)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rec,use_periods,spike",
                         [(False, False, PHI), (True, True, FAST)],
                         ids=["ff-ttfs-phi", "rec-periodic-fs"])
def test_izh_backward_kernels_match_plain_versions_at_dt30(
        card, rec, use_periods, spike, wdtype):
    """dt = 30, where the models are served and trained: dt a b = -1.8 and
    1 - dt a = 0.1, so the chain's u carry moves the gradients as much as
    its v carry (at dt = 1e-3, the cases above, it moves them by ~6e-8 of
    max|g|, under their bars).  Init-scale weights; each backward kernel
    against its plain version on its forward kernel's residuals (the
    forwards are not compared: between spikes the cell triples a last-bit
    difference of v each step), 1e-4 of max|g| float32, one rounding
    bfloat16."""
    B, F, H, O, T = 37, 100, 20, 10, 100
    rng = np.random.default_rng(12)

    def w(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(card)

    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(card)
    lat = pixels_to_firing_periods(pixels, t_max=float(T)).contiguous()
    eye = 1 - torch.eye(H, device=card)
    w_in, w_out, w1 = (w(s).to(wdtype) for s in ((F, H), (H, O), (H, H)))
    w_rec, w_rec1 = ((w((H, H)) * eye).to(wdtype) if rec else None
                     for _ in range(2))
    b_out = 0.1 * w((O,))
    kappa = ReadoutConfig(input_size=H, output_size=O).kappa
    _, v, tstar, counts = fused_izh._head_cuda(
        lat, w_in, w_rec, w_out, b_out, T, use_periods, IZH30_KP, kappa,
        True, True)
    z0, v0 = fused_izh._layer0_cuda(lat, w_in, w_rec, T, use_periods,
                                    IZH30_KP, True)
    z1, v1 = izh._scan_cuda((z0 @ w1.float()).contiguous(), w_rec1,
                            IZH30_KP, True)
    for rate in (float(counts.mean()) / T, float(z0.mean()),
                 float(z1.mean())):
        assert 0 < rate < 1
    bar = 1e-4 if wdtype == torch.float32 else 2.0 ** -7
    g_logits, g_z = w((B, O)) / B, w((T, B, H)) / B
    cases = [(g_logits, gc, tstar, None, None, v, lat, w_in, w_rec, w_out, T,
              use_periods, IZH30_KP, IZH30.gamma, kappa, spike)
             for gc in (None, 1e-3 * w((B, H)) / B)]
    cases.append((None, None, None, g_z, z0, v0, lat, w_in, w_rec, None, T,
                  use_periods, IZH30_KP, IZH30.gamma, 0.0, spike))
    for bargs in cases:
        _grads_close(fused_izh._bwd_cuda(*bargs), fused_izh._bwd_cuda(*bargs),
                     fused_izh._bwd_reference(*bargs), bar)
    sargs = (g_z, z1, v1, w_rec1, IZH30_KP, IZH30.gamma, spike)
    _grads_close(izh._scan_bwd_cuda(*sargs), izh._scan_bwd_cuda(*sargs),
                 izh._scan_bwd_reference(*sargs), bar)


@pytest.mark.cuda
def test_izh_autograd_runs_the_kernel_pairs(card):
    """The public wrappers under autograd: the head (with counts) and the
    first layer followed by a scan launch one forward and one backward
    kernel each and agree with the plain versions' gradients."""
    B, F, H, O, T = 16, 30, 20, 10, 24
    rng = np.random.default_rng(6)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(card)
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   tau=20.0).contiguous()
    base = _izh_weights(card, rng, F, H, O, True, torch.float32)
    w1 = torch.from_numpy((0.1 * rng.standard_normal((H, H))).astype(
        np.float32)).to(card)
    kappa = ReadoutConfig(input_size=H, output_size=O).kappa
    r = torch.from_numpy(rng.standard_normal((B, O)).astype(np.float32)).to(
        card)

    def grads(plain):
        sfx = "_reference" if plain else ""
        w_in, w_rec, w_out, b_out = (t.clone().requires_grad_(True)
                                     for t in base)
        logits, counts = getattr(
            fused_izh, f"fused_encode_izh_scan_head_counts{sfx}")(
                lat, w_in, w_rec, w_out, b_out, IZH_KP, T, False, IZH.gamma,
                kappa)
        z0 = getattr(fused_izh, f"fused_encode_izh_scan{sfx}")(
            lat, w_in, w_rec, IZH_KP, T, True, IZH.gamma)
        z1 = getattr(izh, f"izh_scan{sfx}")(
            3e6 + 1e7 * (z0 @ w1), w_rec, IZH_KP, IZH.gamma)
        loss = ((logits * r).sum() + 1e-3 * (counts ** 2).sum()
                + 1e-3 * z1.sum(0).pow(2).sum())
        loss.backward()
        return [t.grad for t in (w_in, w_rec, w_out, b_out)]

    fused.reset_launch_counts()
    got = grads(False)
    assert _launched() == {fused.KERNEL_IZH_TRAIN: 1, fused.KERNEL_IZH_BWD: 1,
                           fused.KERNEL_IZH_L0: 1, fused.KERNEL_IZH_L0_BWD: 1,
                           fused.KERNEL_IZH_SCAN: 1,
                           fused.KERNEL_IZH_SCAN_BWD: 1}
    for g, p in zip(got, grads(True)):
        scale = float(p.abs().max()) or 1.0
        assert float((g - p).abs().max()) / scale <= 1e-4


@pytest.mark.cuda
def test_izh_models_dispatch_to_the_kernels(card):
    """Flagship and deep Izhikevich configs (dt = 30, where units fire) on
    the card: ``explain_dispatch`` names the kernels, inference launches the
    head (or layer 0 and one scan) once, a training step each pair once."""
    import snnimageclassification_tpu_torch as tst
    from snnimageclassification_tpu_torch.models import snn as tsnn
    from snnimageclassification_tpu_torch.train import Trainer

    enc = tst.EncodeConfig(n_steps=24)
    x = torch.rand((64, 784), device=card)
    y = torch.randint(0, 10, (64,), device=card)
    for hidden, fwd, step in (
            (128, {fused.KERNEL_IZH: 1},
             {fused.KERNEL_IZH_TRAIN: 1, fused.KERNEL_IZH_BWD: 1}),
            ([128, 128], {fused.KERNEL_IZH_L0: 1, fused.KERNEL_IZH_SCAN: 1},
             {fused.KERNEL_IZH_L0: 1, fused.KERNEL_IZH_L0_BWD: 1,
              fused.KERNEL_IZH_SCAN: 1, fused.KERNEL_IZH_SCAN_BWD: 1})):
        cfg = tst.SNNConfig(input_size=784, output_size=10,
                            n_hidden_neurons=hidden,
                            hidden_layer_type="Izhikevich",
                            int_time_steps=24, dt=30.0)
        paths = [r["path"] for r in tsnn.explain_dispatch(cfg, enc)]
        assert all(p.startswith("cuda:") or p == "torch:loop"
                   for p in paths), paths
        trainer = Trainer(cfg, seed=0, encode_config=enc, device="cuda")
        fused.reset_launch_counts()
        with torch.no_grad():
            logits = tsnn.forward_logits_pixels(cfg, trainer.params, x, enc)
        assert _launched() == fwd and bool(torch.isfinite(logits).all())
        fused.reset_launch_counts()
        loss = trainer.train_step(x, y)
        assert _launched() == step and np.isfinite(float(loss))


# The Izhikevich head's tensor-core body (csrc/head_mma_fwd.cuh with the
# Izhikevich cell, csrc/chain_mma.cuh with its chain): every mode against
# the plain versions in the body's order, the forward bit for bit.
IZH_MMA_CASES = [
    (dt, rec, per, spike, T)
    for dt in (1e-3, 30.0) for rec in (True, False) for per in (False, True)
    for spike in (FAST, PHI) for T in (1, 2, 24, 100)]


def _izh_head(dev, dt, rec, use_periods, T, wdtype, B=37, F=30, H=20, O=10,
              seed=31):
    """(lat, w_in, w_rec, w_out, b_out, T, use_periods, kp, kappa): the JAX
    suite's scale at dt = 1e-3, init-scale N(0, 1) weights at dt = 30."""
    rng = np.random.default_rng(seed)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(dev)
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   tau=20.0).contiguous()
    if dt < 1:
        w_in, w_rec, w_out, b_out = _izh_weights(dev, rng, F, H, O, rec,
                                                 wdtype)
    else:
        def w(shape, std=1.0):
            return torch.from_numpy(
                (std * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        w_in, w_out, b_out = w((F, H)).to(wdtype), w((H, O)).to(wdtype), \
            w((O,), 0.1)
        w_rec = ((w((H, H)) * (1 - torch.eye(H, device=dev))).to(wdtype)
                 if rec else None)
    kp = izh.izh_kernel_params(IzhikevichConfig(input_size=1, output_size=1,
                                                dt=dt))
    return (lat, w_in, w_rec, w_out, b_out, T, use_periods, kp,
            ReadoutConfig(input_size=H, output_size=O).kappa)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "dt,rec,use_periods,spike,n_steps", IZH_MMA_CASES,
    ids=[f"dt{c[0]:g}-{'rec' if c[1] else 'ff'}-"
         f"{'periodic' if c[2] else 'ttfs'}-{c[3].name}-{c[4]}"
         for c in IZH_MMA_CASES])
def test_izh_mma_body_matches_plain_versions(card, dt, rec, use_periods,
                                             spike, n_steps, wdtype):
    """The Izhikevich head on its tensor-core body: the forward, the
    training forward (with counts) bit for bit their plain version in the
    body's order (logits, ``v``, ``tstar``, counts), training logits the
    inference kernel's; at dt = 1e-3 also the order-free plain version's
    bars (logits 1e-5, spikes equal, ``v`` 1e-6 relative and 1e-3 mV; at dt
    = 30 the cell triples a last-bit difference each step between spikes).
    The backward on the training forward's residuals, with and without the
    counts' cotangent, against both plain versions: 2e-6 of max|g| (5e-6
    at T = 100) at dt = 1e-3, 1e-4 at dt = 30, bf16 2**-7; equal bits on a
    second run."""
    head = _izh_head(card, dt, rec, use_periods, n_steps, wdtype)
    lat, w_in, w_rec, w_out = head[:4]
    B, F = lat.shape
    H, O = w_out.shape
    assert fused_izh.head_bodies(n_steps, F, H, O, rec, wdtype.itemsize,
                                 card, True, use_periods) == ("mma", "mma")
    fused.reset_launch_counts()
    infer = fused_izh._head_cuda(*head, False, False)[0]
    got = fused_izh._head_cuda(*head, True, True)
    ordered = fused_izh._izh_head_train_ordered_reference(*head, True, True)
    torch.cuda.synchronize()
    assert _launched() == {fused.KERNEL_IZH: 1, fused.KERNEL_IZH_TRAIN: 1}
    assert torch.equal(got[0], infer)
    for k, (a, b) in enumerate(zip(got, ordered)):
        assert torch.equal(a, b), f"output {k} differs from the ordered one"
    if n_steps > 2:
        assert float(got[3].sum()) > 0  # the units fire
    if dt < 1:
        want = fused_izh._head_reference(*head, True, True)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-3)
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    bar = _izh_bar(n_steps, wdtype) if dt < 1 else (
        1e-4 if wdtype == torch.float32 else 2.0 ** -7)
    rng = np.random.default_rng(7)
    g_logits = torch.from_numpy(
        rng.standard_normal((B, O)).astype(np.float32)).to(card) / B
    g_counts = torch.from_numpy(
        (1e-3 * rng.standard_normal((B, H))).astype(np.float32)).to(card) / B
    gamma = IzhikevichConfig(input_size=1, output_size=1).gamma
    order = fused_izh.gradient_plan(card, B, F, H, O, n_steps, rec,
                                    wdtype == torch.bfloat16, use_periods)
    for gc in (None, g_counts):
        bargs = (g_logits, gc, got[2], None, None, got[1], lat, w_in, w_rec,
                 w_out, n_steps, use_periods, head[7], gamma, head[8], spike)
        grads = fused_izh._bwd_cuda(*bargs)
        again = fused_izh._bwd_cuda(*bargs)
        for plain in (fused_izh._izh_bwd_ordered_reference(*bargs, order),
                      fused_izh._bwd_reference(*bargs)):
            _grads_close(grads, again, plain, bar)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rec", [True, False], ids=["rec", "ff"])
def test_izh_mma_body_rows_do_not_depend_on_their_batch(card, rec, wdtype):
    """At dt = 30 (where a last-bit difference grows each step), a row's
    logits and ``v`` are the same bits whichever rows share its 16-row
    tile: rows firing 0 to 7 of F = 48 features at t = 0 (the dense input
    product takes a row from F / 16 = 3 on) and the rest spread over the
    window, run whole and as a shuffled subset; both bit for bit the
    ordered plain version."""
    B, F, H, T = 37, 48, 45, 24
    rng = np.random.default_rng(9)
    lat = rng.integers(1, T + 4, (B, F)).astype(np.int32)
    for r in range(B):
        lat[r, rng.choice(F, r % 8, replace=False)] = 0
    head = list(_izh_head(card, 30.0, rec, False, T, wdtype, B=B, F=F, H=H))
    head[0] = torch.from_numpy(lat).to(card)
    whole = fused_izh._head_cuda(*head, True, False)
    want = fused_izh._izh_head_train_ordered_reference(*head, True, False)
    assert torch.equal(whole[0], want[0]) and torch.equal(whole[1], want[1])
    idx = torch.from_numpy(rng.permutation(B)[:23]).to(card)
    sub = list(head)
    sub[0] = head[0][idx].contiguous()
    part = fused_izh._head_cuda(*sub, True, False)
    assert torch.equal(part[0], whole[0][idx])
    assert torch.equal(part[1], whole[1][:, idx])


@pytest.mark.cuda
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("H,O,wdtype", [(200, 10, torch.float32),
                                        (33, 40, torch.bfloat16),
                                        (288, 10, torch.bfloat16)],
                         ids=["f32-H200", "bf16-O40", "bf16-H288"])
def test_izh_per_unit_body_takes_the_rest(card, H, O, wdtype, use_periods):
    """Shapes past the tensor-core body's limits (float32 W_rec's pieces
    past shared memory, O > 16, H > 256) run the Izhikevich head's per-unit
    body, which ``head_bodies`` names, at the JAX suite's scale against the
    plain versions: spikes, ``tstar`` and counts equal, logits 1e-5, ``v``
    1e-6 relative; the backward at the small bars."""
    T = 24
    head = _izh_head(card, 1e-3, True, use_periods, T, wdtype, B=21, H=H,
                     O=O)
    assert fused_izh.fused_izh_head_supported(T, 30, H, O, True,
                                              wdtype.itemsize, card, True,
                                              use_periods)
    assert fused_izh.head_bodies(T, 30, H, O, True, wdtype.itemsize, card,
                                 True, use_periods) == ("per-unit",
                                                        "per-unit")
    got = fused_izh._head_cuda(*head, True, True)
    want = fused_izh._head_reference(*head, True, True)
    assert torch.equal(got[0], fused_izh._head_cuda(*head, False, False)[0])
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-3)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (21, O)).astype(np.float32)).to(card)
    bargs = (g, None, got[2], None, None, got[1], *head[:4], T, use_periods,
             head[7], IZH.gamma, head[8], FAST)
    _grads_close(fused_izh._bwd_cuda(*bargs), fused_izh._bwd_cuda(*bargs),
                 fused_izh._bwd_reference(*bargs), _izh_bar(T, wdtype))


@pytest.mark.cuda
def test_explain_dispatch_names_the_izh_bodies(card):
    """The Izhikevich head names its body: the tensor-core body ("mma") in
    the forward and the backward's chain at 784-Izh128-10, f32 and bf16,
    single and stacked; the per-unit body at O = 40; layer 0
    (``fused_izh_layer0_fwd``) and the scan of the layer past it
    (``izh_scan_fwd``) name the tensor-core body of their forwards and of
    their backwards' chains."""
    import snnimageclassification_tpu_torch as pt
    from snnimageclassification_tpu_torch.models import snn as model_lib

    enc = pt.EncodeConfig(n_steps=100)

    def cfg(hidden=128, O=10, md="float32"):
        return pt.SNNConfig(input_size=784, output_size=O,
                            n_hidden_neurons=hidden,
                            hidden_layer_type="Izhikevich",
                            int_time_steps=100, dt=30.0, matmul_dtype=md)

    for md in ("float32", "bfloat16"):
        for training in (False, True):
            for stacked in (False, True):
                entry = model_lib.explain_dispatch(
                    cfg(md=md), enc, device="cuda", training=training,
                    stacked=stacked)[0]
                assert "[per-unit]" not in entry["path"], entry
                assert "the tensor-core body (mma)" in entry["reason"], entry
                assert ("backward's chain" in entry["reason"]) == training
            assert fused_izh.head_bodies(
                100, 784, 128, 10, True, 4 if md == "float32" else 2, card,
                True, False) == ("mma", "mma")
    wide_o = model_lib.explain_dispatch(cfg(O=40), enc, device="cuda",
                                        training=True)[0]
    assert wide_o["path"].endswith("[per-unit]")
    assert "per-unit body" in wide_o["reason"]
    assert "(mma)" not in wide_o["reason"]
    deep = model_lib.explain_dispatch(cfg([128, 128]), enc, device="cuda",
                                      training=True)
    assert deep[0]["path"] == (f"cuda:{fused.KERNEL_IZH_L0}+"
                               f"{fused.KERNEL_IZH_L0_BWD}")
    assert deep[1]["path"] == (f"cuda:{fused.KERNEL_IZH_SCAN}+"
                               f"{fused.KERNEL_IZH_SCAN_BWD}")
    for row in deep[:2]:
        assert "the tensor-core body (mma) in the forward" in row["reason"]
        assert ("the tensor-core body (mma) in the backward's chain"
                in row["reason"])
        assert "per-unit" not in row["reason"]
    assert izh.scan_bodies(100, 128, True, 4, card, True) == ("mma", "mma")


# ---------------------------------------------------------------------------
# The two-layer pair
# ---------------------------------------------------------------------------
F2_CASES = [  # name, alif, recurrent, use_periods, surrogate
    ("alif-rec-fs-ttfs", True, True, False, FAST),
    ("alif-rec-phi-periodic", True, True, True, PHI),
    ("lif-ff-phi-ttfs", False, False, False, PHI),
    ("lif-rec-fs-periodic", False, True, True, FAST),
]


def _f2_args(dev, T, alif, rec, use_periods, wdtype, B=9, F=30, H1=20, H2=24,
             O=10, seed=7):
    """Positional arguments of ``fused2._fused2_cuda`` / its plain version
    up to ``kappa``, at a scale where both layers fire."""
    rng = np.random.default_rng(seed)
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H1)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(dev)
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   tau=20.0).contiguous()

    def w(shape, std, mask=False):
        t = torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        if mask:
            t = t * (1 - torch.eye(shape[0], device=dev))
        return t.to(wdtype)

    w0r = w((H1, H1), 0.4, True) if rec else None
    w1r = w((H2, H2), 0.4, True) if rec else None
    return (lat, w((F, H1), 1.5), w0r, 1.6 if alif else 0.0, w((H1, H2), 1.0),
            w1r, 1.2 if alif else 0.0, w((H2, O), 1.0),
            w((O,), 0.1).float(), T, use_periods, alif, cfg.alpha,
            cfg.rho if alif else 0.0, cfg.threshold,
            ReadoutConfig(input_size=H2, output_size=O).kappa), cfg.gamma


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("name,alif,rec,use_periods,spike", F2_CASES,
                         ids=[c[0] for c in F2_CASES])
def test_fused2_kernels_match_plain_versions(card, name, alif, rec,
                                             use_periods, spike, n_steps,
                                             wdtype):
    args, gamma = _f2_args(card, n_steps, alif, rec, use_periods, wdtype)
    store_a = alif and spike == PHI
    fused.reset_launch_counts()
    infer = fused2._fused2_cuda(*args, False, False, False)[0]
    got = fused2._fused2_cuda(*args, True, store_a, True)
    want = fused2._fused2_reference(*args, True, store_a, True)
    torch.cuda.synchronize()
    assert _launched() == {fused.KERNEL_2: 1, fused.KERNEL_2_TRAIN: 1}
    logits, d0, a0, d1, a1, tstar, c0, c1 = got
    assert torch.equal(logits, infer)  # same arithmetic, same order
    torch.testing.assert_close(logits, want[0], atol=1e-5, rtol=1e-5)
    assert torch.equal(tstar, want[5])
    assert torch.equal(c0, want[6]) and torch.equal(c1, want[7])
    assert float(c0.sum()) > 0 and float(c1.sum()) > 0
    tol = 1e-5 if wdtype == torch.float32 else 2.0 ** -7
    for g, p in zip((d0, a0, d1, a1), want[1:5]):
        assert (g is None) == (p is None)
        if g is not None:
            torch.testing.assert_close(g.float(), p.float(), atol=tol,
                                       rtol=tol)
    assert torch.equal(d0.float() >= 0, want[1].float() >= 0)
    assert torch.equal(d1.float() >= 0, want[3].float() >= 0)
    rng = np.random.default_rng(8)
    g_logits = torch.from_numpy(
        rng.standard_normal(logits.shape).astype(np.float32)).to(card)
    g_c0, g_c1 = (torch.from_numpy((0.01 * rng.standard_normal(c.shape))
                                   .astype(np.float32)).to(card)
                  for c in (c0, c1))
    lat, w0, w0r, b0, w1, w1r, b1, w_out = args[:8]
    tail = (n_steps, use_periods, args[12], args[14], gamma, args[15], spike)
    if wdtype == torch.bfloat16:
        bar = 2.0 ** -7
    elif spike == PHI and alif:
        bar = 2e-5
    else:
        bar = 2e-6 if n_steps < 100 else 5e-6
    for gc in ((None, None), (g_c0, g_c1)):
        bargs = (g_logits, *gc, tstar, d0, a0, d1, a1, lat, w0, w0r, b0, w1,
                 w1r, b1, w_out, *tail)
        grads = fused2._fused2_bwd_cuda(*bargs)
        again = fused2._fused2_bwd_cuda(*bargs)
        plain = fused2._fused2_bwd_reference(*bargs)
        torch.cuda.synchronize()
        for gname, g, g2, p in zip(("w0", "w0r", "w1", "w1r", "w_out", "b"),
                                   grads, again, plain):
            if p is None:
                assert g is None
                continue
            assert g.dtype == p.dtype and g.shape == p.shape
            assert torch.equal(g, g2), f"{gname}: not reproducible"
            scale = float(p.float().abs().max()) or 1.0
            err = float((g.float() - p.float()).abs().max()) / scale
            assert err <= bar, f"{gname}: {err:.3g} of max|g|"
    assert fused.launch_counts()[fused.KERNEL_2_BWD] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("name,alif,rec,use_periods,spike", F2_CASES,
                         ids=[c[0] for c in F2_CASES])
def test_fused2_equals_the_composed_kernels_bitwise(card, name, alif, rec,
                                                    use_periods, spike,
                                                    n_steps, wdtype):
    """``fused2_fwd_train`` against ``fused_layer0_fwd`` +
    ``fused_mid_fwd[head]``, bit for bit: logits, ``tstar``, both counts
    and both layers' residuals.  On the tensor-core bodies (two layers of
    20 and 24 units, F = 30) the pair's layer 0 and ``fused_layer0_fwd``
    are one code (``head_mma_fwd.cuh:mma_layer``) and its layer 1 sums as
    the mid head's body; past them (layers of 192 and 48 float32 recurrent
    units, else of 288 and 72, where each of the three kernels runs its
    per-unit body) the per-unit bodies sum in one order."""
    H1p, H2p = (192, 48) if rec and wdtype == torch.float32 else (288, 72)
    args, _ = _f2_args(card, n_steps, alif, rec, use_periods, wdtype, B=40)
    wide, _ = _f2_args(card, n_steps, alif, rec, use_periods, wdtype, B=40,
                       H1=H1p, H2=H2p)
    it = wdtype.itemsize
    for a, body in ((args, "mma"), (wide, "per-unit")):
        H1, H2 = a[4].shape
        assert fused2.fused2_bodies(n_steps, 30, H1, H2, 10, rec, it,
                                    device=card)[0] == body
        assert fused.layer0_bodies(n_steps, 30, H1, rec, it, card)[0] == body
        assert fused_mid.mid_bodies(n_steps, H1, H2, 10, rec, it,
                                    card)[0] == body
        lat, w0, w0r, b0, w1, w1r, b1, w_out, b_out = a[:9]
        sc = a[12:15]
        store_a = alif and spike == PHI
        logits, d0, a0, d1, a1, tstar, c0, c1 = fused2._fused2_cuda(
            *a, True, store_a, True)
        z0, r0, ra0 = fused._layer0_cuda(lat, w0, w0r, b0, n_steps,
                                         use_periods, alif, *sc, True,
                                         store_a, False)
        m = fused_mid._mid_cuda(z0, w1, w1r, b1, w_out, b_out, n_steps,
                                alif, *sc, a[15], True, store_a, True, False)
        torch.cuda.synchronize()
        assert float(c1.sum()) > 0
        assert torch.equal(logits, m[0]) and torch.equal(tstar, m[4]), body
        assert torch.equal(c0, z0.float().sum(0)) and torch.equal(c1, m[5])
        assert torch.equal(d0, r0) and torch.equal(d1, m[2]), body
        for g, w in ((a0, ra0), (a1, m[3])):
            assert (g is None) == (not store_a) == (w is None)
            assert g is None or torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("name,alif,rec,use_periods,spike", F2_CASES,
                         ids=[c[0] for c in F2_CASES])
def test_fused2_bwd_equals_the_composed_kernels(card, name, alif, rec,
                                                use_periods, spike, n_steps,
                                                wdtype):
    """``fused2_bwd`` against ``fused_mid_bwd[head]`` + ``fused_layer0_bwd``
    on the composed forward's residuals (two layers of 20 and 24 units, F =
    30, B = 40, both counts' cotangents; layer 0's ``g_z = g_z_in + g_c0``
    as autograd adds it): in float32 the six gradients bit for bit (every
    chain on the tensor-core chain body, the pair's dz0 + g_cnt0 the same
    float32 sum); bfloat16 within 2**-6 of max|g| (the composed pair rounds
    layer 0's ``g_z`` to bfloat16, the pair keeps it float32)."""
    args, gamma = _f2_args(card, n_steps, alif, rec, use_periods, wdtype,
                           B=40)
    lat, w0, w0r, b0, w1, w1r, b1, w_out, b_out = args[:9]
    H1, H2 = w1.shape
    it = wdtype.itemsize
    assert fused.layer0_bodies(n_steps, 30, H1, rec, it, card, True,
                               use_periods) == ("mma", "mma")
    assert fused_mid.mid_bodies(n_steps, H1, H2, 10, rec, it, card,
                                True) == ("mma", "mma")
    assert fused2.fused2_bodies(n_steps, 30, H1, H2, 10, rec, it,
                                device=card, training=True,
                                use_periods=use_periods) == ("mma", "mma")
    sc, kappa = args[12:15], args[15]
    store_a = alif and spike == PHI
    out = fused2._fused2_cuda(*args, True, store_a, True)
    z0, r0, ra0 = fused._layer0_cuda(lat, w0, w0r, b0, n_steps, use_periods,
                                     alif, *sc, True, store_a, False)
    m = fused_mid._mid_cuda(z0, w1, w1r, b1, w_out, b_out, n_steps, alif,
                            *sc, kappa, True, store_a, True, False)
    rng = np.random.default_rng(23)
    g_logits = torch.from_numpy(rng.standard_normal(
        (40, 10)).astype(np.float32)).to(card) / 40
    g_c0, g_c1 = (torch.from_numpy((1e-3 * rng.standard_normal(
        (40, n))).astype(np.float32)).to(card) / 40 for n in (H1, H2))
    alpha, thr = args[12], args[14]
    got = fused2._fused2_bwd_cuda(
        g_logits, g_c0, g_c1, out[5], out[1], out[2], out[3], out[4], lat,
        w0, w0r, b0, w1, w1r, b1, w_out, n_steps, use_periods, alpha, thr,
        gamma, kappa, spike)
    g_z_in, g_w1, g_w1r, g_wout, g_b = fused_mid._mid_bwd_cuda(
        g_logits, g_c1, m[4], None, None, m[2], m[3], False, z0, w1, w1r, b1,
        w_out, n_steps, alpha, thr, gamma, kappa, spike)
    g_z = (g_z_in.float() + g_c0).to(wdtype).contiguous()
    g_w0, g_w0r = fused._layer0_bwd_cuda(g_z, z0, r0, ra0, False, lat, w0,
                                         w0r, b0, n_steps, use_periods,
                                         alpha, thr, gamma, spike)
    want = (g_w0, g_w0r, g_w1, g_w1r, g_wout, g_b)
    torch.cuda.synchronize()
    if wdtype == torch.float32:
        names = ("g_w0", "g_w0r", "g_w1", "g_w1r", "g_wout", "g_b")
        for what, g, w in zip(names, got, want):
            assert (g is None) == (w is None), what
            assert g is None or torch.equal(g, w), what
    else:
        assert _grad_err(got, want) <= 2.0 ** -6


def _mid_case(dev, T, Hin, H, O, alif, rec, wdtype, B=37, seed=11):
    """``fused_mid`` arguments up to ``kappa`` (``O == 0``: the z-emitting
    mode) at a scale where the layer fires: z_in 0/1 at 25 %, W_in of std
    2 / sqrt(Hin) (the deep net's threshold scale), W_rec 1 / sqrt(H)
    eye-masked."""
    rng = np.random.default_rng(seed)
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=Hin, output_size=H)

    def w(shape, std, mask=False):
        t = torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        if mask:
            t = t * (1 - torch.eye(shape[0], device=dev))
        return t.to(wdtype)

    z_in = torch.from_numpy((rng.random((T, B, Hin)) < 0.25)
                            .astype(np.float32)).to(dev).to(wdtype)
    return (z_in, w((Hin, H), 2.0 / np.sqrt(Hin)),
            w((H, H), 1.0 / np.sqrt(H), True) if rec else None,
            1.6 if alif else 0.0, w((H, O), 1.0) if O else None,
            w((O,), 0.1).float() if O else None, T, alif, cfg.alpha,
            cfg.rho if alif else 0.0, cfg.threshold,
            ReadoutConfig(input_size=H, output_size=max(O, 1)).kappa
            if O else 0.0)


MID_MMA_CASES = [  # name, alif, recurrent, surrogate
    ("alif-rec-fs", True, True, FAST), ("alif-rec-phi", True, True, PHI),
    ("lif-ff-fs", False, False, FAST), ("lif-rec-phi", False, True, PHI),
]
# (Hin, H, O): the z-emitting mode at H = 45 and 128, the head at 45 and
# the deep net's 128 -> 96 -> 10.
MID_MMA_SHAPES = {"z": [(45, 45, 0), (128, 128, 0)],
                  "head": [(45, 45, 10), (128, 96, 10)]}


def _assert_same(got, want, what):
    for g, p, n in zip(got, want, what):
        if g is None or p is None:
            assert g is None or n == "tstar", n
            continue
        assert torch.equal(g, p.to(g.dtype)), (
            f"{n}: {int((g.float() != p.float()).sum())} elements differ")


MID_OUTS = ("logits", "z", "res", "a", "tstar", "counts")


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("mode", ["z", "head"])
@pytest.mark.parametrize("name,alif,rec,spike", MID_MMA_CASES,
                         ids=[c[0] for c in MID_MMA_CASES])
def test_mid_mma_body_matches_ordered_versions(card, name, alif, rec, spike,
                                               mode, n_steps, wdtype):
    """``fused_mid_fwd`` on its tensor-core body equals
    ``_mid_fwd_ordered_reference`` bit for bit at B = 37: spikes,
    residuals (v or delta, and a for ALIF with Phi), logits, tstar and
    counts, training and inference (whose outputs equal training's)."""
    head = mode == "head"
    store_a = fused._stores_a(alif, spike)
    res_is_v = not head and fused._residual_is_v(alif, spike)
    for Hin, H, O in MID_MMA_SHAPES[mode]:
        assert fused_mid.mid_bodies(n_steps, Hin, H, O, rec, wdtype.itemsize,
                                    card, True) == ("mma", "mma")
        args = _mid_case(card, n_steps, Hin, H, O, alif, rec, wdtype)
        fused.reset_launch_counts()
        got = fused_mid._mid_cuda(*args, True, store_a, head, res_is_v)
        inf = fused_mid._mid_cuda(*args, False, False, head, False)
        want = fused_mid._mid_fwd_ordered_reference(*args, True, store_a,
                                                    head, res_is_v)
        torch.cuda.synchronize()
        assert _launched() == {fused.KERNEL_MID: 2}
        _assert_same(got, want, MID_OUTS)
        if head:
            assert torch.equal(inf[0], got[0])
            assert torch.equal(inf[5], got[5])
            assert float(got[5].sum()) > 0
        else:
            assert torch.equal(inf[1], got[1])
            assert 0.01 < float(got[1].float().mean()) < 0.6


F2_OUTS = ("logits", "d0", "a0", "d1", "a1", "tstar", "cnt0", "cnt1")


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("name,alif,rec,use_periods,spike", F2_CASES,
                         ids=[c[0] for c in F2_CASES])
def test_fused2_mma_body_matches_ordered_versions(card, name, alif, rec,
                                                  use_periods, spike,
                                                  n_steps, wdtype):
    """``fused2_fwd[_train]`` on its tensor-core body equals
    ``_fused2_fwd_ordered_reference`` bit for bit at B = 37 with H1 = H2 =
    45 and 128 (F = 30 and 784; W1's pieces from L2 in float32 at 128):
    logits, both layers' residuals, tstar and both counts, training and
    inference (whose logits equal training's)."""
    store_a = fused._stores_a(alif, spike)
    for F, H in ((30, 45), (784, 128)):
        assert fused2.fused2_bodies(n_steps, F, H, H, 10, rec,
                                    wdtype.itemsize, device=card,
                                    training=True) == ("mma", "mma")
        args, _ = _f2_args(card, n_steps, alif, rec, use_periods, wdtype,
                           B=37, F=F, H1=H, H2=H)
        fused.reset_launch_counts()
        got = fused2._fused2_cuda(*args, True, store_a, True)
        inf = fused2._fused2_cuda(*args, False, False, False)
        want = fused2._fused2_fwd_ordered_reference(*args, True, store_a,
                                                    True)
        torch.cuda.synchronize()
        assert _launched() == {fused.KERNEL_2: 1, fused.KERNEL_2_TRAIN: 1}
        _assert_same(got, want, F2_OUTS)
        assert torch.equal(inf[0], got[0])
        assert float(got[6].sum()) > 0 and float(got[7].sum()) > 0


def _rel_err(got, want):
    scale = float(want.float().abs().max()) or 1.0
    return float((got.float() - want.float()).abs().max()) / scale


def _held_to_ordered(record_property, label, got, again, want, keep,
                     ordered_keep, gzin, bar):
    """A deep or two-layer backward on its tensor-core chain body against
    its plain version in its order: equal bits on a repeated call; the
    chains' rounded dcur (``keep`` against ``ordered_keep``, by name) and
    every gradient within ``bar`` of max|g|; ``g_z_in`` (``gzin``: the
    kernel's, and the ordered model fed the kernel's own dcur) within
    ``bar``, its share of equal elements recorded."""
    for g, g2 in zip(got, again):
        assert g is None or torch.equal(g, g2), f"{label}: not reproducible"
    for name in ordered_keep:
        err = _rel_err(keep[name], ordered_keep[name])
        assert err <= bar, f"{label} {name}: {err:.3g} of max|dcur|"
    err = _grad_err(got, want)
    assert err <= bar, f"{label}: gradients {err:.3g} of max|g|"
    kernel, model = gzin
    assert kernel.dtype == model.dtype and kernel.shape == model.shape
    err = _rel_err(kernel, model)
    assert err <= bar, f"{label} g_z_in: {err:.3g} of max|g|"
    record_property(f"{label} g_z_in equal",
                    float((kernel == model).float().mean()))


# Every cell, surrogate and type of the mid layer's cases (its input is a
# 0/1 trace: no encoding), both modes, at the tensor-core body's shapes.
MID_BWD_CASES = MID_MMA_CASES + [
    ("alif-ff-phi", True, False, PHI), ("lif-ff-phi", False, False, PHI)]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("mode", ["z", "head"])
@pytest.mark.parametrize("name,alif,rec,spike", MID_BWD_CASES,
                         ids=[c[0] for c in MID_BWD_CASES])
def test_mid_bwd_mma_chain_matches_ordered_versions(
        card, record_property, name, alif, rec, spike, mode, n_steps,
        wdtype):
    """``fused_mid_bwd`` with its chain on the tensor-core body
    (``ZChain`` z-emitting, ``LifChain`` head) and ``g_z_in`` by
    ``gzin_mma`` (the bits of ``fused_mid.gzin`` on the kept dcur), against
    ``_mid_bwd_ordered_reference`` at B = 37: dcur, ``g_z_in`` and the
    gradients within the chain's bars, equal bits twice."""
    head = mode == "head"
    store_a = fused._stores_a(alif, spike)
    res_is_v = not head and fused._residual_is_v(alif, spike)
    bar = _bwd_bar(wdtype, n_steps)
    rng = np.random.default_rng(14)
    for Hin, H, O in MID_MMA_SHAPES[mode]:
        args = _mid_case(card, n_steps, Hin, H, O, alif, rec, wdtype)
        z_in, w_in, w_rec, beta, w_out = args[:5]
        _, z, res, a_tr, tstar, _ = fused_mid._mid_cuda(
            *args, True, store_a, head, res_is_v)
        B = z_in.shape[1]
        cfg = (ALIFConfig if alif else LIFConfig)(input_size=Hin,
                                                  output_size=H)
        g_logits = g_counts = g_z = None
        if head:
            g_logits = torch.from_numpy(rng.standard_normal((B, O)).astype(
                np.float32)).to(card)
            g_counts = torch.from_numpy((0.01 * rng.standard_normal(
                (B, H))).astype(np.float32)).to(card)
        else:
            g_z = torch.from_numpy(rng.standard_normal(tuple(z.shape)).astype(
                np.float32)).to(card).to(wdtype)
        bargs = (g_logits, g_counts, tstar, g_z, z, res, a_tr, res_is_v,
                 z_in, w_in, w_rec, beta, w_out, n_steps, args[8], args[10],
                 cfg.gamma, args[11], spike)
        order = fused_mid.gradient_plan(card, B, Hin, H, O, n_steps, rec,
                                        wdtype == torch.bfloat16)
        assert order["mma"]
        assert fused_mid.mid_bodies(n_steps, Hin, H, O, rec, wdtype.itemsize,
                                    card, True)[1] == "mma"
        keep, okeep = {}, {}
        fused.reset_launch_counts()
        got = fused_mid._mid_bwd_cuda(*bargs, keep=keep)
        again = fused_mid._mid_bwd_cuda(*bargs)
        assert _functions_launched()[fused.KERNEL_GZIN] == 2
        # gzin_mma alone on the kept dcur: the call's g_z_in bit for bit.
        assert torch.equal(got[0], fused_mid.gzin(keep["dcur"], w_in))
        want = fused_mid._mid_bwd_ordered_reference(*bargs, order,
                                                    keep=okeep)
        model = fused._gzin_ordered_reference(keep["dcur"], w_in, wdtype,
                                              card=True).to(wdtype)
        torch.cuda.synchronize()
        _held_to_ordered(record_property, f"{name} {mode} {Hin}-{H}", got,
                         again, want, {"dcur": keep["dcur"].float()}, okeep,
                         (got[0], model), bar)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("name,alif,rec,use_periods,spike", F2_CASES,
                         ids=[c[0] for c in F2_CASES])
def test_fused2_bwd_mma_chains_match_ordered_versions(
        card, record_property, name, alif, rec, use_periods, spike, n_steps,
        wdtype):
    """``fused2_bwd`` with both chains on the tensor-core body and ``dz0 =
    dcur1 @ W1^T`` by ``gzin_mma`` (the bits of ``fused_mid.gzin``), against
    ``_fused2_bwd_ordered_reference`` at B = 37 with H1 = H2 = 45 and 128 (F
    = 30 and 784), both counts' cotangents: both dcur, dz0 and the six
    gradients within the chain's bars, equal bits twice."""
    store_a = alif and spike == PHI
    bar = _bwd_bar(wdtype, n_steps)
    for F, H in ((30, 45), (784, 128)):
        args, gamma = _f2_args(card, n_steps, alif, rec, use_periods, wdtype,
                               B=37, F=F, H1=H, H2=H)
        out = fused2._fused2_cuda(*args, True, store_a, True)
        rng = np.random.default_rng(9)
        g_logits = torch.from_numpy(rng.standard_normal(
            out[0].shape).astype(np.float32)).to(card)
        g_c0, g_c1 = (torch.from_numpy((0.01 * rng.standard_normal(
            c.shape)).astype(np.float32)).to(card) for c in out[6:])
        lat, w0, w0r, b0, w1, w1r, b1, w_out = args[:8]
        bargs = (g_logits, g_c0, g_c1, out[5], out[1], out[2], out[3],
                 out[4], lat, w0, w0r, b0, w1, w1r, b1, w_out, n_steps,
                 use_periods, args[12], args[14], gamma, args[15], spike)
        order = fused2.gradient_plan(card, 37, F, H, H, 10, n_steps, rec,
                                     wdtype == torch.bfloat16, use_periods)
        assert order["mma"]
        keep, okeep = {}, {}
        fused.reset_launch_counts()
        got = fused2._fused2_bwd_cuda(*bargs, keep=keep)
        again = fused2._fused2_bwd_cuda(*bargs)
        assert _functions_launched()[fused.KERNEL_GZIN] == 2
        assert torch.equal(keep["dz0"], fused_mid.gzin(keep["dcur1"], w1,
                                                       torch.float32))
        want = fused2._fused2_bwd_ordered_reference(*bargs, order,
                                                    keep=okeep)
        model = fused._gzin_ordered_reference(keep["dcur1"], w1, wdtype,
                                              card=True)
        torch.cuda.synchronize()
        kept = {k: keep[k].float() for k in ("dcur0", "dcur1")}
        _held_to_ordered(record_property, f"{name} {H}", got, again, want,
                         kept, {k: okeep[k] for k in kept},
                         (keep["dz0"], model), bar)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mid_and_fused2_rows_do_not_depend_on_their_batch(card, wdtype):
    """A row's outputs are the same bits whichever rows share its 16-row
    tile: the batch whole and a shuffled subset of 23 rows, through the mid
    layer's two modes and the two-layer pair (TTFS, where a row firing at
    least F / 16 features at a step takes layer 0's dense product: rows
    firing 0 to 7 of F = 48 features at t = 0)."""
    rng = np.random.default_rng(12)
    idx = torch.from_numpy(rng.permutation(37)[:23]).to(card)
    for O in (0, 10):
        args = _mid_case(card, 24, 45, 45, O, True, True, wdtype)
        whole = fused_mid._mid_cuda(*args, True, True, O > 0, False)
        sub = (args[0][:, idx].contiguous(),) + args[1:]
        part = fused_mid._mid_cuda(*sub, True, True, O > 0, False)
        for w, p, n in zip(whole, part, MID_OUTS):
            if w is None:
                continue
            assert torch.equal(p, w[:, idx] if w.dim() == 3 else w[idx]), n
    args, _ = _f2_args(card, 24, True, True, False, wdtype, B=37, F=48,
                       H1=45, H2=45)
    lat = rng.integers(1, 28, (37, 48)).astype(np.int32)
    for r in range(37):
        lat[r, rng.choice(48, r % 8, replace=False)] = 0
    args = (torch.from_numpy(lat).to(card),) + args[1:]
    whole = fused2._fused2_cuda(*args, True, True, True)
    part = fused2._fused2_cuda(args[0][idx].contiguous(), *args[1:], True,
                               True, True)
    for w, p, n in zip(whole, part, F2_OUTS):
        assert torch.equal(p, w[:, idx] if w.dim() == 3 else w[idx]), n


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mid_and_fused2_per_unit_bodies_take_the_rest(card, wdtype):
    """Shapes past the tensor-core bodies' limits run the per-unit bodies,
    chosen by shape, which explain_dispatch names: the mid layer's head at
    O = 20 (and bf16 at H = 288, both modes), the two-layer pair at O = 20
    (and bf16 at 130 + 160 units, whose chains fit the tensor-core chain
    body while its forward does not); each forward against its order-free
    plain version at the small bars, and each backward (the per-unit
    chains past O = 16 or H = 256) against its order-free plain version at
    the backward's small bars."""
    import snnimageclassification_tpu_torch as pt
    from snnimageclassification_tpu_torch.models import snn as model_lib

    T = 24
    bf16 = wdtype == torch.bfloat16
    bar = _bwd_bar(wdtype, T)
    rng = np.random.default_rng(15)
    gamma = ALIFConfig(input_size=1, output_size=1).gamma
    mids = ((45, 45, 20),) + (((64, 288, 10), (64, 288, 0)) if bf16 else ())
    for Hin, H, O in mids:
        head = O > 0
        assert fused_mid.mid_bodies(T, Hin, H, O, True, wdtype.itemsize,
                                    card, True) == ("per-unit", "per-unit")
        args = _mid_case(card, T, Hin, H, O, True, True, wdtype)
        got = fused_mid._mid_cuda(*args, True, False, head, False)
        want = fused_mid._mid_reference(*args, True, False, head, False)
        if head:
            torch.testing.assert_close(got[0], want[0], atol=1e-5,
                                       rtol=1e-5)
            assert torch.equal(got[4], want[4])
            assert torch.equal(got[5], want[5])
        else:
            assert torch.equal(got[1], want[1])
        B = args[0].shape[1]
        g_logits = (torch.from_numpy(rng.standard_normal((B, O)).astype(
            np.float32)).to(card) if head else None)
        g_z = (None if head else torch.from_numpy(rng.standard_normal(
            tuple(got[1].shape)).astype(np.float32)).to(card).to(wdtype))
        bargs = (g_logits, None, got[4], g_z, got[1], got[2], None, False,
                 *args[:5], T, args[8], args[10], gamma, args[11], FAST)
        err = _grad_err(fused_mid._mid_bwd_cuda(*bargs),
                        fused_mid._mid_bwd_reference(*bargs))
        assert err <= bar, f"mid {Hin}-{H}-{O} backward: {err:.3g}"
    for H1, H2, O, chain in ((45, 45, 20, "per-unit"),) + (
            ((130, 160, 10, "mma"),) if bf16 else ()):
        assert fused2.fused2_bodies(T, 30, H1, H2, O, True, wdtype.itemsize,
                                    device=card, training=True,
                                    use_periods=False) == ("per-unit", chain)
        args, gamma = _f2_args(card, T, True, True, False, wdtype, B=21,
                               H1=H1, H2=H2, O=O)
        got = fused2._fused2_cuda(*args, True, False, True)
        want = fused2._fused2_reference(*args, True, False, True)
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5)
        assert torch.equal(got[5], want[5])
        assert torch.equal(got[6], want[6]) and torch.equal(got[7], want[7])
        g_logits = torch.from_numpy(rng.standard_normal(got[0].shape).astype(
            np.float32)).to(card)
        bargs = (g_logits, None, None, got[5], got[1], got[2], got[3],
                 got[4], *args[:8], T, False, args[12], args[14], gamma,
                 args[15], FAST)
        err = _grad_err(fused2._fused2_bwd_cuda(*bargs),
                        fused2._fused2_bwd_reference(*bargs))
        assert err <= bar, f"fused2 {H1}-{H2}-{O} backward: {err:.3g}"
    enc = pt.EncodeConfig(n_steps=100)
    md = "float32" if wdtype == torch.float32 else "bfloat16"
    for hidden, out, mma in (([128, 128, 96], 10, True),
                             ([128, 128], 10, True),
                             ([128, 128, 96], 20, False),
                             ([128, 128], 20, False)):
        cfg = pt.SNNConfig(input_size=784, output_size=out,
                           n_hidden_neurons=hidden,
                           hidden_layer_type=pt.LayerType.ALIF,
                           use_recurrent_connection=True, int_time_steps=100,
                           matmul_dtype=md)
        for training in (False, True):
            entries = model_lib.explain_dispatch(cfg, enc, device="cuda",
                                                 training=training)
            last = entries[-1]
            assert ("(mma) in the forward" in last["reason"]) == mma, last
            assert last["path"].endswith("[per-unit]") != mma, last
            chain = ("the tensor-core body (mma) in the backward's chain"
                     if mma else "in the backward's chain")
            assert (chain in last["reason"]) == training, last
            assert ("by gzin_mma on tensor cores" in last["reason"]) \
                == training, last


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [False, True], ids=["logits", "counts"])
def test_fused2_autograd_runs_the_kernel_pair(card, counts):
    """The public wrappers under autograd launch one training forward and
    one backward and agree with the plain versions' gradients; the betas
    get zero; without a gradient the inference kernel runs."""
    args, gamma = _f2_args(card, 24, True, True, False, torch.float32, B=16)
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16, 10)).astype(np.float32)).to(card)

    def grads(plain):
        a = list(args)
        idx = (1, 2, 4, 5, 7, 8)
        for i in idx:
            a[i] = a[i].clone().requires_grad_(True)
        a[3] = torch.tensor(1.6, device=card, requires_grad=True)
        a[6] = torch.tensor(1.2, device=card, requires_grad=True)
        name = ("fused2_rec_head" + ("_counts" if counts else "")
                + ("_reference" if plain else ""))
        out = getattr(fused2, name)(*a[:15], gamma, a[15])
        loss = ((out[0] * r).sum() + 1e-3 * (out[1][0] ** 2).sum()
                + 1e-3 * (out[1][1] ** 2).sum()) if counts else (out * r).sum()
        loss.backward()
        assert float(a[3].grad) == 0.0 and float(a[6].grad) == 0.0
        return [a[i].grad for i in idx]

    fused.reset_launch_counts()
    got = grads(False)
    assert _launched() == {fused.KERNEL_2_TRAIN: 1, fused.KERNEL_2_BWD: 1}
    for g, p in zip(got, grads(True)):
        scale = float(p.abs().max()) or 1.0
        assert float((g - p).abs().max()) / scale <= 2e-6
    with torch.no_grad():
        fused2.fused2_rec_head(*args[:15], gamma, args[15])
    assert fused.launch_counts()[fused.KERNEL_2] == 1


@pytest.mark.cuda
def test_fused2_model_dispatch_and_gate(card):
    """784-ALIF128-ALIF128-10 on the card: ``explain_dispatch`` names the
    pair, inference launches ``fused2_fwd`` once and no layer-0 or mid
    kernel, a training step (with a count regularizer too) the training pair
    once; the gate takes the shape, f32 and bf16."""
    import snnimageclassification_tpu_torch as tst
    from snnimageclassification_tpu_torch.models import snn as tsnn
    from snnimageclassification_tpu_torch.train import (
        L2SpikesPerNeuron,
        Trainer,
    )

    assert fused2.fused2_head_supported(100, 784, 128, 128, 10, True, 4,
                                        device=card, training=True)
    assert fused2.fused2_head_supported(100, 784, 128, 128, 10, True, 2,
                                        device=card, training=True)
    assert not fused2.fused2_head_supported(100, 784, 512, 512, 10,
                                            device=card)  # 2 MB of weights
    enc = tst.EncodeConfig(n_steps=24)
    cfg = tst.SNNConfig(input_size=784, output_size=10,
                        n_hidden_neurons=[128, 128], hidden_layer_type="ALIF",
                        learn_beta=True, int_time_steps=24)
    assert [r["path"] for r in tsnn.explain_dispatch(cfg, enc)] == [
        f"cuda:{fused.KERNEL_2}"]
    assert [r["path"] for r in tsnn.explain_dispatch(cfg, enc,
                                                     training=True)] == [
        f"cuda:{fused.KERNEL_2_TRAIN}+{fused.KERNEL_2_BWD}"]
    x = torch.rand((64, 784), device=card)
    y = torch.randint(0, 10, (64,), device=card)
    for reg in (None, L2SpikesPerNeuron(scale=1e-9)):
        trainer = Trainer(cfg, seed=0, encode_config=enc, reg_fn=reg,
                          device="cuda")
        fused.reset_launch_counts()
        with torch.no_grad():
            logits = tsnn.forward_logits_pixels(cfg, trainer.params, x, enc)
        assert _launched() == {fused.KERNEL_2: 1}
        assert bool(torch.isfinite(logits).all())
        fused.reset_launch_counts()
        loss = trainer.train_step(x, y)
        assert _launched() == {fused.KERNEL_2_TRAIN: 1,
                               fused.KERNEL_2_BWD: 1}
        assert np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# The unfused tier: encoded input product and recurrent scan (wide layers)
# ---------------------------------------------------------------------------
# B, F, H: no B a multiple of the backward's row batch (4); H a multiple of
# the 32-column chunk and not (40, 1000); H = 45, not a multiple of 4, takes
# the backward's copy by the threads instead of TMA.
ENC_SHAPES = [(9, 30, 40), (5, 784, 512), (3, 784, 1024), (13, 784, 1000),
              (6, 30, 45)]
ENC_STEPS = [1, 2, 23, 24, 100]


def _latencies(dev, rng, B, F, T):
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(dev)
    return pixels_to_firing_periods(pixels, t_max=float(T),
                                    tau=20.0).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", ENC_STEPS)
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("shape", ENC_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_encode_kernels_match_plain_versions(card, shape, use_periods,
                                             n_steps, wdtype):
    """``encode_matmul_fwd``: currents within 1e-5 of max|current| (up to
    F terms of either sign in another order: the error scales with their
    absolute sum) and bit for bit the plain forward in the kernel's order
    (``_fwd_ordered_reference``); ``encode_matmul_bwd``: g_W within 2e-6
    of max|g| (5e-6 at T = 100; bf16 one rounding), equal bits twice; each
    launched once through the public function under autograd."""
    from snnimageclassification_tpu_torch.ops import encode

    B, F, H = shape
    rng = np.random.default_rng(7)
    lat = _latencies(card, rng, B, F, n_steps)
    w = torch.from_numpy((0.5 * rng.standard_normal((F, H)))
                         .astype(np.float32)).to(card).to(wdtype)
    fused.reset_launch_counts()
    got = encode._fwd_cuda(lat, w, n_steps, use_periods)
    want = encode._fwd_reference(lat, w, n_steps, use_periods)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(got, encode._fwd_ordered_reference(lat, w, n_steps,
                                                          use_periods))
    g = torch.from_numpy(rng.standard_normal((n_steps, B, H))
                         .astype(np.float32)).to(card)
    _grads_close(
        [encode._bwd_cuda(lat, g, wdtype, n_steps, use_periods)],
        [encode._bwd_cuda(lat, g, wdtype, n_steps, use_periods)],
        [encode._bwd_reference(lat, g, wdtype, n_steps, use_periods)],
        _izh_bar(n_steps, wdtype))
    wl = w.clone().requires_grad_(True)
    fused.reset_launch_counts()
    out = encode.encoded_input_matmul(lat, wl, n_steps, use_periods)
    (out * g).sum().backward()
    assert _launched() == {fused.KERNEL_ENC: 1, fused.KERNEL_ENC_BWD: 1}
    assert wl.grad.dtype == wdtype


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [1, 2, 23, 100])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_encode_kernels_edge_latencies(card, use_periods, n_steps, wdtype):
    """Latencies drawn from [-2, T + 2) (below 0: periodic period 1, TTFS
    never; T and above: TTFS never, periodic period T - 1), and the
    production latencies of quirk Q2 (0 or t_max) with rows where every
    pixel is below threshold: the forward bit for bit its ordered plain
    version, both kernels within the bars of
    ``test_encode_kernels_match_plain_versions``."""
    from snnimageclassification_tpu_torch.ops import encode

    B, F, H = 37, 784, 512
    rng = np.random.default_rng(n_steps)
    drawn = torch.from_numpy(rng.integers(-2, n_steps + 2, size=(B, F))
                             .astype(np.int32)).to(card)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32))
    pixels[[3, 20, 36]] *= 0.19
    q2 = pixels_to_firing_periods(pixels.to(card),
                                  t_max=float(n_steps)).contiguous()
    assert set(torch.unique(q2).tolist()) <= {0, n_steps}
    w = torch.from_numpy((0.05 * rng.standard_normal((F, H)))
                         .astype(np.float32)).to(card).to(wdtype)
    g = torch.from_numpy(rng.standard_normal((n_steps, B, H))
                         .astype(np.float32)).to(card)
    for lat in (drawn, q2):
        got = encode._fwd_cuda(lat, w, n_steps, use_periods)
        want = encode._fwd_reference(lat, w, n_steps, use_periods)
        assert torch.equal(got, encode._fwd_ordered_reference(
            lat, w, n_steps, use_periods))
        assert float((got - want).abs().max()) <= \
            1e-5 * max(float(want.abs().max()), 1.0)
        _grads_close(
            [encode._bwd_cuda(lat, g, wdtype, n_steps, use_periods)],
            [encode._bwd_cuda(lat, g, wdtype, n_steps, use_periods)],
            [encode._bwd_reference(lat, g, wdtype, n_steps, use_periods)],
            _izh_bar(n_steps, wdtype))
    if not use_periods:
        assert not bool(got[:, [3, 20, 36]].any())


@pytest.mark.cuda
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_encode_backward_of_an_empty_batch(card, use_periods):
    """B = 0: g_W is zeros of W's shape and dtype, one launch."""
    from snnimageclassification_tpu_torch.ops import encode

    lat = torch.zeros((0, 784), dtype=torch.int32, device=card)
    g = torch.zeros((100, 0, 512), device=card)
    fused.reset_launch_counts()
    for wdtype in (torch.float32, torch.bfloat16):
        g_w = encode._bwd_cuda(lat, g, wdtype, 100, use_periods)
        assert g_w.shape == (784, 512) and g_w.dtype == wdtype
        assert not bool(g_w.any())
    assert _launched() == {fused.KERNEL_ENC_BWD: 2}


def _rec_inputs(dev, rng, B, H, T, wdtype):
    """Currents 0.3 + 0.6 N(0, 1) and a masked W_rec of std 1.3 / sqrt(H):
    10-20 % of unit-steps fire, a tenth of them pushed by the recurrence."""
    cur = torch.from_numpy((0.3 + 0.6 * rng.standard_normal((T, B, H)))
                           .astype(np.float32)).to(dev)
    w = torch.from_numpy((1.3 / np.sqrt(H) * rng.standard_normal((H, H)))
                         .astype(np.float32)).to(dev)
    return cur, (w * (1 - torch.eye(H, device=dev))).to(wdtype)


REC_CASES = [  # name, alif, surrogate
    ("alif-fs", True, FAST), ("alif-phi", True, PHI),
    ("lif-fs", False, FAST), ("lif-phi", False, PHI),
]


def _rec_scalars(alif):
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=1, output_size=1)
    return cfg.alpha, (cfg.rho if alif else 0.0), cfg.threshold, cfg.gamma


def _rec_bwd_ordered(bw, chain=None):
    """The backward's plain version in a chain body's order: g_i from
    ``chain`` (the cluster body's ``_chain_ordered_reference`` by default)
    and g_W_rec = sum_t z(t-1)^T round(g_i(t)) (float32, cast to W's
    type), as ``_bwd_reference`` forms it."""
    from snnimageclassification_tpu_torch.ops import rec_scan

    g_z, z, _, _, _, w_rec = bw[:6]
    g_i = (chain or rec_scan._chain_ordered_reference)(*bw)
    z_prev = torch.cat([torch.zeros_like(z[:1]), z[:-1]]).float()
    d = g_i.to(w_rec.dtype).float()
    g_w = torch.einsum("tbj,tbh->jh", z_prev, d)
    return g_i, g_w.to(w_rec.dtype)


def _rec_check(dev, B, H, T, alif, spike, wdtype, min_rows):
    """The forward kernels against the plain version fed the same currents
    (share of rows with equal spikes at least ``min_rows``; residuals 1e-5,
    bf16 one rounding, on those rows) and the backward on the training
    kernel's residuals (2e-6 of max|g|, 5e-6 at T = 100, bf16 2**-7; equal
    bits twice).  Where the chain runs the cluster body (bf16: k16-sliced
    sums on tensor cores) the backward is held at that bar against the
    order-free plain version and against the plain version in that order
    (``_rec_bwd_ordered``); where it runs the CUDA-core body (every float32
    chain) against the plain version in that body's order
    (``_rec_chain_ordered_reference``) at the same bar, and its g_i against
    a float64 chain at most twice as far as the order-free plain
    version's (``_within_float64_chain``)."""
    from snnimageclassification_tpu_torch.ops import rec_scan

    rng = np.random.default_rng(13)
    cur, w = _rec_inputs(dev, rng, B, H, T, wdtype)
    alpha, rho, thr, gamma = _rec_scalars(alif)
    beta = 1.6 if alif else 0.0
    store_a = fused._stores_a(alif, spike)
    res_is_v = fused._residual_is_v(alif, spike)
    fwd = (cur, w, beta, alif, alpha, rho, thr)
    z, res, a_tr = rec_scan._fwd_cuda(*fwd, True, store_a, res_is_v)
    z_inf = rec_scan._fwd_cuda(*fwd, False, False, False)[0]
    zp, resp, ap = rec_scan._fwd_reference(*fwd, True, store_a, res_is_v)
    torch.cuda.synchronize()
    assert torch.equal(z, z_inf), "inference and training spikes differ"
    assert z.dtype == wdtype and res.dtype == wdtype
    assert 0.02 < float(z.float().mean()) < 0.6
    same = (z == zp).all(dim=2).all(dim=0)
    assert float(same.float().mean()) >= min_rows
    tol = 1e-5 if wdtype == torch.float32 else 2.0 ** -7
    for got, want in ((res, resp), (a_tr, ap)):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got[:, same].float(),
                                       want[:, same].float(), atol=tol,
                                       rtol=tol)
    g_z = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(dev).to(wdtype)
    bw = (g_z, z, res, a_tr, res_is_v, w, beta, alpha, thr, gamma, spike)
    got, again = rec_scan._bwd_cuda(*bw), rec_scan._bwd_cuda(*bw)
    bar = _izh_bar(T, wdtype)
    if rec_scan.rec_bodies(T, H, itemsize=wdtype.itemsize)[1] == "mma":
        _grads_close(got, again, rec_scan._bwd_reference(*bw), bar)
        _grads_close(got, again, _rec_bwd_ordered(bw), bar)
        return
    # The CUDA-core chain (every float32 chain): held at the same bar
    # against the plain version in its own order, and against a float64
    # chain no further than twice the order-free plain version.
    _grads_close(got, again, _rec_bwd_ordered(
        bw, rec_scan._rec_chain_ordered_reference), bar)
    _within_float64_chain(got[0], rec_scan._bwd_reference(*bw)[0], bw)


def _within_float64_chain(g_i, plain, bw):
    """The kernel's g_i against the chain in float64 (``tools/
    chain_conditioning.py:chain``) is at most twice as far, as a share of
    max|g|, as the order-free plain version's."""
    from snnimageclassification_tpu_torch.tools.chain_conditioning import (
        chain,
        share,
    )

    w64 = bw[5].double()
    exact = chain(bw, lambda d: d @ w64.T, torch.float64)
    err, plain_err = share(g_i, exact), share(plain, exact)
    assert err <= 2 * plain_err, (
        f"{err:.3g} of max|g| from the float64 chain, the plain version "
        f"{plain_err:.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("name,alif,spike", REC_CASES,
                         ids=[c[0] for c in REC_CASES])
def test_rec_scan_kernels_match_plain_versions(card, name, alif, spike,
                                               n_steps, wdtype):
    """Small shapes (B = 37, H = 20 and 40): spikes equal on every row."""
    for H in (20, 40):
        _rec_check(card, 37, H, n_steps, alif, spike, wdtype, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H", [(64, 512), (16, 1024), (40, 200)],
                         ids=["512", "1024", "200"])
def test_rec_scan_kernels_wide(card, B, H, wdtype):
    """Widths past one block's shared memory (W_rec streamed in chunks;
    H = 200 f32 stays resident), ALIF with FastSigmoid, T = 100: equal
    spikes on at least 95 % of rows (a near-tie flip between two float32
    summation orders takes its row's trace with it)."""
    _rec_check(card, B, H, 100, True, FAST, wdtype, 0.95)


REC_MMA_WIDTHS = [20, 40, 200, 300, 512, 1024]


def _rec_mma_run(dev, B, H, T, alif, spike, wdtype, seed=13, rows=None):
    """Both kernels on one input set: (forward arguments, the training
    forward's outputs, the inference spikes, the backward's arguments, its
    g_i); ``rows`` takes those batch rows of the inputs."""
    from snnimageclassification_tpu_torch.ops import rec_scan

    rng = np.random.default_rng(seed)
    cur, w = _rec_inputs(dev, rng, B, H, T, wdtype)
    g_z = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(dev).to(wdtype)
    if rows is not None:
        cur, g_z = cur[:, rows].contiguous(), g_z[:, rows].contiguous()
    alpha, rho, thr, gamma = _rec_scalars(alif)
    beta = 1.6 if alif else 0.0
    store_a = fused._stores_a(alif, spike)
    res_is_v = fused._residual_is_v(alif, spike)
    fwd = (cur, w, beta, alif, alpha, rho, thr)
    outs = rec_scan._fwd_cuda(*fwd, True, store_a, res_is_v)
    z_inf = rec_scan._fwd_cuda(*fwd, False, False, False)[0]
    bw = (g_z, outs[0], outs[1], outs[2], res_is_v, w, beta, alpha, thr,
          gamma, spike)
    return fwd, outs, z_inf, bw, rec_scan._bwd_cuda(*bw)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H", REC_MMA_WIDTHS)
@pytest.mark.parametrize("name,alif,spike", REC_CASES,
                         ids=[c[0] for c in REC_CASES])
def test_rec_mma_body_matches_ordered_versions(card, name, alif, spike, H,
                                               wdtype):
    """The recurrent scan's tensor-core cluster body (``csrc/rec_mma.cuh``)
    at widths that are no multiple of its slices, B = 37 (no multiple of its
    rows), T = 100: the training forward's spikes and residuals bit for bit
    ``_fwd_ordered_reference`` (its summation order), inference spikes the
    training kernel's; the bf16 chain's g_i within 2**-7 of max|g| of
    ``_chain_ordered_reference`` on the same residuals, equal bits twice.
    The float32 chain runs the CUDA-core body (held by ``_rec_check``);
    float32 at H = 1024 (the pieces past a cluster's shared memory) runs
    the CUDA-core body both ways."""
    from snnimageclassification_tpu_torch.ops import rec_scan

    bodies = rec_scan.rec_bodies(100, H, itemsize=wdtype.itemsize)
    if H == 1024 and wdtype == torch.float32:
        assert bodies == ("cuda-core", "cuda-core")
        return
    f32 = wdtype == torch.float32
    assert bodies == ("mma", "cuda-core" if f32 else "mma")
    fwd, outs, z_inf, bw, g_i = _rec_mma_run(card, 37, H, 100, alif, spike,
                                             wdtype)
    want = rec_scan._fwd_ordered_reference(
        *fwd, True, outs[2] is not None, bw[4])
    for got, ref in zip(outs, want):
        assert (got is None) == (ref is None)
        if got is not None:
            assert torch.equal(got, ref)
    assert torch.equal(z_inf, outs[0])
    assert 0.02 < float(outs[0].float().mean()) < 0.6
    if not f32:
        _grads_close((g_i,), (rec_scan._bwd_cuda(*bw)[0],),
                     (rec_scan._chain_ordered_reference(*bw),),
                     _izh_bar(100, wdtype))


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("H", [40, 512])
def test_rec_mma_rows_do_not_depend_on_their_batch(card, H, wdtype):
    """Rows 5 .. 20 of a 37-row batch give the same spikes, residuals and
    g_i bit for bit when run as a batch of their own (other clusters,
    another plan): every unit sums its H inputs in one order."""
    rows = torch.arange(5, 21, device=card)
    _, outs, _, _, g_i = _rec_mma_run(card, 37, H, 100, True, FAST, wdtype)
    _, sub, _, _, g_sub = _rec_mma_run(card, 37, H, 100, True, FAST, wdtype,
                                       rows=rows)
    assert torch.equal(outs[0][:, rows], sub[0])
    assert torch.equal(outs[1][:, rows], sub[1])
    assert torch.equal(g_i[:, rows], g_sub)


@pytest.mark.cuda
def test_rec_scan_autograd_launches_the_pair(card):
    """Under autograd ``rec_alif_scan`` launches the training forward and
    the backward once each (beta's gradient is zero); under ``no_grad`` the
    inference kernel once."""
    from snnimageclassification_tpu_torch.ops import rec_scan

    rng = np.random.default_rng(2)
    cur, w = _rec_inputs(card, rng, 8, 64, 24, torch.float32)
    beta = torch.tensor(1.6, device=card, requires_grad=True)
    cur.requires_grad_(True)
    w.requires_grad_(True)
    fused.reset_launch_counts()
    z = rec_scan.rec_alif_scan(cur, w, beta, 0.9, 0.95, 1.0, 10.0)
    z.float().sum().backward()
    assert _launched() == {fused.KERNEL_REC_TRAIN: 1,
                           fused.KERNEL_REC_BWD: 1}
    assert float(beta.grad) == 0.0 and cur.grad.dtype == torch.float32
    fused.reset_launch_counts()
    with torch.no_grad():
        rec_scan.rec_lif_scan(cur, w, 0.9, 1.0, 10.0)
    assert _launched() == {fused.KERNEL_REC: 1}


def _wide_cfg(T=24, matmul_dtype="float32", widths=512):
    import snnimageclassification_tpu_torch as tst

    return tst.SNNConfig(input_size=784, output_size=10,
                         n_hidden_neurons=widths, hidden_layer_type="ALIF",
                         learn_beta=True, int_time_steps=T,
                         matmul_dtype=matmul_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_wide_model_dispatch_and_launches(card, matmul_dtype):
    """784-ALIF512-10: no fused gate takes it; ``explain_dispatch`` names
    the encode and scan kernels; inference launches each forward once, a
    training step each of the four once, and the step's gradients agree
    with the per-step loop's (``use_kernels=False``) within 1e-4 of
    max|g| (bf16 2**-6)."""
    import dataclasses

    import snnimageclassification_tpu_torch as tst
    from snnimageclassification_tpu_torch.models import snn as tsnn
    from snnimageclassification_tpu_torch.train import Trainer

    cfg = _wide_cfg(matmul_dtype=matmul_dtype)
    enc = tst.EncodeConfig(n_steps=24)
    assert [r["path"] for r in tsnn.explain_dispatch(cfg, enc)] == [
        f"cuda:{fused.KERNEL_ENC}", f"cuda:{fused.KERNEL_REC}", "torch:loop"]
    assert [r["path"] for r in tsnn.explain_dispatch(cfg, enc,
                                                     training=True)] == [
        f"cuda:{fused.KERNEL_ENC}+{fused.KERNEL_ENC_BWD}",
        f"cuda:{fused.KERNEL_REC_TRAIN}+{fused.KERNEL_REC_BWD}", "torch:loop"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((32, 784), dtype=np.float32)).to(card)
    y = torch.from_numpy(rng.integers(0, 10, 32)).to(card)
    trainer = Trainer(cfg, seed=0, encode_config=enc, device="cuda")
    fused.reset_launch_counts()
    with torch.no_grad():
        logits = tsnn.forward_logits_pixels(cfg, trainer.params, x, enc)
    assert _launched() == {fused.KERNEL_ENC: 1, fused.KERNEL_REC: 1}
    assert bool(torch.isfinite(logits).all())
    fused.reset_launch_counts()
    _, grads = trainer.loss_and_grads(x, y)
    assert _launched() == {fused.KERNEL_ENC: 1, fused.KERNEL_REC_TRAIN: 1,
                           fused.KERNEL_REC_BWD: 1, fused.KERNEL_ENC_BWD: 1}
    loop = Trainer(dataclasses.replace(cfg, use_kernels=False),
                   params=trainer.params, encode_config=enc, device="cuda")
    _, want = loop.loss_and_grads(x, y)
    bar = 1e-4 if matmul_dtype == "float32" else 2.0 ** -6
    for n in want:
        for k, g in want[n].items():
            scale = float(g.abs().max()) or 1.0
            err = float((grads[n][k] - g).abs().max()) / scale
            assert err <= bar, f"{n}.{k}: {err:.3g} of max|g|"


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["flagship", "wide"])
def test_server_launches_only_inference_kernels(card, wide):
    """A server built from ``Trainer.params`` serves its own copy under
    inference mode: each batch launches the inference kernels once
    (``fused_head_fwd``; wide: ``encode_matmul_fwd`` + ``rec_scan_fwd``)
    and no training kernel, and a later ``train_step`` does not move the
    served logits."""
    import snnimageclassification_tpu_torch as tst
    from snnimageclassification_tpu_torch.train import Trainer

    cfg = (_wide_cfg() if wide else tst.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=128,
        hidden_layer_type="ALIF", learn_beta=True, int_time_steps=24))
    enc = tst.EncodeConfig(n_steps=24)
    trainer = Trainer(cfg, seed=0, encode_config=enc, device="cuda")
    rng = np.random.default_rng(5)
    x = rng.random((64, 784), dtype=np.float32)
    y = rng.integers(0, 10, 64)
    with tst.InferenceServer(cfg, trainer.params, batch_size=64,
                             encode_config=enc, device="cuda") as srv:
        fused.reset_launch_counts()
        before = srv.submit(x).result(timeout=120)
        want = ({fused.KERNEL_ENC: 1, fused.KERNEL_REC: 1} if wide
                else {fused.KERNEL: 1})
        assert _launched() == want
        trainer.train_step(x, y)
        torch.cuda.synchronize()
        after = srv.submit(x).result(timeout=120)
    assert np.array_equal(before, after)


# ---------------------------------------------------------------------------
# The feedforward scan (scan_fwd[_train], scan_bwd) and its models
# ---------------------------------------------------------------------------
def _scan_check(dev, B, H, T, alif, spike, wdtype, min_rows, beta_tensor):
    """The forward kernels against the plain version fed the same currents
    (0.3 + 0.6 N(0, 1); the share of rows with equal spikes at least
    ``min_rows``; residuals 1e-5, bf16 one rounding) and the backward on
    the training kernel's residuals (the same elementwise chain: 2e-6 of
    max|g| at any T, bf16 2**-7; equal bits twice).  ``beta_tensor``: beta
    as a device tensor."""
    from snnimageclassification_tpu_torch.ops import scan

    rng = np.random.default_rng(17)
    cur = torch.from_numpy((0.3 + 0.6 * rng.standard_normal((T, B, H)))
                           .astype(np.float32)).to(dev)
    alpha, rho, thr, gamma = _rec_scalars(alif)
    beta = 1.6 if alif else 0.0
    if beta_tensor:
        beta = torch.tensor(beta, device=dev)
    store_a = fused._stores_a(alif, spike)
    res_is_v = fused._residual_is_v(alif, spike)
    fwd = (cur, beta, alif, alpha, rho, thr)
    z, res, a_tr = scan._fwd_cuda(*fwd, True, store_a, res_is_v, wdtype)
    z_inf = scan._fwd_cuda(*fwd, False, False, False, wdtype)[0]
    zp, resp, ap = scan._fwd_reference(*fwd, True, store_a, res_is_v, wdtype)
    torch.cuda.synchronize()
    assert torch.equal(z, z_inf), "inference and training spikes differ"
    assert z.dtype == wdtype and res.dtype == wdtype
    assert 0.02 < float(z.float().mean()) < 0.6
    same = (z == zp).all(dim=2).all(dim=0)
    assert float(same.float().mean()) >= min_rows
    tol = 1e-5 if wdtype == torch.float32 else 2.0 ** -7
    for got, want in ((res, resp), (a_tr, ap)):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got[:, same].float(),
                                       want[:, same].float(), atol=tol,
                                       rtol=tol)
    g_z = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(dev).to(wdtype)
    bw = (g_z, z, res, a_tr, res_is_v, beta, alpha, thr, gamma, spike)
    _grads_close((scan._bwd_cuda(*bw),), (scan._bwd_cuda(*bw),),
                 (scan._bwd_reference(*bw),),
                 2e-6 if wdtype == torch.float32 else 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [23, 24, 100])
@pytest.mark.parametrize("name,alif,spike", REC_CASES,
                         ids=[c[0] for c in REC_CASES])
def test_scan_kernels_match_plain_versions(card, name, alif, spike, n_steps,
                                           wdtype):
    """Small shapes (B = 37, H = 19 and 45; beta a float, then a device
    tensor): spikes equal on every row."""
    for H, beta_tensor in ((19, False), (45, True)):
        _scan_check(card, 37, H, n_steps, alif, spike, wdtype, 1.0,
                    beta_tensor)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,alif,spike,H", [
    ("alif-fs-256", True, FAST, 256), ("lif-fs-128", False, FAST, 128)],
    ids=["ff-a", "ff-l"])
def test_scan_kernels_at_full_batch(card, name, alif, spike, H, wdtype):
    """B = 8192, T = 100 at the widths of 784-ALIF256-10 and 784-LIF128-10:
    spikes equal on at least 99.5 % of rows."""
    _scan_check(card, 8192, H, 100, alif, spike, wdtype, 0.995, False)


@pytest.mark.cuda
def test_scan_autograd_launches_the_pair(card):
    """Under autograd ``alif_scan`` launches the training forward and the
    backward once each (beta's gradient is zero); under ``no_grad`` the
    inference kernel once."""
    from snnimageclassification_tpu_torch.ops import scan

    rng = np.random.default_rng(3)
    cur = torch.from_numpy((0.3 + 0.6 * rng.standard_normal((24, 8, 64)))
                           .astype(np.float32)).to(card).requires_grad_(True)
    beta = torch.tensor(1.6, device=card, requires_grad=True)
    fused.reset_launch_counts()
    z = scan.alif_scan(cur, beta, 0.9, 0.95, 1.0, 10.0,
                       trace_dtype="bfloat16")
    z.float().sum().backward()
    assert _launched() == {fused.KERNEL_SCAN_TRAIN: 1,
                           fused.KERNEL_SCAN_BWD: 1}
    assert z.dtype == torch.bfloat16
    assert float(beta.grad) == 0.0 and cur.grad.dtype == torch.float32
    fused.reset_launch_counts()
    with torch.no_grad():
        scan.lif_scan(cur, 0.9, 1.0, 10.0)
    assert _launched() == {fused.KERNEL_SCAN: 1}


def _ff_cfg(net, matmul_dtype="float32", use_kernels=True):
    """784-ALIF256-10 (``ff-a``) or 784-LIF128-10 (``ff-l``), feedforward,
    T = 24."""
    import snnimageclassification_tpu_torch as tst

    return tst.SNNConfig(
        input_size=784, output_size=10,
        n_hidden_neurons=256 if net == "ff-a" else 128,
        hidden_layer_type="ALIF" if net == "ff-a" else "LIF",
        use_recurrent_connection=False, int_time_steps=24,
        matmul_dtype=matmul_dtype, use_kernels=use_kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", ["ff-a", "ff-l"])
def test_ff_model_serve_and_train_launch_the_scan(card, net, matmul_dtype):
    """Constant-pixel input (``as_timeseries=False``): ``explain_dispatch``
    names the scan kernels; a served batch launches ``scan_fwd`` once and
    its results equal a direct forward bit for bit; a training step
    launches ``scan_fwd_train`` and ``scan_bwd`` once each, with gradients
    within 1e-4 of max|g| of the per-step loop's (bf16 2**-6); a raster
    through ``forward_logits`` launches ``scan_fwd`` once."""
    import snnimageclassification_tpu_torch as tst
    from snnimageclassification_tpu_torch.models import snn as tsnn
    from snnimageclassification_tpu_torch.train import Trainer

    cfg = _ff_cfg(net, matmul_dtype)
    enc = tst.EncodeConfig(n_steps=24, as_timeseries=False)
    assert [r["path"] for r in tsnn.explain_dispatch(cfg, enc)] == [
        f"cuda:{fused.KERNEL_SCAN}", "torch:loop"]
    assert [r["path"] for r in tsnn.explain_dispatch(cfg, enc,
                                                     training=True)] == [
        f"cuda:{fused.KERNEL_SCAN_TRAIN}+{fused.KERNEL_SCAN_BWD}",
        "torch:loop"]
    rng = np.random.default_rng(6)
    x = rng.random((64, 784), dtype=np.float32)
    y = rng.integers(0, 10, 64)
    trainer = Trainer(cfg, seed=0, encode_config=enc, device="cuda")
    with tst.InferenceServer(cfg, trainer.params, batch_size=64,
                             encode_config=enc, device="cuda") as srv:
        fused.reset_launch_counts()
        served = srv.submit(x).result(timeout=120)
        assert _launched() == {fused.KERNEL_SCAN: 1}
    with torch.no_grad():
        direct = tsnn.forward_logits_pixels(cfg, trainer.params,
                                            torch.from_numpy(x).to(card),
                                            enc).cpu().numpy()
    assert np.array_equal(served, direct)
    fused.reset_launch_counts()
    _, grads = trainer.loss_and_grads(x, y)
    assert _launched() == {fused.KERNEL_SCAN_TRAIN: 1,
                           fused.KERNEL_SCAN_BWD: 1}
    loop = Trainer(_ff_cfg(net, matmul_dtype, use_kernels=False),
                   params=trainer.params, encode_config=enc, device="cuda")
    _, want = loop.loss_and_grads(x, y)
    bar = 1e-4 if matmul_dtype == "float32" else 2.0 ** -6
    for n in want:
        for k, g in want[n].items():
            scale = float(g.abs().max()) or 1.0
            err = float((grads[n][k] - g).abs().max()) / scale
            assert err <= bar, f"{n}.{k}: {err:.3g} of max|g|"
    raster = torch.from_numpy(
        (rng.random((16, 24, 784)) < 0.05).astype(np.float32)).to(card)
    fused.reset_launch_counts()
    with torch.no_grad():
        logits = tsnn.forward_logits(cfg, trainer.params, raster)
    assert _launched() == {fused.KERNEL_SCAN: 1}
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# The stacked replica mode (ensembles of seeds) of both head kernel triples
# ---------------------------------------------------------------------------
STACKED_CASES = [  # name, alif, recurrent, use_periods, n_steps, surrogate
    ("alif-rec-ttfs", True, True, False, 23, FAST),
    ("alif-ff-periodic", True, False, True, 24, FAST),
    ("lif-rec-periodic-phi", False, True, True, 24, PHI),
    ("alif-rec-phi", True, True, False, 100, PHI),
]


def _stack_replicas(dev, a, S, rng, beta_tensor):
    """``_args``' latencies and constants with S replicas' weights."""
    F, H = a["w_in"].shape
    O = a["w_out"].shape[1]
    wdtype = a["w_in"].dtype

    def w(shape, std):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    a = dict(a, w_in=w((S, F, H), 0.5).to(wdtype),
             w_out=w((S, H, O), 1.0).to(wdtype), b_out=w((S, O), 0.1))
    if a["w_rec"] is not None:
        a["w_rec"] = (w((S, H, H), 0.3)
                      * (1 - torch.eye(H, device=dev))).to(wdtype)
    if a["alif"] and beta_tensor:
        a["beta"] = 1.6 + w((S,), 0.3)
    return a


def _replica(a, s):
    return dict(a, w_in=a["w_in"][s],
                w_rec=None if a["w_rec"] is None else a["w_rec"][s],
                beta=fused.replica_beta(a["beta"], s), w_out=a["w_out"][s],
                b_out=a["b_out"][s])


def _lif_calls(a, g):
    """Inference logits, the training forward and the backward on it."""
    common = (a["latencies"], a["w_in"], a["w_rec"], a["beta"], a["w_out"],
              a["b_out"], a["n_steps"], a["use_periods"], a["alif"],
              a["alpha"], a["rho"], a["threshold"], a["kappa"])
    out = fused._head_cuda(*common)
    res = fused._head_train_cuda(*common, True, fused._stores_a(
        a["alif"], a["spike_func"]), False)
    _, delta, a_tr, tstar, _ = res
    grads = fused._head_bwd_cuda(
        g, None, tstar, delta, a_tr, a["latencies"], a["w_in"], a["w_rec"],
        a["beta"], a["w_out"], a["n_steps"], a["use_periods"], a["alpha"],
        a["threshold"], a["gamma"], a["kappa"], a["spike_func"])
    return out, res, grads


def _assert_stacked_equals_singles(stacked, singles):
    """Every output of the stacked launches equals the single launches'
    bit for bit, replica by replica."""
    out, res, grads = stacked
    for s, (o1, r1, g1) in enumerate(singles):
        assert torch.equal(o1, out[s]), f"replica {s} logits"
        for k, (x, y) in enumerate(zip(r1, res)):
            if x is not None:
                assert torch.equal(x, y[s]), f"replica {s} train output {k}"
        for k, (x, y) in enumerate(zip(g1, grads)):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y[s]), f"replica {s} gradient {k}"


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("beta_tensor", [False, True],
                         ids=["beta-float", "beta-tensor"])
@pytest.mark.parametrize("name,alif,rec,per,T,spike", STACKED_CASES,
                         ids=[c[0] for c in STACKED_CASES])
def test_stacked_head_equals_single_launches(card, name, alif, rec, per, T,
                                             spike, beta_tensor, wdtype):
    """``fused_head_fwd_stacked``, ``fused_head_fwd_train_stacked`` and
    ``fused_head_bwd_stacked`` on S = 3 replicas equal three single
    launches bit for bit (logits, ``tstar``, residuals, every gradient),
    and each counts one launch under its own name."""
    S = 3
    rng = np.random.default_rng(41)
    a = _stack_replicas(card, _args(card, 37, 30, 20, 10, T, alif, rec, per,
                                    wdtype, spike), S, rng, beta_tensor)
    g = torch.from_numpy(rng.standard_normal((S, 37, 10)).astype(
        np.float32)).to(card)
    fused.reset_launch_counts()
    stacked = _lif_calls(a, g)
    assert _launched() == {fused.KERNEL_STACKED: 1,
                           fused.KERNEL_TRAIN_STACKED: 1,
                           fused.KERNEL_BWD_STACKED: 1}
    singles = [_lif_calls(_replica(a, s), g[s].contiguous())
               for s in range(S)]
    torch.cuda.synchronize()
    _assert_stacked_equals_singles(stacked, singles)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("rec", [True, False], ids=["rec", "ff"])
@pytest.mark.parametrize("per,T,H", [(False, 24, 20), (True, 24, 20),
                                     (False, 100, 20), (False, 25, 45),
                                     (True, 25, 45)],
                         ids=["ttfs", "periodic", "ttfs-100", "ttfs-odd",
                              "periodic-odd"])
def test_stacked_izh_head_equals_single_launches(card, per, T, H, rec,
                                                 wdtype):
    """The Izhikevich head's stacked launches at dt = 30 (chaotic: last
    bits grow ~3x a step, which the stacked-vs-single contract survives
    only when the arithmetic is the same) equal three single launches bit
    for bit, on the tensor-core body; a stacked first layer raises.  The
    ``-odd`` cases make T B H odd, so every odd replica's v trace starts 4
    bytes past an 8-byte boundary."""
    S, B, F, O = 3, 37, 30, 10
    cfg = IzhikevichConfig(input_size=1, output_size=1, dt=30.0)
    kp = izh.izh_kernel_params(cfg)
    kappa = ReadoutConfig(input_size=H, output_size=O).kappa
    rng = np.random.default_rng(43)

    def w(shape, std=1.0):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).to(card)

    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(card)
    lat = pixels_to_firing_periods(pixels, t_max=float(T)).contiguous()
    w_in = w((S, F, H)).to(wdtype)
    w_rec = ((w((S, H, H)) * (1 - torch.eye(H, device=card))).to(wdtype)
             if rec else None)
    w_out, b_out = w((S, H, O)).to(wdtype), w((S, O), 0.1)
    g = w((S, B, O))

    def calls(wi, wr, wo, bo, gl):
        out = fused_izh._head_cuda(lat, wi, wr, wo, bo, T, per, kp, kappa,
                                   False, False)[0]
        res = fused_izh._head_cuda(lat, wi, wr, wo, bo, T, per, kp, kappa,
                                   True, False)
        grads = fused_izh._bwd_cuda(gl, None, res[2], None, None, res[1],
                                    lat, wi, wr, wo, T, per, kp, cfg.gamma,
                                    kappa, cfg.spike_func)
        return out, res, grads

    assert fused_izh.head_bodies(T, F, H, O, rec, wdtype.itemsize, card,
                                 True, per) == ("mma", "mma")

    fused.reset_launch_counts()
    stacked = calls(w_in, w_rec, w_out, b_out, g)
    assert _launched() == {fused.KERNEL_IZH_STACKED: 1,
                           fused.KERNEL_IZH_TRAIN_STACKED: 1,
                           fused.KERNEL_IZH_BWD_STACKED: 1}
    assert float((stacked[1][1] >= cfg.v_peak).float().mean()) > 0
    singles = [calls(w_in[s], None if w_rec is None else w_rec[s], w_out[s],
                     b_out[s], g[s].contiguous()) for s in range(S)]
    torch.cuda.synchronize()
    _assert_stacked_equals_singles(stacked, singles)
    with pytest.raises(ValueError, match="head only"):
        fused_izh.fused_encode_izh_scan(lat, w_in, w_rec, kp, T, False,
                                        cfg.gamma)


def _ensemble_cfg():
    import snnimageclassification_tpu_torch as tst

    return tst.SNNConfig(
        input_size=784, output_size=10, n_hidden_neurons=128,
        hidden_layer_type="ALIF", use_recurrent_connection=True,
        learn_beta=True, int_time_steps=24)


@pytest.mark.cuda
def test_ensemble_server_one_stacked_launch_a_batch(card):
    """``EnsembleTrainer.serve()`` answers a batch with one
    ``fused_head_fwd_stacked`` launch and no other kernel; its rows are the
    seed-averaged probabilities of ``predict_proba`` (within 1e-6)."""
    import snnimageclassification_tpu_torch as tst
    from snnimageclassification_tpu_torch.parallel import EnsembleTrainer

    cfg = _ensemble_cfg()
    enc = tst.EncodeConfig(n_steps=24, use_periods=True)
    ens = EnsembleTrainer(cfg, seeds=range(4), device="cuda")
    x = np.random.default_rng(7).random((64, 784), dtype=np.float32)
    with ens.serve(encode_config=enc, batch_size=64) as srv:
        srv.submit(x[:1]).result(timeout=120)
        fused.reset_launch_counts()
        got = srv.submit(x).result(timeout=120)
        assert _launched() == {fused.KERNEL_STACKED: 1}
    want = ens.predict_proba(x, enc).cpu().numpy()
    assert got.shape == (64, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_stacked_and_unrolled_trainers_give_equal_losses(card):
    """``fused_replicas="stacked"`` (one stacked kernel pair a step) and
    the default (S unrolled single pairs) give bitwise equal per-seed
    losses and params over three steps; beta stays bitwise."""
    from snnimageclassification_tpu_torch.parallel import EnsembleTrainer

    cfg = _ensemble_cfg()
    rng = np.random.default_rng(9)
    batches = [(rng.random((256, 784), dtype=np.float32),
                rng.integers(0, 10, 256)) for _ in range(3)]
    runs = []
    for fr, want in (("stacked", {fused.KERNEL_TRAIN_STACKED: 3,
                                  fused.KERNEL_BWD_STACKED: 3}),
                     (None, {fused.KERNEL_TRAIN: 9, fused.KERNEL_BWD: 9})):
        ens = EnsembleTrainer(cfg, seeds=(0, 1, 2), fused_replicas=fr,
                              device="cuda")
        beta = ens.params["input"]["beta"].clone()
        fused.reset_launch_counts()
        losses = torch.stack([ens.train_step(x, y) for x, y in batches])
        assert _launched() == want
        assert torch.equal(ens.params["input"]["beta"], beta)
        runs.append((losses, ens.params))
    assert torch.equal(runs[0][0], runs[1][0])
    for n, g in runs[0][1].items():
        for k, v in g.items():
            assert torch.equal(v, runs[1][1][n][k]), f"{n}.{k}"


# ---------------------------------------------------------------------------
# gbits_mma: every g_W_rec and a mid layer's g_W_in on tensor cores
# ---------------------------------------------------------------------------
def _gbits_check(record, label, got, d, left, B, T, groups, wd,
                 step_major=False):
    """``gbits_mma``'s float32 sum ``got`` against its plain version in its
    order (``gbits._gbits_ordered_reference`` on the kernel's plan) on the
    operands ``d`` and ``left`` (``(B T, ·)`` in their memory order): bit
    for bit below 300 rows of a batch; from 300 rows, where a slice whose
    exact sum does not fit float32 is truncated on the card and rounded in
    the plain version, its error against the float64 exact sum of the same
    operands at most twice the error of the CUDA-core bit walk it replaced
    (``gbits._gbits_walk_reference`` with that walk's plan) on the same
    operands.  Records the share of elements equal to the ordered
    version."""
    want = gbits._gbits_ordered_reference(d, left, B, T, groups, wd,
                                          step_major)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float(got.abs().max()) > 0
    share = float((got == want).float().mean())
    record(f"{label} bitwise share", share)
    if B < 300:
        assert torch.equal(got, want), f"{label}: bitwise share {share:.4f}"
        return
    exact = gbits.exact_sum(d, left, wd)
    scale = float(exact.abs().max())
    err = float((got.double() - exact).abs().max()) / scale
    J, H = got.shape
    walk = gbits._gbits_walk_reference(
        d, left, B, T, gbits.walk_groups(B, T, J, H, step_major, d.device),
        wd, step_major)
    walk_err = float((walk.double() - exact).abs().max()) / scale
    record(f"{label} error", err)
    record(f"{label} walk error", walk_err)
    assert err <= 2 * walk_err, (label, err, walk_err, share)


def _mask_rows(words, B, T, nrows, J):
    return gbits.unpack_bits(gbits._rows_of(words, B, T, nrows), J)


def _kept(monkeypatch, module, name):
    """Every call of ``module.name`` (a CUDA backward wrapper) from here on
    hands its ``keep`` dict to the returned list."""
    calls, orig = [], getattr(module, name)

    def wrapped(*a, **k):
        k["keep"] = {}
        out = orig(*a, **k)
        calls.append(k["keep"])
        return out

    monkeypatch.setattr(module, name, wrapped)
    return calls


GBITS_B = [37, 300]


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=lambda s: "x".join(
    str(v) for v in s))
def test_gbits_matches_its_ordered_version(card, record_property, shape,
                                           use_periods, n_steps, wdtype):
    """The head's g_W_rec (``gbits_mma`` inside ``fused_head_bwd``) against
    its ordered plain version on the chain's rounded dcur and z bits
    (``_gbits_check``); ALIF, recurrent, Phi under TTFS as in
    ``test_gradient_functions_match_their_ordered_versions``."""
    B, F, H = shape
    args = _args(card, B, F, H, 10, n_steps, True, True, use_periods,
                 wdtype, FAST if use_periods else PHI)
    _, delta, _, tstar, _ = fused._head_train_cuda(
        *_train_args(args), True, False, False)
    g_logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, 10)).astype(np.float32)).to(card)
    keep = {}
    fused._head_bwd_cuda(
        *_bwd_args(args, g_logits, None, delta, None, tstar), keep=keep)
    order = fused.gradient_plan(card, B, F, H, 10, n_steps, True,
                                wdtype == torch.bfloat16, use_periods)
    row = H * wdtype.itemsize
    assert order["gbits_ring"] == (row % 16 == 0 and row >= 128)
    left = fused.z_prev_rows(delta)
    assert torch.equal(left, _mask_rows(keep["zmask"], B, n_steps,
                                        n_steps + 1, H))
    d = keep["dcur"].reshape(B * n_steps, H)
    _gbits_check(record_property, "head g_W_rec", keep["g_w_rec"], d, left,
                 B, n_steps, order["groups_rec"], wdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", GBITS_B)
@pytest.mark.parametrize("n_steps", [24, 100])
def test_gbits_of_the_deep_layers(card, monkeypatch, record_property,
                                  n_steps, B, wdtype):
    """Layer 0's g_W_rec and both mid layers' g_W_in (J = Hin) and g_W_rec
    (z-emitting and head mode) of 784... -> 20 -> 24 -> 18 -> 10 under
    autograd, each against its ordered plain version."""
    l0 = _kept(monkeypatch, fused, "_layer0_bwd_cuda")
    mids = _kept(monkeypatch, fused_mid, "_mid_bwd_cuda")
    fused.reset_launch_counts()
    _deep_chain(card, n_steps, True, True, False, FAST, wdtype, plain=False,
                B=B)
    assert _functions_launched() == {fused.KERNEL_GBITS: 5,
                                     fused.KERNEL_GZIN: 2}
    T = n_steps
    for label, k in [("layer0", l0[0])] + [(f"mid{i}", m)
                                             for i, m in enumerate(mids)]:
        H = k["dcur"].shape[2]
        d = k["dcur"].reshape(B * T, H)
        if label == "layer0":
            F = 30
            groups = fused._plan_layer0_bwd(card, B, F, H, T, True,
                                            wdtype == torch.bfloat16,
                                            False)[1]
            pairs = [("g_w_rec", k["zmask"], T + 1, H, groups)]
        else:
            Hin = k["g_w_in"].shape[0]
            n_in, n_rec, _ = fused_mid._plan_bwd(
                card, B, Hin, H, 0, T, True, wdtype == torch.bfloat16)
            pairs = [("g_w_in", k["zinmask"], T, Hin, n_in),
                     ("g_w_rec", k["zmask"], T + 1, H, n_rec)]
        for name, words, nrows, J, groups in pairs:
            left = _mask_rows(words, B, T, nrows, J)
            _gbits_check(record_property, f"{label} {name}", k[name], d,
                         left, B, T, groups, wdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", GBITS_B)
@pytest.mark.parametrize("n_steps", [24, 100])
def test_gbits_of_the_two_layer_pair(card, monkeypatch, record_property,
                                     n_steps, B, wdtype):
    """``fused2_bwd``'s three: g_W0r, g_W1 (z0's masks one row on, J =
    H1) and g_W1r, each against its ordered plain version."""
    args, gamma = _f2_args(card, n_steps, True, True, False, wdtype, B=B)
    kept = _kept(monkeypatch, fused2, "_fused2_bwd_cuda")
    a = list(args)
    for i in (1, 2, 4, 5, 7):
        a[i] = a[i].clone().requires_grad_(True)
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, 10)).astype(np.float32)).to(card)
    fused.reset_launch_counts()
    (fused2.fused2_rec_head(*a[:15], gamma, a[15]) * r).sum().backward()
    assert _functions_launched() == {fused.KERNEL_GBITS: 3,
                                     fused.KERNEL_GZIN: 1}
    k, T = kept[0], n_steps
    H1, H2 = k["dcur0"].shape[2], k["dcur1"].shape[2]
    F = args[0].shape[1]
    _, n_w0r, n_w1, n_w1r, _ = fused2._plan_bwd(
        card, B, F, H1, H2, 10, T, True, wdtype == torch.bfloat16, False)
    hw0 = (H1 + 31) // 32
    z0 = k["zmask0"][:B * (T + 1) * hw0].view(B * (T + 1), hw0)
    z0_next = k["zmask0"][hw0:].view(-1, hw0)
    zm1 = k["zmask1"].view(B * (T + 1), -1)
    for name, dn, words, J, groups in (
            ("g_w0r", "dcur0", z0, H1, n_w0r),
            ("g_w1", "dcur1", z0_next, H1, n_w1),
            ("g_w1r", "dcur1", zm1, H2, n_w1r)):
        d = k[dn].reshape(B * T, -1)
        left = _mask_rows(words, B, T, T + 1, J)
        _gbits_check(record_property, name, k[name], d, left, B, T, groups,
                     wdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", GBITS_B)
def test_gbits_of_the_izhikevich_kernels(card, monkeypatch, record_property,
                                         B, wdtype):
    """The Izhikevich head's, its first layer's and ``izh_scan``'s g_W_rec
    (T = 24, the JAX suite's weight scale) against their ordered plain
    versions."""
    F, H, O, T = 30, 20, 10, 24
    rng = np.random.default_rng(6)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(card)
    lat = pixels_to_firing_periods(pixels, t_max=float(T),
                                   tau=20.0).contiguous()
    w_in, w_rec, w_out, b_out = (
        t.requires_grad_(True) for t in _izh_weights(card, rng, F, H, O,
                                                     True, wdtype))
    w1 = torch.from_numpy((0.1 * rng.standard_normal((H, H))).astype(
        np.float32)).to(card)
    kappa = ReadoutConfig(input_size=H, output_size=O).kappa
    heads = _kept(monkeypatch, fused_izh, "_bwd_cuda")
    scans = _kept(monkeypatch, izh, "_scan_bwd_cuda")
    fused.reset_launch_counts()
    logits = fused_izh.fused_encode_izh_scan_head(
        lat, w_in, w_rec, w_out, b_out, IZH_KP, T, False, IZH.gamma, kappa)
    z0 = fused_izh.fused_encode_izh_scan(lat, w_in, w_rec, IZH_KP, T, True,
                                         IZH.gamma)
    z1 = izh.izh_scan(3e6 + 1e7 * (z0.float() @ w1), w_rec.float(), IZH_KP,
                      IZH.gamma)
    (logits.sum() + 1e-3 * z1.sum(0).pow(2).sum()).backward()
    assert _functions_launched() == {fused.KERNEL_GBITS: 3}
    bf16 = wdtype == torch.bfloat16
    groups = fused_izh._plan_bwd(card, B, F, H, O, T, True, bf16, False)[1]
    scan_groups = izh._plan_bwd(card, B, H, T, True, False)
    for label, k, g, wd in [(f"izh {i}", h, groups, wdtype)
                            for i, h in enumerate(heads)] + [
            ("izh_scan", scans[0], scan_groups, torch.float32)]:
        d = k["dcur"].reshape(B * T, H)
        left = _mask_rows(k["zmask"], B, T, T + 1, H)
        assert float(left.sum()) > 0, label
        _gbits_check(record_property, label, k["g_w_rec"], d, left, B, T,
                     g, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", GBITS_B)
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
def test_gbits_of_the_stacked_head(card, record_property, use_periods, B,
                                   wdtype):
    """``fused_head_bwd_stacked`` at S = 6 (an ensemble's seeds): every
    replica's g_W_rec against its ordered plain version, on one launch of
    gbits_mma."""
    S, T = 6, 24
    rng = np.random.default_rng(43)
    a = _stack_replicas(card, _args(card, B, 30, 20, 10, T, True, True,
                                    use_periods, wdtype), S, rng, False)
    _, delta, _, tstar, _ = fused._head_train_cuda(*_train_args(a), True,
                                                   False, False)
    g = torch.from_numpy(rng.standard_normal((S, B, 10)).astype(
        np.float32)).to(card)
    keep = {}
    fused.reset_launch_counts()
    fused._head_bwd_cuda(*_bwd_args(a, g, None, delta, None, tstar),
                         keep=keep)
    assert _functions_launched() == {fused.KERNEL_GBITS: 1}
    order = fused.gradient_plan(card, B, 30, 20, 10, T, True,
                                wdtype == torch.bfloat16, use_periods)
    for s in range(S):
        d = keep["dcur"][s].reshape(B * T, 20)
        left = fused.z_prev_rows(delta[s])
        _gbits_check(record_property, f"replica {s}", keep["g_w_rec"][s], d,
                     left, B, T, order["groups_rec"], wdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H", [(37, 45), (37, 512), (300, 45), (300, 512)],
                         ids=["37x45", "37x512", "300x45", "300x512"])
def test_gbits_of_the_recurrent_scan(card, record_property, B, H, wdtype):
    """``rec_scan_bwd``'s g_W_rec (T = 100): the chain's float32 g_i (T, B,
    H), rounded to W's dtype as it loads, and the z bits rec_chain writes
    (T, B, HW), k = t B + b; H = 45 is off the TMA strides (180 bytes), H =
    512 is the wide net's 16 output tiles."""
    from snnimageclassification_tpu_torch.ops import rec_scan

    T = 100
    rng = np.random.default_rng(13)
    cur, w = _rec_inputs(card, rng, B, H, T, wdtype)
    alpha, rho, thr, gamma = _rec_scalars(True)
    z, res, a_tr = rec_scan._fwd_cuda(cur, w, 1.6, True, alpha, rho, thr,
                                      True, False, False)
    g_z = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(card).to(wdtype)
    keep = {}
    fused.reset_launch_counts()
    g_i, _ = rec_scan._bwd_cuda(g_z, z, res, a_tr, False, w, 1.6, alpha, thr,
                                gamma, FAST, keep=keep)
    assert _functions_launched() == {fused.KERNEL_GBITS: 1}
    d = g_i.reshape(T * B, H)
    left = gbits.unpack_bits(keep["zmask"].view(T * B, -1), H)
    z_prev = torch.cat([torch.zeros_like(z[:1]), z[:-1]]).float()
    assert torch.equal(left, z_prev.reshape(T * B, H))
    groups = rec_scan._plan(card, B, H, T, wdtype == torch.bfloat16)
    _gbits_check(record_property, "rec g_W_rec", keep["g_w_rec"], d, left, B,
                 T, groups, wdtype, step_major=True)


@pytest.mark.cuda
@pytest.mark.parametrize("wd,d_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)], ids=["f32", "bf16", "f32-to-bf16"])
@pytest.mark.parametrize("B,T,J,H,step_major", [
    (37, 24, 20, 20, False), (37, 100, 45, 45, False),
    (9, 24, 130, 200, False), (300, 7, 96, 128, True)],
    ids=["20", "45", "tiles", "step-major"])
def test_gbits_call_on_its_own(card, B, T, J, H, step_major, wd, d_dtype):
    """``gbits.gbits`` (the kernel alone, for its time and plan) on random
    masks and d spanning ten binades, against its ordered plain version bit
    for bit (below 300 rows; above, ``_gbits_check``'s rule) and the CPU
    plain version within float32 rounding; J and H past one 128 x 128
    tile, a batch below one 16-row chunk (the threads read d), the wide
    net's step-major layout."""
    rng = np.random.default_rng(3)
    K = B * T
    d = torch.from_numpy((rng.standard_normal((K, H)) * np.exp2(
        rng.integers(-5, 5, (K, 1)))).astype(np.float32)).to(card)
    d = d.to(d_dtype)
    left = torch.from_numpy((rng.random((K, J)) < 0.3).astype(
        np.float32)).to(card)
    if step_major:
        nrows, words = 1, gbits.pack_bits(left)
    else:
        nrows = T + 1
        words = torch.zeros((B, nrows, (J + 31) // 32), dtype=torch.int32,
                            device=card)
        words[:, :T] = gbits.pack_bits(left.view(B, T, J))
        words = words.view(B * nrows, -1)
    fused.reset_launch_counts()
    got = gbits.gbits(d, words, J, B, T, nrows, wd, step_major)
    assert _functions_launched() == {fused.KERNEL_GBITS: 1}
    p = gbits.plan(card, B, T, J, H, d_dtype, wd)
    row = H * d_dtype.itemsize
    assert p["ring"] == (row % 16 == 0 and row >= 128 and B >= 16)
    _gbits_check(lambda *a: None, "gbits", got, d, left, B, T, p["groups"],
                 wd, step_major)
    cpu = gbits.gbits(d.cpu(), words.cpu(), J, B, T, nrows, wd, step_major)
    exact = gbits.exact_sum(d.cpu(), left.cpu(), wd)
    scale = float(exact.abs().max())
    assert float((cpu.double() - exact).abs().max()) <= 1e-5 * scale
