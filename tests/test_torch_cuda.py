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
  once.
* the two-layer pair (``fused2_fwd[_train]``, ``fused2_bwd``) at T = 24 and
  100: logits 1e-5, ``tstar``, counts and spikes equal to the plain
  version's, residuals 1e-5 (bf16 2**-7), training logits bitwise the
  inference kernel's; the backward on the forward kernel's residuals within
  2e-6 of max|g| (5e-6 at T = 100, 2e-5 ALIF with Phi, bf16 2**-7), equal
  bits on a second run; logits, ``tstar`` and counts bitwise those of the
  composed kernels (``fused_layer0_fwd`` + ``fused_mid_fwd[head]``); the
  public functions under autograd and the model's dispatch launch the pair
  once.
* the feedforward scan (``scan_fwd[_train]``, ``scan_bwd``) at T = 23, 24
  and 100, small and at B = 8192: spikes equal to the plain version's,
  residuals 1e-5 (bf16 2**-7), the backward on the training kernel's
  residuals within 2e-6 of max|g| (bf16 2**-7), equal
  bits twice; 784-ALIF256-10 and 784-LIF128-10 on constant-pixel input
  served (one ``scan_fwd`` a batch, bitwise a direct forward) and trained
  (one ``scan_fwd_train`` and one ``scan_bwd`` a step, gradients against
  the per-step loop's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snnimageclassification_tpu_torch.ops import (  # noqa: E402
    fused,
    fused2,
    fused_izh,
    fused_mid,
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


def _launched():
    """The kernels launched since the last reset, with their counts."""
    return {k: n for k, n in fused.launch_counts().items() if n}


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


DEEP_CASES = [  # name, alif, recurrent, use_periods, surrogate
    ("alif-rec-fs", True, True, False, FAST),
    ("alif-ff-phi-periodic", True, False, True, PHI),
    ("lif-rec-phi", False, True, False, PHI),
    ("lif-ff-fs-periodic", False, False, True, FAST),
]


def _deep_chain(dev, T, alif, rec, use_periods, spike, wdtype, plain, seed=5,
                backward=True):
    """Layer 0 -> mid -> mid head with counts on fresh leaves; returns
    (z0, z1, logits, counts, gradients of every weight)."""
    B, F, H0, H1, H2, O = 9, 30, 20, 24, 18, 10
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
    # The first layer is the head's template without the readout.
    assert torch.equal(v0, v) and torch.equal(z0, (v >= IZH.v_peak).float())
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
    """The same sums in the same order: logits, ``tstar`` and both counts of
    ``fused2_fwd_train`` equal those of ``fused_layer0_fwd`` +
    ``fused_mid_fwd[head]`` bit for bit."""
    args, _ = _f2_args(card, n_steps, alif, rec, use_periods, wdtype, B=40)
    lat, w0, w0r, b0, w1, w1r, b1, w_out, b_out = args[:9]
    sc = args[12:15]
    logits, _, _, _, _, tstar, c0, c1 = fused2._fused2_cuda(
        *args, True, False, True)
    z0 = fused._layer0_cuda(lat, w0, w0r, b0, n_steps, use_periods, alif,
                            *sc, False, False, False)[0]
    m = fused_mid._mid_cuda(z0, w1, w1r, b1, w_out, b_out, n_steps, alif,
                            *sc, args[15], True, False, True, False)
    torch.cuda.synchronize()
    assert torch.equal(logits, m[0]) and torch.equal(tstar, m[4])
    assert torch.equal(c1, m[5]) and torch.equal(c0, z0.float().sum(0))
    assert float(c1.sum()) > 0


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
ENC_SHAPES = [(9, 30, 40), (5, 784, 512), (3, 784, 1024)]  # B, F, H


def _latencies(dev, rng, B, F, T):
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(dev)
    return pixels_to_firing_periods(pixels, t_max=float(T),
                                    tau=20.0).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [24, 100])
@pytest.mark.parametrize("use_periods", [False, True],
                         ids=["ttfs", "periodic"])
@pytest.mark.parametrize("shape", ENC_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_encode_kernels_match_plain_versions(card, shape, use_periods,
                                             n_steps, wdtype):
    """``encode_matmul_fwd``: currents within 1e-5 of max|current| (up to
    F terms of either sign in another order: the error scales with their
    absolute sum); ``encode_matmul_bwd``: g_W within 2e-6
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


def _rec_check(dev, B, H, T, alif, spike, wdtype, min_rows):
    """The forward kernels against the plain version fed the same currents
    (share of rows with equal spikes at least ``min_rows``; residuals 1e-5,
    bf16 one rounding, on those rows) and the backward on the training
    kernel's residuals (2e-6 of max|g|, 5e-6 at T = 100, bf16 2**-7; equal
    bits twice)."""
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
    _grads_close(rec_scan._bwd_cuda(*bw), rec_scan._bwd_cuda(*bw),
                 rec_scan._bwd_reference(*bw), _izh_bar(T, wdtype))


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
def test_stacked_izh_head_equals_single_launches(card, rec, wdtype):
    """The Izhikevich head's stacked launches at dt = 30 (chaotic: last
    bits grow ~3x a step, which the stacked-vs-single contract survives
    only when the arithmetic is the same) equal three single launches bit
    for bit; a stacked first layer raises."""
    S, B, F, H, O, T = 3, 37, 30, 20, 10, 24
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
        out = fused_izh._head_cuda(lat, wi, wr, wo, bo, T, False, kp, kappa,
                                   False, False)[0]
        res = fused_izh._head_cuda(lat, wi, wr, wo, bo, T, False, kp, kappa,
                                   True, False)
        grads = fused_izh._bwd_cuda(gl, None, res[2], None, None, res[1],
                                    lat, wi, wr, wo, T, False, kp, cfg.gamma,
                                    kappa, cfg.spike_func)
        return out, res, grads

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
