"""Whole-network head: the port's plain PyTorch version against the JAX
Pallas kernel run in interpret mode, on identical numpy inputs, for the
JAX suite's head cases (T=24 spans several time blocks) in float32 and
bfloat16 weights.  Tolerance atol=rtol=1e-5: the two sum in different
orders and the JAX kernel's readout adds the bias before the kappa sum.
The gradients are held in tests/test_torch_fused_bwd.py.

The CUDA kernels run only on the card: tests/test_torch_cuda.py holds
them against the plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_fused as jfused  # noqa: E402
from snnimageclassification_tpu.ops.cells import (  # noqa: E402
    ALIFConfig,
    LIFConfig,
    ReadoutConfig,
)
from snnimageclassification_tpu.ops.encoding import (  # noqa: E402
    pixels_to_firing_periods,
)
from snnimageclassification_tpu.ops.surrogate import SpikeFuncType  # noqa: E402
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402

B, F, H, O = 5, 30, 20, 10
KAPPA = ReadoutConfig(input_size=H, output_size=O).kappa

# tests/test_pallas_fused.py:HEAD_CASES (the surrogate only shapes the
# backward).
HEAD_CASES = [
    ("alif-rec-ttfs", True, True, False, SpikeFuncType.FastSigmoid, 12),
    ("alif-ff-periodic", True, False, True, SpikeFuncType.FastSigmoid, 12),
    ("lif-rec-phi", False, True, True, SpikeFuncType.Phi, 12),
    ("alif-rec-phi", True, True, False, SpikeFuncType.Phi, 12),
    ("alif-rec-2blocks", True, True, False, SpikeFuncType.FastSigmoid, 24),
    ("lif-ff-2blocks", False, False, True, SpikeFuncType.FastSigmoid, 24),
    ("alif-ff-phi-2blocks", True, False, True, SpikeFuncType.Phi, 24),
]


def _inputs(seed, n_steps, rec, wdtype):
    rng = np.random.default_rng(seed)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = np.array(pixels_to_firing_periods(jnp.asarray(pixels),
                                              t_max=float(n_steps)))
    w_in = (0.5 * rng.standard_normal((F, H))).astype(np.float32)
    w_rec = ((0.3 * rng.standard_normal((H, H))).astype(np.float32)
             * (1 - np.eye(H, dtype=np.float32))) if rec else None
    w_out = rng.standard_normal((H, O)).astype(np.float32)
    b_out = (0.1 * rng.standard_normal((O,))).astype(np.float32)
    jw = {k: None if v is None else jnp.asarray(v).astype(wdtype)
          for k, v in dict(w_in=w_in, w_rec=w_rec, w_out=w_out).items()}
    tw = {k: None if v is None else torch.from_numpy(v).to(
        getattr(torch, wdtype)) for k, v in dict(
            w_in=w_in, w_rec=w_rec, w_out=w_out).items()}
    return lat, b_out, jw, tw


def _scalars(alif, spike_func):
    cfg = (ALIFConfig if alif else LIFConfig)(
        input_size=F, output_size=H, spike_func=spike_func)
    return cfg, (cfg.beta if alif else 0.0), (cfg.rho if alif else 0.0)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "name,alif,rec,use_periods,spike_func,n_steps", HEAD_CASES,
    ids=[c[0] for c in HEAD_CASES],
)
def test_reference_matches_pallas_head(name, alif, rec, use_periods,
                                       spike_func, n_steps, wdtype):
    lat, b_out, jw, tw = _inputs(11, n_steps, rec, wdtype)
    cfg, beta, rho = _scalars(alif, spike_func)
    jcommon = (n_steps, use_periods, alif, cfg.alpha, rho, cfg.threshold,
               cfg.gamma, KAPPA, spike_func, True)
    tcommon = (n_steps, use_periods, alif, cfg.alpha, rho, cfg.threshold,
               cfg.gamma, KAPPA, spike_func.name)
    if rec:
        want = jfused.fused_encode_rec_scan_head(
            jnp.asarray(lat), jw["w_in"], jw["w_rec"], beta, jw["w_out"],
            jnp.asarray(b_out), *jcommon)
        got = tfused.fused_encode_rec_scan_head_reference(
            torch.from_numpy(lat), tw["w_in"], tw["w_rec"], beta,
            tw["w_out"], torch.from_numpy(b_out), *tcommon)
    else:
        want = jfused.fused_encode_ff_scan_head(
            jnp.asarray(lat), jw["w_in"], beta, jw["w_out"],
            jnp.asarray(b_out), *jcommon)
        got = tfused.fused_encode_ff_scan_head_reference(
            torch.from_numpy(lat), tw["w_in"], beta, tw["w_out"],
            torch.from_numpy(b_out), *tcommon)
    assert got.dtype == torch.float32 and got.shape == (B, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("rec", [True, False])
def test_wrapper_on_cpu_is_the_reference(rec):
    lat, b_out, _, tw = _inputs(3, 12, rec, "float32")
    cfg, beta, rho = _scalars(True, SpikeFuncType.FastSigmoid)
    args = (12, False, True, cfg.alpha, rho, cfg.threshold, cfg.gamma, KAPPA)
    lat_t, b_t = torch.from_numpy(lat), torch.from_numpy(b_out)
    tfused.reset_launch_counts()
    if rec:
        got = tfused.fused_encode_rec_scan_head(
            lat_t, tw["w_in"], tw["w_rec"], torch.tensor(beta), tw["w_out"],
            b_t, *args)
        want = tfused.fused_encode_rec_scan_head_reference(
            lat_t, tw["w_in"], tw["w_rec"], beta, tw["w_out"], b_t, *args)
    else:
        got = tfused.fused_encode_ff_scan_head(
            lat_t, tw["w_in"], beta, tw["w_out"], b_t, *args)
        want = tfused.fused_encode_ff_scan_head_reference(
            lat_t, tw["w_in"], beta, tw["w_out"], b_t, *args)
    assert torch.equal(got, want)
    assert not any(tfused.launch_counts().values())  # no kernel on CPU


def test_readout_max_without_hidden_spikes():
    """No hidden spikes: the readout is a per-class bias ramp whose max is
    the last step; with b < 0 it is the first step (strict >)."""
    lat = torch.zeros((2, 4), dtype=torch.int32)
    w_in = torch.zeros((4, 3))
    w_out = torch.ones((3, 2))
    b = torch.tensor([0.5, -0.5])
    got = tfused.fused_encode_ff_scan_head_reference(
        lat, w_in, 0.0, w_out, b, 6, False, False, 0.9, 0.0, 1.0, 1.0, 0.9)
    ramp_pos = sum(0.5 * 0.9 ** k for k in range(6))
    np.testing.assert_allclose(got.numpy(), [[ramp_pos, -0.5]] * 2,
                               rtol=1e-6)


def test_supported_gate():
    assert tfused.fused_head_supported(100, 784, 128, 10, device="cpu")
    assert not tfused.fused_head_supported(0, 784, 128, 10, device="cpu")
    assert not tfused.fused_head_supported(100, 784, 128, 0, device="cpu")
    assert tfused.fused_head_supported(100, 784, 128, 10, device="cpu",
                                       training=True)


def test_cuda_tensor_never_takes_the_reference(monkeypatch):
    """A non-CPU tensor goes to the kernel or raises; here the device is
    unsupported, so it raises instead of running the plain version."""
    called = []
    for name in ("_head_reference", "_head_train_reference",
                 "_head_bwd_reference"):
        monkeypatch.setattr(tfused, name, lambda *a: called.append(a))
    lat = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    for w_in in (torch.zeros((4, 3)), torch.zeros((4, 3), requires_grad=True)):
        with pytest.raises(ValueError, match="no implementation"):
            tfused.fused_encode_ff_scan_head(
                lat, w_in, 0.0, torch.zeros((3, 2)), torch.zeros(2), 6,
                False, False, 0.9, 0.0, 1.0, 1.0, 0.9)
    assert not called
