"""The head kernel against its plain PyTorch version on a CUDA card.

Needs the card and no JAX, so on the card it runs without the suite's
conftest (which imports JAX)::

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Elsewhere every case skips.  Shapes are the JAX suite's head cases
(B=5, 30-20-10, T=12 and T=24) plus one at the flagship width; logits to
atol=rtol=1e-5 (small) -- the kernel and cuBLAS sum in different orders.
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

CASES = [  # name, alif, recurrent, use_periods, n_steps
    ("alif-rec-ttfs", True, True, False, 12),
    ("alif-ff-periodic", True, False, True, 12),
    ("lif-rec-periodic", False, True, True, 12),
    ("alif-rec-2blocks", True, True, False, 24),
    ("lif-ff-2blocks", False, False, True, 24),
    ("alif-ff-periodic-2blocks", True, False, True, 24),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _run(dev, B, F, H, O, T, alif, rec, use_periods, wdtype, seed=11):
    rng = np.random.default_rng(seed)
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H)
    pixels = torch.from_numpy(rng.random((B, F)).astype(np.float32)).to(dev)
    lat = pixels_to_firing_periods(pixels, t_max=float(T), tau=20.0)

    def w(shape, std):
        return torch.from_numpy(
            (std * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    w_in = w((F, H), 0.5).to(wdtype)
    w_rec = ((w((H, H), 0.3) * (1 - torch.eye(H, device=dev))).to(wdtype)
             if rec else None)
    w_out = w((H, O), 1.0).to(wdtype)
    b_out = w((O,), 0.1)
    common = dict(n_steps=T, use_periods=use_periods, alif=alif,
                  alpha=cfg.alpha, rho=cfg.rho if alif else 0.0,
                  threshold=cfg.threshold,
                  kappa=ReadoutConfig(input_size=H, output_size=O).kappa)
    beta = 1.6 if alif else 0.0
    fused.reset_launch_counts()
    if rec:
        got = fused.fused_encode_rec_scan_head(lat, w_in, w_rec, beta, w_out,
                                               b_out, **common)
        want = fused.fused_encode_rec_scan_head_reference(
            lat, w_in, w_rec, beta, w_out, b_out, **common)
    else:
        got = fused.fused_encode_ff_scan_head(lat, w_in, beta, w_out, b_out,
                                              **common)
        want = fused.fused_encode_ff_scan_head_reference(
            lat, w_in, beta, w_out, b_out, **common)
    torch.cuda.synchronize()
    assert fused.launch_counts()[fused.KERNEL] == 1
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,alif,rec,use_periods,n_steps", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version(card, name, alif, rec, use_periods,
                                      n_steps, wdtype):
    got, want = _run(card, 5, 30, 20, 10, n_steps, alif, rec, use_periods,
                     wdtype)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_flagship_width(card):
    got, want = _run(card, 256, 784, 128, 10, 100, True, True, False,
                     torch.float32)
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
            torch.zeros(2, device=card), 6, False, False, 0.9, 0.0, 1.0, 0.9)
