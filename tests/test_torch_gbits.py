"""The bit-masked weight gradient ``sum_k bit(k)^T d(k)`` on the CPU
(``ops/gbits.py``, the plain versions of ``csrc/gbits_mma.cuh``, which
computes every g_W_rec of the port and a mid layer's g_W_in).

* ``_gbits_ordered_reference`` (the kernel's order: its blocks' unit
  ranges, k16 slices, bf16 pieces, each slice exact and rounded to nearest)
  against the float64 sum of the same rounded operands within 1e-6 of
  max|g|, at T = 24 and 100, J != H (a mid layer's g_W_in), one unit of a
  row (the wide net's k = t B + b), both weight dtypes; the parent's bit
  walk and the order-free plain version beside it;
* the head's g_W_rec from it, on the plain chain's rounded dcur, against
  ``jax.grad`` through the JAX kernel pair in interpret mode (B = 5, H =
  20): 2e-6 of max|g| float32, 2**-7 bfloat16 (``test_torch_fused_bwd.py``'s
  bars);
* CPU twins of the kernel's fragments: the A fragment unpacked from mask
  words and the B fragment of d's bf16 pieces, read by mma.m16n8k16's
  layout, reproduce one slice of ``z^T d`` exactly (the kernel's row
  permutation within a slice agrees between A and B);
* the mask words, the call on its own (``gbits.gbits`` on CPU tensors runs
  the plain version) and the plan's row ranges.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from snnimageclassification_tpu.ops import pallas_fused as jfused  # noqa: E402
from snnimageclassification_tpu.ops.surrogate import (  # noqa: E402
    SpikeFuncType as JSpike,
)
from snnimageclassification_tpu_torch.ops import fused, gbits  # noqa: E402
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

DTYPES = [torch.float32, torch.bfloat16]


def _operands(seed, K, J, H, spread=6):
    """d (K, H) spanning ``2 spread`` binades across rows, left (K, J)
    0/1 at ~30 % ones."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((K, H)) * np.exp2(
        rng.integers(-spread, spread, (K, 1)))
    left = (rng.random((K, J)) < 0.3).astype(np.float32)
    return (torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(left))


def _rel(got, exact):
    return float((got.double() - exact).abs().max()) / float(
        exact.abs().max())


@pytest.mark.parametrize("wd", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T,J,H,groups,step_major", [
    (37, 24, 20, 20, 5, False),    # the head: (B, T, H) dcur
    (40, 100, 20, 20, 3, False),   # chunks of 16 rows, one partial
    (13, 100, 24, 18, 13, False),  # a mid layer's g_W_in: J = Hin != H
    (9, 24, 45, 130, 2, False),    # past one 128-column tile
    (50, 24, 40, 40, 3, True),     # the wide net's (T, B, H) g_i
], ids=["head-24", "head-100", "mid-100", "tiles-24", "step-major"])
def test_ordered_version_is_the_exact_sum(B, T, J, H, groups, step_major,
                                          wd):
    d, left = _operands(1, B * T, J, H)
    exact = gbits.exact_sum(d, left, wd)
    got = gbits._gbits_ordered_reference(d, left, B, T, groups, wd,
                                         step_major)
    assert got.dtype == torch.float32 and got.shape == (J, H)
    assert _rel(got, exact) <= 1e-6
    # The parent's CUDA-core walk and the order-free version, same bar.
    walk = gbits._gbits_walk_reference(d, left, B, T, groups, wd,
                                       step_major)
    assert _rel(walk, exact) <= 1e-6
    assert _rel(gbits._gbits_reference(d, left, wd), exact) <= 1e-6


def test_slices_follow_the_kernels_order():
    """Block y's slices: 16 rows at one step, steps ascending, within a step
    the chunks of 16 rows; rows past the block's share point at the zero
    row ``B T``."""
    B, T = 40, 3
    turns = [k.tolist() for k in gbits._slices(B, T, 2, False, "cpu")]
    assert len(turns) == 2 * T  # 20 rows a block: two chunks a step
    pad = B * T
    assert turns[0][0] == [b * T for b in range(16)]
    assert turns[1][0] == [b * T for b in range(16, 20)] + [pad] * 12
    assert turns[2][1] == [b * T + 1 for b in range(20, 36)]
    step = [k.tolist() for k in gbits._slices(B, T, 2, True, "cpu")]
    assert step[2][0] == [B + b for b in range(16)]


@pytest.mark.parametrize("wd", DTYPES, ids=["f32", "bf16"])
def test_ordered_version_follows_its_slices(wd):
    """One group, one slice: the ordered version is the slice's pieces'
    products rounded as the kernel adds them (bf16: one rounded product;
    float32: hi apart, lo then mid chained, ``small + big``)."""
    d, left = _operands(2, 16, 8, 8, spread=12)
    got = gbits._gbits_ordered_reference(d, left, 16, 1, 1, wd)
    a = left.double().T
    dr = gbits._rounded(d, wd)
    if wd == torch.bfloat16:
        want = (a @ dr.double()).float()
    else:
        hi, mid, lo = (p.double() for p in fused.split_pieces(dr))
        big = (a @ hi).float()
        small = (a @ lo).float()
        small = (small.double() + a @ mid).float()
        want = small + big
    assert torch.equal(got, want)


@pytest.mark.parametrize("wd", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("j0", [0, 16, 32, 48])
def test_fragment_twins_reproduce_one_slice(j0, wd):
    """A fragment from mask words, B fragment from d's pieces, read by the
    instruction's layout: the slice's ``left^T round(d)`` exactly."""
    rng = np.random.default_rng(j0)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (16, 2))
                             .astype(np.int64)).to(torch.int32)
    # Rows spanning 16 binades: every float64 sum below stays exact.
    d = torch.from_numpy((rng.standard_normal((16, 8)) * np.exp2(
        rng.integers(-8, 8, (16, 1)))).astype(np.float32))
    got = gbits.fragment_product(gbits.a_fragment(words, j0),
                                 gbits.b_fragment(d, wd))
    left = gbits.unpack_bits(words, 64)[:, j0:j0 + 16]
    want = left.double().T @ gbits._rounded(d, wd).double()
    assert torch.equal(got, want)
    # bf16 1.0 in each half of an A register.
    regs = {r for lane in gbits.a_fragment(words, j0) for r in lane}
    assert regs <= {0, 0x3F80, 0x3F800000, 0x3F803F80}


def test_mask_words_round_trip():
    rng = np.random.default_rng(4)
    left = torch.from_numpy((rng.random((3, 7, 70)) < 0.5).astype(
        np.float32))
    words = gbits.pack_bits(left)
    assert words.dtype == torch.int32 and words.shape == (3, 7, 3)
    assert torch.equal(gbits.unpack_bits(words, 70), left)
    # Bit j % 32 of word j // 32, the high bit included.
    one = torch.zeros((1, 64))
    one[0, 31] = 1
    assert int(gbits.pack_bits(one)[0, 0]) == -2 ** 31


@pytest.mark.parametrize("wd", DTYPES, ids=["f32", "bf16"])
def test_call_on_the_cpu_runs_the_plain_version(wd):
    """``gbits.gbits`` on CPU tensors: units of ``nrows`` mask rows (the
    head's T + 1, row t = z(t - 1)), stacked replicas too."""
    B, T, J, H = 6, 10, 33, 12
    d, left = _operands(5, B * T, J, H)
    words = torch.zeros((B, T + 1, 2), dtype=torch.int32)
    words[:, :T] = gbits.pack_bits(left.view(B, T, J))
    got = gbits.gbits(d.to(wd), words.view(-1, 2), J, B, T, T + 1, wd)
    assert torch.equal(got, gbits._gbits_reference(d.to(wd), left, wd))
    both = gbits.gbits(torch.stack([d, 2 * d]), torch.stack(
        [words.view(-1, 2)] * 2), J, B, T, T + 1, wd)
    assert both.shape == (2, J, H)
    assert torch.equal(both[0], gbits._gbits_reference(d, left, wd))
    step = gbits.gbits(d, gbits.pack_bits(left), J, T, B, 1, wd,
                       step_major=True)
    assert torch.equal(step, gbits._gbits_reference(d, left, wd))
    with pytest.raises(ValueError):
        gbits.gbits(d, words.view(-1, 2)[:-3], J, B, T, T + 1, wd)


def test_row_ranges_split_the_batch_in_order():
    b0, b1 = gbits._row_ranges(10, 4, "cpu")
    assert b0.tolist() == [0, 2, 5, 7] and b1.tolist() == [2, 5, 7, 10]
    assert gbits.walk_groups(8192, 100, 128, 128, False) == 264
    assert gbits.walk_groups(8192, 100, 512, 512, True) == 16


def test_z_prev_rows_is_the_heads_left_operand():
    rng = np.random.default_rng(6)
    delta = torch.from_numpy(rng.standard_normal((5, 3, 4)).astype(
        np.float32))
    rows = fused.z_prev_rows(delta).view(3, 5, 4)
    assert torch.equal(rows[:, 0], torch.zeros((3, 4)))
    assert torch.equal(rows[:, 1:], (delta[:-1] >= 0).float()
                       .transpose(0, 1))


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alif,spike,use_periods,T", [
    (True, "FastSigmoid", False, 12),
    (True, "FastSigmoid", True, 24),
    (False, "Phi", True, 12),
], ids=["alif-ttfs", "alif-periodic-2blocks", "lif-phi-periodic"])
def test_head_g_w_rec_matches_pallas(alif, spike, use_periods, T, wdtype):
    """The head's g_W_rec in gbits_mma's order (``_head_bwd_ordered_
    reference``: the plain chain's rounded dcur, ``z(t - 1)`` from the
    residuals, 2 row groups) against ``jax.grad`` of ``sum(logits * r)``
    through the JAX kernel pair in interpret mode."""
    B, F, H, O = 5, 30, 20, 10
    rng = np.random.default_rng(11)
    pixels = rng.random((B, F)).astype(np.float32)
    lat = pixels_to_firing_periods(torch.from_numpy(pixels), t_max=float(T),
                                   tau=20.0).contiguous()
    w = {"w_in": (0.5 * rng.standard_normal((F, H))).astype(np.float32),
         "w_rec": ((0.3 * rng.standard_normal((H, H))).astype(np.float32)
                   * (1 - np.eye(H, dtype=np.float32))),
         "w_out": rng.standard_normal((H, O)).astype(np.float32),
         "b_out": (0.1 * rng.standard_normal((O,))).astype(np.float32)}
    r = rng.standard_normal((B, O)).astype(np.float32)
    cfg = (ALIFConfig if alif else LIFConfig)(input_size=F, output_size=H)
    kappa = ReadoutConfig(input_size=H, output_size=O).kappa
    beta = 1.6 if alif else 0.0
    scalars = (T, use_periods, alif, cfg.alpha, cfg.rho if alif else 0.0,
               cfg.threshold, cfg.gamma, kappa)

    def loss(w_rec):
        cast = {k: jnp.asarray(v).astype("float32" if k == "b_out"
                                         else wdtype) for k, v in w.items()}
        out = jfused.fused_encode_rec_scan_head(
            jnp.asarray(lat.numpy()), cast["w_in"], w_rec.astype(wdtype),
            jnp.float32(beta), cast["w_out"], cast["b_out"], *scalars,
            JSpike[spike], True)
        return jnp.sum(out * r)

    want = np.asarray(jax.grad(loss)(jnp.asarray(w["w_rec"]))).astype(
        np.float32)
    wd = getattr(torch, wdtype)
    t = {k: torch.from_numpy(v).to(torch.float32 if k == "b_out" else wd)
         for k, v in w.items()}
    _, delta, _, tstar, _ = fused._head_train_reference(
        lat, t["w_in"], t["w_rec"], beta, t["w_out"], t["b_out"], T,
        use_periods, alif, cfg.alpha, cfg.rho if alif else 0.0,
        cfg.threshold, kappa, True, False, False)
    order = dict(groups_in=2, rows_in=1, groups_out=2, rows_out=1,
                 groups_rec=2)
    got = fused._head_bwd_ordered_reference(
        torch.from_numpy(r), None, tstar, delta, None, lat, t["w_in"],
        t["w_rec"], beta, t["w_out"], T, use_periods, cfg.alpha,
        cfg.threshold, cfg.gamma, kappa, SpikeFuncType[spike], order)[1]
    assert got.dtype == wd
    scale = float(np.abs(want).max())
    bar = 2.0 ** -7 if wdtype == "bfloat16" else 2e-6
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               atol=bar, rtol=0)
