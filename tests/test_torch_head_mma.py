"""CPU twins of the head kernel pair's tensor-core body (ops/head_mma.py).

Torch only, no JAX: the arithmetic the CUDA body relies on, checked where a
CPU can check it.

* The bf16 split of a float32 operand: the three pieces are bf16 values and
  sum back to the operand exactly.  The products the kernels take from
  them: for a 0/1 left operand (the forward's spikes) three products equal
  the float32 weights' product exactly (in float64); for a float32 left
  operand (the backward's dcur) the six products of PRODUCT_TERMS are
  within 2**-22 of sum |a| |w| of the float64 product, where the three
  largest alone are off by about 2**-16.
* The per-row feature lists of ``head_sort_kernel``: at T = 1, 2, 23, 24
  and 100, TTFS and periodic, the runs a step reads (``step_runs``, plus
  the run of period 1 at t >= 1 under periodic encoding) list exactly the
  features that fire at that step (``fires(L, t, T, periodic)``), each once,
  ascending f within a run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snnimageclassification_tpu_torch.ops import head_mma  # noqa: E402


def _wide_floats(rng, shape):
    """float32 normals with exponents spread over 2**-30 .. 2**30."""
    mant = rng.standard_normal(shape)
    return torch.from_numpy(
        (mant * 2.0 ** rng.integers(-30, 31, shape)).astype(np.float32))


def test_split_pieces_sum_back_exactly():
    x = _wide_floats(np.random.default_rng(0), (4096,))
    pieces = head_mma.split_pieces(x)
    for p in pieces:
        assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)
    total = sum(p.double() for p in pieces)
    assert torch.equal(total, x.double())
    # Each piece is at most 2**-8 of the one before (round to nearest).
    assert bool((pieces[1].abs() <= pieces[0].abs() * 2.0 ** -8).all())
    assert bool((pieces[2].abs() <= pieces[1].abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("k,n", [(128, 128), (20, 20), (128, 16)])
def test_split_product_of_spikes_is_exact(k, n):
    rng = np.random.default_rng(1)
    z = torch.from_numpy((rng.random((16, k)) < 0.47).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    got = head_mma.split_matmul(z, w, exact_a=True)
    assert torch.equal(got, z.double() @ w.double())


@pytest.mark.parametrize("k", [16, 128, 256])
def test_split_product_of_a_float_operand(k):
    rng = np.random.default_rng(2)
    a = _wide_floats(rng, (16, k)) * 1e-3
    w = torch.from_numpy((0.1 * rng.standard_normal((k, 128)))
                         .astype(np.float32))
    want = a.double() @ w.double()
    scale = a.double().abs() @ w.double().abs()
    six = (head_mma.split_matmul(a, w, exact_a=False) - want).abs() / scale
    three = (head_mma.split_matmul(
        a, w, exact_a=False, terms=((1, 0), (0, 1), (0, 0))) - want
    ).abs() / scale
    assert float(six.max()) <= 2.0 ** -22
    assert float(three.max()) >= 2.0 ** -20  # why the kernels take six


def _fires(L, t, T, periodic):
    """head_common.cuh:fires in Python integers."""
    if not periodic:
        return L == t
    p = min(max(L, 1), T - 1)
    d = t - p
    if d < 0:
        return False
    return True if p <= 0 else d % p == 0


@pytest.mark.parametrize("periodic", [False, True], ids=["ttfs", "periodic"])
@pytest.mark.parametrize("T", [1, 2, 23, 24, 100])
def test_step_runs_list_exactly_the_firing_features(T, periodic):
    rng = np.random.default_rng(T)
    B, F = 6, 53
    lat = rng.integers(-2, T + 3, (B, F))
    lat[0] = 0  # every feature at latency 0 (period 1: every step)
    lat[1] = T  # none fires under TTFS
    lat = torch.from_numpy(lat.astype(np.int32))
    lists = head_mma.head_lists(lat, T, periodic)
    assert lists.shape == (B, head_mma.list_row_words(F))
    for b in range(B):
        row = lists[b]
        every = head_mma.every_step_run(row, F, T, periodic)
        for t in range(T):
            runs = head_mma.step_runs(row, F, t, T, periodic)
            if every is not None and t >= 1:
                runs = [every] + runs
            got = []
            for s, e in runs:
                run = row[s:e].tolist()
                assert run == sorted(run) and len(run) == e - s > 0
                got += run
            want = [f for f in range(F)
                    if _fires(int(lat[b, f]), t, T, periodic)]
            assert len(got) == len(set(got))
            assert sorted(got) == want, (b, t)
