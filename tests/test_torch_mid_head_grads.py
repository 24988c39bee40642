"""Gradients of the mid layer's head mode (``fused_mid_{rec,ff}_scan_head[_counts]``) through the port's
``autograd.Function`` (plain versions on the CPU) against ``jax.grad``
through the JAX kernel pair in interpret mode (``pallas_fused_mid``).
Cases, inputs, bars and the test's body: tests/test_torch_mid.py
(``check_mid_gradients``); the kinds of one test stand in two files so
that the test runner's workers, which take whole files, spread them.
"""
import pytest

pytest.importorskip("torch")

from test_torch_mid import GRID, IDS, check_mid_gradients  # noqa: E402


@pytest.mark.parametrize("kind", ["head", "counts"])
@pytest.mark.parametrize("case,T,wd", GRID, ids=IDS)
def test_mid_gradients_match_the_jax_kernel(case, T, wd, kind):
    """``g_z_in`` and the weights' gradients through the port's
    ``autograd.Function`` against ``jax.grad`` through the kernel pair."""
    check_mid_gradients(case, T, wd, kind)
