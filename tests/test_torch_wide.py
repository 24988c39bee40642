"""The unfused tier through the port's dispatch on the CPU, against the JAX
package on identical numpy parameters and inputs.

On the card a recurrent layer too wide for the fused kernels' shared
memory (784-ALIF512-10) takes the encoded input product and the recurrent
scan: ``apply_pixels`` computes the first layer's currents from the
latencies (``encoded_input_matmul``), ``apply`` scans them
(``rec_alif_scan``), and a wide recurrent layer past the first scans the
currents of one ``torch.matmul``.  On the CPU every fused gate passes, so
the tests force that route, as tests/test_pallas_encode.py forces the JAX
one: the fused gates are monkeypatched to False.  The JAX side runs its
own CPU path (encode, then a ``lax.scan`` per layer).

Sizes: ALIF 24-40-4 and 24-16-40-4 (recurrent, learn_beta), T = 24,
B = 6, TTFS and periodic encoding.  Logits and losses within 1e-5,
parameters after three steps within 1e-5 of max|p|, beta bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import snnimageclassification_tpu as jst  # noqa: E402
from snnimageclassification_tpu.data.datasets import (  # noqa: E402
    EncodeConfig as JEnc,
)
from snnimageclassification_tpu.models import snn as jsnn  # noqa: E402
from snnimageclassification_tpu.train import trainer as jtrainer  # noqa: E402
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax,
    params_to_numpy,
)
from snnimageclassification_tpu_torch.ops import fused as tfused  # noqa: E402
from snnimageclassification_tpu_torch.train import trainer as ttrainer  # noqa: E402

B, F, O, T = 6, 24, 4, 24
ENC, REC = "torch:encode_matmul_reference", "torch:rec_scan_reference"
CONFIGS = [  # name, hidden widths, encoding, expected paths
    ("alif-40", 40, dict(), [ENC, REC, "torch:loop"]),
    ("alif-40-periodic", 40, dict(use_periods=True),
     [ENC, REC, "torch:loop"]),
    ("alif-16-40", [16, 40], dict(), [ENC, REC, REC, "torch:loop"]),
]
IDS = [c[0] for c in CONFIGS]


@pytest.fixture
def wide_route(monkeypatch):
    """Every fused gate says no, as at H = 512 on the card."""
    for gate in ("_head_fusible", "_layer0_fusible", "_twolayer_head_fusible",
                 "_deep_head_fusible", "_mid_layer_fusible"):
        monkeypatch.setattr(tsnn, gate, lambda *a, **k: False)


def _pair(widths):
    kw = dict(input_size=F, output_size=O, int_time_steps=T,
              n_hidden_neurons=widths, hidden_layer_type="ALIF",
              learn_beta=True)
    return jst.SNNConfig(**kw), tst.SNNConfig(**kw)


def _params(jcfg, seed=0):
    """JAX-initialised params with every hidden layer's input weights
    scaled up (as tests/test_torch_deep.py) so that the small network
    spikes down to its last layer."""
    jp = jsnn.init(jcfg, jax.random.PRNGKey(seed))
    for i, (name, _) in enumerate(jcfg.layer_configs[:-1]):
        jp[name]["w_in"] = jp[name]["w_in"] * (8.0 if i == 0 else 3.0)
    return jp, jax.tree.map(np.asarray, jax.device_get(jp))


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((B, F)).astype(np.float32),
             rng.integers(0, O, B).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("name,widths,ekw,paths", CONFIGS, ids=IDS)
def test_wide_route_logits_match_jax(wide_route, name, widths, ekw, paths):
    jcfg, tcfg = _pair(widths)
    jp, np_p = _params(jcfg)
    enc = dict(n_steps=T, tau=20.0, **ekw)
    tenc = tst.EncodeConfig(**enc)
    assert [r["path"] for r in tsnn.explain_dispatch(
        tcfg, tenc, device="cpu")] == paths
    x = _batches(1, seed=5)[0][0]
    tp = params_from_jax(np_p, device="cpu")
    tfused.reset_launch_counts()
    with torch.no_grad():
        tl, tc = tsnn.forward_logits_counts_pixels(tcfg, tp, x, tenc,
                                                   device="cpu")
    assert not any(tfused.launch_counts().values())  # no kernel on the CPU
    jl, jc = jsnn.forward_logits_counts_pixels(jcfg, jp, x, JEnc(**enc))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    for k in jc:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        assert float(tc[k].sum()) > 0, f"{k} does not spike"


@pytest.mark.parametrize("name,widths,ekw,paths", CONFIGS, ids=IDS)
def test_wide_route_train_steps_match_the_jax_trainer(wide_route, name,
                                                      widths, ekw, paths,
                                                      tmp_path):
    jcfg, tcfg = _pair(widths)
    jp, np_p = _params(jcfg)
    enc = dict(n_steps=T, tau=20.0, **ekw)
    jt = jtrainer.Trainer(jcfg, checkpoint_folder=str(tmp_path))
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp))
    train_step = jt._build_steps(JEnc(**enc), tx)[0]
    opt_state = tx.init(jp)
    tt = ttrainer.Trainer(tcfg, params=params_from_jax(np_p, device="cpu"),
                          encode_config=tst.EncodeConfig(**enc),
                          device="cpu")
    assert [r["path"] for r in tsnn.explain_dispatch(
        tcfg, tt.enc, device="cpu", training=True)] == paths
    w = np.ones(B, np.float32)
    w[-1] = 0.0  # a padding row
    for i, (x, y) in enumerate(_batches(3, seed=8)):
        jp, opt_state, jloss = train_step(jp, opt_state, jnp.asarray(x),
                                          jnp.asarray(y), jnp.asarray(w))
        tloss = tt.train_step(x, y, w)
        np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {i}")
    want = jax.tree.map(np.asarray, jax.device_get(jp))
    got = params_to_numpy(tt.params)
    for n in want:
        for k in want[n]:
            if k == "beta":
                np.testing.assert_array_equal(got[n][k], np_p[n][k])
                continue
            scale = np.abs(want[n][k]).max()
            np.testing.assert_allclose(got[n][k] / scale, want[n][k] / scale,
                                       atol=1e-5, rtol=0,
                                       err_msg=f"{name} {n}.{k}")
            assert not np.array_equal(got[n][k], np_p[n][k]), f"{n}.{k}"


def test_apply_first_layer_currents_equals_the_raster_path():
    """``apply(first_layer_currents=)`` with the encoded product equals
    ``apply`` on the encoded raster (the loop: no kernel gate involved)."""
    from snnimageclassification_tpu_torch.ops.encode import (
        encoded_input_matmul,
    )
    from snnimageclassification_tpu_torch.ops.encoding import (
        encode_spikes,
        pixels_to_firing_periods,
    )

    _, tcfg = _pair(40)
    cfg = tst.SNNConfig(**{**tcfg.__dict__, "use_kernels": False})
    params = tsnn.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    x = torch.from_numpy(_batches(1, seed=2)[0][0])
    lat = pixels_to_firing_periods(x, t_max=float(T), tau=20.0)
    cur = encoded_input_matmul(lat, params["input"]["w_in"], T, False)
    got, _ = tsnn.apply(cfg, params, None, first_layer_currents=cur,
                        device="cpu")
    want, _ = tsnn.apply(cfg, params, encode_spikes(x, n_steps=T, tau=20.0),
                         device="cpu")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
