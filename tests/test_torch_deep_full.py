"""784-ALIF128-ALIF128-10 (``bench.py``'s twolayer leg) trained at full
width, T = 100, by the port's ``Trainer`` and by the JAX package's trainer
from the same init on the CPU: the first losses agree and the loss falls in
both.  Kept in a file of its own (it is the longest of the deep-network
tests), so that the test runner's workers, which take whole files, spread
it apart from tests/test_torch_deep.py.
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
from snnimageclassification_tpu_torch.models.convert import (  # noqa: E402
    params_to_numpy,
)
from snnimageclassification_tpu_torch.train import trainer as ttrainer  # noqa: E402


def test_full_width_two_layer_training_falls_in_both_trainers(tmp_path):
    """784-ALIF128-ALIF128-10, T = 100, on ``chip_smoke.py``'s prototype
    task (B = 128) from the port's seed-0 init in both trainers at lr 3e-4:
    the first losses agree and the loss falls in both over 12 steps.  (With
    B = 8192 at this lr it falls for four steps and then climbs on the card,
    through the per-step loop as through the pair: ROADMAP.md Queue 3;
    chip_smoke.py's phase 13 trains at 3e-5.)"""
    kw = dict(input_size=784, output_size=10, n_hidden_neurons=[128, 128],
              hidden_layer_type="ALIF", learn_beta=True, int_time_steps=100)
    jcfg, tcfg = jst.SNNConfig(**kw), tst.SNNConfig(**kw)
    rng = np.random.default_rng(3)
    protos = rng.random((10, 784), dtype=np.float32)
    batches = []
    for _ in range(4):
        y = rng.integers(0, 10, 128)
        x = np.clip(protos[y] + 0.15 * rng.standard_normal(
            (128, 784), dtype=np.float32), 0.0, 1.0)
        batches.append((x, y.astype(np.int32)))
    enc = dict(n_steps=100)
    tt = ttrainer.Trainer(tcfg, seed=0, lr=3e-4, weight_decay=1e-5,
                          encode_config=tst.EncodeConfig(**enc), device="cpu")
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tt.params))
    jt = jtrainer.Trainer(jcfg, checkpoint_folder=str(tmp_path))
    tx = jtrainer.make_optimizer(jsnn.param_labels(jcfg, jp), lr=3e-4,
                                 weight_decay=1e-5)
    step = jt._build_steps(JEnc(**enc), tx)[0]
    opt_state = tx.init(jp)
    w = jnp.ones(128)
    jl, tl = [], []
    for i in range(12):
        x, y = batches[i % 4]
        jp, opt_state, loss = step(jp, opt_state, jnp.asarray(x),
                                   jnp.asarray(y), w)
        jl.append(float(loss))
        tl.append(float(tt.train_step(x, y)))
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    for losses in (jl, tl):
        assert np.mean(losses[-4:]) < 0.75 * np.mean(losses[:4]), losses
