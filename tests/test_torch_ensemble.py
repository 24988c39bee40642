"""The port's multi-seed ensemble (parallel/ensemble.py) on the CPU: against
the JAX package's ``EnsembleTrainer`` from the same stacked params
(carried across by ``params_from_jax``), and its own contracts --
checkpoints, resume, early stopping, per-replica clipping.

Sizes: 30-16-4 (ALIF recurrent, learn_beta, or LIF), T = 12, three seeds,
batches of 16.  Tolerances: per-seed losses 1e-5 over three steps and
parameters 1e-5 of max|p| (float32 sums in another order; Adam divides by
sqrt(v)), as tests/test_torch_train.py; probabilities 1e-5; a 2-epoch fit's
per-seed histories 1e-4 (two epochs of steps); predictions and best epochs
equal.  The port's own contracts hold bit for bit.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from snnimageclassification_tpu.data import datasets as jdata  # noqa: E402
from snnimageclassification_tpu.models.config import (  # noqa: E402
    SNNConfig as JConfig,
)
from snnimageclassification_tpu.parallel import ensemble as jens  # noqa: E402
import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import convert  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as tsnn  # noqa: E402
from snnimageclassification_tpu_torch.parallel import ensemble as tens  # noqa: E402
from snnimageclassification_tpu_torch.train import (  # noqa: E402
    LoadCheckpointMode,
    MaskedAdam,
)
from snnimageclassification_tpu_torch.train.checkpoint import (  # noqa: E402
    copy_tree_,
)

F, H, O, T, BATCH = 30, 16, 4, 12, 16
SEEDS = (0, 1, 2)


def _cfgs(layer="ALIF"):
    kw = dict(input_size=F, output_size=O, n_hidden_neurons=H,
              hidden_layer_type=layer, use_recurrent_connection=True,
              int_time_steps=T)
    if layer == "ALIF":
        kw["learn_beta"] = True
    return JConfig(**kw), tst.SNNConfig(**kw)


def _data(n=72, seed=0):
    """A learnable task: O prototypes plus noise."""
    rng = np.random.default_rng(seed)
    protos = rng.random((O, F)).astype(np.float32)
    y = rng.integers(0, O, n).astype(np.int32)
    x = np.clip(protos[y] + 0.2 * rng.standard_normal((n, F)), 0, 1)
    return x.astype(np.float32), y


def _enc(per=False):
    return (jdata.EncodeConfig(n_steps=T, use_periods=per),
            tst.EncodeConfig(n_steps=T, use_periods=per))


def _pair(layer="ALIF", j_fused=None, t_fused=None, **kw):
    """A JAX and a port trainer from the same stacked params."""
    jcfg, tcfg = _cfgs(layer)
    jtr = jens.EnsembleTrainer(jcfg, SEEDS, fused_replicas=j_fused, **kw)
    ttr = tens.EnsembleTrainer(tcfg, SEEDS, fused_replicas=t_fused,
                               device="cpu", **kw)
    copy_tree_(ttr.params, convert.params_from_jax(jax.device_get(jtr.params),
                                                   device="cpu"))
    return jtr, ttr


def _close_params(tparams, jparams, tol, label):
    jp = jax.device_get(jparams)
    for n, g in tparams.items():
        for k, v in g.items():
            want = np.asarray(jp[n][k], np.float32)
            scale = max(float(np.abs(want).max()), 1e-12)
            np.testing.assert_allclose(v.detach().numpy() / scale,
                                       want / scale, atol=tol, rtol=0,
                                       err_msg=f"{label} {n}.{k}")


@pytest.mark.parametrize("t_fused,j_fused", [
    ("stacked", "stacked"), (False, False), (None, None)],
    ids=["stacked", "general", "default"])
def test_three_steps_match_the_jax_ensemble(t_fused, j_fused):
    """Per-seed losses and params of three steps (a weight-0 padding row in
    the last batch).  On the CPU the JAX package's "stacked" falls back to
    its per-replica path (a warning) and the port's runs the stacked plain
    version: the same function."""
    jtr, ttr = _pair(j_fused=j_fused, t_fused=t_fused)
    jenc, tenc = _enc()
    step = jtr._steps_for(jenc).train
    x, y = _data(3 * BATCH, seed=1)
    for i in range(3):
        xb, yb = x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]
        w = np.ones(BATCH, np.float32)
        if i == 2:
            w[-1] = 0.0
        jtr.params, jtr.opt_state, jl = step(jtr.params, jtr.opt_state, xb,
                                             yb, w)
        tl = ttr.train_step(xb, yb, w, tenc)
        assert tuple(tl.shape) == (len(SEEDS),)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5, err_msg=f"step {i}")
    _close_params(ttr.params, jtr.params, 1e-5, "after 3 steps")
    jb = np.asarray(jax.device_get(jtr.params)["input"]["beta"])
    assert np.array_equal(ttr.params["input"]["beta"].numpy(), jb)


def test_predictions_match_the_jax_ensemble():
    jtr, ttr = _pair("LIF")
    jenc, tenc = _enc(per=True)
    x, _ = _data(20, seed=2)
    want = np.asarray(jtr.predict_proba(x, jenc))
    got = ttr.predict_proba(x, tenc).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    per_seed = ttr.predict_proba(x, tenc, reduce=None)
    assert tuple(per_seed.shape) == (len(SEEDS), 20, O)
    for method in ("mean_proba", "vote"):
        np.testing.assert_array_equal(ttr.predict(x, tenc, method=method),
                                      jtr.predict(x, jenc, method=method))
    with pytest.raises(ValueError, match="method"):
        ttr.predict(x, tenc, method="median")
    with pytest.raises(ValueError, match="reduce"):
        ttr.predict_proba(x, tenc, reduce="max")


def test_majority_vote_ties_go_to_the_lowest_label():
    preds = np.array([[2, 1, 0, 3], [1, 1, 3, 3], [2, 0, 3, 0],
                      [1, 2, 0, 0]])
    got = tens.majority_vote(preds, 4)
    np.testing.assert_array_equal(got, jens.majority_vote(preds, 4))
    np.testing.assert_array_equal(got, [1, 1, 0, 0])


def _loaders(mod, x, y, enc, seed=0):
    return (mod.ArrayDataLoader(x[:56], y[:56], BATCH, shuffle=True,
                                seed=seed + 1, encode_config=enc),
            mod.ArrayDataLoader(x[56:], y[56:], BATCH, encode_config=enc))


def test_two_epoch_fit_matches_the_jax_ensemble():
    """Histories, best epochs and the installed best params of a 2-epoch
    fit (the JAX fit takes its blocked path, the port its per-epoch loop:
    the same batches, histories and best snapshots)."""
    jtr, ttr = _pair()
    jenc, tenc = _enc()
    x, y = _data()
    jh = jtr.fit(*_loaders(jdata, x, y, jenc), 2, verbose=False)
    th = ttr.fit(*_loaders(tst.data.datasets, x, y, tenc), 2, verbose=False)
    assert len(th) == len(SEEDS)
    for j, t in zip(jh, th):
        for key in ("train", "val"):
            assert len(t[key]) == 2
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(ttr.best_epoch, jtr.best_epoch)
    jtr.load_best()
    ttr.load_best()
    _close_params(ttr.params, jtr.params, 1e-4, "best")


def _trainer(folder=None, layer="ALIF", **kw):
    return tens.EnsembleTrainer(_cfgs(layer)[1], SEEDS, device="cpu",
                                checkpoint_folder=folder, **kw)


def _tloaders(seed=0):
    x, y = _data()
    return _loaders(tst.data.datasets, x, y, _enc()[1], seed)


def _params_equal(a, b):
    return all(torch.equal(v, b[n][k]) for n, g in a.items()
               for k, v in g.items())


def test_checkpoint_roundtrip_and_meta_layout(tmp_path):
    tr = _trainer(str(tmp_path), fused_replicas="stacked")
    tr.fit(*_tloaders(), 2, verbose=False)
    meta = json.loads((tmp_path / "snn_ensemble-checkpoints.json").read_text())
    assert set(meta) == {"best", "epochs", "best_per_seed", "ensemble"}
    assert set(meta["epochs"]) == {"0", "1"}
    assert meta["epochs"]["1"].endswith("snn_ensemble-epoch1.pth")
    assert set(meta["best_per_seed"]) == {str(s) for s in SEEDS}
    assert meta["ensemble"]["seeds"] == list(SEEDS)
    assert set(meta["ensemble"]["history"]) == {"0", "1"}
    payload = tr.ckpt.load_checkpoint(LoadCheckpointMode.LAST_EPOCH)
    assert payload["epoch"] == 1
    assert set(payload["loss"]) == {"train", "val"}
    assert _params_equal(payload["model_state_dict"],
                         {n: {k: v.detach() for k, v in g.items()}
                          for n, g in tr.params.items()})
    other = _trainer(fused_replicas="stacked")
    other.ckpt = tr.ckpt
    other.ckpt.restore(payload, other.params, other.optimizer)
    assert _params_equal(other.params, tr.params)
    hist = tr.ckpt.get_checkpoints_loss_history()
    assert len(hist["train"]) == 2


def test_resume_equals_a_continuous_fit(tmp_path):
    """Two epochs, then a resume from LAST_EPOCH for a third on the same
    loaders (their shuffles advanced), equal a continuous 3-epoch fit bit
    for bit; a resume past the end returns the restored histories."""
    loaders = _tloaders()
    _trainer(str(tmp_path / "r")).fit(*loaders, 2, verbose=False)
    resumed = _trainer(str(tmp_path / "r"))
    hist_r = resumed.fit(*loaders, 3, verbose=False,
                         load_checkpoint_mode=LoadCheckpointMode.LAST_EPOCH)
    whole = _trainer(str(tmp_path / "w"))
    hist_w = whole.fit(*_tloaders(), 3, verbose=False)
    assert [h.to_dict() for h in hist_r] == [h.to_dict() for h in hist_w]
    assert _params_equal(resumed.params, whole.params)
    np.testing.assert_array_equal(resumed.best_epoch, whole.best_epoch)
    assert _params_equal(resumed.best_params, whole.best_params)
    done = _trainer(str(tmp_path / "w"))
    hist_d = done.fit(*_tloaders(), 3, verbose=False,
                      load_checkpoint_mode=LoadCheckpointMode.LAST_EPOCH)
    assert [h.to_dict() for h in hist_d] == [h.to_dict() for h in hist_w]
    assert _params_equal(done.params, whole.params)


def test_overwrite_contract_and_seed_check(tmp_path):
    """Quirk Q5: an existing checkpoint folder needs force_overwrite (then
    it is wiped); a checkpoint of other seeds refuses to resume; a missing
    one downgrades to a fresh fit."""
    _trainer(str(tmp_path)).fit(*_tloaders(), 1, verbose=False)
    with pytest.raises(AssertionError, match="force_overwrite"):
        _trainer(str(tmp_path)).fit(*_tloaders(), 1, verbose=False)
    _trainer(str(tmp_path)).fit(*_tloaders(), 1, verbose=False,
                                force_overwrite=True)
    assert not os.path.exists(tmp_path / "snn_ensemble-epoch1.pth")
    other = tens.EnsembleTrainer(_cfgs()[1], (5, 6, 7), device="cpu",
                                 checkpoint_folder=str(tmp_path))
    with pytest.raises(ValueError, match="seeds"):
        other.fit(*_tloaders(), 2, verbose=False,
                  load_checkpoint_mode=LoadCheckpointMode.LAST_EPOCH)
    fresh = _trainer(str(tmp_path / "none"))
    hist = fresh.fit(*_tloaders(), 1, verbose=False,
                     load_checkpoint_mode=LoadCheckpointMode.BEST_EPOCH)
    assert len(hist[0]["val"]) == 1


def test_early_stopping_with_an_underfull_window_stops_after_epoch_one():
    tr = _trainer()
    hist = tr.fit(*_tloaders(), 4, verbose=False, early_stopping=True)
    assert all(len(h["val"]) == 1 for h in hist)


def test_checkpoint_every_writes_selected_files_and_the_merged_best(tmp_path):
    tr = _trainer(str(tmp_path))
    tr.fit(*_tloaders(), 3, verbose=False, checkpoint_every=2)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["snn_ensemble-best-merged.pth",
                     "snn_ensemble-checkpoints.json",
                     "snn_ensemble-epoch0.pth", "snn_ensemble-epoch2.pth"]
    meta = json.loads((tmp_path / "snn_ensemble-checkpoints.json").read_text())
    assert set(meta["ensemble"]["history"]) == {"0", "1", "2"}
    merged = tr.ckpt.load_best_merged()
    assert merged["best_epoch_per_seed"] == tr.best_epoch.tolist()
    assert _params_equal(merged["model_state_dict"], tr.best_params)
    resumed = _trainer(str(tmp_path))
    resumed.fit(*_tloaders(), 3, verbose=False,
                load_checkpoint_mode=LoadCheckpointMode.LAST_EPOCH)
    assert _params_equal(resumed.best_params, tr.best_params)


def test_per_replica_clipping_equals_separate_optimizers():
    """A stacked MaskedAdam with max_grad_norm clips each replica by its
    own norm: bit for bit S separate MaskedAdams, beta untouched; with
    grad_accum the same."""
    cfg = _cfgs()[1]
    stacked = tens.init_ensemble(cfg, SEEDS, device="cpu")
    labels = tsnn.param_labels(cfg, tens.replica(stacked, 0))
    for p in (stacked,):
        for n, g in p.items():
            for k, v in g.items():
                v.requires_grad_(labels[n][k] == "weight")
    singles = [{n: {k: v[s].detach().clone().requires_grad_(v.requires_grad)
                    for k, v in g.items()} for n, g in stacked.items()}
               for s in range(len(SEEDS))]
    kw = dict(lr=1e-2, max_grad_norm=0.05, grad_accum=2)
    opt = MaskedAdam(stacked, labels, stacked=True, **kw)
    opts = [MaskedAdam(p, labels, **kw) for p in singles]
    rng = np.random.default_rng(0)
    for _ in range(4):
        grads = {n: {k: torch.from_numpy(rng.standard_normal(
            tuple(v.shape)).astype(np.float32) * (1.0 + np.arange(3).reshape(
                (3,) + (1,) * (v.dim() - 1))).astype(np.float32))
            for k, v in g.items()} for n, g in stacked.items()}
        opt.step(grads)
        for s, o in enumerate(opts):
            o.step({n: {k: v[s] for k, v in g.items()}
                    for n, g in grads.items()})
    for s, p in enumerate(singles):
        for n, g in p.items():
            for k, v in g.items():
                assert torch.equal(stacked[n][k][s], v), f"{s} {n}.{k}"
    beta = tens.init_ensemble(cfg, SEEDS, device="cpu")["input"]["beta"]
    assert torch.equal(stacked["input"]["beta"], beta)


def test_ensemble_init_seeds_serving_and_unported_options():
    """Replica i is ``models.init`` at seed i; the server's rows are the
    seed-averaged probabilities; meshes and seed sharding raise."""
    cfg = _cfgs()[1]
    tr = _trainer(fused_replicas="stacked")
    for i, s in enumerate(SEEDS):
        one = tsnn.init(cfg, torch.Generator().manual_seed(s), device="cpu")
        for n, g in one.items():
            for k, v in g.items():
                assert torch.equal(tr.params[n][k][i].detach(), v)
    x, _ = _data(10, seed=3)
    with tr.serve(batch_size=8, device="cpu") as srv:
        got = srv.submit(x).result(timeout=60)
    np.testing.assert_allclose(got, tr.predict_proba(x).numpy(), rtol=0,
                               atol=1e-7)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tens.EnsembleTrainer(cfg, SEEDS, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        tens.EnsembleTrainer(cfg, SEEDS, shard_seeds=True, device="cpu")
    with pytest.raises(ValueError, match="fused_replicas"):
        tens.EnsembleTrainer(cfg, SEEDS, fused_replicas="fast", device="cpu")
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(RuntimeError, match="CUDA"):
            tens.EnsembleTrainer(cfg, SEEDS)


def test_adam_state_from_a_vmapped_optax_state():
    """``adam_state_from_optax`` takes a vmapped state: counts (S,), all
    equal, moments with a leading S."""
    cfg = _cfgs()[1]
    params = tens.init_ensemble(cfg, SEEDS, device="cpu")
    labels = tsnn.param_labels(cfg, tens.replica(params, 0))
    opt = MaskedAdam(params, labels, stacked=True)
    mu = {n: {k: np.full(tuple(v.shape), 0.5, np.float32)
              for k, v in g.items() if k != "beta"}
          for n, g in params.items()}
    convert.adam_state_from_optax(opt, np.array([3, 3, 3]), mu, mu)
    st = convert.adam_state_to_numpy(opt)
    assert st["count"] == 3
    assert st["mu"]["input"]["w_in"].shape == (3, F, H)
    with pytest.raises(ValueError, match="differ"):
        convert.adam_state_from_optax(opt, np.array([3, 4, 3]), mu, mu)
