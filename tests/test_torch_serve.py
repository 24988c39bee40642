"""The port's InferenceServer on the CPU (``device="cpu"``): the server
cases of tests/test_serve.py that need no mesh -- coalesced fixed-shape
batches, invisible padding, chunking, thread-safe submission, the uint8
wire format, drain on close -- with results equal to the port's direct
``forward_logits_pixels``, plus one check against the JAX server."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import snnimageclassification_tpu_torch as tst  # noqa: E402
from snnimageclassification_tpu_torch.models import snn as model_lib  # noqa: E402
from snnimageclassification_tpu_torch.serve import InferenceServer  # noqa: E402

N_F, N_O = 20, 10
CPU = "cpu"


@pytest.fixture(scope="module")
def cfg():
    return tst.SNNConfig(
        input_size=N_F, output_size=N_O, n_hidden_neurons=16,
        hidden_layer_type=tst.LayerType.ALIF,
        use_recurrent_connection=False, int_time_steps=3,
    )


@pytest.fixture(scope="module")
def params(cfg):
    return model_lib.init(cfg, torch.Generator().manual_seed(0), device=CPU)


def _server(cfg, params, **kw):
    return InferenceServer(cfg, params, device=CPU, **kw)


def _pixels(rng, n):
    return rng.random((n, N_F), dtype=np.float32) if n > 1 else rng.random(
        (N_F,), dtype=np.float32
    )


def _oracle(cfg, params, rows):
    enc = tst.EncodeConfig(n_steps=cfg.int_time_steps)
    return model_lib.forward_logits_pixels(cfg, params, rows, enc,
                                           device=CPU).numpy()


class TestCorrectness:
    def test_single_row_matches_direct(self, cfg, params):
        rng = np.random.default_rng(0)
        x = _pixels(rng, 1)
        with _server(cfg, params, batch_size=8) as srv:
            got = srv.submit(x).result(timeout=60)
        assert got.shape == (N_O,)
        np.testing.assert_allclose(
            got, _oracle(cfg, params, x[None])[0], rtol=1e-5, atol=1e-6
        )

    def test_block_request_matches_direct(self, cfg, params):
        rng = np.random.default_rng(1)
        x = _pixels(rng, 5)
        with _server(cfg, params, batch_size=8) as srv:
            got = srv.submit(x).result(timeout=60)
        assert got.shape == (5, N_O)
        np.testing.assert_allclose(
            got, _oracle(cfg, params, x), rtol=1e-5, atol=1e-6
        )

    def test_oversized_request_chunks(self, cfg, params):
        rng = np.random.default_rng(2)
        x = _pixels(rng, 19)  # 3 chunks at batch_size=8
        with _server(cfg, params, batch_size=8) as srv:
            got = srv.submit(x).result(timeout=60)
            assert srv.stats.batches >= 3
        np.testing.assert_allclose(
            got, _oracle(cfg, params, x), rtol=1e-5, atol=1e-6
        )

    def test_padding_rows_invisible(self, cfg, params):
        rng = np.random.default_rng(3)
        x = _pixels(rng, 3)
        with _server(cfg, params, batch_size=8, max_delay_s=0.01) as srv:
            got = srv.submit(x).result(timeout=60)
        padded = np.zeros((8, N_F), np.float32)
        padded[:3] = x
        np.testing.assert_array_equal(got, _oracle(cfg, params, padded)[:3])

    def test_classify(self, cfg, params):
        rng = np.random.default_rng(4)
        x = _pixels(rng, 4)
        with _server(cfg, params, batch_size=8) as srv:
            labels = srv.classify(x)
        np.testing.assert_array_equal(
            labels, np.argmax(_oracle(cfg, params, x), axis=-1)
        )

    def test_matches_jax_server(self):
        """The same params served by both packages agree to 1e-5."""
        import jax

        import snnimageclassification_tpu as jst
        from snnimageclassification_tpu.models import snn as jsnn
        from snnimageclassification_tpu.serve import (
            InferenceServer as JaxServer,
        )
        from snnimageclassification_tpu_torch.models.convert import (
            params_from_jax,
        )

        kw = dict(input_size=N_F, output_size=N_O, n_hidden_neurons=16,
                  use_recurrent_connection=True, int_time_steps=12)
        jcfg = jst.SNNConfig(hidden_layer_type=jst.LayerType.ALIF,
                             learn_beta=True, **kw)
        tcfg = tst.SNNConfig(hidden_layer_type=tst.LayerType.ALIF,
                             learn_beta=True, **kw)
        jp = jsnn.init(jcfg, jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jax.device_get(jp)),
                             device=CPU)
        raw = np.random.default_rng(5).integers(0, 256, size=(6, N_F),
                                                dtype=np.uint8)
        with JaxServer(jcfg, jp, batch_size=8, input_dtype=np.uint8) as js:
            want = js.submit(raw).result(timeout=120)
        with InferenceServer(tcfg, tp, batch_size=8, input_dtype=np.uint8,
                             device=CPU) as ts:
            got = ts.submit(raw).result(timeout=60)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


class TestUint8Wire:
    def test_uint8_matches_float_server_bitwise(self, cfg, params):
        rng = np.random.default_rng(7)
        raw = rng.integers(0, 256, size=(5, N_F), dtype=np.uint8)
        with _server(cfg, params, batch_size=8, input_dtype=np.uint8) as srv:
            got = srv.submit(raw).result(timeout=60)
        want = _oracle(cfg, params,
                       raw.astype(np.float32) / np.float32(255.0))
        np.testing.assert_array_equal(got, want)

    def test_uint8_single_row_and_padding(self, cfg, params):
        rng = np.random.default_rng(8)
        raw = rng.integers(0, 256, size=(N_F,), dtype=np.uint8)
        with _server(cfg, params, batch_size=8, input_dtype=np.uint8) as srv:
            got = srv.submit(raw).result(timeout=60)
        assert got.shape == (N_O,)
        want = _oracle(cfg, params,
                       raw[None].astype(np.float32) / np.float32(255.0))[0]
        np.testing.assert_array_equal(got, want)

    def test_uint8_accepts_wider_ints(self, cfg, params):
        raw = np.arange(N_F, dtype=np.int64) % 256
        with _server(cfg, params, batch_size=8, input_dtype=np.uint8) as srv:
            got = srv.submit(raw).result(timeout=60)
        assert got.shape == (N_O,)

    def test_uint8_rejects_floats_and_out_of_range(self, cfg, params):
        with _server(cfg, params, batch_size=8, input_dtype=np.uint8) as srv:
            with pytest.raises(ValueError, match="uint8 raw bytes"):
                srv.submit(np.zeros(N_F, dtype=np.float32))
            with pytest.raises(ValueError, match="out of uint8 range"):
                srv.submit(np.full(N_F, 300, dtype=np.int32))

    def test_custom_scale_float_server(self, cfg, params):
        rng = np.random.default_rng(9)
        x = (16.0 * rng.random((3, N_F))).astype(np.float32)
        with _server(cfg, params, batch_size=8, input_scale=16.0) as srv:
            got = srv.submit(x).result(timeout=60)
        np.testing.assert_array_equal(
            got, _oracle(cfg, params, x / np.float32(16.0)))

    def test_bad_input_dtype_rejected(self, cfg, params):
        with pytest.raises(ValueError, match="input_dtype"):
            _server(cfg, params, input_dtype=np.float64)


class TestConcurrency:
    def test_many_threads_all_correct(self, cfg, params):
        rng = np.random.default_rng(5)
        reqs = [_pixels(rng, int(n)) for n in rng.integers(1, 7, size=24)]
        results = [None] * len(reqs)
        with _server(cfg, params, batch_size=16, max_delay_s=0.005) as srv:
            def worker(i):
                results[i] = srv.submit(reqs[i]).result(timeout=60)

            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            snap = srv.stats.snapshot()
        assert snap["requests"] == len(reqs)
        assert snap["rows"] == sum(
            1 if r.ndim == 1 else r.shape[0] for r in reqs)
        assert 0.0 < snap["occupancy"] <= 1.0
        assert snap["latency_p99_s"] >= snap["latency_p50_s"] >= 0.0
        for req, got in zip(reqs, results):
            rows = req[None] if req.ndim == 1 else req
            np.testing.assert_allclose(
                got if got.ndim == 2 else got[None],
                _oracle(cfg, params, rows), rtol=1e-5, atol=1e-6)

    def test_coalescing_fills_batches(self, cfg, params):
        rng = np.random.default_rng(6)
        with _server(cfg, params, batch_size=16, max_delay_s=0.05) as srv:
            futs = [srv.submit(_pixels(rng, 2)) for _ in range(16)]
            for f in futs:
                f.result(timeout=60)
            assert srv.stats.batches <= 4  # 32 rows / 16-row batches (+slack)


class TestLifecycle:
    def test_submit_after_close_raises(self, cfg, params):
        srv = _server(cfg, params, batch_size=4)
        srv.close()
        with pytest.raises(RuntimeError):
            srv.submit(np.zeros(N_F, np.float32))

    def test_close_drains_pending(self, cfg, params):
        rng = np.random.default_rng(7)
        srv = _server(cfg, params, batch_size=4, max_delay_s=5.0)
        fut = srv.submit(_pixels(rng, 2))
        srv.close(drain=True)  # must not wait the 5 s delay
        assert fut.result(timeout=1).shape == (2, N_O)

    def test_close_without_drain_fails_pending(self, cfg, params):
        rng = np.random.default_rng(8)
        srv = _server(cfg, params, batch_size=64, max_delay_s=30.0)
        fut = srv.submit(_pixels(rng, 2))
        srv.close(drain=False)
        with pytest.raises(RuntimeError):
            fut.result(timeout=1)

    def test_close_idempotent(self, cfg, params):
        srv = _server(cfg, params, batch_size=4)
        srv.close()
        srv.close()

    def test_cancelled_future_does_not_wedge_server(self, cfg, params):
        rng = np.random.default_rng(10)
        with _server(cfg, params, batch_size=4, max_delay_s=0.2) as srv:
            fut = srv.submit(_pixels(rng, 2))
            assert fut.cancel()  # pending (dispatcher still coalescing)
            x = _pixels(rng, 3)
            got = srv.submit(x).result(timeout=60)
        np.testing.assert_allclose(got, _oracle(cfg, params, x), rtol=1e-5,
                                   atol=1e-6)

    def test_bad_shape_rejected(self, cfg, params):
        with _server(cfg, params, batch_size=4) as srv:
            with pytest.raises(ValueError):
                srv.submit(np.zeros((2, N_F + 1), np.float32))
            with pytest.raises(ValueError):
                srv.submit(np.zeros((1, 2, 3), np.float32))

    def test_forward_failure_fails_the_batch(self, cfg, params):
        def broken(p, x):
            raise RuntimeError("boom")

        with _server(cfg, params, batch_size=4, forward_fn=broken) as srv:
            with pytest.raises(RuntimeError, match="boom"):
                srv.submit(np.zeros(N_F, np.float32)).result(timeout=60)


class TestForwardFnAndValidation:
    def test_invalid_input_scale_rejected(self, cfg, params):
        for bad in (0.0, -1.0, float("nan"), float("inf")):
            with pytest.raises(ValueError, match="input_scale"):
                _server(cfg, params, batch_size=4, input_scale=bad)

    def test_invalid_batch_size_rejected(self, cfg, params):
        with pytest.raises(ValueError, match="batch_size"):
            _server(cfg, params, batch_size=0)

    def test_custom_forward_fn(self, cfg, params):
        enc = tst.EncodeConfig(n_steps=cfg.int_time_steps)

        def fwd(p, x):  # softmax probabilities instead of logits
            return torch.softmax(model_lib.forward_logits_pixels(
                cfg, p, x, enc, device=CPU), dim=-1)

        rng = np.random.default_rng(7)
        x = _pixels(rng, 5)
        with _server(cfg, params, batch_size=8, forward_fn=fwd) as srv:
            got = srv.submit(x).result(timeout=60)
        want = torch.softmax(torch.from_numpy(_oracle(cfg, params, x)),
                             dim=-1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


class TestOwnParameters:
    """The server keeps a copy of the parameters and serves without a
    gradient, as the JAX server, whose arrays are immutable, does."""

    def test_served_logits_do_not_follow_the_trainer(self, cfg):
        from snnimageclassification_tpu_torch.train import Trainer

        enc = tst.EncodeConfig(n_steps=cfg.int_time_steps)
        trainer = Trainer(cfg, seed=0, encode_config=enc, device=CPU)
        rng = np.random.default_rng(3)
        x = _pixels(rng, 8)
        y = rng.integers(0, N_O, 8)
        seen = []

        def forward(p, rows):
            out = model_lib.forward_logits_pixels(cfg, p, rows, enc,
                                                  device=CPU)
            seen.append((torch.is_grad_enabled(), out.requires_grad))
            return out

        with _server(cfg, trainer.params, batch_size=8,
                     forward_fn=forward) as srv:
            assert all(
                srv.params[n][k].data_ptr() != v.data_ptr()
                and not srv.params[n][k].requires_grad
                for n, g in trainer.params.items() for k, v in g.items())
            before = srv.submit(x).result(timeout=60)
            for _ in range(3):
                trainer.train_step(x, y)
            after = srv.submit(x).result(timeout=60)
            with torch.no_grad():
                moved = model_lib.forward_logits_pixels(
                    cfg, trainer.params, x, enc, device=CPU).numpy()
        np.testing.assert_array_equal(before, after)
        assert not np.allclose(moved, before)  # the trainer did move
        assert seen == [(False, False), (False, False)]
