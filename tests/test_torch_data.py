"""The port's data layer (data/datasets.py, data/device_cache.py) against the
JAX package's on the CPU: the same arrays from the same files or the same
synthetic generator, and the same batches index for index (both draw the
order from ``np.random.default_rng(seed)``).  Everything is compared for
equality: these are integer indices and copies of the same numbers.
"""
import gzip
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from snnimageclassification_tpu.data import datasets as jdata  # noqa: E402
from snnimageclassification_tpu.data import device_cache as jcache  # noqa: E402
from snnimageclassification_tpu_torch.data import (  # noqa: E402
    datasets as tdata,
)
from snnimageclassification_tpu_torch.data import (  # noqa: E402
    device_cache as tcache,
)


@pytest.fixture
def no_local_files(tmp_path, monkeypatch):
    """Both packages look only in an empty folder (the synthetic
    fallback)."""
    monkeypatch.delenv(tdata.DATA_DIR_ENV, raising=False)
    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, "_candidate_roots",
                            lambda data_dir, p=tmp_path: [p])
    return tmp_path


def _write_idx(path, arr, gz=False):
    code = {np.dtype(np.uint8): 0x08, np.dtype(np.int32): 0x0C}[arr.dtype]
    head = struct.pack("BBBB", 0, 0, code, arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    data = head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    (gzip.open if gz else open)(path, "wb").write(data)


@pytest.mark.parametrize("dataset", ["MNIST", "FASHION_MNIST"])
def test_synthetic_fallback_and_loaders_match_jax(no_local_files, dataset):
    kw = dict(batch_size=100, train_val_split_ratio=0.8, seed=3)
    jl = jdata.get_dataloaders(jdata.DatasetId[dataset], **kw)
    tl = tdata.get_dataloaders(tdata.DatasetId[dataset], **kw)
    for split in ("train", "val", "test"):
        j, t = jl[split], tl[split]
        assert t.source == j.source == "synthetic"
        assert np.array_equal(t.x, j.x) and np.array_equal(t.y, j.y)
        assert t.encode_config.n_steps == j.encode_config.n_steps
        assert len(t) == len(j)
        for _ in range(3):  # three epochs: the shuffles advance together
            ti, ji = list(t.iter_indices()), list(j.iter_indices())
            assert len(ti) == len(ji)
            for a, b in zip(ti, ji):
                np.testing.assert_array_equal(a, b)
        for (tx, ty), (jx, jy) in zip(t, j):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("drop_last", [False, True])
def test_array_loader_order_matches_jax(drop_last):
    rng = np.random.default_rng(0)
    x = rng.random((53, 7)).astype(np.float32)
    y = rng.integers(0, 3, 53).astype(np.int32)
    j = jdata.ArrayDataLoader(x, y, 8, shuffle=True, drop_last=drop_last,
                              seed=9)
    t = tdata.ArrayDataLoader(x, y, 8, shuffle=True, drop_last=drop_last,
                              seed=9)
    assert len(t) == len(j) == (6 if drop_last else 7)
    for _ in range(2):
        for a, b in zip(t.iter_indices(), j.iter_indices()):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tdata.ArrayDataLoader(x, y[:5], 8)


def test_idx_and_npz_files_read_as_jax_reads_them(tmp_path, monkeypatch):
    monkeypatch.delenv(tdata.DATA_DIR_ENV, raising=False)
    rng = np.random.default_rng(1)
    folder = tmp_path / "mnist"
    folder.mkdir()
    imgs = rng.integers(0, 256, (12, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 12).astype(np.uint8)
    _write_idx(folder / "train-images-idx3-ubyte", imgs)
    _write_idx(folder / "train-labels-idx1-ubyte.gz", labels, gz=True)
    _write_idx(folder / "t10k-images-idx3-ubyte", imgs[:4])
    _write_idx(folder / "t10k-labels-idx1-ubyte", labels[:4])
    np.testing.assert_array_equal(
        tdata.read_idx(folder / "train-images-idx3-ubyte"), imgs)
    np.testing.assert_array_equal(
        tdata.read_idx(folder / "train-labels-idx1-ubyte.gz"),
        jdata.read_idx(folder / "train-labels-idx1-ubyte.gz"))
    t = tdata.load_raw(tdata.DatasetId.MNIST, str(tmp_path),
                       allow_synthetic=False)
    j = jdata.load_raw(jdata.DatasetId.MNIST, str(tmp_path),
                       allow_synthetic=False)
    assert t["source"] == j["source"] == str(folder)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(t[k], j[k])
    npz = tmp_path / "npz"
    npz.mkdir()
    np.savez(npz / "fashion_mnist.npz", x_train=imgs, y_train=labels,
             x_test=imgs[:3], y_test=labels[:3])
    t = tdata.load_raw(tdata.DatasetId.FASHION_MNIST, str(npz),
                       allow_synthetic=False)
    j = jdata.load_raw(jdata.DatasetId.FASHION_MNIST, str(npz),
                       allow_synthetic=False)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(t[k], j[k])
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x00\x08\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="magic"):
        tdata.read_idx(bad)


def test_no_files_without_synthetic_raises(no_local_files):
    with pytest.raises(FileNotFoundError):
        tdata.load_raw(tdata.DatasetId.MNIST, allow_synthetic=False)


def test_digits_match_jax():
    pytest.importorskip("sklearn")
    t = tdata.load_raw(tdata.DatasetId.DIGITS)
    j = jdata.load_raw(jdata.DatasetId.DIGITS)
    assert t["source"] == j["source"] == "sklearn:load_digits"
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(t[k], j[k])


def test_digits_without_sklearn_fall_back_to_synthetic(monkeypatch):
    """Where scikit-learn is missing (the card's machine), DIGITS is the
    synthetic set at its own 8 x 8 size, loudly labelled."""
    monkeypatch.setattr(tdata, "_load_digits_raw", lambda: None)
    raw = tdata.load_raw(tdata.DatasetId.DIGITS, synthetic_train=50,
                         synthetic_test=10)
    assert raw["source"] == "synthetic"
    assert raw["x_train"].shape == (50, 64) and raw["x_test"].shape == (10, 64)
    with pytest.raises(FileNotFoundError):
        tdata.load_raw(tdata.DatasetId.DIGITS, allow_synthetic=False)


def test_pad_rows_and_device_cache_batches_match_jax():
    for n, target in ((5, 8), (8, 8), (9, 8)):
        idx = np.arange(n)[::-1].copy()
        for a, b in zip(tcache.pad_rows(idx, target),
                        jcache.pad_rows(idx, target)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    x = rng.random((21, 6)).astype(np.float32)
    y = rng.integers(0, 4, 21).astype(np.int32)
    loader = tdata.ArrayDataLoader(x, y, 8, shuffle=True, seed=4)
    twin = tdata.ArrayDataLoader(x, y, 8, shuffle=True, seed=4)
    cache = tcache.DeviceDataCache()
    assert cache.fits(loader)
    assert not tcache.DeviceDataCache(limit_bytes=10).fits(loader)
    dev = torch.device("cpu")
    for (bx, by, bw), idx in zip(cache.batches(loader, dev),
                                 twin.iter_indices()):
        padded, w = jcache.pad_rows(np.asarray(idx), 8)
        assert tuple(bx.shape) == (8, 6)
        np.testing.assert_array_equal(bx.numpy(), x[padded])
        np.testing.assert_array_equal(by.numpy(), y[padded])
        np.testing.assert_array_equal(bw.numpy(), w)
    assert cache.arrays(loader, dev)[0] is cache.arrays(loader, dev)[0]
