"""Port parity of the data plane: MNIST/FashionMNIST idx files, RecordIO
and its prefetching iterator, the prefetch thread and the device-cached
loader (geomx_tpu_torch vs geomx_tpu on the same files and arrays).

Everything is exact: the readers' arrays, the RecordIO bytes (both
ways), the iterator's batches and the loaders' batches must be equal.
The device-cached loader's augmentation draws from a torch generator,
not ``jax.random``, so its crops are held by their properties instead:
each is a window of the reflect-padded image at an offset in ``[0,
2p]``, flipped or not.  Files are written from seeded numpy arrays into
``tmp_path``; nothing is downloaded.
"""

import gzip
import inspect
import os
import struct

import numpy as np
import pytest
import torch

from geomx_tpu import HiPSTopology as JaxTopology
from geomx_tpu.config import GeoConfig as JaxConfig
from geomx_tpu.data import datasets as jax_datasets
from geomx_tpu.data import record_iter as jax_record_iter
from geomx_tpu.data import recordio as jax_recordio
from geomx_tpu.data.loader import GeoDataLoader as JaxLoader
from geomx_tpu_torch import GeoConfig, HiPSTopology
from geomx_tpu_torch.data import datasets, record_iter, recordio
from geomx_tpu_torch.data.loader import GeoDataLoader


def _write_idx(d, prefix, x, y, gz):
    os.makedirs(d, exist_ok=True)
    op = (lambda p: gzip.open(p + ".gz", "wb")) if gz \
        else (lambda p: open(p, "wb"))
    n, h, w = x.shape[:3]
    with op(os.path.join(d, f"{prefix}-images-idx3-ubyte")) as f:
        f.write(struct.pack(">IIII", 2051, n, h, w) + x.tobytes())
    with op(os.path.join(d, f"{prefix}-labels-idx1-ubyte")) as f:
        f.write(struct.pack(">II", 2049, n) + y.astype(np.uint8).tobytes())


@pytest.mark.parametrize("name,gz,sub", [("mnist", False, ""),
                                         ("mnist", True, "raw"),
                                         ("fashion-mnist", True, "")])
def test_idx_files_read_identically(tmp_path, name, gz, sub):
    rng = np.random.RandomState(0)
    d = os.path.join(tmp_path, name, sub)
    for prefix, n in (("train", 64), ("t10k", 16)):
        _write_idx(d, prefix, rng.randint(0, 256, (n, 28, 28), np.uint8),
                   rng.randint(0, 10, n), gz)
    got = datasets.load_dataset(name, root=str(tmp_path))
    ref = jax_datasets.load_dataset(name, root=str(tmp_path))
    assert not got["synthetic"] and not ref["synthetic"]
    assert got["train_x"].shape == (64, 28, 28, 1)
    for k in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(got[k], ref[k])
        assert got[k].dtype == ref[k].dtype


def test_mnist_synthetic_fallback(tmp_path):
    got = datasets.load_dataset("mnist", root=str(tmp_path),
                                synthetic_train_n=256)
    ref = jax_datasets.load_dataset("mnist", root=str(tmp_path),
                                    synthetic_train_n=256)
    assert got["synthetic"] and got["shape"] == (28, 28, 1)
    assert got["train_x"].shape == (256, 28, 28, 1)
    np.testing.assert_array_equal(got["train_x"], ref["train_x"])
    with pytest.raises(FileNotFoundError):
        datasets.load_dataset("mnist", root=str(tmp_path),
                              synthetic_fallback=False)


def test_data_dir_and_prefetch_defaults_match_jax(monkeypatch):
    """F2: the default data root, and GeoConfig's data_dir and prefetch
    read from GEOMX_DATA_DIR and GEOMX_PREFETCH, equal the JAX
    package's."""
    root = inspect.signature(datasets.load_dataset).parameters["root"]
    jroot = inspect.signature(jax_datasets.load_dataset).parameters["root"]
    assert root.default == jroot.default
    assert GeoConfig().data_dir == JaxConfig().data_dir == jroot.default
    assert GeoConfig().prefetch == JaxConfig().prefetch == 2
    monkeypatch.setenv("GEOMX_DATA_DIR", "/srv/datasets")
    monkeypatch.setenv("GEOMX_PREFETCH", "3.0")
    got, ref = GeoConfig.from_env(), JaxConfig.from_env()
    assert (got.data_dir, got.prefetch) == (ref.data_dir, ref.prefetch) \
        == ("/srv/datasets", 3)


def _images(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 6, 5, 3)).astype(np.uint8),
            rng.randint(0, 10, n))


@pytest.mark.parametrize("index", [True, False])
def test_recordio_bytes_identical_both_ways(tmp_path, index):
    x, y = _images()
    paths = {}
    for tag, mod in (("port", recordio), ("jax", jax_recordio)):
        p = str(tmp_path / f"{tag}.rec")
        with mod.recordio_writer(p, index=index) if tag == "port" \
                else mod.RecordIOWriter(p, index=index) as w:
            for img, lab in zip(x, y):
                w.write(mod.pack_labelled(float(lab), img))
        paths[tag] = p
    for ext in ("", ".idx") if index else ("",):
        a = open(paths["port"] + ext, "rb").read()
        b = open(paths["jax"] + ext, "rb").read()
        assert a == b
    # each package reads the other's file
    for reader_mod, path in ((recordio, paths["jax"]),
                             (jax_recordio, paths["port"])):
        with reader_mod.RecordIOReader(path) as r:
            recs = list(r)
        assert len(recs) == len(x)
        label, img = recordio.unpack_labelled(recs[7])
        assert label == float(y[7])
        np.testing.assert_array_equal(img, x[7])
    if index:
        with recordio.recordio_reader(paths["jax"]) as r, \
                jax_recordio.RecordIOReader(paths["port"]) as jr:
            assert len(r) == len(jr) == 40
            assert r.keys() == jr.keys()
            assert r.read_idx(13) == jr.read_idx(13)
            for part in range(3):
                assert list(r.read_shard(part, 3)) == \
                    list(jr.read_shard(part, 3))
    for n, part, parts in ((10, 2, 3), (7, 0, 1)):
        assert recordio.shard_bounds(n, part, parts) == \
            jax_recordio.shard_bounds(n, part, parts)
    with pytest.raises(ValueError):
        recordio.shard_bounds(4, 3, 3)


def test_image_record_iter_batches_equal(tmp_path):
    x, y = _images(50)
    path = str(tmp_path / "d.rec")
    with recordio.RecordIOWriter(path) as w:
        for img, lab in zip(x, y):
            w.write(recordio.pack_labelled(float(lab), img))
    for part in range(2):
        it = record_iter.ImageRecordIter(path, 8, part_index=part,
                                         num_parts=2, seed=3)
        jit_ = jax_record_iter.ImageRecordIter(path, 8, part_index=part,
                                               num_parts=2, seed=3)
        assert it.steps_per_epoch == jit_.steps_per_epoch == 3
        for epoch in range(2):
            got, ref = list(it.epoch(epoch)), list(jit_.epoch(epoch))
            assert len(got) == len(ref) == 3
            for (a, b), (c, d) in zip(got, ref):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, d)
        it.close()
        jit_.close()


def test_prefetch_iter_reraises_and_stops():
    def boom():
        yield 1
        raise KeyError("producer failed")

    it = record_iter.PrefetchIter(boom(), depth=1)
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer failed"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    it2 = record_iter.PrefetchIter(iter(range(100)), depth=2)
    assert next(it2) == 0
    it2.close()
    assert not it2._t.is_alive()


def _loaders(augment=False, device_cache=False, P=2, W=2, b=4):
    rng = np.random.RandomState(5)
    x = rng.randint(0, 256, (96, 8, 8, 3)).astype(np.uint8)
    y = rng.randint(0, 10, 96).astype(np.int32)
    port = GeoDataLoader(x, y, HiPSTopology(P, W), b, seed=7,
                         augment=augment, device="cpu",
                         device_cache=device_cache)
    ref = JaxLoader(x, y, JaxTopology(P, W), b, seed=7, augment=augment)
    return port, ref


@pytest.mark.parametrize("prefetch,augment,device_cache",
                         [(0, False, False), (2, False, False),
                          (2, True, False), (1, False, True)])
def test_loader_batches_equal_the_jax_host_loader(prefetch, augment,
                                                  device_cache):
    port, ref = _loaders(augment, device_cache)
    for epoch in range(2):
        got = list(port.epoch(epoch, prefetch=prefetch))
        want = list(ref.epoch(epoch, prefetch=0))
        assert len(got) == len(want) == port.steps_per_epoch == 6
        for (xb, yb), (rx, ry) in zip(got, want):
            assert xb.dtype == torch.uint8 and yb.dtype == torch.int64
            np.testing.assert_array_equal(xb.numpy(), np.asarray(rx))
            np.testing.assert_array_equal(yb.numpy(), np.asarray(ry))


def test_epoch_indices_match_jax():
    port, ref = _loaders()
    sel, gen = port.epoch_indices(1)
    rsel, _ = ref.epoch_indices(1)
    np.testing.assert_array_equal(sel, np.asarray(rsel))
    assert sel.shape == (6, 2, 2, 4) and isinstance(gen, torch.Generator)


def test_device_cached_augmentation_properties():
    """Each augmented crop is a window of the reflect-padded image at an
    offset in [0, 2p], mirrored or not; labels are the gathered ones; the
    same epoch draws the same crops."""
    port, _ = _loaders(augment=True, device_cache=True)
    p = port.pad
    sel, _ = port.epoch_indices(0)
    batches = list(port.epoch(0))
    again = list(port.epoch(0))
    flips = 0
    for step, (xb, yb) in enumerate(batches):
        np.testing.assert_array_equal(xb.numpy(), again[step][0].numpy())
        idx = sel[step].reshape(-1)
        np.testing.assert_array_equal(yb.numpy().reshape(-1),
                                      port.y[idx].astype(np.int64))
        for crop, i in zip(xb.numpy().reshape((-1, 8, 8, 3)), idx):
            padded = np.pad(port.x[i], ((p, p), (p, p), (0, 0)),
                            mode="reflect")
            hits = [(oy, ox, f) for oy in range(2 * p + 1)
                    for ox in range(2 * p + 1) for f in (False, True)
                    if np.array_equal(crop, (lambda w: w[:, ::-1] if f
                                             else w)(
                        padded[oy:oy + 8, ox:ox + 8]))]
            assert hits, f"crop of sample {i} is no window of its image"
            flips += all(f for _, _, f in hits)
    assert 0 < flips < len(idx) * len(batches)


def test_prefetch_thread_reraises_producer_errors():
    port, _ = _loaders()

    def bad_batches(epoch):
        yield from list(GeoDataLoader.host_batches(port, epoch))[:2]
        raise RuntimeError("assembly failed")

    port.host_batches = bad_batches
    it = port.epoch(0, prefetch=2)
    next(it)
    next(it)
    with pytest.raises(RuntimeError, match="assembly failed"):
        next(it)
