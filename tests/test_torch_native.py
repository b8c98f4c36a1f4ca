"""The port's ctypes binding of native/libgeops.so against the JAX
package's binding of the same library: equal results for the pair merge
and scatter, the wire seal, the server-side SGD and the priority queue;
the native RecordIO route of ``data/recordio.py``."""

import os

import numpy as np
import pytest

import geomx_tpu.data.recordio as jrec
import geomx_tpu.runtime.native as jn
import geomx_tpu_torch.data.recordio as trec
import geomx_tpu_torch.runtime.native as tn


@pytest.fixture(scope="module", autouse=True)
def native_built():
    # both bindings load the one library; without a toolchain neither
    # can, and the JAX package's own native tests skip the same way
    if tn.load_native() is None or jn.load_native() is None:
        pytest.skip("native runtime could not be built (no C++ toolchain)")


def _pairs(seed, n, k, parts):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(k * parts).astype(np.float32)
    idx = rng.integers(-1, n, k * parts).astype(np.int64)
    return vals, idx


@pytest.mark.parametrize("seed,n,k,parts",
                         [(0, 64, 16, 2), (1, 5000, 300, 4), (2, 8, 0, 3)])
def test_merge_pairs_equal(seed, n, k, parts):
    vals, idx = _pairs(seed, n, k, parts)
    tv, ti = tn.merge_pairs(vals, idx)
    jv, ji = jn.merge_pairs(vals, idx)
    np.testing.assert_array_equal(ti, ji)
    assert tv.tobytes() == jv.tobytes()
    assert np.all(np.diff(ti) > 0) and np.all(ti >= 0)


@pytest.mark.parametrize("seed", [0, 3])
def test_scatter_pairs_equal(seed):
    vals, idx = _pairs(seed, 300, 64, 3)
    outs = []
    for mod in (tn, jn):
        out = np.full(300, 0.5, np.float32)
        applied = mod.scatter_pairs(out, vals, idx)
        outs.append((applied, out))
    assert outs[0][0] == outs[1][0] == int((idx >= 0).sum())
    assert outs[0][1].tobytes() == outs[1][1].tobytes()
    with pytest.raises(IndexError):
        tn.scatter_pairs(np.zeros(4, np.float32), vals[:2],
                         np.array([1, 9], np.int64))


@pytest.mark.parametrize("version", [1, 2])
def test_wire_seal_and_verify_equal(version):
    body = bytes(range(256)) * 40
    frames = []
    for mod in (tn, jn):
        frame = bytearray(5) + bytearray(body)
        assert mod.wire_seal(frame, version)
        frames.append(bytes(frame))
    assert frames[0] == frames[1] and frames[0][0] == version
    for mod in (tn, jn):
        assert mod.wire_verify(frames[0]) is True
        bad = bytearray(frames[0])
        bad[1000] ^= 4
        assert mod.wire_verify(bytes(bad)) is False


@pytest.mark.parametrize("kw", [
    {"learning_rate": 0.05},
    {"learning_rate": 0.1, "momentum": 0.9},
    {"learning_rate": 0.1, "momentum": 0.5, "weight_decay": 1e-3,
     "clip_gradient": 0.5},
])
def test_native_sgd_equal(kw):
    rng = np.random.default_rng(4)
    w0 = rng.standard_normal((33, 7)).astype(np.float32)
    grads = [rng.standard_normal((33, 7)).astype(np.float32)
             for _ in range(3)]
    out = []
    for mod in (tn, jn):
        opt = mod.NativeSGD(**kw)
        w = w0.copy()
        mom = opt.init_state(w)
        for g in grads:
            w = opt.update(w, g, mom)
        out.append(w)
    assert out[0].tobytes() == out[1].tobytes()
    assert not np.array_equal(out[0], w0)


def test_native_priority_queue_order_equal():
    items = [(b"a", 0), (b"b", 5), (b"c", -2), (b"d", 5), (b"e", 1),
             (b"f" * 70000, 3)]
    orders = []
    for mod in (tn, jn):
        q = mod.NativePriorityQueue()
        for payload, prio in items:
            q.push(payload, prio)
        assert len(q) == len(items)
        orders.append([q.pop(timeout=1.0) for _ in items])
        assert q.pop(timeout=0) is None
        q.close()
        q.destroy()
    assert orders[0] == orders[1]
    assert [p for p, _ in orders[0]][:3] == [b"b", b"d", b"f" * 70000]


def test_native_tsengine_equal():
    outs = []
    for mod in (tn, jn):
        ts = mod.NativeTSEngine(4, max_greed_rate=0.9, seed=7)
        ts.report(0, 1, 5.0, 1)
        ts.report(0, 2, 9.0, 1)
        trace = [ts.ask(0, 2) for _ in range(6)]
        trace += [ts.ask1_key(n, "w", 3) for n in (1, 2, 3, 1)]
        trace.append(ts.drain_key("w"))
        outs.append((trace, ts.iters))
    assert outs[0] == outs[1]


def _records(n=20):
    rng = np.random.default_rng(5)
    return [rng.bytes(int(rng.integers(0, 300))) for _ in range(n)]


@pytest.mark.parametrize("index", [True, False])
def test_native_recordio_writer_bytes_equal_python_writer(tmp_path, index):
    recs = _records()
    paths = {}
    for name, cls in (("native", tn.NativeRecordIOWriter),
                      ("python", trec.RecordIOWriter)):
        p = str(tmp_path / f"{name}.rec")
        with cls(p, index=index) as w:
            for i, r in enumerate(recs):
                w.write(r, key=i * 3)
        paths[name] = p
    for suffix in ("",) + ((".idx",) if index else ()):
        with open(paths["native"] + suffix, "rb") as a, \
                open(paths["python"] + suffix, "rb") as b:
            assert a.read() == b.read()


def test_recordio_factories_take_the_native_route(tmp_path, monkeypatch):
    p = str(tmp_path / "f.rec")
    w = trec.recordio_writer(p)
    assert isinstance(w, tn.NativeRecordIOWriter)
    w.close()
    assert isinstance(trec.recordio_reader(p), tn.NativeRecordIOReader)
    monkeypatch.setenv("GEOMX_NATIVE_RECORDIO", "0")
    assert isinstance(trec.recordio_writer(str(tmp_path / "g.rec")),
                      trec.RecordIOWriter)
    assert isinstance(trec.recordio_reader(p), trec.RecordIOReader)


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_others_files(tmp_path, writer, reader):
    recs = _records(12)
    mods = {"port": trec, "jax": jrec}
    p = str(tmp_path / "x.rec")
    with mods[writer].recordio_writer(p) as w:
        for i, r in enumerate(recs):
            w.write(r, key=100 + i)
    rd = mods[reader].recordio_reader(p)
    assert list(rd) == recs
    assert len(rd) == len(recs)
    assert rd.keys() == [100 + i for i in range(len(recs))]
    assert rd.read_idx(5) == recs[5]
    assert list(rd.read_shard(1, 3)) == recs[4:8]
    rd.close()
    assert os.path.exists(p + ".idx")
