"""The port's transport schedulers and the host half of the compressed
aggregation against the JAX package's: P3 slicing and reassembly, the
priority send queue, the TSEngine scheduler (seeded), the host pair
merge and the pair wire payload."""

import numpy as np
import pytest

import geomx_tpu.compression.sparseagg as jsa
import geomx_tpu.service.protocol as jproto
import geomx_tpu.transport as jt
import geomx_tpu_torch.compression.sparseagg as tsa
import geomx_tpu_torch.service.protocol as tproto
import geomx_tpu_torch.transport as tt


@pytest.mark.parametrize("size,slice_elems", [(10, 3), (4096, 1024),
                                              (1, 500_000)])
def test_p3_slicer_equal(size, slice_elems):
    tc = tt.P3Slicer(slice_elems).chunks("k", size, priority=-2)
    jc = jt.P3Slicer(slice_elems).chunks("k", size, priority=-2)
    assert [vars(c) for c in tc] == [vars(c) for c in jc]
    data = np.arange(size, dtype=np.float32)
    pieces_t = [(c, data[c.start:c.stop]) for c in tc]
    pieces_j = [(c, data[c.start:c.stop]) for c in jc]
    np.testing.assert_array_equal(tt.P3Slicer.reassemble(size, pieces_t),
                                  jt.P3Slicer.reassemble(size, pieces_j))
    with pytest.raises(ValueError):
        tt.P3Slicer.reassemble(size + 1, pieces_t)


def _feed_trace(mod, clear, monotonic):
    asm = mod.ChunkAssembler(clear_on_complete=clear,
                             monotonic_gen=monotonic)
    out = []
    metas = [
        {"n_total": 6, "num_chunks": 3, "start": 0, "chunk": 0,
         "shape": [2, 3], "round": 2},
        {"n_total": 6, "num_chunks": 3, "start": 2, "chunk": 1,
         "shape": [2, 3], "round": 2},
        # a stale straggler from round 1, then the set completes
        {"n_total": 6, "num_chunks": 3, "start": 4, "chunk": 2,
         "shape": [2, 3], "round": 1},
        {"n_total": 6, "num_chunks": 3, "start": 4, "chunk": 2,
         "shape": [2, 3], "round": 2},
        {"n_total": 6, "num_chunks": 3, "start": 0, "chunk": 0,
         "shape": [2, 3], "round": 3},
    ]
    for i, m in enumerate(metas):
        r = asm.feed(m, np.full(2, i + 1, np.float32))
        out.append(None if r is None else r.copy())
        out.append(asm.gen)
    f = asm.force()
    out.append(None if f is None else f.copy())
    return out


@pytest.mark.parametrize("clear,monotonic", [(True, False), (False, True),
                                             (True, True)])
def test_chunk_assembler_equal(clear, monotonic):
    a = _feed_trace(tt, clear, monotonic)
    b = _feed_trace(jt, clear, monotonic)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_priority_send_queue_equal():
    items = [("a", 0), ("b", 3), ("c", 3), ("d", -1), ("e", 7)]
    orders = []
    for mod in (tt, jt):
        q = mod.PrioritySendQueue()
        for it, p in items:
            q.push(it, p)
        orders.append([q.pop(timeout=0) for _ in items])
        assert q.pop(timeout=0) is None
        q.close()
        with pytest.raises(RuntimeError):
            q.push("x")
    assert orders[0] == orders[1] == ["e", "b", "c", "a", "d"]


@pytest.mark.parametrize("seed", [0, 5, 42])
def test_tsengine_scheduler_equal(seed):
    def trace(mod):
        ts = mod.TSEngineScheduler(5, max_greed_rate=0.8, seed=seed)
        out = []
        rng = np.random.default_rng(seed)
        for version in range(1, 6):
            while True:
                r = ts.ask(0, version)
                out.append(r)
                if r == -1:
                    break
                ts.report(0, r, float(rng.uniform(1, 10)), version)
        for node in (1, 2, 3, 4, 2, 1):
            out.append(ts.ask1_key(node, "w", 4))
            out.append(ts.ask1(node))
        out.append(ts.drain_key("w"))
        out.append(ts.iters)
        return out, ts.A, ts.lifetime
    assert trace(tt.tsengine) == trace(jt.tsengine)


@pytest.mark.parametrize("native_wire", ["1", "0"])
@pytest.mark.parametrize("seed", [0, 9])
def test_merge_pairs_host_equal(monkeypatch, native_wire, seed):
    monkeypatch.setenv("GEOMX_NATIVE_WIRE", native_wire)
    for m in (tproto, jproto):
        m.reset_wire_codec_cache()
    try:
        rng = np.random.default_rng(seed)
        parts = [(rng.standard_normal(40).astype(np.float32),
                  rng.integers(-1, 100, 40)) for _ in range(4)]
        tv, ti = tsa.merge_pairs_host(parts)
        jv, ji = jsa.merge_pairs_host(parts)
        assert tv.tobytes() == jv.tobytes()
        np.testing.assert_array_equal(ti, ji)
        assert tsa.merge_pairs_host([])[0].size == 0
    finally:
        monkeypatch.delenv("GEOMX_NATIVE_WIRE")
        for m in (tproto, jproto):
            m.reset_wire_codec_cache()


def test_numpy_merge_replica_equals_native():
    # the fold the port runs without libgeops.so, against the C++ one
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(500).astype(np.float32)
    idx = rng.integers(-1, 60, 500).astype(np.int64)
    native = tsa._native_merge(vals, idx)
    import geomx_tpu_torch.runtime.native as tn
    real = tn.merge_pairs
    try:
        tn.merge_pairs = lambda v, i: None
        replica = tsa._native_merge(vals, idx)
    finally:
        tn.merge_pairs = real
    assert native[0].tobytes() == replica[0].tobytes()
    np.testing.assert_array_equal(native[1], replica[1])


def test_pair_payload_and_densify_equal():
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(30).astype(np.float32)
    idx = rng.integers(-1, 50, 30)
    tp_, jp_ = (tsa.encode_pairs_payload(vals, idx),
                jsa.encode_pairs_payload(vals, idx))
    assert tp_.dtype == np.float32 and tp_.tobytes() == jp_.tobytes()
    for a, b in zip(tsa.decode_pairs_payload(tp_),
                    jsa.decode_pairs_payload(jp_)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tsa.densify_pairs_host(vals, idx, 50).tobytes() == \
        jsa.densify_pairs_host(vals, idx, 50).tobytes()
    assert tsa.PAIR_WIRE_MAX_N == jsa.PAIR_WIRE_MAX_N == 1 << 24
