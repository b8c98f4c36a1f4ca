"""The port's wire protocol against the JAX package's: the same Msg gives
the same frame bytes under both codecs, each package decodes the other's
frames, and the integrity checks, the frame-length bound and the seeded
fault injection decide alike."""

import socket

import numpy as np
import pytest

import geomx_tpu.service.protocol as jp
import geomx_tpu_torch.service.protocol as tp

PACKAGES = {"jax": jp, "port": tp}


@pytest.fixture(params=["binary", "legacy"])
def codec(request, monkeypatch):
    monkeypatch.setenv("GEOMX_NATIVE_WIRE",
                       "1" if request.param == "binary" else "0")
    for m in PACKAGES.values():
        m.reset_wire_codec_cache()
    yield request.param
    monkeypatch.delenv("GEOMX_NATIVE_WIRE")
    for m in PACKAGES.values():
        m.reset_wire_codec_cache()


# one meta value for every TLV tag of the binary codec: None, False,
# True, i8, i16, i32, i64, bigint, f64, str8, str32, bytes8, bytes32,
# list8, list32, tuple8, tuple32, dict8, dict32 and a well-known key
EVERY_TAG = {
    "rid": 7, "none": None, "f": False, "t": True, "i16": -300,
    "i32": 70_000, "i64": -(1 << 40), "big": 1 << 70, "f64": 2.5,
    "s8": "relay", "s32": "x" * 300, "b8": b"\x00\x01", "b32": b"y" * 300,
    "l8": [1, "a", None], "l32": list(range(300)), "t8": (1, 2.0),
    "t32": tuple(range(260)), "d8": {"k": [1, {"j": None}]},
    "d32": {f"k{i}": i for i in range(260)}, "round": 3, "shape": [2, 3],
}


def _msgs():
    rng = np.random.default_rng(0)
    out = []
    for t in jp.MsgType:
        out.append((f"{t.name}-bare", dict(type=int(t), key=None,
                                           sender=-1, meta={})))
    arrays = {
        "fp32": rng.standard_normal((3, 5)).astype(np.float32),
        "fp16": rng.standard_normal(17).astype(np.float16),
        "int32": rng.integers(-9, 9, (2, 2, 2)).astype(np.int32),
        "empty": np.zeros((0,), np.float32),
    }
    for name, a in arrays.items():
        out.append((f"push-{name}", dict(type=int(jp.MsgType.PUSH),
                                         key="layer.w", sender=3,
                                         meta=dict(EVERY_TAG), array=a)))
    chunk = {"chunk": 1, "num_chunks": 3, "start": 1024, "n_total": 3000,
             "shape": [3000], "round": 4, "wire_declared": 4096,
             "rid": 99, "reliable": True, "resend": True}
    out.append(("p3-chunk", dict(type=int(jp.MsgType.PUSH), key="k",
                                 sender=2, meta=chunk,
                                 array=np.arange(1024, dtype=np.float32))))
    out.append(("p3-chunk-generic", dict(
        type=int(jp.MsgType.PULL_REPLY), key="k", sender=2,
        meta=dict(chunk, gen=5, pushed=2),
        array=np.arange(16, dtype=np.float32))))
    return out


MSGS = _msgs()


def _build(pkg, spec):
    spec = dict(spec)
    spec["type"] = pkg.MsgType(spec["type"])
    return pkg.Msg(**spec)


@pytest.mark.parametrize("name,spec", MSGS, ids=[m[0] for m in MSGS])
def test_frames_are_byte_identical_and_cross_decode(codec, name, spec):
    fj, ft = _build(jp, spec).encode(), _build(tp, spec).encode()
    assert fj == ft
    assert fj[0] == (0x02 if codec == "binary" else 0x01)
    for enc, dec in ((jp, tp), (tp, jp)):
        frame = _build(enc, spec).encode()
        got = dec.Msg.decode(frame)
        assert int(got.type) == spec["type"]
        assert got.key == spec["key"] and got.sender == spec["sender"]
        assert got.meta == spec["meta"]
        if spec.get("array") is None:
            assert got.array is None
        else:
            assert got.array.dtype == spec["array"].dtype
            np.testing.assert_array_equal(got.array, spec["array"])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_flipped_bit_raises_frame_integrity_error(codec, pkg):
    m = PACKAGES[pkg]
    frame = bytearray(_build(m, MSGS[len(jp.MsgType)][1]).encode())
    for off in (5, 40, len(frame) - 3):
        bad = bytearray(frame)
        bad[off] ^= 0x10
        for dec in PACKAGES.values():
            with pytest.raises(dec.FrameIntegrityError):
                dec.Msg.decode(bytes(bad))
    with pytest.raises(m.FrameIntegrityError):
        m.Msg.decode(b"\x07" + bytes(frame[1:]))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_oversized_length_prefix_is_refused(monkeypatch, pkg):
    m = PACKAGES[pkg]
    monkeypatch.setenv("GEOMX_MAX_FRAME_BYTES", "4096")
    m.reset_frame_limit_cache()
    a, b = socket.socketpair()
    try:
        a.settimeout(5.0)
        b.settimeout(5.0)
        a.sendall((8192).to_bytes(4, "little"))
        with pytest.raises(m.FrameIntegrityError, match="4096"):
            m.recv_frame(b)
        # at the bound a frame still passes
        frame = m.Msg(m.MsgType.PUSH, key="w",
                      array=np.zeros(512, np.float32)).encode()
        assert len(frame) < 4096
        a.sendall(len(frame).to_bytes(4, "little") + frame)
        got = m.recv_frame(b)
        assert got.key == "w" and got.array.shape == (512,)
    finally:
        a.close()
        b.close()
        monkeypatch.delenv("GEOMX_MAX_FRAME_BYTES")
        m.reset_frame_limit_cache()


@pytest.mark.parametrize("seed", [0, 11])
def test_seeded_drop_and_corruption_decide_alike(seed):
    def msg(pkg, i):
        meta = {"rid": i}
        if i % 3:
            meta["resend"] = True
        if i % 5 == 0:
            meta["best_effort"] = True
        if i % 7 == 0:
            meta["reliable"] = True
        t = pkg.MsgType.PUSH if i % 4 else pkg.MsgType.PULL
        return pkg.Msg(t, key=f"k{i}", sender=i % 3, meta=meta,
                       array=np.full(8, i, np.float32))
    drops, corrupt = {}, {}
    for name, m in PACKAGES.items():
        m.reseed_drop_rng(seed)
        m.reseed_corrupt_rng(seed)
        m.set_drop_rate_override(35)
        m.set_corruption_override(-1, 40)
        m.set_corruption_override(1, 90)
        try:
            drops[name] = [m.should_drop(msg(m, i)) for i in range(200)]
            corrupt[name] = [m.maybe_corrupt_frame(msg(m, i),
                                                   msg(m, i).encode())
                             for i in range(200)]
        finally:
            m.set_drop_rate_override(None)
            m.clear_corruption_overrides()
    assert drops["jax"] == drops["port"]
    assert 0 < sum(drops["port"]) < 200
    assert corrupt["jax"] == corrupt["port"]
    flipped = [f for i, f in enumerate(corrupt["port"])
               if f != msg(tp, i).encode()]
    assert flipped
    for f in flipped:
        with pytest.raises(tp.FrameIntegrityError):
            tp.Msg.decode(f)


def test_link_shaping_matches():
    for m in PACKAGES.values():
        m.set_link_shaping_override(2, factor=0.25, delay_ms=30.0)
    try:
        assert tp.get_link_shaping(2) == jp.get_link_shaping(2)
        assert tp.shaping_extra_seconds(2, 0.1) == \
            jp.shaping_extra_seconds(2, 0.1) == pytest.approx(0.33)
        assert tp.shaping_extra_seconds(3, 0.1) == 0.0
    finally:
        for m in PACKAGES.values():
            m.clear_link_shaping_overrides()
