"""Wire protocol: length-prefixed, CRC-protected frames, numpy payloads
(port of geomx_tpu/service/protocol.py; the frames are byte-identical
to the JAX package's under both codecs, so either package reads the
other's, and payloads are numpy arrays, never torch tensors).

The reference serializes ps-lite Meta via protobuf plus raw SArray data
(3rdparty/ps-lite/include/ps/internal/message.h, src/meta.pb.cc).  Here a
frame is one of two codec versions behind the SAME 5-byte integrity
prelude (version byte + CRC32 of everything after it):

v0x02 (binary, the default — docs/performance.md "Host-plane fast
path"):

    [u8 0x02][u32 crc32(body)]
    [u32 header_len][fixed binary header + TLV meta][payload bytes]

a fixed-layout struct-packed header (type / sender / key / dtype /
shape) plus a compact tag-length-value meta encoding — no pickle
anywhere on the hot path, ~6x leaner than the pickled header at
typical data-frame metas, and assembled/CRC-sealed by the native
runtime (``native/geops_runtime.cpp``) with the GIL released when
built.  ``GEOMX_NATIVE_WIRE=0`` forces the legacy encoder (bit-exact
prior behavior); the decoder accepts BOTH versions unconditionally, so
mixed fleets negotiate per frame via the version byte during rolling
upgrades.

v0x01 (legacy):

    [u8 0x01][u32 crc32 of the rest]
    [u32 header_len][header: pickled dict][payload bytes]

with tensor payloads as raw little-endian numpy bytes described by
header["dtype"]/header["shape"].  Pickle never carries user code — headers
are dicts of primitives only (enforced in Msg), and the binary codec
carries none at all.

Integrity (docs/resilience.md "Host-plane recovery"): the version/flags
byte + CRC32 prelude rides EVERY frame, so one flipped bit on a WAN
link is *detected* (THC, PAPERS.md: compressed-domain streams amplify
exactly this class of silent corruption) instead of silently corrupting
a gradient — a bad frame raises :class:`FrameIntegrityError`, which the
serve/recv loops treat as a dead connection (drop + the client's
retry/reconnect path), never a tier crash.  ``recv_frame`` additionally
bounds the 4-byte length prefix at ``GEOMX_MAX_FRAME_BYTES`` (default
1 GiB) so a corrupted length can no longer drive ``_recv_exact`` into
an unbounded allocation.  Both rejections count in
``geomx_wire_crc_errors_total{reason}``.
"""

from __future__ import annotations

import enum
import io
import os
import pickle
import socket
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

_LEN = struct.Struct("<I")

# frame prelude: one version/flags byte (upper nibble = flags, all zero
# today) + CRC32 over everything after the prelude
FRAME_VERSION = 0x01       # legacy codec: pickled-dict header
FRAME_VERSION_BIN = 0x02   # binary codec: fixed header + TLV meta
_PRELUDE = 5  # 1 version byte + 4 CRC bytes

DEFAULT_MAX_FRAME_BYTES = 1 << 30  # 1 GiB

# The exact clean-link framing bound of one BINARY data frame: overhead
# over the declared payload = 4 (socket length prefix) + 5 (prelude)
# + 4 (header_len) + 6 (type/flags/sender) + key TLV (2 + len <= 64)
# + array desc (2 + dtype <= 6 + 8 per dim, <= 4 dims) + hot-path meta
# TLV (known-key coded, <= 72 B for the push/reply/relay metas).  The
# compact P3-chunk form (header flags bit1) is tighter still: ~24 B of
# header for a chunked push.  The ledger's reconciliation gate uses
# this instead of the legacy pickled codec's 512 B allowance
# (telemetry/ledger.py).
BIN_FRAME_OVERHEAD_BOUND = 192


class FrameIntegrityError(ConnectionError):
    """A frame failed its CRC / version / length-bound check.  Subclass
    of ConnectionError so every existing serve/recv loop routes it into
    the drop-the-connection path it already has for dead sockets."""


_max_frame_cache: Optional[int] = None


def max_frame_bytes() -> int:
    """``GEOMX_MAX_FRAME_BYTES`` (cached like the verbose level; tests
    call :func:`reset_frame_limit_cache`)."""
    global _max_frame_cache
    if _max_frame_cache is None:
        _max_frame_cache = max(1, env_int(("GEOMX_MAX_FRAME_BYTES",),
                                          DEFAULT_MAX_FRAME_BYTES))
    return _max_frame_cache


def reset_frame_limit_cache() -> None:
    global _max_frame_cache
    _max_frame_cache = None


# ---- codec selection (GEOMX_NATIVE_WIRE) ----------------------------------

_wire_codec_cache: Optional[bool] = None


def binary_wire_enabled() -> bool:
    """True (the default) routes every ``Msg.encode`` through the
    v0x02 binary codec and the host-plane fast paths it gates (native
    pair merge, native CRC seal).  ``GEOMX_NATIVE_WIRE=0`` forces the
    legacy pickled encoder and the pure-Python merge — bit-exact prior
    behavior.  Decoding is NOT gated: both codec versions are always
    accepted (rolling-upgrade interop rides the version byte).  Cached
    like the verbose level; tests call
    :func:`reset_wire_codec_cache`."""
    global _wire_codec_cache
    if _wire_codec_cache is None:
        _wire_codec_cache = env_int(("GEOMX_NATIVE_WIRE",), 1) != 0
    return _wire_codec_cache


def reset_wire_codec_cache() -> None:
    global _wire_codec_cache, _wire_native_state, _batch_drain_cache
    _wire_codec_cache = None
    _wire_native_state = None
    _batch_drain_cache = None


# ---- small-key round batching (GEOMX_BATCH_DRAIN) -------------------------
#
# One P3 queue drain coalesces many small-key frames into a single
# syscall-level sendall: after the blocking pop returns the head frame,
# the sender keeps popping with timeout=0 (never blocking the batch on a
# quiet queue) until the queue is momentarily empty, the batch reaches
# BATCH_DRAIN_MAX_FRAMES, or the batched bytes reach
# BATCH_DRAIN_MAX_BYTES (the closing frame may overshoot the byte cap —
# it is already popped).  Each frame keeps its own 4-byte length prefix
# inside the batch — receivers are oblivious — and per-frame wire_stats
# accounting is unchanged (the batch is a syscall optimisation, not a
# wire-format construct).

_batch_drain_cache: Optional[bool] = None

BATCH_DRAIN_MAX_BYTES = 1 << 18
BATCH_DRAIN_MAX_FRAMES = 64


def batch_drain_enabled() -> bool:
    """True (the default) lets the client/server send loops coalesce
    queued frames into one syscall per drain.  ``GEOMX_BATCH_DRAIN=0``
    restores strictly one ``sendall`` per frame.  Cached; tests call
    :func:`reset_wire_codec_cache`."""
    global _batch_drain_cache
    if _batch_drain_cache is None:
        _batch_drain_cache = env_int(("GEOMX_BATCH_DRAIN",), 1) != 0
    return _batch_drain_cache


# the native runtime's wire entry points (runtime/native.py wire_seal /
# wire_verify): resolved once, lazily — the scheduler process must stay
# importable without a C++ toolchain, and a missing/stale libgeops.so
# degrades to the bit-identical zlib/struct fallback, never an error
_wire_native_state: Any = None  # None=untried, False=unavailable, module

# frames shorter than this CRC through zlib in-process: the ctypes
# crossing (buffer pin + GIL drop/reacquire) costs ~1-2us, which a
# small control frame's CRC never amortizes — measured crossover on
# this container is ~2-4 KiB (zlib 4.2us vs native 3.6us at 4 KiB,
# 0.4us vs 1.4us at 64 B); the bytes are identical either way
_NATIVE_CRC_MIN = 4096


def _wire_native():
    global _wire_native_state
    if _wire_native_state is None:
        try:
            from geomx_tpu_torch.runtime import native as mod
            _wire_native_state = mod if mod.load_native() is not None \
                else False
        except Exception:
            _wire_native_state = False
    return _wire_native_state or None


def _count_frame_error(reason: str) -> None:
    """Bump ``geomx_wire_crc_errors_total{reason}`` and surface the
    incident to the flight recorder and the event log (telemetry
    imported lazily — this only runs on the error path, and the registry
    is resolved per call so test-time registry resets never orphan
    it)."""
    try:
        from geomx_tpu_torch.telemetry import get_registry
        get_registry().counter(
            "geomx_wire_crc_errors_total",
            "Wire frames rejected by the integrity layer "
            "(CRC mismatch, unknown version, length bound)",
            ("reason",)).labels(reason=reason).inc()
        from geomx_tpu_torch.telemetry.flight import notify_host_incident
        notify_host_incident("wire_crc_error", reason=reason)
    except Exception:
        pass  # the integrity REJECTION must stand even if telemetry
        # is mid-teardown; the counter is observability, not the gate


def wire_crc_errors() -> float:
    """Total frames rejected by the integrity layer so far (all
    reasons) — what the corrupt@ chaos acceptance asserts is nonzero."""
    from geomx_tpu_torch.telemetry import get_registry
    fam = get_registry().get("geomx_wire_crc_errors_total")
    if fam is None:
        return 0.0
    return float(sum(child.value for _lbl, child in fam.children()))

_ALLOWED_HEADER_TYPES = (str, int, float, bool, bytes, type(None), list,
                         tuple, dict)

# frame kinds the fleet round ledger accounts (telemetry/ledger.py):
# only round-tagged data traffic — control frames carry no round id
_LEDGER_TYPES = frozenset((2, 4, 14))  # PUSH, PULL_REPLY, RELAY


def _ledger_account(direction: str, msg: "Msg", nbytes: int) -> None:
    """Byte-true wire accounting at the one encode/decode choke point:
    every producer ships ``Msg.encode`` output verbatim (send_frame AND
    the pre-encoded priority-queue paths) and every consumer parses via
    ``Msg.decode``, so counting here measures the frame that crosses the
    socket — P3 framing, pair codec, CRC prelude, header and the 4-byte
    length prefix included.  Best-effort: accounting must never break
    the wire."""
    meta = msg.meta
    if msg.key is None or not meta or int(msg.type) not in _LEDGER_TYPES:
        return
    rid = meta.get("round")
    if rid is None:
        return
    try:
        from geomx_tpu_torch.telemetry.ledger import account_frame
        account_frame(direction, msg.type.name, msg.key, int(rid),
                      int(nbytes), declared=meta.get("wire_declared"))
    except Exception:
        pass

class MsgType(enum.IntEnum):
    INIT = 1
    PUSH = 2
    PULL = 3
    PULL_REPLY = 4
    BARRIER = 5
    BARRIER_RELEASE = 6
    HEARTBEAT = 7
    COMMAND = 8          # set_optimizer / set_compression / profiler
    ACK = 9
    STOP = 10            # reference kStopServer
    ERROR = 11
    AUTOPULL = 12        # server-initiated update (TSEngine AutoPull,
                         # reference kv_app.h:364 / AUTOPULLREPLY)
    TS_DIRECTIVE = 13    # scheduler -> node: send your partial to X
                         # (reference ASK1 reply, van.cc:1238-1296)
    RELAY = 14           # node -> node partial-aggregate transfer
                         # (reference TS_Process merge path, kv_app.h:1520)
    INFER = 15           # serving fast path: client -> gateway inference
                         # batch (rows x feat fp32; docs/serving.md
                         # "Serving fast path")
    INFER_REPLY = 16     # gateway -> client outputs (or an error meta)


# graftlint: disable=GX-WIRE-001 — legacy-compat v0x01 header decode only
class _HeaderUnpickler(pickle.Unpickler):
    """Headers are primitives only, and a pickle of primitives never needs
    to resolve a global — so refuse all class lookups.  This closes the
    arbitrary-code-execution hole unrestricted ``pickle.loads`` would open
    once servers bind non-loopback interfaces (GEOMX_PS_BIND_HOST)."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"wire header tried to load {module}.{name}; only primitive "
            "types are allowed")


def _header_loads(data: bytes):
    return _HeaderUnpickler(io.BytesIO(data)).load()


# ---- v0x02 binary header codec --------------------------------------------
#
# Fixed layout after the [u32 header_len] word:
#
#     [u8 msg_type][i32 sender][u8 flags]          flags bit0 = has array
#     [key: TLV value]                             (None or str, 1-N bytes)
#     [if array: u8 dlen][dtype.str ascii][u8 ndim][i64 dim x ndim]
#     [meta: TLV dict]
#
# TLV value encoding (tag byte, then payload; integers little-endian,
# smallest signed width that fits — canonical, so the Python and any
# native encoder produce identical bytes):
#
#     0x00 None   0x01 False   0x02 True
#     0x10 i8   0x11 i16   0x12 i32   0x13 i64
#     0x14 bigint: u32 nbytes + signed little-endian two's complement
#     0x20 f64
#     0x30 str8:  u8 len + utf-8        0x31 str32: u32 len + utf-8
#     0x38 bytes8: u8 len               0x39 bytes32: u32 len
#     0x40 list8: u8 count + items      0x41 list32: u32 count + items
#     0x48 tuple8 / 0x49 tuple32        0x50 dict8 / 0x51 dict32
#     0x60 well-known dict KEY: u8 code into _WIRE_KEYS
#
# Lists/tuples/dicts nest (depth-bounded by Msg._check_meta); dict
# entries keep insertion order, exactly like the pickled codec did.
# _WIRE_KEYS is append-only: codes are wire format, never renumber.

_I8 = struct.Struct("<b")
_I16 = struct.Struct("<h")
_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

_WIRE_KEYS = (
    "round", "rid", "resend", "wire_declared", "chunk", "num_chunks",
    "start", "n_total", "shape", "gen", "pushed", "comp", "n",
    "priority", "best_effort", "reliable", "cmd", "version", "node",
    "host", "port", "keys", "sig", "p3_chunk_elems", "dtype", "pairs",
)
_WIRE_KEY_CODE = {k: i for i, k in enumerate(_WIRE_KEYS)}


def _pack_int(v: int, out: bytearray) -> None:
    if -0x80 <= v < 0x80:
        out.append(0x10)
        out += _I8.pack(v)
    elif -0x8000 <= v < 0x8000:
        out.append(0x11)
        out += _I16.pack(v)
    elif -0x80000000 <= v < 0x80000000:
        out.append(0x12)
        out += _I32.pack(v)
    elif -(1 << 63) <= v < (1 << 63):
        out.append(0x13)
        out += _I64.pack(v)
    else:
        b = v.to_bytes((v.bit_length() + 8) // 8, "little", signed=True)
        out.append(0x14)
        out += _LEN.pack(len(b))
        out += b


def _tlv_pack(obj, out: bytearray, depth: int = 0) -> None:
    # exact-type dispatch first (the hot header fields are all builtin
    # types); subclasses (IntEnum, np.float64, ...) take the isinstance
    # ladder below.  Packing validates as it goes — the supported tag
    # set IS _ALLOWED_HEADER_TYPES, and the depth cap here mirrors
    # Msg._check_meta so the binary encoder need not pre-walk the meta
    # tree (a cycle or over-deep nest raises the same ValueError).
    t = type(obj)
    if t is int:
        _pack_int(obj, out)
    elif t is str:
        b = obj.encode("utf-8")
        if len(b) < 0x100:
            out.append(0x30)
            out.append(len(b))
        else:
            out.append(0x31)
            out += _LEN.pack(len(b))
        out += b
    elif obj is None:
        out.append(0x00)
    elif t is bool:
        out.append(0x02 if obj else 0x01)
    elif t is float:
        out.append(0x20)
        out += _F64.pack(obj)
    elif t is dict:
        if depth >= 6:
            raise ValueError("meta too deep")
        if len(obj) < 0x100:
            out.append(0x50)
            out.append(len(obj))
        else:
            out.append(0x51)
            out += _LEN.pack(len(obj))
        for k, v in obj.items():
            code = _WIRE_KEY_CODE.get(k) if type(k) is str else None
            if code is not None:
                out.append(0x60)
                out.append(code)
            else:
                _tlv_pack(k, out, depth + 1)
            _tlv_pack(v, out, depth + 1)
    elif t is list or t is tuple:
        if depth >= 6:
            raise ValueError("meta too deep")
        small, big = (0x40, 0x41) if t is list else (0x48, 0x49)
        if len(obj) < 0x100:
            out.append(small)
            out.append(len(obj))
        else:
            out.append(big)
            out += _LEN.pack(len(obj))
        for v in obj:
            _tlv_pack(v, out, depth + 1)
    elif t is bytes:
        if len(obj) < 0x100:
            out.append(0x38)
            out.append(len(obj))
        else:
            out.append(0x39)
            out += _LEN.pack(len(obj))
        out += obj
    # ---- subclass / numpy-scalar ladder (cold) ----
    elif isinstance(obj, bool):
        out.append(0x02 if obj else 0x01)
    elif isinstance(obj, int):  # IntEnums land here
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0x20)
        out += _F64.pack(float(obj))
    elif isinstance(obj, (str, bytes, list, tuple, dict)):
        if depth >= 6 and isinstance(obj, (list, tuple, dict)):
            raise ValueError("meta too deep")
        # canonicalize the subclass so the wire bytes match the builtin
        base = (str if isinstance(obj, str) else
                bytes if isinstance(obj, bytes) else
                list if isinstance(obj, list) else
                tuple if isinstance(obj, tuple) else dict)
        _tlv_pack(base(obj), out, depth)
    else:
        raise ValueError(f"disallowed meta type {type(obj)}")


def _tlv_unpack(buf, off: int):
    tag = buf[off]
    off += 1
    if tag == 0x00:
        return None, off
    if tag == 0x01:
        return False, off
    if tag == 0x02:
        return True, off
    if tag == 0x10:
        return _I8.unpack_from(buf, off)[0], off + 1
    if tag == 0x11:
        return _I16.unpack_from(buf, off)[0], off + 2
    if tag == 0x12:
        return _I32.unpack_from(buf, off)[0], off + 4
    if tag == 0x13:
        return _I64.unpack_from(buf, off)[0], off + 8
    if tag == 0x14:
        n = _LEN.unpack_from(buf, off)[0]
        off += 4
        return int.from_bytes(bytes(buf[off:off + n]), "little",
                              signed=True), off + n
    if tag == 0x20:
        return _F64.unpack_from(buf, off)[0], off + 8
    if tag in (0x30, 0x31):
        if tag == 0x30:
            n = buf[off]
            off += 1
        else:
            n = _LEN.unpack_from(buf, off)[0]
            off += 4
        return bytes(buf[off:off + n]).decode("utf-8"), off + n
    if tag in (0x38, 0x39):
        if tag == 0x38:
            n = buf[off]
            off += 1
        else:
            n = _LEN.unpack_from(buf, off)[0]
            off += 4
        return bytes(buf[off:off + n]), off + n
    if tag in (0x40, 0x41, 0x48, 0x49, 0x50, 0x51):
        if tag & 1:
            n = _LEN.unpack_from(buf, off)[0]
            off += 4
        else:
            n = buf[off]
            off += 1
        if tag in (0x50, 0x51):
            d = {}
            for _ in range(n):
                if buf[off] == 0x60:
                    k = _WIRE_KEYS[buf[off + 1]]
                    off += 2
                else:
                    k, off = _tlv_unpack(buf, off)
                d[k], off = _tlv_unpack(buf, off)
            return d, off
        items = []
        for _ in range(n):
            v, off = _tlv_unpack(buf, off)
            items.append(v)
        return (items if tag in (0x40, 0x41) else tuple(items)), off
    raise ValueError(f"unknown TLV tag {tag:#x}")


# ---- compact P3-chunk header form (v0x02 header flags bit1) ---------------
#
# The one header the host plane emits in bulk is the P3 chunk push
# (client.push_async slicing): meta is exactly
#   {chunk, num_chunks, start, n_total, shape=[n_total], round,
#    wire_declared, rid}  (+ optional reliable=True / resend)
# over a 1-D array of a small closed dtype set.  Generic TLV costs
# ~70 B per chunk — at the 2048 B chunk payloads the sharded tier
# ships, that alone busts the <= 1.02 wire-honesty bound.  The compact
# form packs the whole meta dict plus the array descriptor in ~20 B:
#   [u8 dtype_code][u8 cflags][u8 chunk][u8 num_chunks]
#   [varu32 start][varu32 n_total][varu32 round][varu32 wire_declared]
#   [varu32 rid]
# cflags: bit0 = reliable=True present, bit1 = resend=True present
# (both are presence markers — the resend-armed client literally sets
# ``meta["resend"] = True``, protocol.should_drop tests truthiness).  The
# array shape is implied (1-D, length = payload_bytes // itemsize), and
# the sender rides as a varu32 instead of the generic form's i32.
# Encode falls back to the generic form whenever ANY field is out of
# range, so decode always reconstructs the exact same Python values.

_COMPACT_DTYPES = {"<f4": 1, "<f2": 2, "<f8": 3, "<i8": 4, "<i4": 5,
                   "|u1": 6, "<u4": 7}
_COMPACT_DTYPES_INV = {v: k for k, v in _COMPACT_DTYPES.items()}
_COMPACT_META_KEYS = frozenset((
    "chunk", "num_chunks", "start", "n_total", "shape", "round",
    "wire_declared", "rid"))
_U32_MAX = (1 << 32) - 1


def _varu32_pack(v: int, out: bytearray) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _varu32_unpack(buf, off: int):
    v = shift = 0
    while True:
        b = buf[off]
        off += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            if v > _U32_MAX:
                raise ValueError(f"varu32 out of range: {v}")
            return v, off
        shift += 7
        if shift > 28:
            raise ValueError("varu32 continuation overflow")


def _is_u32(v) -> bool:
    return type(v) is int and 0 <= v <= _U32_MAX


def _pack_compact_chunk(m, arr, sender, out: bytearray) -> bool:
    """Append the compact chunk meta+array descriptor to ``out`` and
    return True iff every field fits the compact form exactly."""
    if arr is None or arr.ndim != 1 or "chunk" not in m:
        return False
    dc = _COMPACT_DTYPES.get(arr.dtype.str)
    if dc is None or not _is_u32(sender):
        return False
    ks = set(m)
    if not _COMPACT_META_KEYS <= ks:
        return False
    extra = ks - _COMPACT_META_KEYS
    if extra - {"reliable", "resend"}:
        return False
    chunk, num = m["chunk"], m["num_chunks"]
    if not (type(chunk) is int and 0 <= chunk <= 0xFF
            and type(num) is int and 0 <= num <= 0xFF):
        return False
    for k in ("start", "n_total", "round", "wire_declared", "rid"):
        if not _is_u32(m[k]):
            return False
    shape = m["shape"]
    if not (type(shape) is list and len(shape) == 1
            and type(shape[0]) is int and shape[0] == m["n_total"]):
        return False
    cflags = 0
    if "reliable" in extra:
        if m["reliable"] is not True:
            return False
        cflags |= 1
    if "resend" in extra:
        if m["resend"] is not True:
            return False
        cflags |= 2
    out.append(dc)
    out.append(cflags)
    out.append(chunk)
    out.append(num)
    _varu32_pack(m["start"], out)
    _varu32_pack(m["n_total"], out)
    _varu32_pack(m["round"], out)
    _varu32_pack(m["wire_declared"], out)
    _varu32_pack(m["rid"], out)
    return True


@dataclass
class Msg:
    type: MsgType
    key: Optional[str] = None
    sender: int = -1
    meta: Dict[str, Any] = field(default_factory=dict)
    array: Optional[np.ndarray] = None

    def _check_meta(self, obj, depth=0):
        if depth > 6:
            raise ValueError("meta too deep")
        if isinstance(obj, dict):
            for k, v in obj.items():
                self._check_meta(k, depth + 1)
                self._check_meta(v, depth + 1)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                self._check_meta(v, depth + 1)
        elif not isinstance(obj, _ALLOWED_HEADER_TYPES):
            raise ValueError(f"disallowed meta type {type(obj)}")

    def encode(self) -> bytes:
        """Wire frame WITH the integrity prelude: ``[u8 version]
        [u32 crc32(body)] [u32 header_len][header][payload]``.  Every
        producer (send_frame, the client/server priority send queues)
        ships ``encode()`` output verbatim, so the CRC covers exactly
        what crosses the wire.  The header codec is version-selected:
        binary v0x02 by default, the legacy pickled v0x01 under
        ``GEOMX_NATIVE_WIRE=0`` (byte-for-byte the prior format)."""
        if binary_wire_enabled():
            return self._encode_binary()
        return self._encode_legacy()

    def _encode_legacy(self) -> bytes:
        self._check_meta(self.meta)
        header = {"t": int(self.type), "k": self.key, "s": self.sender,
                  "m": self.meta}
        payload = b""
        if self.array is not None:
            arr = np.ascontiguousarray(self.array)
            header["dtype"] = arr.dtype.str
            header["shape"] = arr.shape
            payload = arr.tobytes()
        # graftlint: disable=GX-WIRE-001 — legacy-compat v0x01 encoder
        hb = pickle.dumps(header, protocol=4)
        body = _LEN.pack(len(hb)) + hb + payload
        frame = (bytes((FRAME_VERSION,)) + _LEN.pack(zlib.crc32(body))
                 + body)
        # fleet round ledger (telemetry/ledger.py): +4 for the outer
        # length prefix send_frame / the send loops add on the socket
        _ledger_account("tx", self, len(frame) + 4)
        return frame

    def _encode_binary(self) -> bytes:
        """The v0x02 zero-copy encoder: ONE output allocation, the
        payload copied into it exactly once through the buffer protocol
        (never via ``tobytes`` + concatenation), and the CRC seal
        written by the native runtime with the GIL released when
        ``libgeops.so`` is built (bit-identical zlib fallback
        otherwise).  Meta validation happens inside ``_tlv_pack``
        itself (same type set and depth cap as ``_check_meta``) — no
        separate pre-walk."""
        arr = None
        if self.array is not None:
            arr = np.ascontiguousarray(self.array)
        hb = bytearray()
        hb.append(int(self.type) & 0xFF)
        cb = bytearray()
        if (isinstance(self.meta, dict)
                and _pack_compact_chunk(self.meta, arr, self.sender, cb)):
            hb.append(0x03)  # bit0 array present, bit1 compact chunk form
            _varu32_pack(self.sender, hb)
            _tlv_pack(self.key, hb)
            hb += cb
        else:
            hb.append(1 if arr is not None else 0)
            hb += _I32.pack(int(self.sender))
            _tlv_pack(self.key, hb)
            if arr is not None:
                ds = arr.dtype.str.encode("ascii")
                hb.append(len(ds))
                hb += ds
                hb.append(arr.ndim)
                for d in arr.shape:
                    hb += _I64.pack(d)
            _tlv_pack(self.meta, hb)
        pn = 0 if arr is None else arr.nbytes
        hoff = _PRELUDE + 4
        frame = bytearray(hoff + len(hb) + pn)
        _LEN.pack_into(frame, _PRELUDE, len(hb))
        frame[hoff:hoff + len(hb)] = hb
        if pn:
            frame[hoff + len(hb):] = memoryview(arr).cast("B")
        # below _NATIVE_CRC_MIN the ctypes crossing costs more than the
        # CRC itself — zlib (C, no GIL drop) wins on small control
        # frames; the bytes are identical either way
        nat = _wire_native() if len(frame) >= _NATIVE_CRC_MIN else None
        if nat is None or not nat.wire_seal(frame, FRAME_VERSION_BIN):
            frame[0] = FRAME_VERSION_BIN
            _LEN.pack_into(frame, 1,
                           zlib.crc32(memoryview(frame)[_PRELUDE:]))
        out = bytes(frame)
        _ledger_account("tx", self, len(out) + 4)
        return out

    @classmethod
    def decode(cls, frame: bytes) -> "Msg":
        """Verify-and-parse.  Every frame MUST carry the version byte
        and a matching CRC32 — there is deliberately no bare-frame
        fallback (a length-byte that happens to equal the version would
        make the formats ambiguous).  BOTH codec versions are always
        accepted regardless of ``GEOMX_NATIVE_WIRE`` — that is the
        mixed-fleet negotiation: a binary sender and a legacy receiver
        (or vice versa) interoperate per frame via the version byte.
        An unknown version or a CRC mismatch raises
        :class:`FrameIntegrityError` (counted in
        ``geomx_wire_crc_errors_total{reason}``): the connection drops
        and the sender's retry path re-delivers."""
        if len(frame) < _PRELUDE + _LEN.size \
                or frame[0] not in (FRAME_VERSION, FRAME_VERSION_BIN):
            _count_frame_error("version")
            raise FrameIntegrityError(
                f"wire frame version {frame[:1]!r} is not a supported "
                f"codec ({FRAME_VERSION:#x} legacy / "
                f"{FRAME_VERSION_BIN:#x} binary) — truncated, "
                "corrupted, or a pre-integrity peer")
        nat = _wire_native() if len(frame) >= _NATIVE_CRC_MIN else None
        if nat is not None:
            ok = nat.wire_verify(frame)
            if ok is None:
                ok = (zlib.crc32(memoryview(frame)[_PRELUDE:])
                      == _LEN.unpack_from(frame, 1)[0])
        else:
            ok = (zlib.crc32(memoryview(frame)[_PRELUDE:])
                  == _LEN.unpack_from(frame, 1)[0])
        if not ok:
            _count_frame_error("crc")
            raise FrameIntegrityError(
                "wire frame failed its CRC32 check (one or more "
                "corrupted bits); dropping the connection so the "
                "sender's retry path re-delivers")
        off = _PRELUDE
        hlen = _LEN.unpack_from(frame, off)[0]
        if frame[0] == FRAME_VERSION_BIN:
            msg = cls._decode_binary(frame, off + 4, hlen)
        else:
            # graftlint: disable=GX-WIRE-001 — legacy-compat v0x01 decoder
            header = _header_loads(frame[off + 4:off + 4 + hlen])
            arr = None
            if "dtype" in header:
                arr = np.frombuffer(frame[off + 4 + hlen:],
                                    dtype=np.dtype(header["dtype"]))
                arr = arr.reshape(header["shape"])
            msg = cls(type=MsgType(header["t"]), key=header["k"],
                      sender=header["s"], meta=header["m"], array=arr)
        # receive-side wire accounting: unlike encode (once per frame
        # construction), decode runs once per ARRIVAL, so retransmitted
        # frames count here — the retry overhead the honesty audit
        # exists to surface
        _ledger_account("rx", msg, len(frame) + 4)
        return msg

    @classmethod
    def _decode_binary(cls, frame: bytes, hoff: int, hlen: int) -> "Msg":
        """Parse a CRC-verified v0x02 frame.  The payload is a
        ZERO-COPY view into the received buffer (``np.frombuffer`` at
        an offset — the legacy path's tail slice copied it), read-only
        like every decoded payload always was.  A CRC-valid frame whose
        header fails to parse is a codec bug or an unsupported future
        extension, surfaced as :class:`FrameIntegrityError` (reason
        ``header``) so every serve/recv loop routes it into the
        drop-the-connection path it already has."""
        try:
            p = hoff
            mtype = frame[p]
            flags = frame[p + 1]
            p += 2
            if flags & 2:  # compact P3-chunk form
                sender, p = _varu32_unpack(frame, p)
                key, p = _tlv_unpack(frame, p)
                dtype = _COMPACT_DTYPES_INV[frame[p]]
                cflags = frame[p + 1]
                meta = {"chunk": frame[p + 2], "num_chunks": frame[p + 3]}
                p += 4
                meta["start"], p = _varu32_unpack(frame, p)
                meta["n_total"], p = _varu32_unpack(frame, p)
                meta["shape"] = [meta["n_total"]]
                meta["round"], p = _varu32_unpack(frame, p)
                meta["wire_declared"], p = _varu32_unpack(frame, p)
                if cflags & 1:
                    meta["reliable"] = True
                meta["rid"], p = _varu32_unpack(frame, p)
                if cflags & 2:
                    meta["resend"] = True
                if p != hoff + hlen:
                    raise ValueError(
                        f"header length {hlen} vs parsed {p - hoff}")
                poff = hoff + hlen
                if poff == len(frame):
                    arr = np.frombuffer(b"", dtype=np.dtype(dtype))
                else:
                    arr = np.frombuffer(frame, dtype=np.dtype(dtype),
                                        offset=poff)
                return cls(type=MsgType(mtype), key=key, sender=sender,
                           meta=meta, array=arr)
            sender = _I32.unpack_from(frame, p)[0]
            p += 4
            key, p = _tlv_unpack(frame, p)
            dtype = shape = None
            if flags & 1:
                dlen = frame[p]
                p += 1
                dtype = bytes(frame[p:p + dlen]).decode("ascii")
                p += dlen
                ndim = frame[p]
                p += 1
                shape = tuple(_I64.unpack_from(frame, p + 8 * i)[0]
                              for i in range(ndim))
                p += 8 * ndim
            meta, p = _tlv_unpack(frame, p)
            if p != hoff + hlen:
                raise ValueError(
                    f"header length {hlen} vs parsed {p - hoff}")
            arr = None
            if flags & 1:
                poff = hoff + hlen
                if poff == len(frame):
                    arr = np.frombuffer(b"", dtype=np.dtype(dtype))
                else:
                    arr = np.frombuffer(frame, dtype=np.dtype(dtype),
                                        offset=poff)
                arr = arr.reshape(shape)
            return cls(type=MsgType(mtype), key=key, sender=sender,
                       meta=meta, array=arr)
        except FrameIntegrityError:
            raise
        except Exception as e:
            _count_frame_error("header")
            raise FrameIntegrityError(
                f"binary wire header malformed ({e!r}); dropping the "
                "connection") from e


# ---- fault injection (reference PS_DROP_MSG, van.cc:510-512: received
# data messages are dropped with the given percentage probability) ---------

import random as _random  # noqa: E402 — fault-injection section stays self-contained

_drop_rng = _random.Random(0xD209)

# chaos drop-rate epochs (resilience/chaos.py): an in-process override
# that takes precedence over GEOMX_DROP_MSG for a window of steps
_drop_override: "int | None" = None


def set_drop_rate_override(rate) -> None:
    """Install (0-100) or clear (None) the in-process drop-rate
    override.  The chaos engine uses this so loss epochs are scheduled
    and reversible instead of leaking env state across tests."""
    global _drop_override
    _drop_override = None if rate is None else max(0, min(100, int(rate)))


def reseed_drop_rng(seed: int) -> None:
    """Reseed the shared drop RNG: a seeded chaos schedule reproduces
    the exact message-loss pattern run to run."""
    _drop_rng.seed(seed)


# chaos bit-corruption epochs (resilience/chaos.py ``corrupt@``): the
# in-process sender-side override the data path consults, installed and
# cleared by the chaos engine exactly like the drop-rate override.  A
# corrupted frame keeps its CRC of the ORIGINAL bytes, so the receiver's
# integrity check fails, the connection drops, and the sender's
# retry/reconnect path re-delivers a clean copy — the end-to-end story
# the wire-CRC gate exists to prove.  Keyed by wire sender id (the
# bench's workers use party == sender_id); -1 matches every sender.
_corrupt_rates: "dict[int, int]" = {}
_corrupt_rng = _random.Random(0xC0DE)


def set_corruption_override(party, rate) -> None:
    """Install (0-100) or clear (None) the corruption rate for wire
    sender ``party`` (-1 = all senders)."""
    p = int(party)
    if rate is None:
        _corrupt_rates.pop(p, None)
    else:
        _corrupt_rates[p] = max(0, min(100, int(rate)))


def clear_corruption_overrides() -> None:
    _corrupt_rates.clear()


def reseed_corrupt_rng(seed: int) -> None:
    """Seeded corruption patterns, like :func:`reseed_drop_rng`."""
    _corrupt_rng.seed(seed)


def maybe_corrupt_frame(msg: "Msg", frame: bytes) -> bytes:
    """Fault injection at the sender: with the configured probability,
    flip one random bit of an encoded frame's CRC-covered region.  Only
    retry-protected data traffic is eligible (``meta["resend"]`` /
    ``best_effort``, never ``reliable`` or control frames) — the same
    discipline :func:`should_drop` enforces, because corruption without
    a retry path would wedge a tier instead of testing its recovery.
    The flip lands at offset >= 1 so the version byte survives and the
    receiver takes the CRC-checked parse, not the legacy fallback."""
    if not _corrupt_rates:
        return frame
    if msg.type not in (MsgType.PUSH, MsgType.PULL):
        return frame
    if not (msg.meta.get("resend") or msg.meta.get("best_effort")) \
            or msg.meta.get("reliable"):
        return frame
    rate = _corrupt_rates.get(int(msg.sender), _corrupt_rates.get(-1, 0))
    if rate <= 0 or _corrupt_rng.random() * 100.0 >= rate:
        return frame
    buf = bytearray(frame)
    i = _corrupt_rng.randrange(1, len(buf))
    buf[i] ^= 1 << _corrupt_rng.randrange(8)
    if msg.key is not None and msg.meta.get("round") is not None:
        # fleet round ledger: name the exact (key, round) hop this
        # injected fault landed on — the receiver can only count an
        # anonymous CRC rejection, the sender knows the victim
        try:
            from geomx_tpu_torch.telemetry.ledger import CORRUPT, record_hop
            record_hop(msg.key, int(msg.meta["round"]), CORRUPT,
                       party=msg.sender,
                       detail={"offset": i, "nbytes": len(buf)})
        except Exception:
            pass
    return bytes(buf)


# chaos link-quality shaping (resilience/chaos.py `throttle@`/`delay@`):
# per-party overrides the in-process transports consult, installed and
# cleared by the chaos engine exactly like the drop-rate override above.
# ``factor`` multiplies the link's effective throughput (0 < f <= 1
# slows it; 0.125 models an 8x-degraded uplink), ``delay_ms`` adds
# fixed latency per WAN round.  The server's relay hop turns these into
# real extra wall-clock inside its RelayToGlobal span, so the
# LinkObservatory *measures* the degradation the schedule injected —
# which is what makes a chaos replay a controller acceptance harness.
_link_shaping: "dict[int, dict]" = {}

_SHAPE_KEEP = object()  # "argument not passed": keep the installed value


def set_link_shaping_override(party, factor=_SHAPE_KEEP,
                              delay_ms=_SHAPE_KEEP) -> None:
    """Install per-party link shaping.  A component you do not pass is
    left as installed (throttle and delay compose on one party);
    passing ``None`` clears that component, and an entry with neither
    component is removed entirely."""
    p = int(party)
    ent = dict(_link_shaping.get(p, {}))
    if factor is not _SHAPE_KEEP:
        if factor is None:
            ent.pop("factor", None)
        else:
            f = float(factor)
            if not 0.0 < f:
                raise ValueError(
                    f"throttle factor must be > 0 (got {factor!r})")
            ent["factor"] = f
    if delay_ms is not _SHAPE_KEEP:
        if delay_ms is None:
            ent.pop("delay_ms", None)
        else:
            d = float(delay_ms)
            if d < 0:
                raise ValueError(f"delay_ms must be >= 0 (got {delay_ms!r})")
            ent["delay_ms"] = d
    if ent:
        _link_shaping[p] = ent
    else:
        _link_shaping.pop(p, None)


def get_link_shaping(party) -> dict:
    """The active shaping entry for ``party`` ({} when unshapen)."""
    return dict(_link_shaping.get(int(party), {}))


def clear_link_shaping_overrides() -> None:
    """Remove every shaping override (chaos-engine close / test
    isolation)."""
    _link_shaping.clear()


def shaping_extra_seconds(party, base_seconds: float = 0.0) -> float:
    """Artificial extra wall-clock for a WAN round on ``party``'s link
    that genuinely took ``base_seconds``: the configured fixed delay
    plus the slowdown a throughput factor implies
    (``base * (1/factor - 1)``).  0.0 when the link is unshapen."""
    ent = _link_shaping.get(int(party))
    if not ent:
        return 0.0
    extra = ent.get("delay_ms", 0.0) / 1e3
    f = ent.get("factor")
    if f is not None and f < 1.0:
        extra += max(base_seconds, 0.0) * (1.0 / f - 1.0)
    return extra


def env_int(names, default: int) -> int:
    """First-set env var among `names` wins (shared config._env parser, so
    unparseable values raise like every other GEOMX_* knob)."""
    from geomx_tpu_torch.config import _env
    return _env(names, default, int)


def drop_rate() -> int:
    """Drop percentage: the chaos override when installed, else
    GEOMX_DROP_MSG / PS_DROP_MSG (0-100)."""
    if _drop_override is not None:
        return _drop_override
    return max(0, min(100, env_int(("GEOMX_DROP_MSG", "PS_DROP_MSG"), 0)))


def should_drop(msg: Msg) -> bool:
    """True if fault injection says to drop this *data* message.  Only
    resend-protected traffic (meta["resend"], set by clients with the
    Resender enabled) is droppable — the reference likewise only drops
    through the Resender-covered path, and refuses PS_DROP_MSG without
    PS_RESEND.  Control traffic and the local->global relay hop (which
    blocks under the store lock with no resender) are never dropped."""
    rate = drop_rate()
    if rate <= 0:
        return False
    if msg.type not in (MsgType.PUSH, MsgType.PULL):
        return False
    # best-effort DGT blocks are droppable WITHOUT resend protection —
    # the reference's lossy UDP channels, where a dropped block is
    # simply gone (van.cc:723-846)
    droppable = msg.meta.get("resend") or msg.meta.get("best_effort")
    if not droppable or msg.meta.get("reliable"):
        return False
    return _drop_rng.random() * 100.0 < rate


def connect_retry(addr, total_timeout_s: float = 30.0,
                  interval_s: float = 0.25) -> socket.socket:
    """create_connection with retry-until-deadline: cluster bring-up is not
    strictly ordered (the launcher starts tiers with best-effort delays;
    ssh + interpreter start times vary), so peers wait for their server to
    come up instead of dying on the first ConnectionRefused — the same
    spin the reference's Van does waiting for the scheduler.  Retries go
    through the shared seeded-jitter discipline (service/retry.py):
    counted in ``geomx_rpc_retries_total{op="connect"}``, jitter seeded
    from the target address so co-starting peers decorrelate while any
    one peer's timing stays reproducible."""
    from geomx_tpu_torch.service.retry import SeededBackoff, count_retry
    backoff = SeededBackoff(seed=zlib.crc32(repr(addr).encode()),
                            base_s=interval_s, factor=1.0,
                            max_s=max(interval_s, 0.25), jitter=0.5)
    deadline = time.monotonic() + total_timeout_s
    while True:
        try:
            sock = socket.create_connection(addr, timeout=10.0)
            # the connect timeout must not persist as the operation timeout:
            # PS sockets legitimately block >10s (sync pulls held for a
            # straggling party, barriers), and a timeout mid-frame would
            # desync the length-prefixed framing
            sock.settimeout(None)
            return sock
        except socket.gaierror:
            raise  # name resolution failure is not a bring-up race
        except OSError:
            if time.monotonic() >= deadline:
                raise
            count_retry("connect")
            time.sleep(backoff.next())


class WireStats:
    """Process-wide sent/received byte and message counters — the
    analogue of ps-lite's Van counters (van.h:182-183, send_bytes_/
    recv_bytes_), surfaced per process because one process is one node
    role in the launch model."""

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0
        self.msgs_sent = 0
        self.msgs_received = 0
        # small-key round batching (batch_drain_enabled): one drain =
        # one syscall; per-frame byte/message counters stay exact while
        # these two expose the coalescing the batch path achieved
        self.batches_sent = 0
        self.batched_frames = 0

    def add_sent(self, n: int):
        with self._lock:
            self.bytes_sent += n
            self.msgs_sent += 1

    def add_sent_batch(self, nframes: int, nbytes: int):
        """Account one coalesced drain: ``nframes`` frames shipped in a
        single ``sendall`` totalling ``nbytes`` on-wire bytes (length
        prefixes included)."""
        with self._lock:
            self.bytes_sent += nbytes
            self.msgs_sent += nframes
            self.batches_sent += 1
            self.batched_frames += nframes

    def add_received(self, n: int):
        with self._lock:
            self.bytes_received += n
            self.msgs_received += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"bytes_sent": self.bytes_sent,
                    "bytes_received": self.bytes_received,
                    "msgs_sent": self.msgs_sent,
                    "msgs_received": self.msgs_received,
                    "batches_sent": self.batches_sent,
                    "batched_frames": self.batched_frames}


wire_stats = WireStats()


_verbose_cache: Optional[int] = None


def _verbose_level() -> int:
    # cached: two env lookups per frame on the hot path add up; tests
    # (and runtime reconfiguration) call reset_verbose_cache()
    global _verbose_cache
    if _verbose_cache is None:
        try:
            # graftlint: disable=GXL006 — host-plane knob
            _verbose_cache = int(os.environ.get("GEOMX_PS_VERBOSE")
                                 # graftlint: disable=GXL006 — host-plane knob
                                 or os.environ.get("PS_VERBOSE") or "0")
        except ValueError:
            _verbose_cache = 0
    return _verbose_cache


def reset_verbose_cache() -> None:
    global _verbose_cache
    _verbose_cache = None


def _log_msg(direction: str, msg: Msg, nbytes: int) -> None:
    """PS_VERBOSE>=2: log every wire message (the reference's per-message
    Van logging, postoffice.h:237 / van.cc DBG)."""
    import sys
    print(f"[geomx-wire] {direction} {msg.type.name} key={msg.key!r} "
          f"sender={msg.sender} rid={msg.meta.get('rid')} "
          f"bytes={nbytes}", file=sys.stderr, flush=True)


def send_frame(sock: socket.socket, msg: Msg) -> int:
    """Encode + ship one frame; returns the total on-wire byte count
    (length prefix included) so callers doing byte-true accounting —
    the serving fast path's RequestLedger — measure what actually
    crossed the socket."""
    data = maybe_corrupt_frame(msg, msg.encode())
    sock.sendall(_LEN.pack(len(data)) + data)
    wire_stats.add_sent(len(data) + 4)
    if _verbose_level() >= 2:
        _log_msg("SEND", msg, len(data))
    return len(data) + 4


def recv_frame_sized(sock: socket.socket) -> Optional[Tuple[Msg, int]]:
    """:func:`recv_frame` plus the received frame's on-wire byte count
    (length prefix included) — the rx half of the byte-true accounting
    the serving fast path's RequestLedger does per request."""
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    cap = max_frame_bytes()
    if n > cap:
        # a corrupted/hostile length prefix must not drive _recv_exact
        # into an unbounded allocation: reject BEFORE allocating and
        # drop the connection (the stream position is untrustworthy)
        _count_frame_error("length")
        import sys
        print(f"[geomx-wire] rejected frame announcing {n} bytes "
              f"(GEOMX_MAX_FRAME_BYTES={cap}); closing connection",
              file=sys.stderr, flush=True)
        raise FrameIntegrityError(
            f"frame length {n} exceeds GEOMX_MAX_FRAME_BYTES={cap}")
    data = _recv_exact(sock, n)
    if data is None:
        return None
    # count BEFORE decode: a frame rejected by the header unpickler was
    # still read off the wire, and the sent/received reconciliation the
    # counters exist for must not show a phantom deficit during exactly
    # the malformed-frame events being diagnosed
    wire_stats.add_received(n + 4)
    msg = Msg.decode(data)
    if _verbose_level() >= 2:
        _log_msg("RECV", msg, n)
    return msg, n + 4


def recv_frame(sock: socket.socket) -> Optional[Msg]:
    got = recv_frame_sized(sock)
    return None if got is None else got[0]


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = io.BytesIO()
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            return None
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()
