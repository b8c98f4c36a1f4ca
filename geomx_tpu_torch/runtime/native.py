"""ctypes bindings for native/geops_runtime.cpp (the port's own binding
of the shared ``native/libgeops.so``; geomx_tpu/runtime/native.py is the
JAX package's).  One library, two bindings: the C++ source is not
forked, and the library builds at first use with ``make -C native``, as
the JAX binding builds it.  The build runs under an exclusive file lock
so that processes starting together (the launcher's roles, test
workers) do not write the library at once."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgeops.so")

_lib = None
_lib_lock = threading.Lock()


def _stale() -> bool:
    """The built .so predates the source (e.g. after a pull): rebuild."""
    src = os.path.join(_NATIVE_DIR, "geops_runtime.cpp")
    try:
        return os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    except OSError:
        return False


def _build_locked() -> None:
    """``make -C native -B`` under an exclusive lock on
    ``native/.build.lock``, into a temporary name that then replaces
    ``libgeops.so`` in one rename: a process that loads the library
    meanwhile sees the old file or the new one, never a half-written
    one, and a process that waited on the lock finds the library fresh
    and builds nothing."""
    import fcntl
    try:
        lock = open(os.path.join(_NATIVE_DIR, ".build.lock"), "a")
    except OSError:
        return  # read-only checkout: a pre-existing .so may still bind
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH) and not _stale():
            return
        tmp = f".libgeops.{os.getpid()}.so"
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR, "-B",
                            f"TARGET={tmp}"],
                           check=True, capture_output=True, timeout=120)
            os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
        except (subprocess.SubprocessError, OSError):
            pass  # fall through: a pre-existing .so may still bind


def load_native(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native runtime; None if unavailable."""
    global _lib
    if _lib is not None:  # hot path: no lock once bound (GIL-atomic read)
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if build and (not os.path.exists(_LIB_PATH) or _stale()):
            _build_locked()
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            return _bind(lib)
        except (OSError, AttributeError):
            # missing symbol = stale binary that could not be rebuilt:
            # degrade to the pure-Python paths instead of crashing the
            # capability probe (native_available)
            return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
        global _lib
        # queue
        lib.gx_queue_create.restype = ctypes.c_void_p
        lib.gx_queue_destroy.argtypes = [ctypes.c_void_p]
        lib.gx_queue_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int64, ctypes.c_int64]
        lib.gx_queue_push.restype = ctypes.c_int
        lib.gx_queue_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.POINTER(ctypes.c_int64)]
        lib.gx_queue_pop.restype = ctypes.c_int64
        lib.gx_queue_size.argtypes = [ctypes.c_void_p]
        lib.gx_queue_size.restype = ctypes.c_int64
        lib.gx_queue_close.argtypes = [ctypes.c_void_p]
        # tsengine
        lib.gx_ts_create.argtypes = [ctypes.c_int, ctypes.c_double,
                                     ctypes.c_uint64]
        lib.gx_ts_create.restype = ctypes.c_void_p
        lib.gx_ts_destroy.argtypes = [ctypes.c_void_p]
        lib.gx_ts_report.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_double,
                                     ctypes.c_int64]
        lib.gx_ts_ask.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int64]
        lib.gx_ts_ask.restype = ctypes.c_int
        lib.gx_ts_ask1.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.gx_ts_ask1.restype = ctypes.c_int
        lib.gx_ts_ask1_key.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.gx_ts_ask1_key.restype = ctypes.c_int
        lib.gx_ts_drain_key.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.gx_ts_drain_key.restype = ctypes.c_int
        lib.gx_ts_iters.argtypes = [ctypes.c_void_p]
        lib.gx_ts_iters.restype = ctypes.c_int64
        # sgd
        fp = ctypes.POINTER(ctypes.c_float)
        lib.gx_sgd_update.argtypes = [fp, fp, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_float]
        lib.gx_sgd_mom_update.argtypes = [fp, fp, fp, ctypes.c_int64,
                                          ctypes.c_float, ctypes.c_float,
                                          ctypes.c_float, ctypes.c_float]
        # recordio
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gx_recio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.gx_recio_writer_open.restype = ctypes.c_void_p
        lib.gx_recio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int]
        lib.gx_recio_write.restype = ctypes.c_int64
        lib.gx_recio_writer_close.argtypes = [ctypes.c_void_p]
        lib.gx_recio_writer_close.restype = ctypes.c_int
        lib.gx_recio_reader_open.argtypes = [ctypes.c_char_p]
        lib.gx_recio_reader_open.restype = ctypes.c_void_p
        lib.gx_recio_count.argtypes = [ctypes.c_void_p]
        lib.gx_recio_count.restype = ctypes.c_int64
        lib.gx_recio_key.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.gx_recio_key.restype = ctypes.c_int64
        lib.gx_recio_read_idx.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_char_p, ctypes.c_int64,
                                          i64p]
        lib.gx_recio_read_idx.restype = ctypes.c_int64
        lib.gx_recio_size.argtypes = [ctypes.c_void_p]
        lib.gx_recio_size.restype = ctypes.c_int64
        lib.gx_recio_read_off.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_char_p, ctypes.c_int64,
                                          i64p, i64p]
        lib.gx_recio_read_off.restype = ctypes.c_int64
        lib.gx_recio_reader_close.argtypes = [ctypes.c_void_p]
        # wire fast path (service/protocol.py binary frames): ctypes
        # foreign calls drop the GIL, so CRC/seal/verify and the pair
        # merge run truly concurrently across serve/drain threads.
        # argtypes use c_void_p for the buffers — the call sites pass
        # writable bytearrays via (c_char * n).from_buffer and numpy
        # arrays via .ctypes.data, which c_char_p would refuse/copy.
        lib.gx_wire_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.gx_wire_crc32.restype = ctypes.c_uint32
        lib.gx_wire_seal.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int32]
        lib.gx_wire_seal.restype = ctypes.c_int32
        lib.gx_wire_verify.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.gx_wire_verify.restype = ctypes.c_int32
        lib.gx_merge_pairs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_void_p,
                                       ctypes.c_void_p]
        lib.gx_merge_pairs.restype = ctypes.c_int64
        lib.gx_scatter_pairs.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64]
        lib.gx_scatter_pairs.restype = ctypes.c_int64
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


# ---- wire fast path (service/protocol.py binary frames) -------------------

def wire_seal(frame: bytearray, version: int) -> bool:
    """Fill a binary frame's 5-byte integrity prelude in place (version
    byte + CRC32 of the body) with the GIL released.  Returns False
    when the native runtime is unavailable — the caller's pure-Python
    zlib path produces the identical bytes."""
    lib = load_native()
    if lib is None:
        return False
    # base address without minting a ctypes array TYPE per call
    # ((c_char * n) costs ~10us of class creation; from_buffer on the
    # scalar type is a cheap writable view that pins the bytearray)
    base = ctypes.addressof(ctypes.c_char.from_buffer(frame))
    return lib.gx_wire_seal(base, len(frame), int(version)) == 0


def wire_verify(frame: bytes) -> Optional[bool]:
    """CRC-check a sealed frame (either codec version) with the GIL
    released.  True/False on a real check; None when the native runtime
    is unavailable (caller falls back to zlib.crc32)."""
    lib = load_native()
    if lib is None:
        return None
    return lib.gx_wire_verify(frame, len(frame)) == 0


def merge_pairs(vals, idx):
    """Nogil sorted-sender pair merge — bit-identical to
    compression.sparseagg.merge_pairs_host's numpy fold (stable index
    sort + sequential float32 segment sums).  Takes the CONCATENATED
    (vals f32, idx i64) contribution arrays; returns compact
    ``(vals, idx)`` or None when the native runtime is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    import numpy as np
    vals = np.ascontiguousarray(vals, np.float32).reshape(-1)
    idx = np.ascontiguousarray(idx, np.int64).reshape(-1)
    n = int(vals.size)
    if n != int(idx.size):
        raise ValueError(f"pair arrays disagree: {n} vs {idx.size}")
    out_v = np.empty(n, np.float32)
    out_i = np.empty(n, np.int64)
    m = lib.gx_merge_pairs(vals.ctypes.data, idx.ctypes.data, n,
                           out_v.ctypes.data, out_i.ctypes.data)
    return out_v[:m].copy(), out_i[:m].copy()


def scatter_pairs(out, vals, idx) -> Optional[int]:
    """Nogil in-place pair scatter-add: ``out[idx[i]] += vals[i]`` in
    order (sentinels idx<0 dropped) — bit-identical to
    compression.sparseagg.densify_pairs_host's np.add.at fold.  ``out``
    must be a C-contiguous float32 1-D array; ``vals``/``idx`` must
    already be contiguous f32/i64 (the serving replica's delta decode
    hands them over in exactly that form — no silent copies here, a
    copy would defeat the O(k) point).  Returns the applied pair count,
    or None when the native runtime is unavailable (caller falls back
    to the numpy path).  Raises on an out-of-range index — the native
    side checks bounds before any write, so a bad delta never
    half-applies."""
    lib = load_native()
    if lib is None:
        return None
    import numpy as np
    if not (isinstance(out, np.ndarray) and out.dtype == np.float32
            and out.ndim == 1 and out.flags["C_CONTIGUOUS"]
            and out.flags["WRITEABLE"]):
        raise ValueError("out must be a writable C-contiguous float32 "
                         "1-D ndarray")
    if not (isinstance(vals, np.ndarray) and vals.dtype == np.float32
            and vals.flags["C_CONTIGUOUS"]):
        raise ValueError("vals must be a C-contiguous float32 ndarray")
    if not (isinstance(idx, np.ndarray) and idx.dtype == np.int64
            and idx.flags["C_CONTIGUOUS"]):
        raise ValueError("idx must be a C-contiguous int64 ndarray")
    k = int(vals.size)
    if k != int(idx.size):
        raise ValueError(f"pair arrays disagree: {k} vs {idx.size}")
    applied = lib.gx_scatter_pairs(out.ctypes.data, int(out.size),
                                   vals.ctypes.data, idx.ctypes.data, k)
    if applied < 0:
        raise IndexError(
            f"pair delta index out of range for size-{out.size} layer")
    return int(applied)


class NativePriorityQueue:
    """C++ priority send queue (drop-in for transport.PrioritySendQueue
    for bytes payloads)."""

    def __init__(self):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native runtime unavailable (no toolchain?)")
        self._lib = lib
        self._q = lib.gx_queue_create()
        # persistent pop buffer, grown on demand: the old per-call
        # ``create_string_buffer(64 KiB)`` + ``buf.raw[:n]`` pattern
        # allocated AND materialized the whole buffer on every pop — a
        # >1 MiB frame paid two large copies per message.  The buffer
        # is guarded by a lock (pop is re-entrant across the send-loop
        # and test threads) and ``string_at`` copies exactly n bytes.
        self._pop_lock = threading.Lock()
        self._pop_buf = ctypes.create_string_buffer(1 << 16)

    def push(self, payload: bytes, priority: int = 0) -> None:
        rc = self._lib.gx_queue_push(self._q, payload, len(payload),
                                     priority)
        if rc != 0:
            raise RuntimeError("queue closed")

    def pop(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[bytes, int]]:
        """(payload, priority), or None on close/timeout."""
        with self._pop_lock:
            while True:
                buf = self._pop_buf
                prio = ctypes.c_int64()
                req = ctypes.c_int64()
                t = -1 if timeout is None else int(timeout * 1000)
                n = self._lib.gx_queue_pop(self._q, buf, len(buf), t,
                                           ctypes.byref(prio),
                                           ctypes.byref(req))
                if n == -3:
                    # buffer too small: the message stays queued and the
                    # required size came back in *req — retry with
                    # EXACTLY that size (no doubling loop; one grow per
                    # high-water mark, kept for subsequent pops)
                    self._pop_buf = ctypes.create_string_buffer(
                        int(req.value))
                    continue
                if n < 0:
                    return None
                return ctypes.string_at(buf, n), int(prio.value)

    def close(self) -> None:
        if self._q is not None:
            self._lib.gx_queue_close(self._q)

    def destroy(self) -> None:
        """Free the native queue.  Only call once no consumer thread can
        re-enter pop(); gx_queue_destroy additionally drains in-flight
        poppers (waiter count) before freeing."""
        q, self._q = self._q, None
        if q is not None:
            self._lib.gx_queue_destroy(q)

    def __len__(self) -> int:
        if self._q is None:
            return 0
        return int(self._lib.gx_queue_size(self._q))

    def __del__(self):
        # close (wakes blocked poppers) but deliberately do NOT destroy:
        # a daemon sender thread may still loop back into pop(); the small
        # native object is reclaimed at process exit instead.
        try:
            if self._q is not None:
                self._lib.gx_queue_close(self._q)
        except Exception:
            pass


class NativeTSEngine:
    """C++ TSEngine scheduler (same surface as transport.TSEngineScheduler)."""

    STOP = -1

    def __init__(self, num_nodes: int, max_greed_rate: float = 0.9,
                 seed: int = 0):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native runtime unavailable (no toolchain?)")
        self._lib = lib
        self._ts = lib.gx_ts_create(num_nodes, max_greed_rate, seed)
        self.n = num_nodes

    def report(self, sender: int, receiver: int, throughput: float,
               version: int) -> None:
        self._lib.gx_ts_report(self._ts, sender, receiver, throughput, version)

    def ask(self, sender: int, version: int) -> int:
        return int(self._lib.gx_ts_ask(self._ts, sender, version))

    def ask1(self, node: int) -> Optional[Tuple[int, int]]:
        out = (ctypes.c_int * 2)()
        if self._lib.gx_ts_ask1(self._ts, node, out):
            return int(out[0]), int(out[1])
        return None

    def ask1_key(self, node: int, key,
                 num_pushers: int) -> Optional[Tuple[int, int]]:
        """Per-key ASK1 pairing with sink termination (same semantics as
        TSEngineScheduler.ask1_key)."""
        out = (ctypes.c_int * 2)()
        if self._lib.gx_ts_ask1_key(self._ts, node,
                                    str(key).encode("utf-8"),
                                    num_pushers, out):
            return int(out[0]), int(out[1])
        return None

    def drain_key(self, key) -> list:
        """Abort a key's round; returns the still-queued nodes."""
        out = (ctypes.c_int * self.n)()
        n = self._lib.gx_ts_drain_key(self._ts, str(key).encode("utf-8"),
                                      out)
        return [int(out[i]) for i in range(n)]

    @property
    def iters(self) -> int:
        return int(self._lib.gx_ts_iters(self._ts))

    def __del__(self):
        try:
            self._lib.gx_ts_destroy(self._ts)
        except Exception:
            pass


class NativeSGD:
    """C++ server-side SGD (reference src/optimizer/sgd-inl.h:40-178):
    in-place plain / momentum updates with gradient clipping and weight
    decay, for the host PS service's hot path — no optax/jax dispatch per
    key per round."""

    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 weight_decay: float = 0.0, clip_gradient: float = -1.0):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native runtime unavailable (no toolchain?)")
        self._lib = lib
        self.lr = float(learning_rate)
        self.momentum = float(momentum)
        self.wd = float(weight_decay)
        self.clip = float(clip_gradient)

    def init_state(self, w):
        import numpy as np
        if self.momentum == 0.0:
            return None
        # np.zeros (not zeros_like): the buffer must be C-contiguous even
        # when w arrived F-ordered — update() rejects anything else
        return np.zeros(np.shape(w), np.float32)

    def update(self, w, g, mom=None):
        """In-place update of float32 arrays w (and mom); returns w."""
        import ctypes as ct

        import numpy as np
        w = np.ascontiguousarray(w, np.float32)
        g = np.ascontiguousarray(g, np.float32)
        if w.shape != g.shape:
            raise ValueError(f"shape mismatch {w.shape} vs {g.shape}")
        fp = ct.POINTER(ct.c_float)
        wp = w.ctypes.data_as(fp)
        gp = g.ctypes.data_as(fp)
        if self.momentum == 0.0:
            self._lib.gx_sgd_update(wp, gp, w.size, self.lr, self.wd,
                                    self.clip)
        else:
            if mom is None:
                raise ValueError("momentum update needs the mom buffer")
            # the momentum update is in place; a silent ascontiguousarray
            # copy here would be applied to a temporary and lost
            if not (isinstance(mom, np.ndarray) and mom.dtype == np.float32
                    and mom.flags["C_CONTIGUOUS"]):
                raise ValueError(
                    "mom must be a C-contiguous float32 ndarray "
                    "(use init_state to allocate it)")
            self._lib.gx_sgd_mom_update(wp, gp,
                                        mom.ctypes.data_as(fp), w.size,
                                        self.lr, self.momentum, self.wd,
                                        self.clip)
        return w


class NativeRecordIOWriter:
    """C++ recordio writer — byte-identical output to
    data.recordio.RecordIOWriter (magic/len/crc framing + .idx sidecar)."""

    def __init__(self, path: str, index: bool = True):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self.path = path
        self._h = lib.gx_recio_writer_open(path.encode(), 1 if index else 0)
        if not self._h:
            raise OSError(f"cannot open {path!r} for writing")

    def write(self, payload: bytes, key: Optional[int] = None) -> int:
        off = self._lib.gx_recio_write(self._h, payload, len(payload),
                                       0 if key is None else int(key),
                                       0 if key is None else 1)
        if off < 0:
            raise OSError("recordio write failed")
        return int(off)

    def close(self):
        if self._h:
            h, self._h = self._h, None
            if self._lib.gx_recio_writer_close(h) != 0:
                raise OSError(
                    f"recordio close failed for {self.path!r} (buffered "
                    "writes could not be flushed — disk full?)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeRecordIOReader:
    """C++ recordio reader with the same surface as
    data.recordio.RecordIOReader (iteration, read_idx, keys,
    read_shard)."""

    def __init__(self, path: str):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self.path = path
        self._h = lib.gx_recio_reader_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path!r}")
        # per-READER buffer for indexed reads, reused across calls under
        # a Python-side lock (the C mutex only guards the fill; the
        # copy-out must not race another call's fill).  Iterators own
        # their OWN buffer+cursor, so concurrent iteration is safe.
        self._buf = [ctypes.create_string_buffer(1 << 16)]
        self._rd_lock = threading.Lock()

    def _call(self, fn, *args, bufholder, consumed=None) -> bytes:
        import ctypes as ct
        while True:
            req = ct.c_int64()
            extra = () if consumed is None else (ct.byref(consumed),)
            buf = bufholder[0]
            n = fn(self._h, *args, buf, len(buf), ct.byref(req), *extra)
            if n == -3:
                bufholder[0] = ct.create_string_buffer(int(req.value))
                continue
            if n == -1:
                raise EOFError("end of recordio stream")
            if n == -4:
                raise IndexError("record index out of range")
            if n < 0:
                raise ValueError("corrupt record (bad magic or crc)")
            # copy exactly n bytes (`.raw[:n]` would materialize the
            # whole — possibly once-grown-huge — buffer every record)
            return ct.string_at(buf, n)

    def __iter__(self):
        # per-iterator cursor AND buffer (parity with the Python
        # reader): nested or concurrent iterators share nothing mutable
        import ctypes as ct
        off = 0
        size = int(self._lib.gx_recio_size(self._h))
        consumed = ct.c_int64()
        bufholder = [ct.create_string_buffer(1 << 16)]
        while off < size:
            payload = self._call(self._lib.gx_recio_read_off, off,
                                 bufholder=bufholder, consumed=consumed)
            off += int(consumed.value)
            yield payload

    def __len__(self) -> int:
        n = self._lib.gx_recio_count(self._h)
        if n < 0:
            raise TypeError("no .idx sidecar; sequential access only")
        return int(n)

    def read_idx(self, i: int) -> bytes:
        with self._rd_lock:
            return self._call(self._lib.gx_recio_read_idx, int(i),
                              bufholder=self._buf)

    def keys(self):
        return [int(self._lib.gx_recio_key(self._h, i))
                for i in range(len(self))]

    def read_shard(self, part_index: int, num_parts: int):
        from geomx_tpu_torch.data.recordio import shard_bounds
        lo, hi = shard_bounds(len(self), part_index, num_parts)
        for i in range(lo, hi):
            yield self.read_idx(i)

    def close(self):
        if self._h:
            self._lib.gx_recio_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
