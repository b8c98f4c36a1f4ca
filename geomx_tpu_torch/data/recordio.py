"""RecordIO — the reference's packed binary dataset format (port of
geomx_tpu/data/recordio.py; the files are byte-identical to the JAX
package's Python writer).

Reference: dmlc-core recordio (3rdparty/dmlc-core/include/dmlc/recordio.h:
magic-delimited length-prefixed records) consumed by the image iterators
in src/io/ (iter_image_recordio_2.cc), packed by tools/im2rec.  Packing a
dataset into one sequential file turns millions of small reads into
large streaming reads — exactly what feeding a TPU pod from networked
storage wants.

Format (little-endian):

    [MAGIC u32][len u32][crc32 u32][payload len bytes][pad to 4B]

An optional ``.idx`` sidecar (``<key>\t<offset>\n`` per record, the
reference's indexed recordio) enables O(1) random access and sharded
reads (``read_shard`` = each worker reads only its slice — the
SplitSampler applied at the file level).

``recordio_writer``/``recordio_reader`` prefer the native C++ runtime
(``runtime/native.py``, the port's binding of the shared
``native/libgeops.so``; byte-identical files), as the JAX package's do;
``GEOMX_NATIVE_RECORDIO=0`` or a missing toolchain selects the Python
classes.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

_MAGIC = 0xCED7230A
_HEAD = struct.Struct("<III")


class RecordIOWriter:
    def __init__(self, path: str, index: bool = True):
        self.path = path
        self._f = open(path, "wb")
        self._idx = open(path + ".idx", "w") if index else None
        self._n = 0

    def write(self, payload: bytes, key: Optional[int] = None) -> int:
        """Append one record; returns its offset."""
        off = self._f.tell()
        self._f.write(_HEAD.pack(_MAGIC, len(payload),
                                 zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        pad = (-len(payload)) % 4
        if pad:
            self._f.write(b"\x00" * pad)
        if self._idx is not None:
            self._idx.write(f"{self._n if key is None else key}\t{off}\n")
        self._n += 1
        return off

    def close(self):
        self._f.close()
        if self._idx is not None:
            self._idx.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordIOReader:
    """Sequential + (with the .idx sidecar) random-access reader."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._flock = threading.Lock()
        self._offsets: Optional[List[Tuple[int, int]]] = None
        idx = path + ".idx"
        if os.path.exists(idx):
            with open(idx) as f:
                self._offsets = [
                    (int(k), int(off)) for k, off in
                    (ln.split("\t") for ln in f if ln.strip())]

    def _read_at(self, off: int) -> bytes:
        # seek+read must be atomic: prefetch threads and the consumer may
        # share this reader, and interleaved seeks corrupt the stream
        with self._flock:
            return self._read_at_locked(off)

    def _read_at_locked(self, off: int) -> bytes:
        self._f.seek(off)
        head = self._f.read(_HEAD.size)
        if len(head) < _HEAD.size:
            raise EOFError("truncated record header")
        magic, length, crc = _HEAD.unpack(head)
        if magic != _MAGIC:
            raise ValueError(f"bad magic at offset {off}: {magic:#x}")
        payload = self._f.read(length)
        if len(payload) < length:
            raise EOFError("truncated record payload")
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise ValueError(f"crc mismatch at offset {off}")
        return payload

    def __iter__(self) -> Iterator[bytes]:
        off = 0
        end = os.fstat(self._f.fileno()).st_size
        while off < end:
            payload = self._read_at(off)
            off += _HEAD.size + len(payload) + ((-len(payload)) % 4)
            yield payload

    def __len__(self) -> int:
        if self._offsets is None:
            raise TypeError("no .idx sidecar; sequential access only")
        return len(self._offsets)

    def read_idx(self, i: int) -> bytes:
        """Record by index-file position (reference indexed recordio)."""
        if self._offsets is None:
            raise TypeError("no .idx sidecar; sequential access only")
        return self._read_at(self._offsets[i][1])

    def keys(self) -> Sequence[int]:
        if self._offsets is None:
            raise TypeError("no .idx sidecar; sequential access only")
        return [k for k, _ in self._offsets]

    def read_shard(self, part_index: int, num_parts: int) -> Iterator[bytes]:
        """This worker's contiguous slice of the records — the
        SplitSampler's disjoint-parts semantics applied at the file level
        (reference iterators' part_index/num_parts args)."""
        if self._offsets is None:
            raise TypeError("no .idx sidecar; sharding needs it")
        lo, hi = shard_bounds(len(self._offsets), part_index, num_parts)
        for i in range(lo, hi):
            yield self.read_idx(i)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def shard_bounds(n: int, part_index: int, num_parts: int) -> Tuple[int, int]:
    """[lo, hi) of ``part_index``'s contiguous slice; the tail goes to the
    last part.  Validates like SplitSampler (samplers.py)."""
    if num_parts < 1 or not (0 <= part_index < num_parts):
        raise ValueError(
            f"part_index {part_index} out of range for {num_parts} parts")
    part = n // num_parts
    lo = part_index * part
    hi = n if part_index == num_parts - 1 else lo + part
    return lo, hi


# ---- labelled-array convenience (the im2rec payload layout) --------------

_REC = struct.Struct("<Ifhhh")  # label-count=1 marker, label, h, w, c


def pack_labelled(label: float, image: np.ndarray) -> bytes:
    """Serialize (label, uint8 HWC image) — the shape im2rec produces."""
    img = np.ascontiguousarray(image, np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    return _REC.pack(1, float(label), h, w, c) + img.tobytes()


def unpack_labelled(payload: bytes) -> Tuple[float, np.ndarray]:
    """Always returns HWC (c=1 kept) so round-trips preserve the NHWC
    contract of load_dataset (mnist is (n,28,28,1))."""
    _, label, h, w, c = _REC.unpack_from(payload, 0)
    img = np.frombuffer(payload, np.uint8, h * w * c, _REC.size)
    return label, img.reshape((h, w, c))


# ---- factories ------------------------------------------------------------

def recordio_writer(path: str, index: bool = True):
    """The native writer when the runtime is built, else the Python one
    (``GEOMX_NATIVE_RECORDIO=0`` forces Python)."""
    # graftlint: disable=GXL006 — host I/O kill-switch
    if os.environ.get("GEOMX_NATIVE_RECORDIO", "1") != "0":
        from geomx_tpu_torch.runtime.native import (NativeRecordIOWriter,
                                                    native_available)
        if native_available():
            return NativeRecordIOWriter(path, index=index)
    return RecordIOWriter(path, index=index)


def recordio_reader(path: str):
    """The native reader when the runtime is built, else the Python one
    (``GEOMX_NATIVE_RECORDIO=0`` forces Python)."""
    # graftlint: disable=GXL006 — host I/O kill-switch
    if os.environ.get("GEOMX_NATIVE_RECORDIO", "1") != "0":
        from geomx_tpu_torch.runtime.native import (NativeRecordIOReader,
                                                    native_available)
        if native_available():
            return NativeRecordIOReader(path)
    return RecordIOReader(path)
