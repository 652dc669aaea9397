"""RecordIO-style sharded record files: Python API over the native reader.

Reference parity: the reference reads training data from RecordIO shards via
the external C++ `pyrecordio` package, and tasks are (file, offset, count)
spans (SURVEY §2.4). This module provides the same role for the EDLR format
(see native/recordio.cc for the layout): a ctypes binding to the C++
reader/writer plus a pure-Python twin used when the native library isn't
built (and to cross-check it in tests).

The native library auto-builds on first use when a toolchain is present
(g++, one translation unit, no deps — a few hundred ms).
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.data import nativelib
from elasticdl_tpu_torch.data.reader import AbstractDataReader, Shard

logger = default_logger(__name__)

_NATIVE_DIR = nativelib.NATIVE_DIR
_LIB_PATH = os.path.join(_NATIVE_DIR, "libedlrecordio.so")
_lib: Optional[ctypes.CDLL] = None
_FILE_MAGIC = b"EDLR"
_CHUNK_MAGIC = b"CHNK"
_INDEX_MAGIC = b"INDX"
_VERSION = 1


def build_native(force: bool = False) -> Optional[str]:
    """Compile libedlrecordio.so with g++ if missing (delegates to the shared
    builder in data/nativelib.py). Returns path or None."""
    src = os.path.join(_NATIVE_DIR, "recordio.cc")
    return nativelib.build_shared(src, _LIB_PATH, force=force)


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()  # fast no-op when the .so is present and fresh
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.edlr_reader_open.restype = ctypes.c_void_p
    lib.edlr_reader_open.argtypes = [ctypes.c_char_p]
    lib.edlr_reader_num_records.restype = ctypes.c_longlong
    lib.edlr_reader_num_records.argtypes = [ctypes.c_void_p]
    lib.edlr_reader_read.restype = ctypes.c_longlong
    lib.edlr_reader_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    lib.edlr_reader_buffer.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.edlr_reader_buffer.argtypes = [ctypes.c_void_p]
    lib.edlr_reader_error.restype = ctypes.c_char_p
    lib.edlr_reader_error.argtypes = [ctypes.c_void_p]
    lib.edlr_reader_close.restype = None
    lib.edlr_reader_close.argtypes = [ctypes.c_void_p]
    lib.edlr_writer_open.restype = ctypes.c_void_p
    lib.edlr_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.edlr_writer_write.restype = ctypes.c_int
    lib.edlr_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_longlong]
    lib.edlr_writer_close.restype = ctypes.c_longlong
    lib.edlr_writer_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


# --------------------------------------------------------------------- #
# Writers


class RecordIOWriter:
    """Writes one EDLR shard file (native when available)."""

    def __init__(self, path: str, chunk_bytes: int = 1 << 20,
                 prefer_native: bool = True):
        self._path = path
        self._native = _load_lib() if prefer_native else None
        self.num_records = 0
        self._closed = False
        if self._native is not None:
            self._h = self._native.edlr_writer_open(path.encode(), chunk_bytes)
            if not self._h:
                raise IOError(f"cannot open {path} for writing")
        else:
            self._f = open(path, "wb")
            self._f.write(_FILE_MAGIC + struct.pack("<I", _VERSION))
            self._chunk_bytes = chunk_bytes
            self._payload = bytearray()
            self._chunk_records = 0
            self._index: List[Tuple[int, int]] = []

    def write(self, record: bytes) -> None:
        self.num_records += 1
        if self._native is not None:
            if self._native.edlr_writer_write(self._h, record, len(record)) != 0:
                raise IOError("native write failed")
            return
        self._payload += struct.pack("<I", len(record)) + record
        self._chunk_records += 1
        if len(self._payload) >= self._chunk_bytes:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        if not self._chunk_records:
            return
        self._index.append((self._f.tell(), self.num_records - self._chunk_records))
        crc = zlib.crc32(bytes(self._payload)) & 0xFFFFFFFF
        self._f.write(
            _CHUNK_MAGIC
            + struct.pack("<IQI", self._chunk_records, len(self._payload), crc)
        )
        self._f.write(self._payload)
        self._payload = bytearray()
        self._chunk_records = 0

    def close(self) -> int:
        if self._closed:
            return self.num_records
        self._closed = True
        if self._native is not None:
            n = self._native.edlr_writer_close(self._h)
            self._h = None
            if n < 0:
                raise IOError("native close failed")
            return int(n)
        self._flush_chunk()
        index_off = self._f.tell()
        self._f.write(_INDEX_MAGIC + struct.pack("<I", len(self._index)))
        for off, first in self._index:
            self._f.write(struct.pack("<QQ", off, first))
        self._f.write(struct.pack("<Q", index_off) + _FILE_MAGIC)
        self._f.close()
        return self.num_records

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------- #
# Readers


class _PyShardReader:
    """Pure-Python EDLR reader (format twin of the native one)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        head = self._f.read(8)
        if head[:4] != _FILE_MAGIC or struct.unpack("<I", head[4:])[0] != _VERSION:
            raise IOError(f"{path}: not an EDLR file")
        self._f.seek(-12, os.SEEK_END)
        index_off, magic = struct.unpack("<Q4s", self._f.read(12))
        if magic != _FILE_MAGIC:
            raise IOError(f"{path}: bad footer")
        self._f.seek(index_off)
        imagic, num_chunks = struct.unpack("<4sI", self._f.read(8))
        if imagic != _INDEX_MAGIC:
            raise IOError(f"{path}: bad index")
        self._index = [
            struct.unpack("<QQ", self._f.read(16)) for _ in range(num_chunks)
        ]
        if self._index:
            self._f.seek(self._index[-1][0] + 4)
            (n,) = struct.unpack("<I", self._f.read(4))
            self.num_records = self._index[-1][1] + n
        else:
            self.num_records = 0

    def read(self, start: int, end: int) -> Iterator[bytes]:
        end = min(end, self.num_records)
        if start >= end:
            return
        lo = 0
        for i, (_, first) in enumerate(self._index):
            if first <= start:
                lo = i
            else:
                break
        for ci in range(lo, len(self._index)):
            off, first = self._index[ci]
            if first >= end:
                break
            self._f.seek(off)
            magic, n, payload_len, crc = struct.unpack("<4sIQI", self._f.read(20))
            if magic != _CHUNK_MAGIC:
                raise IOError("bad chunk magic")
            payload = self._f.read(payload_len)
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise IOError("chunk crc mismatch")
            pos = 0
            for k in range(n):
                (length,) = struct.unpack_from("<I", payload, pos)
                pos += 4
                rec = payload[pos : pos + length]
                pos += length
                gid = first + k
                if start <= gid < end:
                    yield bytes(rec)

    def close(self):
        self._f.close()


class _NativeShardReader:
    def __init__(self, path: str, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.edlr_reader_open(path.encode())
        if not self._h:
            raise IOError(f"{path}: not a readable EDLR file")
        self.num_records = int(lib.edlr_reader_num_records(self._h))

    def read(self, start: int, end: int) -> Iterator[bytes]:
        n = self._lib.edlr_reader_read(self._h, start, end)
        if n < 0:
            raise IOError(
                f"native read failed: {self._lib.edlr_reader_error(self._h).decode()}"
            )
        buf = ctypes.string_at(self._lib.edlr_reader_buffer(self._h), n)
        pos = 0
        while pos < n:
            (length,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            yield buf[pos : pos + length]
            pos += length

    def close(self):
        if self._h:
            self._lib.edlr_reader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def open_shard(path: str, prefer_native: bool = True):
    lib = _load_lib() if prefer_native else None
    if lib is not None:
        return _NativeShardReader(path, lib)
    return _PyShardReader(path)


class RecordIODataReader(AbstractDataReader):
    """AbstractDataReader over a directory/glob of EDLR shard files."""

    def __init__(self, path: str, prefer_native: bool = True, **_):
        if any(c in path for c in "*?["):
            self._files = sorted(glob.glob(path))
        elif os.path.isdir(path):
            self._files = sorted(
                os.path.join(path, f)
                for f in os.listdir(path)
                if f.endswith(".rio")
            )
        else:
            self._files = [path] if os.path.exists(path) else []
        if not self._files:
            raise FileNotFoundError(f"no recordio files match {path!r}")
        self._prefer_native = prefer_native
        # Workers stream one shard at a time; a small LRU bounds open fds (a
        # master over thousands of shards would otherwise exhaust the ulimit)
        # and chunk-cache memory. Readers backing a partially-consumed
        # read_records() generator are pinned (refcounted) so eviction never
        # closes a file mid-iteration; pinned entries may transiently push the
        # cache past its bound.
        self._readers: "collections.OrderedDict[str, object]" = (
            collections.OrderedDict()
        )
        self._pins: Dict[str, int] = {}
        self._max_open = 8

    def _reader(self, fname: str):
        if fname in self._readers:
            self._readers.move_to_end(fname)
            return self._readers[fname]
        reader = open_shard(fname, self._prefer_native)
        self._readers[fname] = reader
        evictable = [f for f in self._readers if not self._pins.get(f)]
        while len(self._readers) > self._max_open and evictable:
            old_name = evictable.pop(0)
            if old_name == fname:
                continue
            self._readers.pop(old_name).close()
        return reader

    def _pin(self, fname: str) -> None:
        self._pins[fname] = self._pins.get(fname, 0) + 1

    def _unpin(self, fname: str) -> None:
        n = self._pins.get(fname, 0) - 1
        if n <= 0:
            self._pins.pop(fname, None)
        else:
            self._pins[fname] = n

    def create_shards(self) -> List[Shard]:
        shards = []
        for f in self._files:
            reader = open_shard(f, self._prefer_native)
            try:
                shards.append((f, 0, reader.num_records))
            finally:
                reader.close()
        return shards

    def read_records(self, shard_name: str, start: int, end: int) -> Iterator[bytes]:
        reader = self._reader(shard_name)
        self._pin(shard_name)
        try:
            yield from reader.read(start, end)
        finally:
            self._unpin(shard_name)
