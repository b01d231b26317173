"""BinFile record store and prefetch queue (counterpart of
``singa_tpu/io/binfile.py``): ctypes bindings over the repo's native C++
runtime, ``native/singa_io.cpp``, and the JAX module's pure-Python codec
of the same format.

A file is an 8-byte magic (``NSTGAIO1``) then records ``[u32 key
length][key][u64 value length][value][u32 CRC-32 of the value]``, little
endian.  Both codecs write the JAX package's bytes exactly.

The native library is compiled from ``native/singa_io.cpp`` (the source
is shared with the JAX package and read, never edited) by the host C++
compiler at first use, inside :func:`_load_native`, into
``singa_tpu_torch/_build/libsinga_io-<hash>.so``, keyed by a hash of the
source and the flags; nothing is built when the module is imported.
Without a compiler, :func:`native_available` is False and the
pure-Python codec serves, as in the JAX package: it is the reference's
own host path, not a device fallback.

Integrity: a truncated tail record or a CRC mismatch raises
:class:`CorruptRecordError` naming the key and the record's offset,
through either codec.  The native reader's index scan stops silently at
a cut record, so the native path holds the index against the file's size
when it opens a file and names the record it cut.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib

__all__ = ["BinFileWriter", "BinFileReader", "PrefetchQueue",
           "CorruptRecordError", "native_available"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_SRC = os.path.join(os.path.dirname(_PKG), "native", "singa_io.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lib = None
_lib_err = None
_build_lock = threading.Lock()

# (name, restype, argtypes) of every C function the module calls
_SIGNATURES = (
    ("binfile_writer_open", ctypes.c_void_p, [ctypes.c_char_p]),
    ("binfile_writer_put", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]),
    ("binfile_writer_close", ctypes.c_int, [ctypes.c_void_p]),
    ("binfile_reader_open", ctypes.c_void_p, [ctypes.c_char_p]),
    ("binfile_reader_count", ctypes.c_int64, [ctypes.c_void_p]),
    ("binfile_reader_key", ctypes.c_int64,
     [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]),
    ("binfile_reader_val_len", ctypes.c_int64,
     [ctypes.c_void_p, ctypes.c_int64]),
    ("binfile_reader_val", ctypes.c_int64,
     [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]),
    ("binfile_reader_close", ctypes.c_int, [ctypes.c_void_p]),
    ("prefetch_queue_new", ctypes.c_void_p, [ctypes.c_int64]),
    ("prefetch_queue_put", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]),
    ("prefetch_queue_get", ctypes.c_int64,
     [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
      ctypes.c_int64]),
    ("prefetch_queue_size", ctypes.c_int64, [ctypes.c_void_p]),
    ("prefetch_queue_close", None, [ctypes.c_void_p]),
    ("prefetch_queue_free", None, [ctypes.c_void_p]),
    ("augment_batch", ctypes.c_int,
     [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
      ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
      ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int64,
      ctypes.c_void_p]),
)


def native_library_path() -> str:
    """Where the library built from ``native/singa_io.cpp`` goes."""
    with open(_NATIVE_SRC, "rb") as fh:
        src = fh.read()
    digest = hashlib.sha256(src + " ".join(_CXX_FLAGS).encode()).hexdigest()
    return os.path.join(_BUILD_DIR, f"libsinga_io-{digest[:16]}.so")


def _build_native() -> str:
    out = native_library_path()
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (g++ or c++) on the PATH")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, _NATIVE_SRC],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({res.returncode}) for "
                           f"{_NATIVE_SRC}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _load_native():
    """The native library, built on the first call; None (and
    :func:`native_available` False) when it cannot be built or loaded."""
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            lib = ctypes.CDLL(_build_native())
            for name, res, args in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        except Exception as e:  # no compiler, a failed build
            _lib_err = e
        return _lib


def native_available() -> bool:
    return _load_native() is not None


_MAGIC = b"NSTGAIO1"


class CorruptRecordError(OSError):
    """A BinFile record failed its integrity checks: a truncated tail
    (a crash mid-write) or a CRC mismatch.  ``key`` (None when the cut
    took the key itself), the byte ``offset`` of the bad record, and for
    a CRC failure the ``expected`` and ``actual`` checksums.  The retry
    layer classifies it fatal (corruption never heals on retry); the
    checkpoint manager's fallback walk absorbs it."""

    def __init__(self, path, reason, key=None, offset=None,
                 expected=None, actual=None):
        detail = f"{path}: {reason}"
        if key is not None:
            detail += f" (key={key!r}"
            if expected is not None:
                detail += (f", crc expected=0x{expected:08x} "
                           f"actual=0x{actual:08x}")
            if offset is not None:
                detail += f", offset={offset}"
            detail += ")"
        elif offset is not None:
            detail += f" (offset={offset})"
        super().__init__(detail)
        self.path = path
        self.reason = reason
        self.key = key
        self.offset = offset
        self.expected = expected
        self.actual = actual


def _fault_check():
    """The ``io.binfile`` injection site: one flag read when disarmed."""
    from ..resilience import faults

    if faults._armed:
        faults.check("io.binfile")


class BinFileWriter:
    """Append key -> bytes records (the reference's
    ``io::BinFileWriter``)."""

    def __init__(self, path):
        self.path = path
        self._lib = _load_native()
        if self._lib is not None:
            self._h = self._lib.binfile_writer_open(path.encode())
            if not self._h:
                raise OSError(f"cannot open {path}")
            self._f = None
        else:
            self._f = open(path, "wb")
            self._f.write(_MAGIC)
            self._h = None

    def put(self, key: str, value: bytes):
        _fault_check()
        if self._h is not None:
            rc = self._lib.binfile_writer_put(self._h, key.encode(), value,
                                              len(value))
            if rc != 0:
                raise OSError(f"write failed for key {key}")
        else:
            k = key.encode()
            self._f.write(struct.pack("<I", len(k)) + k
                          + struct.pack("<Q", len(value)) + value
                          + struct.pack("<I", zlib.crc32(value)))

    def close(self):
        if self._h is not None:
            self._lib.binfile_writer_close(self._h)
            self._h = None
        elif self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _scan(path):
    """The pure-Python reader: every ``(key, value)`` record of ``path``,
    checked; raises :class:`CorruptRecordError` at the first bad one."""
    records = []
    fsize = os.path.getsize(path)
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise OSError(f"bad magic in {path}")
        while True:
            rec_off = f.tell()
            hdr = f.read(4)
            if not hdr:
                return records  # a clean end on a record boundary
            if len(hdr) < 4:
                raise CorruptRecordError(
                    path, "truncated tail: partial key-length header "
                    "(crash mid-write?)", offset=rec_off)
            (klen,) = struct.unpack("<I", hdr)
            # lengths are held against the file before reading: a flipped
            # length field is corruption, not a multi-GB read
            if klen > fsize - f.tell():
                raise CorruptRecordError(
                    path, f"key length {klen} exceeds remaining file "
                    f"(corrupt header?)", offset=rec_off)
            key = f.read(klen).decode()
            vhdr = f.read(8)
            if len(vhdr) < 8:
                raise CorruptRecordError(
                    path, "truncated tail: partial value-length header",
                    key=key, offset=rec_off)
            (vlen,) = struct.unpack("<Q", vhdr)
            if vlen > fsize - f.tell():
                raise CorruptRecordError(
                    path, f"value length {vlen} exceeds remaining file "
                    f"(corrupt header or truncated tail)", key=key,
                    offset=rec_off)
            val = f.read(vlen)
            craw = f.read(4)
            if len(craw) < 4:
                raise CorruptRecordError(
                    path, "truncated tail: CRC footer missing", key=key,
                    offset=rec_off)
            (crc,) = struct.unpack("<I", craw)
            actual = zlib.crc32(val)
            if actual != crc:
                raise CorruptRecordError(
                    path, "CRC mismatch", key=key, offset=rec_off,
                    expected=crc, actual=actual)
            records.append((key, val))


class BinFileReader:
    """Read records; random access by index."""

    def __init__(self, path):
        self.path = path
        _fault_check()
        self._lib = _load_native()
        if self._lib is None:
            self._h = None
            self._records = _scan(path)
            return
        self._h = self._lib.binfile_reader_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open/parse {path}")
        try:
            self._offsets = self._index_offsets()
        except BaseException:
            self.close()
            raise

    def _index_offsets(self):
        """Each record's byte offset, from the native index's key and
        value lengths; a truncated tail (the index stops short of the
        file's end, or its last value runs past it) raises
        :class:`CorruptRecordError` naming the record."""
        fsize = os.path.getsize(self.path)
        offsets, end = [], len(_MAGIC)
        for i in range(self.count()):
            offsets.append(end)
            end += 4 + len(self.key(i).encode()) + 8 \
                + int(self._lib.binfile_reader_val_len(self._h, i)) + 4
            if end > fsize:
                raise CorruptRecordError(
                    self.path, f"truncated tail: record runs to byte {end} "
                    f"of a {fsize}-byte file", key=self.key(i),
                    offset=offsets[-1])
        if end != fsize:
            raise CorruptRecordError(
                self.path, f"truncated tail: {fsize - end} bytes of a cut "
                f"record header (crash mid-write?)", offset=end)
        return offsets

    def count(self) -> int:
        if self._h is not None:
            return int(self._lib.binfile_reader_count(self._h))
        return len(self._records)

    def key(self, i: int) -> str:
        if self._h is not None:
            buf = ctypes.create_string_buffer(4096)
            n = self._lib.binfile_reader_key(self._h, i, buf, 4096)
            if n < 0:
                raise IndexError(i)
            return buf.value.decode()
        return self._records[i][0]

    def value(self, i: int) -> bytes:
        if self._h is None:
            return self._records[i][1]
        n = self._lib.binfile_reader_val_len(self._h, i)
        if n < 0:
            raise IndexError(i)
        buf = ctypes.create_string_buffer(int(n) if n else 1)
        rc = self._lib.binfile_reader_val(self._h, i, buf, n)
        if rc == -2:
            data = buf.raw[:n]
            with open(self.path, "rb") as f:
                f.seek(self._offsets[i] + 4 + len(self.key(i).encode()) + 8
                       + n)
                (crc,) = struct.unpack("<I", f.read(4))
            raise CorruptRecordError(self.path, "CRC mismatch",
                                     key=self.key(i),
                                     offset=self._offsets[i], expected=crc,
                                     actual=zlib.crc32(data))
        if rc < 0:
            raise OSError(f"read failed at record {i}")
        return buf.raw[:n]

    def items(self):
        for i in range(self.count()):
            yield self.key(i), self.value(i)

    def read_all(self) -> dict:
        return dict(self.items())

    def close(self):
        if self._h is not None:
            self._lib.binfile_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class PrefetchQueue:
    """Blocking multi-producer multi-consumer queue over the native ring
    buffer; ``queue.Queue`` without the native library.  Each consumer
    thread receives into a buffer of ``max_value_bytes`` made at its
    first ``get`` and kept, and copies out the value's bytes alone (the
    JAX module makes a new buffer every ``get`` and copies all of it:
    64 MB a batch for the data loader)."""

    def __init__(self, capacity=64, max_value_bytes=1 << 24):
        self._lib = _load_native()
        self.max_value_bytes = max_value_bytes
        self._bufs = threading.local()
        if self._lib is not None:
            self._h = self._lib.prefetch_queue_new(capacity)
        else:
            import queue

            self._h = None
            self._q = queue.Queue(maxsize=capacity)

    def put(self, key: str, value: bytes):
        if self._h is not None:
            rc = self._lib.prefetch_queue_put(self._h, key.encode(), value,
                                              len(value))
            if rc != 0:
                raise RuntimeError("queue closed")
        else:
            self._q.put((key, value))

    def get(self):
        """``(key, value)``, or None once closed and drained."""
        if self._h is not None:
            bufs = self._bufs.__dict__
            if "v" not in bufs:
                bufs["k"] = ctypes.create_string_buffer(4096)
                bufs["v"] = ctypes.create_string_buffer(self.max_value_bytes)
            kbuf, vbuf = bufs["k"], bufs["v"]
            n = self._lib.prefetch_queue_get(self._h, kbuf, 4096, vbuf,
                                             self.max_value_bytes)
            if n == -1:
                return None
            if n < 0:
                raise RuntimeError("record larger than max_value_bytes")
            return kbuf.value.decode(), ctypes.string_at(vbuf, n)
        return self._q.get()  # the None sentinel marks the close

    def qsize(self):
        if self._h is not None:
            return int(self._lib.prefetch_queue_size(self._h))
        return self._q.qsize()

    def close(self):
        if self._h is not None:
            self._lib.prefetch_queue_close(self._h)
        else:
            self._q.put(None)

    def free(self):
        if self._h is not None:
            self._lib.prefetch_queue_free(self._h)
            self._h = None
