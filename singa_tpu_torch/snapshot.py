"""``Snapshot`` key -> tensor store (counterpart of
``singa_tpu/snapshot.py``; the reference's ``src/io/snapshot.cc``), over
the BinFile record store (``io/binfile.py``): each record is a small JSON
header (``dtype``, ``shape``) and the raw buffer.

Files interchange with the JAX package both ways.  A bf16 tensor is
written as the JAX package writes one, its header dtype ``bfloat16``
and its raw bits; a record whose dtype is ``bfloat16``, or a 2-byte void
(``<V2``, numpy's name for bits it cannot type), reads back as bf16.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from . import tensor
from .io.binfile import BinFileReader, BinFileWriter
from .observe import trace as _trace
from .resilience import faults as _faults

__all__ = ["Snapshot"]


def _encode(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            dtype, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            arr = t.numpy()
            dtype, raw = str(arr.dtype), arr.tobytes()
        shape = list(t.shape)
    else:
        arr = np.ascontiguousarray(np.asarray(t))
        dtype = "bfloat16" if _is_bf16(str(arr.dtype)) else str(arr.dtype)
        raw, shape = arr.tobytes(), list(arr.shape)
    meta = json.dumps({"dtype": dtype, "shape": shape}).encode()
    return struct.pack("<I", len(meta)) + meta + raw


def _is_bf16(dtype) -> bool:
    return dtype in ("bfloat16", "V2", "|V2", "<V2")


def _decode(blob: bytes) -> torch.Tensor:
    (mlen,) = struct.unpack("<I", blob[:4])
    meta = json.loads(blob[4:4 + mlen].decode())
    raw = blob[4 + mlen:]
    if _is_bf16(meta["dtype"]):
        bits = np.frombuffer(raw, np.int16).reshape(meta["shape"]).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, meta["dtype"]).reshape(
        meta["shape"]).copy())


class Snapshot:
    """``Snapshot(path, mode)`` with mode ``Snapshot.kWrite`` or
    ``Snapshot.kRead`` (``.bin`` is appended to ``path`` unless it ends
    so); ``write(key, tensor_or_array)``; ``read(device)`` -> ``{key:
    tensor}`` on ``device`` (default: the default device, the GPU);
    ``read_numpy()`` -> ``{key: array}`` (bf16 as float32)."""

    kRead = 0
    kWrite = 1

    def __init__(self, path, mode=1, buffer_size=None, max_param_size=None):
        self.path = path if path.endswith(".bin") else path + ".bin"
        self.mode = mode
        if mode == Snapshot.kWrite:
            self._writer = BinFileWriter(self.path)
            self._reader = None
        else:
            self._reader = BinFileReader(self.path)
            self._writer = None

    def write(self, key, t):
        if self._writer is None:
            raise RuntimeError("snapshot opened for reading")
        if _faults._armed:
            _faults.check("checkpoint.write")
        blob = _encode(t)
        with _trace.span("snapshot/write_record", cat="snapshot",
                         key=str(key), bytes=len(blob)):
            self._writer.put(key, blob)

    Write = write

    def read(self, device=None) -> dict:
        if self._reader is None:
            raise RuntimeError("snapshot opened for writing")
        if _faults._armed:
            _faults.check("checkpoint.read")
        dev = tensor._torch_device(device)
        with _trace.span("snapshot/read", cat="snapshot", path=self.path):
            return {k: _decode(v).to(dev) for k, v in self._reader.items()}

    Read = read

    def read_numpy(self) -> dict:
        if self._reader is None:
            raise RuntimeError("snapshot opened for writing")
        return {k: tensor.to_numpy(_decode(v))
                for k, v in self._reader.items()}

    def done(self):
        if self._writer:
            self._writer.close()
            self._writer = None
        if self._reader:
            self._reader.close()
            self._reader = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.done()
