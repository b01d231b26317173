"""Threaded data loader over the prefetch queue (counterpart of
``singa_tpu/io/loader.py``): reader threads decode BinFile records into
numpy batches ahead of the training loop, so host IO overlaps the
device's steps.

A record is ``encode_example(x, y)``: a header, x's shape, and x as
float32 (so integer inputs such as token ids round-trip exactly below
2^24), the JAX package's bytes.  Batches come out as ``(x (B, ...)
float32, y (B,) int32)`` numpy arrays; the caller moves them to its
device.  The order of the records is a permutation from
``RandomState(seed)`` (``seed`` rises by one each epoch); the order of
the batches is deterministic only with ``num_workers=1``, since the
workers race for the next batch.
"""

from __future__ import annotations

import struct
import threading

import numpy as np

from .binfile import BinFileReader, BinFileWriter, PrefetchQueue

__all__ = ["encode_example", "decode_example", "DataLoader",
           "write_dataset"]


def encode_example(x: np.ndarray, y: int) -> bytes:
    hdr = struct.pack("<Iq", x.nbytes, int(y))
    shape = np.asarray(x.shape, np.int32)
    return hdr + struct.pack("<I", len(shape)) + shape.tobytes() + \
        np.ascontiguousarray(x.astype(np.float32)).tobytes()


def decode_example(blob: bytes):
    nbytes, y = struct.unpack("<Iq", blob[:12])
    (ndim,) = struct.unpack("<I", blob[12:16])
    shape = np.frombuffer(blob[16:16 + 4 * ndim], np.int32)
    x = np.frombuffer(blob[16 + 4 * ndim:], np.float32).reshape(shape)
    return x, y


def _pack_batch(xb, yb) -> bytes:
    return struct.pack("<II", xb.nbytes, xb.ndim) + \
        np.asarray(xb.shape, np.int32).tobytes() + xb.tobytes() + \
        yb.tobytes()


def _unpack_batch(blob):
    xb_nbytes, ndim = struct.unpack("<II", blob[:8])
    shape = np.frombuffer(blob[8:8 + 4 * ndim], np.int32)
    off = 8 + 4 * ndim
    xb = np.frombuffer(blob[off:off + xb_nbytes], np.float32).reshape(shape)
    return xb, np.frombuffer(blob[off + xb_nbytes:], np.int32)


class DataLoader:
    """Iterates ``(x_batch, y_batch)`` numpy pairs from a BinFile dataset,
    with ``num_workers`` reader threads prefetching up to ``queue_depth``
    batches ahead."""

    def __init__(self, path, batch_size, shuffle=True, num_workers=2,
                 seed=0, queue_depth=8):
        self.path = path
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.queue_depth = queue_depth
        with BinFileReader(path) as r:
            self.n = r.count()

    def __len__(self):
        return self.n // self.batch_size

    def __iter__(self):
        order = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(order)
            self.seed += 1
        n_batches = len(self)
        q = PrefetchQueue(capacity=self.queue_depth, max_value_bytes=1 << 26)
        todo = [(i, order[i * self.batch_size:(i + 1) * self.batch_size])
                for i in range(n_batches)]
        lock = threading.Lock()

        def worker():
            reader = BinFileReader(self.path)
            try:
                while True:
                    with lock:
                        if not todo:
                            return
                        bi, idxs = todo.pop(0)
                    xs, ys = zip(*(decode_example(reader.value(int(i)))
                                   for i in idxs))
                    try:
                        q.put(str(bi), _pack_batch(
                            np.stack(xs), np.asarray(ys, np.int32)))
                    except RuntimeError:
                        return  # the queue closed: the consumer stopped
            finally:
                reader.close()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for _ in range(n_batches):
                item = q.get()
                if item is None:
                    break
                yield _unpack_batch(item[1])
        finally:
            q.close()
            for t in threads:
                t.join(timeout=5)
            q.free()


def write_dataset(path, xs: np.ndarray, ys: np.ndarray):
    """Write arrays as a BinFile dataset, one record an example."""
    with BinFileWriter(path) as w:
        for i in range(len(xs)):
            w.put(f"rec_{i:08d}", encode_example(xs[i], int(ys[i])))
