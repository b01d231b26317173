"""Versioned host-side KV block images (counterpart of
``singa_tpu/serve/kvimage.py``): the swap format of preemption, which
the prefix cache will reuse.

A preempted request's blocks leave the device pool as a
:class:`KVImage` (``serve/paged.py`` ``swap_out``) and come back through
``swap_in``.  The image carries a VERSION, the block geometry, a
per-leaf dtype/shape header and a crc32 of its bytes, all captured at
pack time; :meth:`KVImage.validate` re-derives them from the leaves and
cross-checks them against the header (a truncated or mutated image
fails typed) and against the consuming pool's geometry, before any
scatter touches the pool.

Leaves are host (CPU) tensors, one ``(L, 1, H_kv, W, D)`` row per K/V,
``W`` a whole number of blocks: a CPU tensor keeps bf16, which numpy
has no type for, byte for byte.  An int8 pool's image (``quant``) holds
for each of K and V the pair (int8 values ``(L, 1, H_kv, W, D)``,
float32 scales ``(L, 1, H_kv, W)``); dense and int8 images are refused
by pools of the other kind.

The wire codec (:meth:`KVImage.to_bytes` / :meth:`KVImage.from_bytes`)
frames an image for a fleet's KV ship (``serve/fleet.py``) in the JAX
package's bytes: magic, version, quant and a pickled header that names
each leaf's numpy dtype, the leaves' raw bytes, and a crc32 trailer.
:meth:`KVImage.narrowed` cuts an image to the blocks a ship carries.
"""

from __future__ import annotations

import io
import math
import pickle
import struct
import zlib

import torch

from ..models.gpt2_decode import _leaves

__all__ = ["KVIMAGE_VERSION", "KVImage", "KVImageError", "pack_image"]

#: bump when the leaf layout or header schema changes; ``validate``
#: refuses images from a different version rather than guessing
KVIMAGE_VERSION = 1

_WIRE_MAGIC = b"KVIM"
_WIRE_HEAD = struct.Struct("!4sHBI")   # magic, version, quant, meta bytes
_WIRE_CRC = struct.Struct("!I")
#: torch dtype <-> the numpy dtype name the JAX codec writes
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8"}
_FROM_WIRE = {v: k for k, v in _WIRE_DTYPES.items()}


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles the wire frame's metadata, which holds only dicts,
    tuples, strs and ints: a frame that names a global (a class or a
    function to call) is refused, so a peer's bytes run no code."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"KV image wire metadata names the global {module}.{name}")


class KVImageError(ValueError):
    """A KV image failed validation (version, geometry, dtype or header
    mismatch, or leaves inconsistent with their pack-time header).
    Raised before any scatter touches a pool."""


def _signature(kc, vc):
    """Per-leaf (shape, dtype) header, K leaves then V leaves."""
    return tuple((tuple(a.shape), str(a.dtype))
                 for a in _leaves(kc) + _leaves(vc))


def _checksum(kc, vc) -> int:
    """crc32 over every leaf's raw bytes, K leaves then V leaves."""
    crc = 0
    for a in _leaves(kc) + _leaves(vc):
        crc = zlib.crc32(a.contiguous().view(-1).view(torch.uint8).numpy(),
                         crc)
    return crc & 0xFFFFFFFF


class KVImage:
    """One request's KV blocks as a self-describing host image; build it
    with :func:`pack_image`."""

    __slots__ = ("version", "block_size", "n_data", "quant", "header", "kc",
                 "vc", "checksum")

    def __init__(self, version, block_size, n_data, quant, header, kc, vc,
                 checksum):
        self.version = int(version)
        self.block_size = int(block_size)
        self.n_data = int(n_data)
        self.quant = bool(quant)
        self.header = tuple(header)
        self.kc = kc
        self.vc = vc
        self.checksum = int(checksum) & 0xFFFFFFFF

    @property
    def width(self) -> int:
        """Lane width of the image rows (positions per leaf)."""
        return int(_leaves(self.kc)[0].shape[3])

    @property
    def nbytes(self) -> int:
        """Host bytes the image's leaves occupy."""
        return int(sum(a.numel() * a.element_size()
                       for a in _leaves(self.kc) + _leaves(self.vc)))

    def validate(self, block_size, quant=False, pool_k=None):
        """Typed validation before any scatter: version supported, block
        size and layout (``quant``: int8 (values, scales) leaves) equal to
        the consuming pool's, leaves consistent with the pack-time header
        and checksum, lane width a whole number of blocks covering
        ``n_data`` blocks, and, given the pool's K (``(L, N + 1, H_kv, B,
        D)``, or its (values, scales) pair), layer, head, head-dim and
        dtype of each leaf equal to the pool's.  Raises
        :class:`KVImageError`."""
        if self.version != KVIMAGE_VERSION:
            raise KVImageError(
                f"KV image version {self.version} != supported "
                f"{KVIMAGE_VERSION}: refuse rather than guess at the "
                f"leaf layout")
        if self.block_size != block_size:
            raise KVImageError(
                f"KV image block_size ({self.block_size}) != pool "
                f"block_size ({block_size}): lanes would not tile the "
                f"target blocks")
        if self.quant != bool(quant):
            raise KVImageError(
                f"KV image quant={self.quant} vs pool quant={bool(quant)}: "
                f"dense and int8 (values, scales) layouts are not "
                f"interchangeable")
        sig = _signature(self.kc, self.vc)
        if sig != self.header:
            raise KVImageError(
                "KV image leaves do not match their pack-time header "
                f"(truncated or mutated): header={self.header} got={sig}")
        crc = _checksum(self.kc, self.vc)
        if crc != self.checksum:
            raise KVImageError(
                f"KV image payload corrupted: crc32 {crc:#010x} != packed "
                f"{self.checksum:#010x}")
        k_leaves, v_leaves = _leaves(self.kc), _leaves(self.vc)
        if len(k_leaves) != len(v_leaves) \
                or len(k_leaves) != (2 if self.quant else 1):
            raise KVImageError(
                f"KV image has {len(k_leaves)} K and {len(v_leaves)} V "
                f"leaves for quant={self.quant}")
        W = self.width
        for i, a in enumerate(k_leaves + v_leaves):
            scales = self.quant and i % 2 == 1
            if a.dim() != (4 if scales else 5) or a.shape[1] != 1 \
                    or a.shape[3] != W:
                raise KVImageError(
                    f"KV image leaf shape {tuple(a.shape)} is not an "
                    f"(L, 1, H, W{'' if scales else ', D'}) cache row")
        if W % self.block_size != 0:
            raise KVImageError(
                f"KV image lane width ({W}) is not a multiple of "
                f"block_size ({self.block_size})")
        if self.n_data < 0 or self.n_data * self.block_size > W:
            raise KVImageError(
                f"KV image n_data ({self.n_data} blocks) exceeds its own "
                f"lane width ({W} positions)")
        if pool_k is not None:
            pool_leaves = _leaves(pool_k)
            if len(pool_leaves) != len(k_leaves):
                raise KVImageError(
                    f"KV image has {len(k_leaves)} K leaves but the pool "
                    f"has {len(pool_leaves)} (dense vs int8 layout)")
            for img, pool in zip(k_leaves, pool_leaves):
                # pool: (L, N + 1, H, B, ...) vs image: (L, 1, H, W, ...)
                if (img.shape[0] != pool.shape[0]
                        or img.shape[2] != pool.shape[2]
                        or img.shape[4:] != pool.shape[4:]
                        or img.dtype != pool.dtype):
                    raise KVImageError(
                        f"KV image leaf {tuple(img.shape)}/{img.dtype} "
                        f"incompatible with pool leaf {tuple(pool.shape)}/"
                        f"{pool.dtype} (layer/head/head-dim/dtype must "
                        f"match)")


    def narrowed(self, n_data=None) -> "KVImage":
        """A new image of the first ``n_data`` blocks' lanes (default
        ``self.n_data``): the form a ship sends, whose bytes track the
        shipped prefix and not the row's width."""
        n = self.n_data if n_data is None else int(n_data)
        if n > self.n_data:
            raise KVImageError(
                f"narrowed({n}) beyond the image's n_data ({self.n_data})")
        w = max(n, 1) * self.block_size

        def cut(tree):
            if isinstance(tree, tuple):
                return tuple(cut(t) for t in tree)
            return tree[:, :, :, :w].contiguous()

        return pack_image(cut(self.kc), cut(self.vc), self.block_size, n,
                          self.quant)

    def to_bytes(self) -> bytes:
        """The image as one wire frame, byte for byte the JAX codec's:
        the fixed head, the pickled metadata (block size, blocks, the
        per-leaf (shape, numpy dtype name) header, the K leaf count), the
        leaves' raw bytes in header order and the crc32 of those bytes.
        Decode with :meth:`from_bytes`."""
        leaves = _leaves(self.kc) + _leaves(self.vc)
        # a fresh name string a leaf, as str(dtype) makes in the JAX
        # codec: pickle writes a shared object once, a copy each time
        header = tuple((tuple(int(d) for d in a.shape),
                        "".join(_WIRE_DTYPES[a.dtype])) for a in leaves)
        meta = pickle.dumps(
            {"block_size": self.block_size, "n_data": self.n_data,
             "header": header, "k_leaves": len(_leaves(self.kc))},
            protocol=pickle.HIGHEST_PROTOCOL)
        crc = 0
        chunks = [_WIRE_HEAD.pack(_WIRE_MAGIC, self.version,
                                  int(self.quant), len(meta)), meta]
        for a in leaves:
            raw = a.contiguous().view(-1).view(torch.uint8).numpy()
            crc = zlib.crc32(raw, crc)
            chunks.append(raw.tobytes())
        chunks.append(_WIRE_CRC.pack(crc & 0xFFFFFFFF))
        return b"".join(chunks)

    @classmethod
    def from_bytes(cls, buf) -> "KVImage":
        """Decode a :meth:`to_bytes` frame (the JAX codec's too) into an
        image of CPU tensors.  A short buffer, bad magic, a version
        skew, trailing bytes or a crc32 that disagrees with the trailer
        raise :class:`KVImageError`, as does metadata that names a
        global (it is unpickled with none); the image still goes
        through :meth:`validate` at the pool that takes it."""
        buf = bytes(buf)
        fixed = _WIRE_HEAD.size + _WIRE_CRC.size
        if len(buf) < fixed:
            raise KVImageError(
                f"KV image wire frame truncated: {len(buf)} bytes is "
                f"shorter than the fixed framing ({fixed})")
        magic, version, quant, meta_len = _WIRE_HEAD.unpack_from(buf, 0)
        if magic != _WIRE_MAGIC:
            raise KVImageError(
                f"KV image wire frame has bad magic {magic!r} (expected "
                f"{_WIRE_MAGIC!r}): not a KV image")
        if version != KVIMAGE_VERSION:
            raise KVImageError(
                f"KV image wire version {version} != supported "
                f"{KVIMAGE_VERSION}: refuse rather than guess at the "
                f"leaf layout")
        off = _WIRE_HEAD.size
        if len(buf) < off + meta_len + _WIRE_CRC.size:
            raise KVImageError(
                f"KV image wire frame truncated inside metadata "
                f"({len(buf)} bytes, metadata needs "
                f"{off + meta_len + _WIRE_CRC.size})")
        try:
            meta = _PlainUnpickler(
                io.BytesIO(buf[off:off + meta_len])).load()
            header = tuple((tuple(sh), str(dt)) for sh, dt in meta["header"])
            k_leaves = int(meta["k_leaves"])
            block_size, n_data = meta["block_size"], meta["n_data"]
            dtypes = [_FROM_WIRE[dt] for _, dt in header]
        except Exception as e:
            raise KVImageError(
                f"KV image wire metadata undecodable ({e!r})") from e
        off += meta_len
        leaves, crc = [], 0
        for (shape, _), dt in zip(header, dtypes):
            n = math.prod(shape) * torch.empty((), dtype=dt).element_size()
            if len(buf) < off + n + _WIRE_CRC.size:
                raise KVImageError(
                    f"KV image wire frame truncated mid-leaf: leaf "
                    f"{len(leaves)} needs {n} bytes, "
                    f"{len(buf) - off - _WIRE_CRC.size} remain")
            raw = buf[off:off + n]
            crc = zlib.crc32(raw, crc)
            leaves.append(torch.frombuffer(bytearray(raw), dtype=torch.uint8)
                          .view(dt).reshape(shape))
            off += n
        if len(buf) != off + _WIRE_CRC.size:
            raise KVImageError(
                f"KV image wire frame has {len(buf) - off - _WIRE_CRC.size}"
                f" bytes beyond its header's leaves")
        (want,) = _WIRE_CRC.unpack_from(buf, off)
        if crc & 0xFFFFFFFF != want:
            raise KVImageError(
                f"KV image wire payload corrupted: crc32 "
                f"{crc & 0xFFFFFFFF:#010x} != trailer {want:#010x}")
        if not 0 < k_leaves < len(leaves) or k_leaves * 2 != len(leaves):
            raise KVImageError(
                f"KV image wire metadata claims {k_leaves} K leaves of "
                f"{len(leaves)}: K and V must split evenly")

        def tree(ls):
            return ls[0] if len(ls) == 1 else tuple(ls)

        kc, vc = tree(leaves[:k_leaves]), tree(leaves[k_leaves:])
        return cls(version, block_size, n_data, bool(quant),
                   _signature(kc, vc), kc, vc, want)


def pack_image(kc_host, vc_host, block_size, n_data, quant=False) -> KVImage:
    """Seal host cache rows (tensors, or with ``quant`` (values, scales)
    pairs) into a :class:`KVImage`; the header and the checksum are
    captured here, so a later change to the leaves fails
    :meth:`KVImage.validate`."""
    return KVImage(KVIMAGE_VERSION, block_size, n_data, quant,
                   _signature(kc_host, vc_host), kc_host, vc_host,
                   _checksum(kc_host, vc_host))
