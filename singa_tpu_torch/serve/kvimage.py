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
has no type for, byte for byte.  The JAX package's wire codec
(``to_bytes`` / ``from_bytes``, fleet KV shipping) and int8 ``(values,
scales)`` leaves are not ported.
"""

from __future__ import annotations

import zlib

import torch

__all__ = ["KVIMAGE_VERSION", "KVImage", "KVImageError", "pack_image"]

#: bump when the leaf layout or header schema changes; ``validate``
#: refuses images from a different version rather than guessing
KVIMAGE_VERSION = 1


class KVImageError(ValueError):
    """A KV image failed validation (version, geometry, dtype or header
    mismatch, or leaves inconsistent with their pack-time header).
    Raised before any scatter touches a pool."""


def _signature(kc, vc):
    """Per-leaf (shape, dtype) header, K then V."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in (kc, vc))


def _checksum(kc, vc) -> int:
    """crc32 over both leaves' raw bytes, K then V."""
    crc = 0
    for a in (kc, vc):
        crc = zlib.crc32(a.contiguous().view(-1).view(torch.uint8).numpy(),
                         crc)
    return crc & 0xFFFFFFFF


class KVImage:
    """One request's KV blocks as a self-describing host image; build it
    with :func:`pack_image`."""

    __slots__ = ("version", "block_size", "n_data", "header", "kc", "vc",
                 "checksum")

    def __init__(self, version, block_size, n_data, header, kc, vc,
                 checksum):
        self.version = int(version)
        self.block_size = int(block_size)
        self.n_data = int(n_data)
        self.header = tuple(header)
        self.kc = kc
        self.vc = vc
        self.checksum = int(checksum) & 0xFFFFFFFF

    @property
    def width(self) -> int:
        """Lane width of the image rows (positions per leaf)."""
        return int(self.kc.shape[3])

    @property
    def nbytes(self) -> int:
        """Host bytes the image's leaves occupy."""
        return int(sum(a.numel() * a.element_size()
                       for a in (self.kc, self.vc)))

    def validate(self, block_size, pool_k=None):
        """Typed validation before any scatter: version supported, block
        size equal to the consuming pool's, leaves consistent with the
        pack-time header and checksum, lane width a whole number of
        blocks covering ``n_data`` blocks, and, given the pool's K
        (``(L, N + 1, H_kv, B, D)``), layer, head, head-dim and dtype
        equal to the pool's.  Raises :class:`KVImageError`."""
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
        for a in (self.kc, self.vc):
            if a.dim() != 5 or a.shape[1] != 1 \
                    or a.shape[3] != self.kc.shape[3]:
                raise KVImageError(
                    f"KV image leaf shape {tuple(a.shape)} is not an "
                    f"(L, 1, H, W, D) cache row")
        W = self.width
        if W % self.block_size != 0:
            raise KVImageError(
                f"KV image lane width ({W}) is not a multiple of "
                f"block_size ({self.block_size})")
        if self.n_data < 0 or self.n_data * self.block_size > W:
            raise KVImageError(
                f"KV image n_data ({self.n_data} blocks) exceeds its own "
                f"lane width ({W} positions)")
        if pool_k is not None:
            img = self.kc
            if (img.shape[0] != pool_k.shape[0]
                    or img.shape[2] != pool_k.shape[2]
                    or img.shape[4] != pool_k.shape[4]
                    or img.dtype != pool_k.dtype):
                raise KVImageError(
                    f"KV image leaf {tuple(img.shape)}/{img.dtype} "
                    f"incompatible with pool {tuple(pool_k.shape)}/"
                    f"{pool_k.dtype} (layer/head/head-dim/dtype must "
                    f"match)")


def pack_image(kc_host, vc_host, block_size, n_data) -> KVImage:
    """Seal host cache rows into a :class:`KVImage`; the header and the
    checksum are captured here, so a later change to the leaves fails
    :meth:`KVImage.validate`."""
    return KVImage(KVIMAGE_VERSION, block_size, n_data,
                   _signature(kc_host, vc_host), kc_host, vc_host,
                   _checksum(kc_host, vc_host))
