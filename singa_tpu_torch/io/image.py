"""JPEG image codec (counterpart of ``singa_tpu/io/image.py``; the
reference's ``src/io/jpg_encoder.cc`` / ``jpg_decoder.cc``): an HWC uint8
numpy array to JPEG bytes and back, through Pillow.

Pillow is imported at first use, never with the module; without it the
codec raises the JAX package's ``ImportError``.  Nothing else of
``singa_tpu_torch.io`` needs it: the BinFile and text stores carry raw
arrays.
"""

from __future__ import annotations

import io as _io

import numpy as np

__all__ = ["JPGEncoder", "JPGDecoder", "encode_jpg", "decode_jpg"]


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "singa_tpu_torch.io.image needs Pillow for JPEG encode/decode; "
            "store raw arrays via io.loader/binfile instead") from e
    return Image


class JPGEncoder:
    """numpy HWC uint8 (or HW grayscale) -> JPEG bytes."""

    def __init__(self, quality=95):
        self.quality = int(quality)

    def encode(self, arr: np.ndarray) -> bytes:
        Image = _pil()
        arr = np.ascontiguousarray(arr)
        if arr.dtype != np.uint8:
            raise ValueError(f"JPEG encode expects uint8, got {arr.dtype}")
        buf = _io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=self.quality)
        return buf.getvalue()

    Encode = encode


class JPGDecoder:
    """JPEG bytes -> numpy HWC uint8 (RGB) or HW (grayscale)."""

    def decode(self, blob: bytes) -> np.ndarray:
        Image = _pil()
        return np.asarray(Image.open(_io.BytesIO(blob)))

    Decode = decode


def encode_jpg(arr, quality=95) -> bytes:
    return JPGEncoder(quality).encode(arr)


def decode_jpg(blob) -> np.ndarray:
    return JPGDecoder().decode(blob)
