"""Image augmentation helpers (counterpart of ``singa_tpu/image_tool.py``;
the reference's ``python/singa/image_tool.py``): the resize, crop and flip
pipelines of the CNN examples, in numpy (no Pillow needed); images are HWC
uint8 or float arrays, or NCHW float batches.  ``augment_batch`` runs the
native ``augment_batch`` of ``native/singa_io.cpp``, built by
``io/binfile.py``, so its output equals the JAX package's in both modes.
"""

from __future__ import annotations

import numpy as np


def crop(img, patch, position="center"):
    """img HWC; patch (h, w); position in {'center','left_top', 'left_bottom',
    'right_top','right_bottom','random'}."""
    h, w = img.shape[:2]
    ph, pw = patch
    assert ph <= h and pw <= w, f"patch {patch} larger than image {(h, w)}"
    if position == "center":
        y, x = (h - ph) // 2, (w - pw) // 2
    elif position == "left_top":
        y, x = 0, 0
    elif position == "left_bottom":
        y, x = h - ph, 0
    elif position == "right_top":
        y, x = 0, w - pw
    elif position == "right_bottom":
        y, x = h - ph, w - pw
    elif position == "random":
        y = np.random.randint(0, h - ph + 1)
        x = np.random.randint(0, w - pw + 1)
    else:
        raise ValueError(position)
    return img[y:y + ph, x:x + pw]


def flip(img, direction="horizontal"):
    if direction == "horizontal":
        return img[:, ::-1]
    if direction == "vertical":
        return img[::-1]
    raise ValueError(direction)


def resize(img, size):
    """Bilinear resize, HWC -> (size_h, size_w, C)."""
    if isinstance(size, int):
        size = (size, size)
    h, w = img.shape[:2]
    th, tw = size
    ys = np.linspace(0, h - 1, th)
    xs = np.linspace(0, w - 1, tw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None] if img.ndim == 3 else (ys - y0)[:, None]
    wx = (xs - x0)[None, :, None] if img.ndim == 3 else (xs - x0)[None, :]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def color_jitter(img, brightness=0.0, contrast=0.0, rng=None):
    rng = rng or np.random
    out = img.astype(np.float32)
    if brightness:
        out = out + rng.uniform(-brightness, brightness) * 255.0
    if contrast:
        mean = out.mean()
        out = (out - mean) * (1 + rng.uniform(-contrast, contrast)) + mean
    return np.clip(out, 0, 255)


def normalize(img, mean, std):
    """HWC or NCHW; mean/std per channel."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    img = img.astype(np.float32)
    if img.ndim == 4:  # NCHW
        return (img - mean[None, :, None, None]) / std[None, :, None, None]
    return (img - mean) / std


def to_chw(img):
    return np.transpose(img, (2, 0, 1))


def augment_batch(imgs, patch, mean=None, std=None, train=True, seed=0,
                  threads=0):
    """Fused batch augmentation: per-image random crop to ``patch`` +
    coin-flip horizontal mirror (train) or center crop (eval), uint8
    NHWC -> normalized float32 NCHW.

    Runs in the native C++ runtime when available (native/singa_io.cpp
    ``augment_batch`` — one threaded pass per image, the reference's
    C++ transformer equivalent); falls back to numpy with identical
    EVAL-mode output (train-mode random draws differ between the two
    implementations — both are deterministic in ``seed``).
    """
    import ctypes

    from .io import binfile as _bf

    imgs = np.ascontiguousarray(imgs, np.uint8)
    assert imgs.ndim == 4, "imgs must be (N, H, W, C) uint8"
    n, h, w, c = imgs.shape
    ph, pw = (patch, patch) if isinstance(patch, int) else patch
    assert ph <= h and pw <= w, f"patch {patch} larger than {(h, w)}"
    # broadcast to per-channel length — the native loop indexes [ch]
    mean_a = np.ascontiguousarray(np.broadcast_to(
        np.asarray(0.0 if mean is None else mean, np.float32), (c,)))
    std_a = np.ascontiguousarray(np.broadcast_to(
        np.asarray(1.0 if std is None else std, np.float32), (c,)))
    out = np.empty((n, c, ph, pw), np.float32)

    lib = _bf._load_native()
    if lib is not None and hasattr(lib, "augment_batch"):
        rc = lib.augment_batch(
            imgs.ctypes.data_as(ctypes.c_void_p), n, h, w, c, ph, pw,
            mean_a.ctypes.data_as(ctypes.c_void_p),
            std_a.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint64(seed), 1 if train else 0, threads,
            out.ctypes.data_as(ctypes.c_void_p))
        if rc == 0:
            return out
    # numpy fallback
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    fimgs = imgs.astype(np.float32) / 255.0
    for i in range(n):
        if train:
            y = rng.randint(0, h - ph + 1)
            x = rng.randint(0, w - pw + 1)
            mirror = rng.rand() < 0.5
        else:
            y, x = (h - ph) // 2, (w - pw) // 2
            mirror = False
        im = fimgs[i, y:y + ph, x:x + pw]
        if mirror:
            im = im[:, ::-1]
        out[i] = np.transpose((im - mean_a) / std_a, (2, 0, 1))
    return out


class ImageTool:
    """Chainable augmentation pipeline (reference ImageTool API shape):
    ImageTool(img).resize(40).crop((32,32),'random').flip().get()"""

    def __init__(self, img):
        self.img = np.asarray(img)

    def resize_by_range(self, rng_size):
        size = np.random.randint(rng_size[0], rng_size[1] + 1)
        self.img = resize(self.img, size)
        return self

    def resize(self, size):
        self.img = resize(self.img, size)
        return self

    def crop(self, patch, position="center"):
        self.img = crop(self.img, patch, position)
        return self

    def flip(self, direction="horizontal", prob=1.0):
        if np.random.rand() < prob:
            self.img = flip(self.img, direction)
        return self

    def get(self):
        return self.img
