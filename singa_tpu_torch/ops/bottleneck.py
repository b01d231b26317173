"""ResNet-50's conv2_x bottleneck forward as one kernel (counterpart of
``experiments/resnet_megakernel.py:40`` ``megakernel_block``, whose
``pallas_call`` is at ``:84``).

The block, with BN folded into per-channel scale and bias (eval mode),
channels-last::

    y1  = round(relu(x·w1 · s1 + b1))              1×1, C -> CM
    y2  = round(relu(conv3×3_SAME(y1, w2) · s2 + b2))   CM -> CM
    out = round(relu(y2·w3 · s3 + b3 + x))         1×1, CM -> C

Every product sums in float32; ``round`` is to x's dtype (bf16 for the
kernel), at the same two points as the reference's ``xla_chain``
(``preferred_element_type=f32``).  The kernel
(``csrc/resnet_bottleneck.cu``) keeps y1 and y2 in shared memory.

=====================  ===============================================
``megakernel_block``   the wrapper: the kernel for CUDA tensors (or
                       raises), the plain version for CPU tensors only;
                       ``megakernel_block.launches`` counts launches
``megakernel_block_plain``  three ``F.conv2d`` in float32 with the same
                       rounding points
``fold_bottleneck``    the kernel's arguments from an eval-mode port
                       ``Bottleneck`` with an identity skip
=====================  ===============================================
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["megakernel_block", "megakernel_block_plain", "fold_bottleneck",
           "smem_bytes", "MAX_CM"]

#: widest bottleneck the kernel is held to on the card (its CM = 128 edge
#: case); a wider one fits in shared memory at narrow W but is untested
MAX_CM = 128
#: shared memory one block may use on an H100 (227 KB)
_SMEM_LIMIT = 232448


# ------------------------------------------------------------ plain version


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def megakernel_block_plain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """x (B, H, W, C) channels-last; w1 (C, CM), w2 (3, 3, CM, CM) HWIO,
    w3 (CM, C); s/b float32.  Returns (B, H, W, C) in x's dtype.  Values
    are upcast to float32 for the convs; y1 and y2 are rounded to x's
    dtype, as the reference rounds them to bf16."""
    dt = x.dtype

    def affine(y, s, b):
        return y * s[:, None, None] + b[:, None, None]

    xf = _nchw(x.float())
    y1 = F.conv2d(xf, w1.float().t()[:, :, None, None])
    y1 = torch.relu(affine(y1, s1, b1)).to(dt).float()
    y2 = F.conv2d(y1, w2.float().permute(3, 2, 0, 1), padding=1)
    y2 = torch.relu(affine(y2, s2, b2)).to(dt).float()
    y3 = affine(F.conv2d(y2, w3.float().t()[:, :, None, None]), s3, b3)
    out = torch.relu(y3 + xf).to(dt)
    return out.permute(0, 2, 3, 1).contiguous()


def fold_bottleneck(block):
    """``(w1, s1, b1, w2, s2, b2, w3, s3, b3)`` for ``megakernel_block``
    from an eval-mode port ``Bottleneck`` with an identity skip: each
    BN folds to ``s = scale·rsqrt(rv + eps)``, ``b = bias − s·rm``
    (float32); weights go channels-last in bf16: ``w1 =
    conv1.W[:, :, 0, 0]ᵀ``, ``w2 = conv2.W`` as HWIO, ``w3 =
    conv3.W[:, :, 0, 0]ᵀ``."""
    if block.downsample is not None or block.conv2.stride != (1, 1):
        raise ValueError("fold_bottleneck needs an identity skip (no "
                         "downsample, stride 1)")
    if block.training:
        raise ValueError("fold_bottleneck folds the running statistics: "
                         "call eval() first")

    def bn(layer):
        with torch.no_grad():
            s = layer.scale.float() * torch.rsqrt(layer.running_var
                                                  + layer.eps)
            return s.contiguous(), (layer.bias.float()
                                    - s * layer.running_mean).contiguous()

    with torch.no_grad():
        w1 = block.conv1.W[:, :, 0, 0].t()
        w2 = block.conv2.W.permute(2, 3, 1, 0)
        w3 = block.conv3.W[:, :, 0, 0].t()
        w1, w2, w3 = (w.to(torch.bfloat16).contiguous()
                      for w in (w1, w2, w3))
    (s1, b1), (s2, b2), (s3, b3) = (bn(block.bn1), bn(block.bn2),
                                    bn(block.bn3))
    return w1, s1, b1, w2, s2, b2, w3, s3, b3


# ------------------------------------------------------------------ kernel

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("resnet_bottleneck")
    if not getattr(lib, "_typed", False):
        # x, w1, s1, b1, w2, s2, b2, w3, s3, b3, out, B, H, W, C, CM, stream
        lib.resnet_bottleneck.argtypes = [_PTR] * 11 + [_INT] * 5 + [_PTR]
        lib.resnet_bottleneck.restype = ctypes.c_int
        lib.resnet_bottleneck_smem.argtypes = [_INT, _INT]
        lib.resnet_bottleneck_smem.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def smem_bytes(w, cm):
    """Shared memory one block of the kernel takes for rows ``w`` wide
    and ``cm`` bottleneck channels (the kernel's own formula; builds the
    library on first use)."""
    return _lib().resnet_bottleneck_smem(w, cm)


def _check_cuda(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """Raise on anything the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    n, h, w, c = x.shape
    cm = w1.shape[-1]
    want = {"x": (x, (n, h, w, c), torch.bfloat16),
            "w1": (w1, (c, cm), torch.bfloat16),
            "w2": (w2, (3, 3, cm, cm), torch.bfloat16),
            "w3": (w3, (cm, c), torch.bfloat16),
            "s1": (s1, (cm,), torch.float32), "b1": (b1, (cm,), torch.float32),
            "s2": (s2, (cm,), torch.float32), "b2": (b2, (cm,), torch.float32),
            "s3": (s3, (c,), torch.float32), "b3": (b3, (c,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise TypeError(f"megakernel_block: {name} must be {dtype} "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if (t.device != x.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"megakernel_block: {name} must be contiguous, "
                             f"16-byte aligned and on {x.device}")
    if c % 8 or cm % 8 or cm > MAX_CM:
        raise ValueError(f"megakernel_block takes C and CM multiples of 8 "
                         f"and CM <= {MAX_CM}, got C={c}, CM={cm}")
    if smem_bytes(w, cm) > _SMEM_LIMIT:
        raise ValueError(f"megakernel_block: W={w}, CM={cm} needs "
                         f"{smem_bytes(w, cm)} bytes of shared memory, more "
                         f"than {_SMEM_LIMIT}")


def megakernel_block(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The bottleneck forward (see the module docstring).  x: (B, H, W,
    C) bf16 channels-last; w1 (C, CM), w2 (3, 3, CM, CM), w3 (CM, C)
    bf16; s1, b1, s2, b2 (CM,) and s3, b3 (C,) float32."""
    args = (x, w1, s1, b1, w2, s2, b2, w3, s3, b3)
    if x.device.type == "cpu":
        return megakernel_block_plain(*args)
    _check_cuda(*args)
    out = torch.empty_like(x)
    n, h, w, c = x.shape
    err = _lib().resnet_bottleneck(
        *(t.data_ptr() for t in args), out.data_ptr(), n, h, w, c,
        w1.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    megakernel_block.launches += 1
    if err != 0:
        raise RuntimeError(f"megakernel_block: CUDA error {err} at launch")
    return out


megakernel_block.launches = 0
