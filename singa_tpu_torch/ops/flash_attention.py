"""Flash attention: forward, dQ and dK/dV (counterpart of
``singa_tpu/ops/pallas/flash_attention.py``).

Three kernels written by hand for Hopper live in
``singa_tpu_torch/csrc/flash_attention.cu``; each has a wrapper here with
a launch counter and a plain PyTorch version of the same function:

=================  ==========================  ==============================
wrapper            replaces (Pallas, TPU)      plain version
=================  ==========================  ==============================
``flash_fwd``      ``_flash_fwd_pallas``       ``flash_fwd_plain``
``flash_bwd_dq``   ``_flash_bwd_pallas`` (dQ)  ``flash_bwd_dq_plain``
``flash_bwd_dkv``  ``_flash_bwd_pallas`` (dKV) ``flash_bwd_dkv_plain``
=================  ==========================  ==============================

A wrapper takes its plain version only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises: there is no fallback.

Conventions kept from the JAX package: the finite floor ``NEG_INF =
-1e30`` (causal masking writes it, the running max starts at it); a row
with zero softmax mass gives ``O = 0`` and ``lse = NEG_INF``; the
general mask is an ``(M, S, S)`` tile addressed by ``(bh // qdiv) %
qmod``; ``window`` needs ``causal``; ``scale = 1/sqrt(D)``.  Unlike the
JAX wrapper, nothing is padded: the kernels mask the ragged tail of S
and D themselves, so S and D are taken as they are (D <= 256 on the GPU).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = [
    "NEG_INF", "MAX_HEAD_DIM", "flash_attention", "flash_attention_lse",
    "flash_attention_op", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
    "flash_fwd_plain", "flash_bwd_dq_plain", "flash_bwd_dkv_plain",
]

NEG_INF = -1e30
#: widest head the CUDA kernels take (their register and shared-memory
#: tiles are sized for D <= 64, <= 128 and <= 256)
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ------------------------------------------------------------ plain versions


def _scores(q, k, kmask, qmask, qmap, scale, causal, window):
    """(BH, S, S) float32 scores after scale, masks and the causal band,
    with the kernels' NEG_INF convention."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kmask is not None:
        s = s + kmask[:, None, :]
    if qmask is not None:
        qdiv, qmod = qmap
        idx = (torch.arange(q.shape[0], device=q.device) // qdiv) % qmod
        s = s + qmask[idx]
    if causal:
        n = q.shape[1]
        i = torch.arange(n, device=q.device)[:, None]
        j = torch.arange(n, device=q.device)[None, :]
        keep = i >= j
        if window is not None:
            keep = keep & (i - j < window)
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def flash_fwd_plain(q, k, v, kmask, qmask, qmap, scale, causal, window):
    """Plain version of ``flash_fwd``: ``(o, lse)`` with o (BH, S, D) in
    q's dtype and lse (BH, S) float32.  p is rounded to V's dtype before
    ``P·V``, as in the kernel."""
    s = _scores(q, k, kmask, qmask, qmap, scale, causal, window)
    m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _dscores(q, k, v, kmask, qmask, qmap, scale, causal, window, do, lse,
             delta):
    """Recomputed ``p = exp(s − lse)`` and ``dS = p∘(dO·Vᵀ − δ)·scale``."""
    s = _scores(q, k, kmask, qmask, qmap, scale, causal, window)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_plain(q, k, v, kmask, qmask, qmap, scale, causal, window,
                       do, lse, delta):
    """Plain version of ``flash_bwd_dq``: ``dQ = dS·K``."""
    _, ds = _dscores(q, k, v, kmask, qmask, qmap, scale, causal, window,
                     do, lse, delta)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, kmask, qmask, qmap, scale, causal, window,
                        do, lse, delta):
    """Plain version of ``flash_bwd_dkv``: ``dK = dSᵀ·Q``, ``dV = pᵀ·dO``."""
    p, ds = _dscores(q, k, v, kmask, qmask, qmap, scale, causal, window,
                     do, lse, delta)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_MASK_ARGS = [_PTR, _PTR, _INT, _INT]          # kmask, qmask, qdiv, qmod
_SHAPE_ARGS = [_INT, _INT, _INT, _FLOAT, _INT, _INT, _INT, _PTR]
_SIGNATURES = {
    # q, k, v, masks, o, lse, bh, S, D, scale, causal, window, dtype, stream
    "flash_fwd": [_PTR] * 3 + _MASK_ARGS + [_PTR, _PTR] + _SHAPE_ARGS,
    # q, k, v, masks, dO, lse, delta, dq, ...
    "flash_bwd_dq": [_PTR] * 3 + _MASK_ARGS + [_PTR] * 4 + _SHAPE_ARGS,
    # q, k, v, masks, dO, lse, delta, dk, dv, ...
    "flash_bwd_dkv": [_PTR] * 3 + _MASK_ARGS + [_PTR] * 5 + _SHAPE_ARGS,
}


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(q, k, v, kmask, qmask, *rest):
    """Raise on anything the kernels do not take."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    bh, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash kernels take head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    for t in (q, k, v) + rest:
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"flash kernels need q, k, v (and dO) of one "
                             f"shape and dtype: {tuple(t.shape)} {t.dtype} vs "
                             f"{tuple(q.shape)} {q.dtype}")
    for t in (q, k, v, kmask, qmask) + rest:
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError("flash kernels need contiguous tensors on one "
                             "device")
    for t in (kmask, qmask):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"masks must be float32, got {t.dtype}")


def _check_rows(q, lse, delta):
    """Raise unless lse and delta are contiguous float32 (BH, S) tensors on
    q's device: the backward kernels read them as raw float arrays."""
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != q.shape[:2]
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"flash backward kernels need {name} as a contiguous "
                f"float32 {tuple(q.shape[:2])} tensor on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _mask_args(kmask, qmask, qmap):
    qdiv, qmod = qmap if qmask is not None else (1, 1)
    return [_ptr(kmask), _ptr(qmask), int(qdiv), int(qmod)]


def _shape_args(q, scale, causal, window):
    bh, s, d = q.shape
    return [bh, s, d, float(scale), int(bool(causal)), int(window or 0),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream]


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def flash_fwd(q, k, v, kmask, qmask, qmap, scale, causal, window):
    """(BH, S, D) q, k, v -> ``(o, lse)``; o in q's dtype, lse (BH, S)
    float32.  ``kmask``: (BH, S) float32 or None; ``qmask``: (M, S, S)
    float32 or None, row ``(bh // qdiv) % qmod`` for ``qmap = (qdiv,
    qmod)``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, kmask, qmask, qmap, scale, causal,
                               window)
    _check_cuda(q, k, v, kmask, qmask)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], device=q.device, dtype=torch.float32)
    err = _lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *_mask_args(kmask, qmask, qmap), o.data_ptr(), lse.data_ptr(),
        *_shape_args(q, scale, causal, window))
    flash_fwd.launches += 1
    _raise_on(err, "flash_fwd")
    return o, lse


def flash_bwd_dq(q, k, v, kmask, qmask, qmap, scale, causal, window, do,
                 lse, delta):
    """dQ (BH, S, D) from dO, lse and ``delta = rowsum(dO∘O) − dlse``."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, kmask, qmask, qmap, scale, causal,
                                  window, do, lse, delta)
    _check_cuda(q, k, v, kmask, qmask, do)
    _check_rows(q, lse, delta)
    dq = torch.empty_like(q)
    err = _lib().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *_mask_args(kmask, qmask, qmap), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        *_shape_args(q, scale, causal, window))
    flash_bwd_dq.launches += 1
    _raise_on(err, "flash_bwd_dq")
    return dq


def flash_bwd_dkv(q, k, v, kmask, qmask, qmap, scale, causal, window, do,
                  lse, delta):
    """``(dK, dV)`` (BH, S, D) from dO, lse and delta."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, kmask, qmask, qmap, scale,
                                   causal, window, do, lse, delta)
    _check_cuda(q, k, v, kmask, qmask, do)
    _check_rows(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib().flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *_mask_args(kmask, qmask, qmap), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_shape_args(q, scale, causal, window))
    flash_bwd_dkv.launches += 1
    _raise_on(err, "flash_bwd_dkv")
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


class _FlashCore(torch.autograd.Function):
    """The differentiable ``(o, lse)`` pair (``_flash_core``): both
    outputs carry a gradient, and ``δ = rowsum(dO∘O) − dlse``."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, qmask, qmap, scale, causal, window):
        o, lse = flash_fwd(q, k, v, kmask, qmask, qmap, scale, causal,
                           window)
        ctx.save_for_backward(q, k, v, kmask, qmask, o, lse)
        ctx.cfg = (qmap, scale, causal, window)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, kmask, qmask, o, lse = ctx.saved_tensors
        qmap, scale, causal, window = ctx.cfg
        if do is None:
            do = torch.zeros_like(o)
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        args = (q, k, v, kmask, qmask, qmap, scale, causal, window, do, lse,
                delta)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None, None, None


# --------------------------------------------------------------- public API


def _key_mask_flat(mask, b, h, s):
    """(B, 1, 1, S) additive key mask -> (B·H, S), or None if ``mask`` is
    not a pure key mask."""
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        return mask[:, 0, 0, :].expand(b, s).repeat_interleave(h, dim=0)
    return None


def _general_mask_flat(mask, b, h, s):
    """Additive mask broadcastable to (B, H, S, S) -> ``((M, S, S), (qdiv,
    qmod))`` where ``(bh // qdiv) % qmod`` maps the B·H index onto M
    without materializing the broadcast (``_general_mask_flat`` of the
    JAX package)."""
    if mask.dim() == 2:
        mask = mask[None, None]
    if mask.dim() != 4 or mask.shape[0] not in (1, b) \
            or mask.shape[1] not in (1, h):
        raise ValueError(
            f"mask of shape {tuple(mask.shape)} is not broadcastable to "
            f"(B, H, S, S) = {(b, h, s, s)} with B and H each 1 or full")
    b0, h0 = mask.shape[0], mask.shape[1]
    mask = mask.expand(b0, h0, s, s)
    if h0 == 1:
        return mask[:, 0], ((b * h) // b0 if b0 > 1 else b * h, b0)
    return mask.reshape(b0 * h, s, s), (1, b0 * h)


def _prep(q, k, v, mask):
    """(B, H, S, D) inputs -> (B·H, S, D) contiguous views and the mask
    layouts ``(kmask, qmask, qmap)``."""
    b, h, s, d = q.shape
    flat = [t.reshape(b * h, s, d).contiguous() for t in (q, k, v)]
    kmask = qmask = qmap = None
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32)
        kmask = _key_mask_flat(mask, b, h, s)
        if kmask is None:
            qmask, qmap = _general_mask_flat(mask, b, h, s)
            qmask = qmask.contiguous()
        else:
            kmask = kmask.contiguous()
    return flat, kmask, qmask, qmap


def _check_window(causal, window):
    if window is not None and (not causal or window < 1):
        raise ValueError(
            f"window requires causal=True and window >= 1 (got "
            f"causal={causal}, window={window}): window < 1 would mask "
            f"every in-band score to the finite NEG_INF floor and return "
            f"uniform attention")


def flash_attention_lse(q, k, v, mask=None, causal=False, window=None):
    """q, k, v: (B, H, S, D); mask: additive, broadcastable to (B, H, S,
    S).  Returns ``(o (B, H, S, D), lse (B, H, S) float32)``, both
    differentiable."""
    _check_window(causal, window)
    b, h, s, d = q.shape
    (qf, kf, vf), kmask, qmask, qmap = _prep(q, k, v, mask)
    o, lse = _FlashCore.apply(qf, kf, vf, kmask, qmask, qmap,
                              1.0 / math.sqrt(d), bool(causal), window)
    return o.reshape(b, h, s, d), lse.reshape(b, h, s)


def flash_attention(q, k, v, mask=None, causal=False, window=None):
    """Like :func:`flash_attention_lse`, returning only o (B, H, S, D)."""
    return flash_attention_lse(q, k, v, mask, causal, window)[0]


def flash_attention_op(q, k, v, mask=None, causal=False, window=None):
    """The attention op of the transformer layers' flash path."""
    return flash_attention(q, k, v, mask, causal=causal, window=window)
