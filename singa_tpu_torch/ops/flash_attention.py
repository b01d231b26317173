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
tensors it launches the kernel that :func:`route` names or raises: there
is no fallback.  bf16 and float16 with D <= 128 run all three on the
tensor cores (the forward and dK/dV as Hopper warpgroup kernels fed by
TMA, which reads rows of whole 16-byte chunks: a D that is not a
multiple of 8 goes through a zero-padded copy, which is exact); float32
and wider heads run on the CUDA cores.

Conventions kept from the JAX package: the finite floor ``NEG_INF =
-1e30`` (causal masking writes it, the running max starts at it); a row
with zero softmax mass gives ``O = 0`` and ``lse = NEG_INF``; the
general mask is an ``(M, S, S)`` tile addressed by ``(bh // qdiv) %
qmod``; ``window`` needs ``causal``; ``scale = 1/sqrt(D)``.  Unlike the
JAX wrapper, S is never padded: the kernels mask its ragged tail
themselves (D <= 1792 on the GPU; a wider head raises ``ValueError``
naming the limit).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..observe import monitor as _monitor
from . import _build

__all__ = [
    "NEG_INF", "MAX_HEAD_DIM", "TENSOR_CORE_MAX_HEAD_DIM", "F32_CUDA_CORE",
    "BF16_CUDA_CORE", "BF16_TENSOR_CORE", "F16_CUDA_CORE", "F16_TENSOR_CORE",
    "TENSOR_CORE_KINDS", "route",
    "flash_attention", "flash_attention_lse",
    "flash_attention_op", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
    "flash_fwd_plain", "flash_bwd_dq_plain", "flash_bwd_dkv_plain",
]

NEG_INF = -1e30
#: widest head the CUDA kernels take (their register and shared-memory
#: tiles are sized for D <= 64, <= 128, <= 256, <= 512 and, 8 rows a
#: tile, <= 1792: a row that fits 227 KB of shared memory as the dK/dV
#: kernel's four tiles)
MAX_HEAD_DIM = 1792
#: widest head the tensor-core kernels take (their tiles are 64 or 128
#: wide)
TENSOR_CORE_MAX_HEAD_DIM = 128
#: the kernels a C entry point launches (its ``kind`` argument)
F32_CUDA_CORE, BF16_CUDA_CORE, BF16_TENSOR_CORE = 0, 1, 2
F16_CUDA_CORE, F16_TENSOR_CORE = 3, 4
TENSOR_CORE_KINDS = (BF16_TENSOR_CORE, F16_TENSOR_CORE)
#: the 16-bit types' kinds: (CUDA cores, tensor cores)
_HALF_KINDS = {torch.bfloat16: (BF16_CUDA_CORE, BF16_TENSOR_CORE),
               torch.float16: (F16_CUDA_CORE, F16_TENSOR_CORE)}


def route(dtype, d):
    """The ``kind`` of kernel that ``flash_fwd``, ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` launch for CUDA tensors of this dtype and head dim:

    * ``BF16_TENSOR_CORE`` / ``F16_TENSOR_CORE``: bfloat16 / float16
      with D <= 128 (``fwd_wg_kernel`` and ``dkv_wg_kernel``: ``wgmma``
      warpgroup tiles fed by TMA; ``dq_tc_kernel``: ``mma.sync`` tiles;
      one source templated on the element type; float32 sums);
    * ``F32_CUDA_CORE``: float32, whose tensor-core products would be
      TF32 and miss the float32 tolerance;
    * ``BF16_CUDA_CORE`` / ``F16_CUDA_CORE``: bfloat16 / float16 with
      128 < D <= 1792 (``fwd_kernel``, ``dq_kernel``, ``dkv_kernel``,
      past D = 512 their 8-row ``*_narrow_kernel``: float32 FMAs, as for
      float32).

    Raises TypeError for another dtype and ValueError for D > 1792."""
    if dtype != torch.float32 and dtype not in _HALF_KINDS:
        raise TypeError(f"flash kernels take float32, bfloat16 or "
                        f"float16, got {dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash kernels take head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if dtype == torch.float32:
        return F32_CUDA_CORE
    return _HALF_KINDS[dtype][d <= TENSOR_CORE_MAX_HEAD_DIM]


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
    # q, k, v, masks, o, lse, bh, S, D, scale, causal, window, kind, stream
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
    """Raise on anything the kernels do not take; return the ``kind``
    that :func:`route` chooses."""
    kind = route(q.dtype, q.shape[-1])
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
    return kind


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


def _shape_args(q, scale, causal, window, kind, stream):
    bh, s, d = q.shape
    return [bh, s, d, float(scale), int(bool(causal)), int(window or 0),
            kind, stream]


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _tma_operands(kind, *ts):
    """The operands as the tensor-core kernels read them: through TMA,
    whose rows are whole 16-byte chunks at 16-byte aligned addresses.  A
    D that is not a multiple of 8 (or a base off 16 bytes) goes through a
    copy zero-padded to the next multiple of 8: exact, since zero columns
    add nothing to QKᵀ, ``scale`` comes from the true D and the outputs'
    pad columns are dropped (``_unpad``)."""
    d = ts[0].shape[-1]
    if kind not in TENSOR_CORE_KINDS or (
            d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ts)):
        return ts
    out = []
    for t in ts:
        p = t.new_zeros(*t.shape[:-1], d + -d % 8)
        p[..., :d] = t
        out.append(p)
    return tuple(out)


def _unpad(t, d):
    return t if t.shape[-1] == d else t[..., :d].contiguous()


# The launches themselves, on ``lib`` (the built library, or the CPU
# emulator's build of the same source) and ``stream``; outputs in the
# callers' shapes.

def _launch_fwd(lib, stream, kind, q, k, v, kmask, qmask, qmap, scale,
                causal, window):
    q_, k_, v_ = _tma_operands(kind, q, k, v)
    o = torch.empty_like(q_)
    lse = torch.empty(q.shape[:2], device=q.device, dtype=torch.float32)
    _raise_on(lib.flash_fwd(
        q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
        *_mask_args(kmask, qmask, qmap), o.data_ptr(), lse.data_ptr(),
        *_shape_args(q_, scale, causal, window, kind, stream)), "flash_fwd")
    return _unpad(o, q.shape[-1]), lse


def _launch_dq(lib, stream, kind, q, k, v, kmask, qmask, qmap, scale,
               causal, window, do, lse, delta):
    q_, k_, v_, do_ = _tma_operands(kind, q, k, v, do)
    dq = torch.empty_like(q_)
    _raise_on(lib.flash_bwd_dq(
        q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
        *_mask_args(kmask, qmask, qmap), do_.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        *_shape_args(q_, scale, causal, window, kind, stream)),
        "flash_bwd_dq")
    return _unpad(dq, q.shape[-1])


def _launch_dkv(lib, stream, kind, q, k, v, kmask, qmask, qmap, scale,
                causal, window, do, lse, delta):
    q_, k_, v_, do_ = _tma_operands(kind, q, k, v, do)
    dk, dv = torch.empty_like(k_), torch.empty_like(v_)
    _raise_on(lib.flash_bwd_dkv(
        q_.data_ptr(), k_.data_ptr(), v_.data_ptr(),
        *_mask_args(kmask, qmask, qmap), do_.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_shape_args(q_, scale, causal, window, kind, stream)),
        "flash_bwd_dkv")
    return _unpad(dk, q.shape[-1]), _unpad(dv, q.shape[-1])


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _count_flops(q, k, products):
    """Credit a launch's ``products`` (BH, S, S) x D matrix products to
    the step the monitor may be counting (``monitor.count_kernel_flops``:
    a ctypes launch is no aten op, so ``FlopCounterMode`` cannot see
    it).  Model FLOPs, as aten's count of SDPA has them: the forward's
    QKᵀ and PV, the backward's dP and dQ (``flash_bwd_dq``) and dV and
    dK (``flash_bwd_dkv``), each over the whole S x S square whatever
    the mask, recomputed products not counted."""
    bh, s, d = q.shape
    _monitor.count_kernel_flops(products * 2 * bh * s * k.shape[1] * d)


def flash_fwd(q, k, v, kmask, qmask, qmap, scale, causal, window):
    """(BH, S, D) q, k, v -> ``(o, lse)``; o in q's dtype, lse (BH, S)
    float32.  ``kmask``: (BH, S) float32 or None; ``qmask``: (M, S, S)
    float32 or None, row ``(bh // qdiv) % qmod`` for ``qmap = (qdiv,
    qmod)``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, kmask, qmask, qmap, scale, causal,
                               window)
    kind = _check_cuda(q, k, v, kmask, qmask)
    out = _launch_fwd(_lib(), _stream(q), kind, q, k, v, kmask, qmask,
                      qmap, scale, causal, window)
    flash_fwd.launches += 1
    flash_fwd.tensor_core_launches += kind in TENSOR_CORE_KINDS
    _count_flops(q, k, 2)
    return out


def flash_bwd_dq(q, k, v, kmask, qmask, qmap, scale, causal, window, do,
                 lse, delta):
    """dQ (BH, S, D) from dO, lse and ``delta = rowsum(dO∘O) − dlse``."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, kmask, qmask, qmap, scale, causal,
                                  window, do, lse, delta)
    kind = _check_cuda(q, k, v, kmask, qmask, do)
    _check_rows(q, lse, delta)
    dq = _launch_dq(_lib(), _stream(q), kind, q, k, v, kmask, qmask, qmap,
                    scale, causal, window, do, lse, delta)
    flash_bwd_dq.launches += 1
    flash_bwd_dq.tensor_core_launches += kind in TENSOR_CORE_KINDS
    _count_flops(q, k, 2)
    return dq


def flash_bwd_dkv(q, k, v, kmask, qmask, qmap, scale, causal, window, do,
                  lse, delta):
    """``(dK, dV)`` (BH, S, D) from dO, lse and delta."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, kmask, qmask, qmap, scale,
                                   causal, window, do, lse, delta)
    kind = _check_cuda(q, k, v, kmask, qmask, do)
    _check_rows(q, lse, delta)
    out = _launch_dkv(_lib(), _stream(q), kind, q, k, v, kmask, qmask,
                      qmap, scale, causal, window, do, lse, delta)
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.tensor_core_launches += kind in TENSOR_CORE_KINDS
    _count_flops(q, k, 2)
    return out


# launches in all, and those on the tensor-core route
flash_fwd.launches = flash_fwd.tensor_core_launches = 0
flash_bwd_dq.launches = flash_bwd_dq.tensor_core_launches = 0
flash_bwd_dkv.launches = flash_bwd_dkv.tensor_core_launches = 0


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
    """The attention op of the transformer layers' flash path, recorded
    for export as ``TPAttention`` with the fused path's ``scale``,
    ``causal`` and ``window``: the kernel computes the same function, so
    ``sonnx`` writes both routes as the same decomposed subgraph.  While
    exporting on the card, the forward kernel runs inside the record."""
    from .. import autograd

    xs = (q, k, v) if mask is None else (q, k, v, mask)
    return autograd._op(_flash_op, *xs, _name="TPAttention",
                        scale=1.0 / math.sqrt(q.shape[-1]), causal=causal,
                        window=window)


def _flash_op(q, k, v, *mask, scale, causal, window):
    return flash_attention(q, k, v, mask[0] if mask else None,
                           causal=causal, window=window)
