#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``singa_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero:

1. ``build``      - compiles every kernel source of ``singa_tpu_torch/csrc``
                    (flash attention, the ResNet bottleneck) with nvcc for
                    sm_90a, one nvcc process per source, all at once; then
                    reports each kernel's registers and spills (ptxas
                    ``-v``) and counts its tensor-core (HMMA/HGMMA) and
                    local-memory (LDL/STL) instructions in its SASS
                    (``cuobjdump -sass``); fails if a tensor-core kernel
                    (``*_tc_kernel``: the three flash kernels and the
                    bottleneck) is missing or has no HMMA/HGMMA.
2. ``kernels``    - holds ``flash_fwd``, ``flash_bwd_dq`` and
                    ``flash_bwd_dkv`` against their plain PyTorch versions
                    on the card: at GPT-2 small's attention shape (B=8,
                    H=12, S=1024, D=64, causal, bf16) and at edge shapes in
                    float32 and bf16 (key mask, a fully -inf-masked row,
                    general masks, sliding windows, S=1/65/129/1000,
                    D=8/13/72/96/128/160), where bf16 with D <= 128 runs
                    the tensor-core kernels and the rest the CUDA-core
                    ones; and times each kernel, its plain
                    version and PyTorch's fused attention, forward and
                    backward (a yardstick the port never calls).
3. ``slice``      - trains GPT-2 small (124M, n_positions 1024, so
                    attention runs through the flash kernels) for 5 steps
                    with bf16 amp and SGD(lr=1e-4, momentum=0.9) on a batch
                    of 8 x 1024 random ids, as ``bench.py``'s ``bench_gpt2``
                    configures the JAX package; checks finite losses,
                    exactly 12 launches of each kernel per step, all on
                    the tensor-core route, and the logits of an eval forward
                    against the same weights on the plain ("fused")
                    attention path.
4. ``profile``    - device time per kernel group (flash, GEMMs, the rest)
                    over 2 more steps, from torch.profiler; fails if the
                    profiler records no device time.
5. ``resnet``     - trains ResNet-50 (25.6M parameters, full depth and
                    width) for 5 steps at ``bench.py``'s ``bench_resnet50``
                    configuration: batch 128 x 3 x 224 x 224 random images
                    and labels from a numpy seed, 1000 classes, bf16 amp,
                    SGD(lr=0.1, momentum=0.9); checks finite losses and
                    running statistics; then ``resnet_profile``: device
                    time by group (convolutions, batch norm, the rest) over
                    2 more steps.
6. ``bottleneck`` - the trained ResNet-50 in eval mode: the activation
                    that enters ``layer1[1]`` (stem + ``layer1[0]``, batch
                    128, 56 x 56 x 256, channels-last bf16) goes through
                    ``megakernel_block`` with ``fold_bottleneck(layer1[1])``
                    (the one launch counted for the tensor-core
                    ``bottleneck_tc_kernel``), is held
                    element by element against ``megakernel_block_plain``
                    and, loosely, against the port's own eval forward of
                    ``layer1[1]``; the same gate must refuse two planted
                    faults (y1's ring padded with relu(b1), the skip left
                    out of one column);
                    then edge cases (B=1, 7 x 7, 56 x 28, C=128 with CM=32,
                    CM=128, b1=+1, random scales and biases) and times of
                    the kernel, its plain version and the cuDNN chain
                    (three channels-last bf16 convs and the elementwise
                    work; no single PyTorch call computes the block).
7. ``device``     - the card's name and power limit from nvidia-smi.

Then one line ``{"kernels": [...]}`` with each kernel's launches on the
main path, error, times and bound, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Needs a CUDA GPU; there is no CPU
mode.
"""

from __future__ import annotations

import json
import math
import os
import re
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense), used for the bound of each kernel
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

DEVICE = torch.device("cuda")
GPT2_SHAPE = dict(b=8, h=12, s=1024, d=64)
# kernel vs plain version, allclose(rtol, atol):
#   float32 - both sum in float32, in another order: 1e-4;
#   bf16    - inputs and outputs are bf16 (8-bit mantissa, 2^-8 = 0.4%
#             relative), and p / dS are rounded to bf16 against the
#             running max in the kernel but the final max in the plain
#             version: 2e-2 on O, lse and dQ/dK/dV.
#   bottleneck - per element (``bottleneck_stats``): bf16 in and out,
#             float32 sums in other orders, y1, y2 and out rounded to bf16
#             at the same points.  An output whose sum lands on the other
#             side of a rounding boundary moves by one bf16 ulp of itself;
#             a y1 or y2 element that rounded the other way moves the
#             float32 sum of an output by one ulp of one of its CM terms,
#             far below 2^-7 of the outputs' RMS.  So every element within
#             1 ulp_bf16(|want|) + 2^-7 * rms(want); and such roundings
#             are rare (on an H100, the tensor-core kernel: 2.4e-4 of the
#             elements at the real layer1[1] input, at most 5.0e-4 on the
#             edge cases), so at most 0.2% of the elements may differ at
#             all.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2),
       "bottleneck": dict(ulps=1, rtol=0.0, rms_atol=2.0 ** -7,
                          max_differing=2e-3)}
# GPT-2 small logits, flash kernels vs the plain attention path, both
# under bf16 amp: 12 blocks of bf16 activations round differently along
# the two paths; logits here are O(1).
LOGITS_ATOL = 0.1
# the kernel vs the port's eval forward of ``layer1[1]`` under bf16 amp,
# per element: the port rounds each conv's output, the BN affine (with its
# scale and shift in bf16) and the ReLU to bf16, about nine roundings of
# 2^-9 relative on the way to an output, where the kernel rounds only y1
# and y2; each element within 2^-4 |want| + 2^-4 rms(want), the second
# term for outputs where the skip and the block's sum cancel.  Every
# element may differ.
BLOCK_TOL = dict(ulps=0, rtol=2.0 ** -4, rms_atol=2.0 ** -4,
                 max_differing=1.0)
# the float64 witness (``f64_witness``) at random full-size bottleneck
# inputs, where rms(want) is O(1) and the gate's limit is tight: float32
# sums in any order round a few of the 25.7M y2 the other way, and such a
# y2 times a large w3 entry moves an output past the limit, for the plain
# version as for the kernel, but by well under twice it.  A wrong pixel,
# channel or tap moves outputs by O(rms(want)), tens of times the limit.
WITNESS_MAX_OVER = 2.0
RESNET_SHAPE = dict(batch=128, hw=224, classes=1000)


def log(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- kernels


def _case_inputs(b, h, s, d, dtype, seed, mask=None, causal=False,
                 window=None):
    """Flattened kernel inputs for one case, made from a numpy seed."""
    from singa_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(seed)

    def rand(*shape):
        return torch.from_numpy(
            rng.randn(*shape).astype(np.float32)).to(DEVICE)

    q, k, v, do = (rand(b, h, s, d).to(dtype) for _ in range(4))
    (qf, kf, vf), kmask, qmask, qmap = fa._prep(
        q, k, v, None if mask is None else mask.to(DEVICE))
    scale = 1.0 / math.sqrt(d)
    cfg = (kmask, qmask, qmap, scale, causal, window)
    dof = do.reshape(b * h, s, d).contiguous()
    dlse = 0.1 * rand(b * h, s)
    return (qf, kf, vf), cfg, dof, dlse


def check_case(name, b, h, s, d, dtype, seed, mask=None, causal=False,
               window=None):
    """Each kernel against its plain version on one case; returns
    ``{kernel: max |kernel - plain|}`` and raises past the tolerance."""
    from singa_tpu_torch.ops import flash_attention as fa

    (q, k, v), cfg, do, dlse = _case_inputs(b, h, s, d, dtype, seed, mask,
                                            causal, window)
    rtol, atol = TOL[dtype]
    errs = {}

    def compare(kernel, got, want):
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: {kernel} gave non-finite values")
        err = (got - want).abs().max().item()
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(
                f"{name}: {kernel} differs from its plain version by "
                f"{err} (rtol {rtol}, atol {atol})")

    o, lse = fa.flash_fwd(q, k, v, *cfg)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, *cfg)
    compare("flash_fwd", o, o_ref)
    compare("flash_fwd", lse, lse_ref)
    delta = ((do.float() * o_ref.float()).sum(-1) - dlse).contiguous()
    bwd = (do, lse_ref, delta)
    compare("flash_bwd_dq", fa.flash_bwd_dq(q, k, v, *cfg, *bwd),
            fa.flash_bwd_dq_plain(q, k, v, *cfg, *bwd))
    for got, want in zip(fa.flash_bwd_dkv(q, k, v, *cfg, *bwd),
                         fa.flash_bwd_dkv_plain(q, k, v, *cfg, *bwd)):
        compare("flash_bwd_dkv", got, want)
    torch.cuda.synchronize()
    return errs


def edge_cases():
    """(name, kwargs) of the small shapes that pin the semantics."""
    b, h = 2, 3
    key_mask = torch.zeros(b, 1, 1, 200)
    key_mask[:, :, :, 150:] = -1e9
    dead_row = torch.zeros(b, 1, 1, 128)
    dead_row[0] = float("-inf")  # batch row 0: every key masked to -inf
    rng = np.random.RandomState(7)

    def gmask(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    cases = [
        ("causal", dict(s=256, d=64, causal=True)),
        ("key_mask_s200", dict(s=200, d=64, mask=key_mask)),
        ("neg_inf_row", dict(s=128, d=64, mask=dead_row)),
        ("general_mask_m1", dict(s=128, d=64, mask=gmask(128, 128),
                                 causal=True)),
        ("general_mask_mB", dict(s=128, d=64, mask=gmask(b, 1, 128, 128))),
        ("general_mask_mH", dict(s=128, d=64, mask=gmask(1, h, 128, 128))),
        ("general_mask_mBH", dict(s=128, d=64,
                                  mask=gmask(b, h, 128, 128))),
        ("window", dict(s=256, d=64, causal=True, window=48)),
        ("s1000_d128", dict(s=1000, d=128, causal=True)),
        ("d96", dict(s=192, d=96)),
        ("d160_window", dict(s=160, d=160, causal=True, window=33)),
        # the edges of the tensor-core kernels' 64-row tiles and 64 / 128
        # wide rows: one row, one past a tile, a window of one key and one
        # across 128-row tiles, D far below a row and not a multiple of 16
        # or of 8 (element loads instead of cp.async, odd stores)
        ("s1", dict(s=1, d=64, causal=True)),
        ("s65_causal", dict(s=65, d=64, causal=True)),
        ("s129_causal", dict(s=129, d=64, causal=True)),
        ("window1", dict(s=200, d=64, causal=True, window=1)),
        ("window130_s384", dict(s=384, d=64, causal=True, window=130)),
        ("d8", dict(s=128, d=8)),
        ("d72_causal", dict(s=160, d=72, causal=True)),
        ("d13_s100", dict(s=100, d=13, causal=True)),
        ("d128_general_mask_causal", dict(s=192, d=128, causal=True,
                                          mask=gmask(b, h, 192, 192))),
    ]
    return [(n, dict(b=b, h=h, **kw)) for n, kw in cases]


def _work(b, h, s, d, causal, elem_bytes):
    """(products' multiply-adds in pair units, bytes of one (B·H, S, D)
    operand, bytes of one (B·H, S) float32 row vector) for the bounds."""
    bh = b * h
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    return pairs, bh * s * d * elem_bytes, bh * s * 4


def bounds_ms(b, h, s, d, causal, dtype):
    """Least time the card could take for each kernel's work: the larger
    of its FLOPs over the peak rate for the dtype and its bytes (each
    input read once, each output written once) over memory bandwidth."""
    elem = torch.finfo(dtype).bits // 8
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    pairs, mat, row = _work(b, h, s, d, causal, elem)
    work = {
        # QKᵀ and P·V; reads q, k, v; writes o and lse
        "flash_fwd": (2 * 2 * pairs * d, 4 * mat + row),
        # QKᵀ, dO·Vᵀ, dS·K; reads q, k, v, dO, lse, delta; writes dq
        "flash_bwd_dq": (3 * 2 * pairs * d, 5 * mat + 2 * row),
        # QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q; reads q, k, v, dO, lse, delta;
        # writes dk, dv
        "flash_bwd_dkv": (4 * 2 * pairs * d, 6 * mat + 2 * row),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_full_shape():
    """Times of each kernel, its plain version and SDPA at GPT-2 small's
    attention shape, and the kernel-vs-plain errors there."""
    import torch.nn.functional as F

    from singa_tpu_torch.ops import flash_attention as fa

    sh, dtype = GPT2_SHAPE, torch.bfloat16
    errs = check_case("gpt2_small", sh["b"], sh["h"], sh["s"], sh["d"],
                      dtype, seed=0, causal=True)
    (q, k, v), cfg, do, dlse = _case_inputs(
        sh["b"], sh["h"], sh["s"], sh["d"], dtype, seed=0, causal=True)
    o, lse = fa.flash_fwd(q, k, v, *cfg)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    bwd = (do, lse, delta)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, *cfg),
                      lambda: fa.flash_fwd_plain(q, k, v, *cfg)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, *cfg, *bwd),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, *cfg, *bwd)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, *cfg, *bwd),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, *cfg,
                                                         *bwd)),
    }
    times = {n: (cuda_time_ms(kern, 50), cuda_time_ms(plain, 5))
             for n, (kern, plain) in calls.items()}

    # yardstick: PyTorch's fused attention on the same (B, H, S, D) inputs
    shape = (sh["b"], sh["h"], sh["s"], sh["d"])
    q4, k4, v4 = (t.reshape(shape) for t in (q, k, v))
    sdpa_fwd = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        50)
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    do4 = do.reshape(shape)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), do4)

    sdpa_train = cuda_time_ms(sdpa_fwd_bwd, 10)
    sdpa_bwd, sdpa_bwd_err = sdpa_backward(q4, k4, v4, do4)
    return errs, times, sdpa_fwd, sdpa_train, sdpa_bwd, sdpa_bwd_err


def sdpa_backward(q4, k4, v4, do4):
    """Time of PyTorch's fused flash-attention backward, which computes
    dQ, dK and dV in one call, on (B, H, S, D) inputs; and its largest
    |difference| from the port's dQ/dK/dV kernels given each side's own
    forward (dlse = 0)."""
    from singa_tpu_torch.ops import flash_attention as fa

    aten = torch.ops.aten
    o4, lse4, cq, ck, mq, mk, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(q4, k4, v4, 0.0, True)

    def bwd():
        return aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, True, seed,
            offset)

    ms = cuda_time_ms(bwd, 50)
    b, h, s, d = q4.shape
    q, k, v, do = (t.reshape(b * h, s, d) for t in (q4, k4, v4, do4))
    cfg = (None, None, None, 1.0 / math.sqrt(d), True, None)
    o, lse = fa.flash_fwd(q, k, v, *cfg)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    ours = (fa.flash_bwd_dq(q, k, v, *cfg, do, lse, delta),
            *fa.flash_bwd_dkv(q, k, v, *cfg, do, lse, delta))
    err = max((a.float().reshape(b, h, s, d) - w.float()).abs().max().item()
              for a, w in zip(ours, bwd()))
    return ms, err


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {n: 0.0 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for seed, (name, kw) in enumerate(edge_cases()):
            errs = check_case(f"{name}/{str(dtype)[6:]}", dtype=dtype,
                              seed=seed, **kw)
            n_cases += 1
            for kname, e in errs.items():
                worst[kname] = max(worst[kname], e)
    full_errs, times, sdpa_fwd, sdpa_train, sdpa_bwd, sdpa_bwd_err = \
        time_full_shape()
    sh = GPT2_SHAPE
    bounds = bounds_ms(sh["b"], sh["h"], sh["s"], sh["d"], True,
                       torch.bfloat16)
    rows = {}
    for name in worst:
        ms, plain_ms = times[name]
        bound, by = bounds[name]
        rows[name] = dict(
            name=name, route="cuda",
            source="singa_tpu_torch/csrc/flash_attention.cu",
            replaces=REPLACES[name], launches=None,
            max_abs_err=full_errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by,
            # the library's backward is one call for dQ, dK and dV
            # together, so both backward rows carry its time
            library_ms=sdpa_fwd if name == "flash_fwd" else sdpa_bwd,
            library_call=LIBRARY_CALL[name])
    log({"phase": "kernels", "edge_cases": n_cases,
         "edge_max_abs_err": worst, "shape": dict(sh, causal=True,
                                                  dtype="bfloat16"),
         "times_ms": {n: {"kernel": r["ms"], "plain": r["plain_ms"],
                          "bound": r["bound_ms"]} for n, r in rows.items()},
         "sdpa_fwd_ms": sdpa_fwd, "sdpa_fwd_bwd_ms": sdpa_train,
         "sdpa_bwd_ms": sdpa_bwd,
         "sdpa_bwd_max_abs_diff_vs_kernels": sdpa_bwd_err})
    return rows


LIBRARY_CALL = {
    "flash_fwd": "torch.nn.functional.scaled_dot_product_attention "
                 "(forward)",
    "flash_bwd_dq": "aten._scaled_dot_product_flash_attention_backward "
                    "(dQ, dK and dV in one call)",
    "flash_bwd_dkv": "aten._scaled_dot_product_flash_attention_backward "
                     "(dQ, dK and dV in one call)",
}

REPLACES = {
    "flash_fwd": "singa_tpu/ops/pallas/flash_attention.py:183",
    "flash_bwd_dq": "singa_tpu/ops/pallas/flash_attention.py:357",
    "flash_bwd_dkv": "singa_tpu/ops/pallas/flash_attention.py:385",
}


# ------------------------------------------------------------------ slice


def phase_slice(rows, steps=5, batch=8, seq=1024, seed=0):
    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.ops import flash_attention as fa

    dev = device.create_cuda_gpu()
    dev.SetRandSeed(seed)
    amp.enable()
    cfg = GPT2Config.small(dropout=0.0)
    if cfg.attn_impl != "flash":
        raise AssertionError(f"GPT-2 small resolved attn_impl="
                             f"{cfg.attn_impl!r}, expected 'flash'")
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    x, y = tensor.from_numpy(ids, dev), tensor.from_numpy(labels, dev)

    m = GPT2LMHead(cfg)
    m.set_optimizer(opt.SGD(lr=1e-4, momentum=0.9))
    t0 = time.perf_counter()
    m.compile([x], is_train=True, use_graph=False)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for k in kernels:
        k.launches = k.tensor_core_launches = 0
    losses, step_ms = [], []
    for _ in range(steps):
        t = time.perf_counter()
        _, loss = m(x, y)
        losses.append(loss.item())  # synchronizes
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = {k.__name__: k.launches for k in kernels}
    tc_launches = {k.__name__: k.tensor_core_launches for k in kernels}

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    want = cfg.n_layer * steps
    if any(n != want for n in (*launches.values(), *tc_launches.values())):
        raise AssertionError(f"kernel launches {launches} (tensor-core "
                             f"route: {tc_launches}) over {steps} steps, "
                             f"expected {want} each")
    for name, n in launches.items():
        rows[name]["launches"] = n
    profile = profile_steps(m, x, y)

    # eval logits: flash kernels vs the same weights on the plain path
    m.eval()
    states = {k: v.detach() for k, v in m.get_states().items()}
    plain = GPT2LMHead(GPT2Config.small(dropout=0.0, attn_impl="fused"))
    plain.compile([x[:1, :8]], is_train=False)
    plain.set_states(states)
    probe = x[:2]
    with torch.no_grad():
        lf = m(probe).float()
        lp = plain(probe).float()
    if lf.shape != (2, seq, cfg.vocab_size) or not torch.isfinite(lf).all():
        raise AssertionError(f"bad logits: shape {tuple(lf.shape)}")
    logits_err = (lf - lp).abs().max().item()
    if logits_err > LOGITS_ATOL:
        raise AssertionError(f"flash vs plain-path logits differ by "
                             f"{logits_err} > {LOGITS_ATOL}")
    med = statistics.median(step_ms[1:])
    log({"phase": "slice", "model": "gpt2-small", "params": sum(
        p.numel() for p in m.parameters()), "batch": batch, "seq": seq,
        "amp": "bf16", "optimizer": "SGD(lr=1e-4, momentum=0.9)",
        "compile_s": compile_s, "losses": losses, "step_ms": step_ms,
        "median_step_ms": med, "tokens_per_s": batch * seq / med * 1e3,
        "launches": launches, "launches_per_step": {
            n: c / steps for n, c in launches.items()},
        "tensor_core_launches": tc_launches,
        "logits_max_abs_err_vs_plain": logits_err,
        "logits_atol": LOGITS_ATOL,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    log(dict(phase="profile", **profile))
    amp.enable(False)


KERNEL_GROUPS = (
    ("flash_attention", re.compile(r"\b(fwd|dq|dkv)(_tc)?_kernel<")),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
)


def profile_steps(m, x, y, steps=2, groups=KERNEL_GROUPS, ranges=()):
    """Device time by kernel over ``steps`` training steps (torch.profiler,
    CUPTI): the sum per group (kernels whose names match a group's
    pattern; then each ``(group, names)`` of ``ranges``, the device time
    of every kernel launched inside the CPU ranges (ops, autograd nodes)
    of those names; everything else), the ten costliest kernels, and the
    device's busy share of the host wall time of the window."""
    from torch.profiler import ProfilerActivity, profile

    range_names = {n for _, names in ranges for n in names}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            m(x, y)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in range_names]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if total_ms == 0:
        raise AssertionError("torch.profiler recorded no device time: no "
                             "breakdown of the step")
    out = {}
    for e in kernels:
        group = next((g for g, rx in groups if rx.search(e.key)), "other")
        out[group] = out.get(group, 0.0) + \
            e.self_device_time_total / 1e3 / steps
    for group, names in ranges:
        found = {e.key: e for e in events if e.key in names and
                 e.device_type == torch.autograd.DeviceType.CPU}
        if set(found) != set(names):
            raise AssertionError(f"profile has no range named "
                                 f"{sorted(set(names) - set(found))}")
        ms = sum(e.device_time_total for e in found.values()) / 1e3
        out[group] = ms / steps
        out["other"] = out.get("other", 0.0) - ms / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": total_ms / steps,
        "device_busy_share": total_ms / wall_ms,
        "group_ms_per_step": out,
        "top_kernels": [{"name": e.key[:120], "calls_per_step":
                         e.count / steps, "ms_per_step":
                         e.self_device_time_total / 1e3 / steps}
                        for e in top]}


# ----------------------------------------------------------------- resnet

RESNET_GROUPS = (
    # cuDNN convolutions (forward, dgrad, wgrad, layout transforms) and
    # the fc layer's GEMM
    ("conv_and_gemm", re.compile(
        r"conv|fprop|dgrad|wgrad|implicit|cudnn|xmma|cutlass|nvjet|gemm|"
        r"nchwToNhwc|nhwcToNchw", re.I)),
)
# the forward and backward autograd nodes of ops/batchnorm.py's training
# op: the profiler records each as a CPU range holding its kernels
BN_RANGES = (("batchnorm", ("_BatchNormTrain", "_BatchNormTrainBackward")),)


def phase_resnet(steps=5, seed=0):
    """ResNet-50 training at ``bench_resnet50``'s configuration; returns
    the trained model (amp still on) and its input batch."""
    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.resnet import resnet50

    sh = RESNET_SHAPE
    dev = device.create_cuda_gpu()
    dev.SetRandSeed(seed)
    amp.enable()
    rng = np.random.RandomState(seed)
    images = rng.randn(sh["batch"], 3, sh["hw"], sh["hw"]).astype(np.float32)
    labels = rng.randint(0, sh["classes"], sh["batch"]).astype(np.int32)
    x, y = tensor.from_numpy(images, dev), tensor.from_numpy(labels, dev)

    m = resnet50(num_classes=sh["classes"])
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m.compile([x], is_train=True, use_graph=False)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    losses, step_ms = [], []
    for _ in range(steps):
        t = time.perf_counter()
        _, loss = m(x, y)
        losses.append(loss.item())  # synchronizes
        step_ms.append((time.perf_counter() - t) * 1e3)

    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite ResNet-50 loss: {losses}")
    stats = {k: v for k, v in m.get_states().items()
             if k.endswith(("running_mean", "running_var"))}
    bad = [k for k, v in stats.items() if not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"non-finite running statistics: {bad[:5]}")
    if not any(v.abs().max().item() > 0 for k, v in stats.items()
               if k.endswith("running_mean")):
        raise AssertionError("no running mean moved during training")
    med = statistics.median(step_ms[1:])
    log({"phase": "resnet", "model": "resnet50", "params": sum(
        p.numel() for p in m.get_params().values()),
        "running_stat_buffers": len(stats), **sh, "amp": "bf16",
        "optimizer": "SGD(lr=0.1, momentum=0.9)", "compile_s": compile_s,
        "losses": losses, "step_ms": step_ms, "median_step_ms": med,
        "images_per_s": sh["batch"] / med * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    profile = profile_steps(m, x, y, groups=RESNET_GROUPS, ranges=BN_RANGES)
    log(dict(phase="resnet_profile", **profile))
    return m, x


# ------------------------------------------------------------- bottleneck


def bottleneck_inputs(b, h, w, c, cm, seed, affine="unit"):
    """Kernel arguments for one case, from a numpy seed: x ~ N(0, 1) and
    weights ~ N(0, 2/fan_in) in bf16, so every stage is O(1); ``affine``
    is ``"unit"`` (s = 1, b = 0), ``"random"`` (s ~ U(0.5, 1.5), b ~
    N(0, 0.5²)) or ``"b1_plus_one"`` (s = 1, b1 = +1: a halo padded with
    relu(b1) instead of 0 would show)."""
    rng = np.random.RandomState(seed)

    def rand(shape, std, dtype=torch.bfloat16):
        a = rng.randn(*shape).astype(np.float32) * std
        return torch.from_numpy(a).to(DEVICE).to(dtype)

    x = rand((b, h, w, c), 1.0)
    w1 = rand((c, cm), math.sqrt(2.0 / c))
    w2 = rand((3, 3, cm, cm), math.sqrt(2.0 / (9 * cm)))
    w3 = rand((cm, c), math.sqrt(2.0 / cm))
    sb = []
    for n in (cm, cm, c):
        if affine == "random":
            s_ = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(
                np.float32)).to(DEVICE)
            sb += [s_, rand((n,), 0.5, torch.float32)]
        else:
            sb += [torch.ones(n, device=DEVICE),
                   torch.zeros(n, device=DEVICE)]
    if affine == "b1_plus_one":
        sb[1] = torch.ones(cm, device=DEVICE)
    s1, b1, s2, b2, s3, b3 = sb
    return x, w1, s1, b1, w2, s2, b2, w3, s3, b3


def ulp_bf16(t):
    """One bf16 ulp at each |t| (float32): 2^(e-8) for |t| in [2^(e-1),
    2^e)."""
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


def bottleneck_stats(got, want, tol):
    """Per-element comparison of a block's output with its reference under
    ``tol`` (a ``TOL["bottleneck"]``-style dict): each |got - want| against
    ulps * ulp_bf16(want) + rtol * |want| + rms_atol * rms(want).  Returns
    the max |difference|, the RMS and max |want|, the share of elements
    that differ at all and of those past the limit, the largest
    difference over its limit, and ``ok``."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"got shape {tuple(got.shape)} (want "
                             f"{tuple(want.shape)}) or non-finite values")
    d = (got - want).abs()
    rms = want.square().mean().sqrt().item()
    limit = (tol["ulps"] * ulp_bf16(want) + tol["rtol"] * want.abs()
             + tol["rms_atol"] * rms)
    stats = dict(max_abs_err=d.max().item(), rms_want=rms,
                 max_abs_want=want.abs().max().item(),
                 share_differing=(d > 0).double().mean().item(),
                 share_past_limit=(d > limit).double().mean().item(),
                 max_err_over_limit=(d / limit).max().item())
    stats["ok"] = (stats["share_past_limit"] == 0
                   and stats["share_differing"] <= tol["max_differing"])
    return stats


def _compare_bottleneck(name, got, want, tol):
    """``bottleneck_stats``; raises unless they pass."""
    stats = bottleneck_stats(got, want, tol)
    if not stats["ok"]:
        raise AssertionError(f"{name}: megakernel_block fails its gate "
                             f"{tol}: {stats}")
    return stats


def check_bottleneck_case(name, b, h, w, c, cm, seed, affine="unit"):
    """``megakernel_block`` against its plain version on one case from
    ``bottleneck_inputs``; returns ``bottleneck_stats`` and raises past
    ``TOL["bottleneck"]``."""
    from singa_tpu_torch.ops import bottleneck as bk

    # the plain version's float32 convs, not cuDNN's default TF32
    torch.backends.cudnn.allow_tf32 = False
    args = bottleneck_inputs(b, h, w, c, cm, seed, affine)
    got = bk.megakernel_block(*args)
    want = bk.megakernel_block_plain(*args)
    torch.cuda.synchronize()
    return _compare_bottleneck(name, got, want, TOL["bottleneck"])


def bottleneck_f64(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, images=16):
    """The block in float64 with y1, y2 and out rounded to x's dtype at the
    kernel's rounding points: the exact sums, ``images`` at a time."""
    import torch.nn.functional as F

    dt = x.dtype
    k1 = w1.double().t()[:, :, None, None]
    k2 = w2.double().permute(3, 2, 0, 1)
    k3 = w3.double().t()[:, :, None, None]
    s1, b1, s2, b2, s3, b3 = (t.double()[:, None, None]
                              for t in (s1, b1, s2, b2, s3, b3))
    out = torch.empty_like(x)
    for i in range(0, x.shape[0], images):
        xf = x[i:i + images].double().permute(0, 3, 1, 2)
        y1 = torch.relu(F.conv2d(xf, k1) * s1 + b1).to(dt).double()
        y2 = torch.relu(F.conv2d(y1, k2, padding=1) * s2 + b2).to(dt).double()
        y3 = F.conv2d(y2, k3) * s3 + b3
        out[i:i + images] = torch.relu(y3 + xf).to(dt).permute(0, 2, 3, 1)
    return out


def f64_witness(got, plain, exact):
    """The kernel's output ``got`` and its plain version's ``plain``, each
    held against ``exact`` (``bottleneck_f64``) by ``bottleneck_stats``
    under ``TOL["bottleneck"]``, with the gate's own ``got`` against
    ``plain``.  ``ok`` when the kernel is no farther from exact than the
    plain version: it differs from ``exact`` on no larger a share of the
    elements (and within the gate's share), and no element by more than
    ``WITNESS_MAX_OVER`` times the gate's limit."""
    tol = TOL["bottleneck"]
    out = {"vs_plain": bottleneck_stats(got, plain, tol),
           "kernel_vs_f64": bottleneck_stats(got, exact, tol),
           "plain_vs_f64": bottleneck_stats(plain, exact, tol)}
    k, p = out["kernel_vs_f64"], out["plain_vs_f64"]
    out["ok"] = (k["share_differing"] <= min(p["share_differing"],
                                             tol["max_differing"])
                 and k["max_err_over_limit"] <= WITNESS_MAX_OVER)
    return out


def refuse_planted_faults(args, want):
    """``bottleneck_stats`` of each of ``planted_faults(*args)`` against
    the right output ``want``; raises if the gate passes one."""
    faults = {}
    for fault, wrong in planted_faults(*args).items():
        faults[fault] = bottleneck_stats(wrong, want, TOL["bottleneck"])
        if faults[fault]["ok"]:
            raise AssertionError(f"the bottleneck gate passes the planted "
                                 f"fault {fault}: {faults[fault]}")
    return faults


def planted_faults(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """Outputs of two wrong blocks, from the plain version's float32
    arithmetic, that the gate must refuse: ``halo_relu_b1`` pads y1's SAME
    ring with relu(b1) (y1 computed on a zero-padded x) instead of 0, and
    ``no_skip_one_column`` leaves the skip out of the middle column.  The
    first is left out where relu(b1) is 0 everywhere, as it then changes
    nothing."""
    import torch.nn.functional as F

    dt = x.dtype
    xf = x.float().permute(0, 3, 1, 2)

    def conv(y, wt, s, b, padding=0):
        y = F.conv2d(y, wt.float(), padding=padding)
        return y * s[:, None, None] + b[:, None, None]

    k1 = w1.t()[:, :, None, None]
    k2 = w2.permute(3, 2, 0, 1)
    k3 = w3.t()[:, :, None, None]

    def tail(y1, padding):
        y2 = torch.relu(conv(y1, k2, s2, b2, padding)).to(dt).float()
        return conv(y2, k3, s3, b3)

    y1 = torch.relu(conv(xf, k1, s1, b1)).to(dt).float()
    ring = torch.relu(conv(F.pad(xf, (1, 1, 1, 1)), k1, s1, b1))
    skip = xf.clone()
    skip[..., xf.shape[-1] // 2] = 0
    out = {"no_skip_one_column": torch.relu(tail(y1, 1) + skip)}
    if (b1 > 0).any():
        out["halo_relu_b1"] = torch.relu(tail(ring.to(dt).float(), 0) + xf)
    return {n: t.to(dt).permute(0, 2, 3, 1) for n, t in out.items()}


def bottleneck_edge_cases():
    """(name, kwargs) of the shapes that pin the kernel's semantics."""
    full = dict(h=56, w=56, c=256, cm=64)
    return [
        ("b1", dict(full, b=1)),
        ("hw7_bands_ragged", dict(b=2, h=7, w=7, c=256, cm=64)),
        ("h56_w28", dict(b=2, h=56, w=28, c=256, cm=64)),
        ("c128_cm32", dict(b=2, h=14, w=14, c=128, cm=32)),
        # the kernel's CM <= 128 instantiation, with 165 KB of shared
        # memory (one block an SM)
        ("cm128_w56", dict(b=1, h=8, w=56, c=256, cm=128)),
        ("odd_h5_w9_cm8", dict(b=3, h=5, w=9, c=64, cm=8)),
        ("b1_plus_one", dict(b=2, h=14, w=14, c=256, cm=64,
                             affine="b1_plus_one")),
        ("random_affine", dict(full, b=2, affine="random")),
    ]


def bottleneck_bound_ms(b, h, w, c, cm):
    """Least time for the block: x read and out written once (bf16), the
    weights and scales read once, against 2·B·H·W·(C·CM + 9·CM² + CM·C)
    FLOP at the bf16 peak."""
    macs = c * cm + 9 * cm * cm + cm * c
    flops = 2 * b * h * w * macs
    nbytes = 2 * b * h * w * c * 2 + macs * 2 + (4 * cm + 2 * c) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cudnn_chain(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The block as cuDNN runs it: three channels-last bf16 convs, each
    followed by the folded BN and ReLU in bf16 (the yardstick the
    experiment used; the port never calls it).  Returns a callable."""
    import torch.nn.functional as F

    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2)  # an NCHW view in channels-last memory
    k1 = w1.t()[:, :, None, None].contiguous(memory_format=cl)
    k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=cl)
    k3 = w3.t()[:, :, None, None].contiguous(memory_format=cl)
    sb = [t.to(torch.bfloat16)[None, :, None, None]
          for t in (s1, b1, s2, b2, s3, b3)]

    def run():
        y = torch.relu_(torch.addcmul(sb[1], F.conv2d(xc, k1), sb[0]))
        y = torch.relu_(torch.addcmul(sb[3], F.conv2d(y, k2, padding=1),
                                      sb[2]))
        y = torch.addcmul(sb[5], F.conv2d(y, k3), sb[4])
        return torch.relu_(y.add_(xc))

    return run


def phase_bottleneck(m, images):
    """The kernel on the real ``layer1[1]`` input of the trained model,
    its edge cases and its times; returns its row of the kernels line."""
    from singa_tpu_torch import amp
    from singa_tpu_torch.ops import bottleneck as bk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m.eval()
    block = m.layer1[1]
    with torch.no_grad():
        act = m.layer1[0](m.stem(images)).to(torch.bfloat16)
        ref = block(act).float().permute(0, 2, 3, 1)
    x = act.permute(0, 2, 3, 1).contiguous()
    args = (x,) + bk.fold_bottleneck(block)

    bk.megakernel_block.launches = 0
    out = bk.megakernel_block(*args)
    torch.cuda.synchronize()
    launches = bk.megakernel_block.launches
    if launches != 1:
        raise AssertionError(f"megakernel_block launched {launches} times "
                             f"on the main path, expected 1")
    plain = bk.megakernel_block_plain(*args)
    gate = _compare_bottleneck("layer1[1]", out, plain, TOL["bottleneck"])
    vs_block = _compare_bottleneck("layer1[1] vs the port's eval block",
                                   out, ref, BLOCK_TOL)
    amp.enable(False)
    # the gate's power: it must refuse the planted faults at this input
    # and where b1 = +1 makes a relu(b1) ring large
    faults = {"layer1[1]": refuse_planted_faults(args, plain)}
    del ref, plain
    b1_args = bottleneck_inputs(2, 14, 14, 256, 64, seed=0,
                                affine="b1_plus_one")
    faults["b1_plus_one"] = refuse_planted_faults(
        b1_args, bk.megakernel_block_plain(*b1_args))

    edge = {}
    for seed, (name, kw) in enumerate(bottleneck_edge_cases()):
        st = check_bottleneck_case(name, seed=seed, **kw)
        edge[name] = {k: st[k] for k in ("max_abs_err", "share_differing")}

    # random inputs at the main path's shape, refereed by float64 sums
    witness = {}
    for affine in ("unit", "random"):
        full_args = bottleneck_inputs(*x.shape, args[1].shape[1], seed=0,
                                      affine=affine)
        witness[affine] = f64_witness(bk.megakernel_block(*full_args),
                                      bk.megakernel_block_plain(*full_args),
                                      bottleneck_f64(*full_args))
        del full_args
        if not witness[affine]["ok"]:
            raise AssertionError(f"random {tuple(x.shape)} input, {affine} "
                                 f"affine: the kernel is farther from float64 "
                                 f"than its plain version: {witness[affine]}")

    chain = cudnn_chain(*args)
    chain_err = (chain().float() - out.float().permute(0, 3, 1, 2)
                 ).abs().max().item()
    ms = cuda_time_ms(lambda: bk.megakernel_block(*args), 10)
    plain_ms = cuda_time_ms(lambda: bk.megakernel_block_plain(*args), 3)
    chain_ms = cuda_time_ms(chain, 10)
    b, h, w, c = x.shape
    cm = args[1].shape[1]
    bound, by = bottleneck_bound_ms(b, h, w, c, cm)
    log({"phase": "bottleneck", "shape": dict(b=b, h=h, w=w, c=c, cm=cm),
         "input": "ResNet-50 layer1[1] input after the resnet phase's "
                  "steps, eval mode, channels-last bf16",
         "launches_main_path": launches, "vs_plain": gate,
         "tol": TOL["bottleneck"], "vs_eval_block": vs_block,
         "block_tol": BLOCK_TOL, "planted_faults": faults,
         "max_abs_diff_cudnn_chain": chain_err, "edge": edge,
         "random_full_vs_f64": witness,
         "smem_bytes": bk.smem_bytes(w, cm),
         "times_ms": {"kernel": ms, "plain": plain_ms,
                      "cudnn_chain": chain_ms, "bound": bound}})
    return dict(name="megakernel_block", route="cuda",
                source="singa_tpu_torch/csrc/resnet_bottleneck.cu",
                replaces="experiments/resnet_megakernel.py:40",
                launches=launches, max_abs_err=gate["max_abs_err"],
                share_differing=gate["share_differing"],
                rms_want=gate["rms_want"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                library_call="none: no single PyTorch call computes the "
                             "block",
                cudnn_chain_ms=chain_ms)


# ----------------------------------------------------------------- main

#: every kernel source of the port (``singa_tpu_torch/csrc/<name>.cu``)
SOURCES = ("flash_attention", "resnet_bottleneck")


def kernel_report(lib):
    """Per kernel of a built library, by its name as ``cu++filt``
    demangles it: registers and spill bytes from ptxas's ``-v`` report of
    the build, and the counts of tensor-core (HMMA, HGMMA) and
    local-memory (LDL, STL) instructions in its SASS (``cuobjdump
    -sass``)."""
    from singa_tpu_torch.ops import _build

    tools = os.path.dirname(_build.nvcc_path())
    out = {}
    with open(_build.ptxas_report(lib)) as fh:
        ptxas = fh.read()
    for name, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            ptxas, re.S):
        row = out.setdefault(name, {})
        for key, rx in (("registers", r"Used (\d+) registers"),
                        ("stack_bytes", r"(\d+) bytes stack frame"),
                        ("spill_store_bytes", r"(\d+) bytes spill stores"),
                        ("spill_load_bytes", r"(\d+) bytes spill loads")):
            m = re.search(rx, body)
            if m:
                row[key] = int(m.group(1))
    sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    for name, body in re.findall(
            r"Function : (\S+)\n(.*?)(?=Function : |\Z)", sass, re.S):
        row = out.setdefault(name, {})
        row["tensor_core_instructions"] = len(
            re.findall(r"\bH(?:G)?MMA\.", body))
        row["local_memory_instructions"] = len(
            re.findall(r"\b(?:LDL|STL)(?:\.\w+)*\s", body))
    names = sorted(out)
    readable = subprocess.run([os.path.join(tools, "cu++filt"), *names],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
    return dict(zip(readable, (out[n] for n in names), strict=True))


#: the tensor-core kernels each build must hold, by library; a kernel is
#: known by its demangled name, ``(anonymous namespace)::<name><...>(...)``
TENSOR_CORE_KERNELS = {
    "flash_attention": ("fwd_tc_kernel", "dq_tc_kernel", "dkv_tc_kernel"),
    "resnet_bottleneck": ("bottleneck_tc_kernel",),
}


def check_tensor_cores(report):
    """Raise unless every kernel of ``TENSOR_CORE_KERNELS`` is in its
    library's ``kernel_report`` and every ``*_tc_kernel`` instantiation
    there has tensor-core (HMMA/HGMMA) instructions; returns the tensor-core
    kernels' rows by name."""
    tc = {}
    for lib, names in TENSOR_CORE_KERNELS.items():
        rows = {k: v for k, v in report.get(lib, {}).items()
                if re.search(r"::\w+_tc_kernel<", k)}
        missing = [n for n in names
                   if not any(f"::{n}<" in k for k in rows)]
        if missing:
            raise AssertionError(f"{lib}: no {missing} in the build report")
        bare = {k: v for k, v in rows.items()
                if not v.get("tensor_core_instructions")}
        if bare:
            raise AssertionError(f"tensor-core kernels without HMMA/HGMMA "
                                 f"in their SASS: {bare}")
        tc.update(rows)
    return tc


def phase_build():
    """Builds every source at once and reports each kernel's SASS; fails
    if a tensor-core kernel is missing or has no tensor-core
    instruction."""
    from singa_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(_build.build, SOURCES))
    seconds = time.perf_counter() - t0
    for name in SOURCES:
        _build.load(name)
    report = {name: kernel_report(lib) for name, lib in zip(SOURCES, libs)}
    check_tensor_cores(report)
    log({"phase": "build", "libraries": libs, "seconds": seconds,
         "kernels": report})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's smoke run needs "
              "one GPU", file=sys.stderr)
        return 1
    phase_build()
    rows = phase_kernels()
    phase_slice(rows)
    model, images = phase_resnet()
    rows["megakernel_block"] = phase_bottleneck(model, images)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log({"phase": "device", "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda})
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
