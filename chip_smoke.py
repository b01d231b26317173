#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``singa_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero:

1. ``build``      - compiles every kernel source of ``singa_tpu_torch/csrc``
                    (flash attention, the ResNet bottleneck, paged
                    attention) with nvcc for
                    sm_90a, one nvcc process per source, all at once; then
                    reports each kernel's registers and spills (ptxas
                    ``-v``) and counts its warp-level (HMMA) and
                    warpgroup (HGMMA) tensor-core instructions, its TMA
                    loads (UTMALDG) and its local-memory (LDL/STL)
                    instructions in its SASS (``cuobjdump -sass``); fails
                    if a tensor-core kernel (``TENSOR_CORE_KERNELS``: the
                    three flash kernels and the bottleneck) is missing, if
                    a ``*_tc_kernel`` has no tensor-core instruction, or
                    if a Hopper ``*_wg_kernel`` lacks HGMMA or UTMALDG.
2. ``kernels``    - holds ``flash_fwd``, ``flash_bwd_dq`` and
                    ``flash_bwd_dkv`` against their plain PyTorch versions
                    on the card: at GPT-2 small's attention shape (B=8,
                    H=12, S=1024, D=64, causal, bf16 and float16), at
                    BERT-base's (B=16, H=12, S=512, D=64, non-causal,
                    with no mask as its training step runs them and under
                    a ragged key-padding mask, bf16 and float16, timed
                    against PyTorch's fused attention with the same
                    additive mask or none), and at edge shapes in float32, bf16
                    and float16 (key mask, a fully -inf-masked row,
                    general masks, sliding windows, no mask at S=200,
                    S=1/65/129/1000,
                    D=8/13/72/96/128/160/320/512/640/1000/1024/1792), where
                    bf16 and float16 with D <= 128 run the tensor-core
                    kernels
                    (``fwd_wg_kernel`` / ``dkv_wg_kernel`` on wgmma and
                    TMA, ``dq_tc_kernel`` on mma.sync; D = 13 through a
                    zero-padded copy) and the rest the CUDA-core ones
                    (past D = 512 their 8-row rung); and times each
                    kernel, its plain
                    version and PyTorch's fused attention, forward and
                    backward (a yardstick the port never calls).
3. ``slice``      - trains GPT-2 small (124M, n_positions 1024, so
                    attention runs through the flash kernels) with bf16 amp
                    and SGD(lr=1e-4, momentum=0.9) on a batch of 8 x 1024
                    random ids, as ``bench.py``'s ``bench_gpt2`` configures
                    the JAX package, in graph mode (``use_graph=True``: the
                    step captured as a CUDA graph and replayed), 5 steps,
                    against 5 eager steps from the same weights: losses and
                    weights within ``CAPTURE_RTOL`` (worst difference
                    logged), host-clock step medians of both, exactly 12
                    launches of each kernel per replayed step, all on the
                    tensor-core route, the flash kernels named by the
                    profiler in a replayed step, ``graph.cache_miss`` flat
                    after the first step, the time of copying out the
                    logits, the dropout pin (``dropout_pin``), and the
                    logits of an eval forward against the same weights on
                    the plain ("fused") attention path; then two graph-mode
                    steps under ``amp.set_compute_dtype("float16")``
                    (``slice_f16``): finite losses, every flash launch on
                    the tensor-core route (the kernels line's ``_f16``
                    rows).
4. ``profile``    - device time per kernel group (flash, GEMMs, the rest)
                    and the device's busy share over 2 more steps of each
                    mode, from torch.profiler; fails if the profiler
                    records no device time.
5. ``bert``       - trains BERT-base (``BertConfig.base()``, 110M in the
                    trunk) as ``bench.py``'s ``bench_bert`` configures it:
                    batch 16 x 512 random ids and labels from a numpy seed,
                    bf16 amp, SGD(1e-4, 0.9), default dropout, graph mode
                    against eager from one state (``CAPTURE_RTOL``, under
                    deterministic algorithms), once on the fused attention
                    path and once with ``use_flash=True`` (12 launches of
                    each flash kernel a replayed step); host ms a step,
                    device ms by group, busy share, samples/s; eval
                    forwards through the kernels against the fused path,
                    float32 and bf16, with no mask and a ragged
                    ``attention_mask`` (``BERT_LOGITS_ATOL``), the mask
                    dropped on purpose refused.
6. ``onnx``       - ONNX interop at BERT-base's full width (133.5M
                    float32 parameters with the masked-LM head): the
                    model built with ``use_flash=True`` and no dropout
                    from a seed, exported by ``sonnx.to_onnx`` at batch
                    2 x 512 in float32 (the flash forward kernel,
                    ``fwd_kernel``, runs inside the export's record: 12
                    launches), saved, loaded and imported; the imported
                    graph's op types as the record predicts them; its
                    sequence and pooled outputs against the native flash
                    forward in float32 (``BERT_LOGITS_ATOL``) and under
                    bf16 amp (``fwd_wg_kernel``), and a second export with
                    an ``attention_mask`` against the native forward under
                    a ragged mask.  Then the imported graph, wrapped in
                    ``SONNXModel``, trains at ``bench_bert``'s
                    configuration (16 x 512, bf16 amp, SGD(1e-4, 0.9),
                    the masked-LM loss): eager against graph mode under
                    deterministic algorithms, bit for bit, finite losses;
                    its first loss against a native fused BERT loaded with
                    its weights through a ``save_states`` zip (1e-2
                    relative); each mode timed (host ms a step, device ms
                    by group, busy share, samples/s) beside the same
                    native model (fused, no dropout).  Last, the repo's
                    foreign ONNX fixtures imported on the card against
                    their goldens.
7. ``charrnn``    - trains the char-RNN as ``bench_charrnn`` configures
                    it (batch 64 x 100, vocab 100, hidden 256, 2 LSTM
                    layers, SGD(0.1), float32), graph mode against eager,
                    then ``train_n_batches`` over 10 stacked batches; host
                    ms a step, device ms, busy share; cuDNN's LSTM on the
                    same weights as a yardstick the port never calls.
8. ``resnet``     - trains ResNet-50 (25.6M parameters, full depth and
                    width) at ``bench.py``'s ``bench_resnet50``
                    configuration: batch 128 x 3 x 224 x 224 random images
                    and labels from a numpy seed, 1000 classes, bf16 amp,
                    SGD(lr=0.1, momentum=0.9), graph mode against eager as
                    in ``slice``; checks finite losses and running
                    statistics; then ``resnet_profile``: device time by
                    group (convolutions, batch norm, the rest) over 2 more
                    eager steps, and the busy share of both modes.
9. ``bottleneck`` - the trained ResNet-50 in eval mode: the activation
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
10. ``zoo``        - the CNN zoo at its published widths and input sizes,
                    each trained through ``Model.compile(use_graph=True)``
                    and ``train_one_batch`` with bf16 amp, a batch of 32
                    random images from a numpy seed and
                    ``examples/cnn/train_cnn.py``'s SGD(0.005, 0.9, wd
                    1e-5): CNN (28², 1 channel), AlexNet, VGG-16 and
                    MobileNetV2 (224²), Xception (299²) and
                    ``UNet(num_classes=2, base_channels=16, depth=3)``
                    (256², per-pixel labels); 3 eager steps against 3 in
                    graph mode from one state and one generator seed
                    (losses and weights within ``CAPTURE_RTOL``, finite
                    losses), then one profiled step of each mode: host
                    ms a step, device ms, busy share and images/s beside
                    the card's name and power limit.  Then the VGG-16
                    checkpoint check (``checkpoint_check``: the step
                    after ``save_states``/``load_states`` into a fresh
                    model and optimizer, and after an ``async_save``
                    taken between replays, bit for bit equal to the
                    uninterrupted step), the MLP at
                    ``examples/mlp/train.py``'s configuration (float32,
                    batch 64) the same way, that script's flow (eval
                    accuracy > 0.9), and ``schedule_probe`` (an
                    ``ExponentialDecay`` rate read off replayed steps
                    against its formula).
11. ``serve``      - serves GPT-2 small (124M, 12 layers, n_positions 1024,
                    random weights from a seed) through the paged engine,
                    ``model.serve(max_slots=8, paged=PagedConfig(
                    block_size=32, num_blocks=256))``, every decode step a
                    replay of its width bucket's captured graph: 24
                    requests at once, prompts of 16-512 tokens, 32-128 new
                    tokens, alternately greedy and at temperature 0.9 with
                    their own seeds.  In float32: the captured engine's
                    streams equal the eager engine's (``capture=False``),
                    the gather oracle's and offline ``generate``'s token
                    for token, ``paged_attn`` launches 12 times a decode
                    step, no block is in use after the drain, every
                    request completes by its length, and the serve census
                    (``jit_cache_size``) grows by one graph per width
                    bucket used and then stays flat.  In bf16: the same
                    traffic timed, captured and eager (TTFT and TPOT
                    medians, decode tokens/s), once each under
                    torch.profiler (the device's busy share), once eager
                    with every step's logits held against the gather
                    oracle on a copy of the pool (``SERVE_BF16_LOGITS_ATOL``)
                    and against a gather engine's streams up to each
                    request's first token whose top-2 margin is below it.
                    Then, float32 and captured: a pressured priority engine
                    (8 slots, ``PagedConfig(block_size=32, num_blocks=64)``,
                    12 requests of 200-500-token prompts and 32 new
                    tokens, a priority-0 wave then a higher-priority one)
                    that must preempt and resume, streams equal to offline
                    ``generate``, no block left, the census flat; and
                    ``GPT2Config.tiny`` (D = 16) served on the card,
                    streams equal to offline ``generate``.  Last, the
                    traffic captured in float16 (``paged_attn`` on float16
                    pools: the kernels line's ``paged_attn_f16`` row), 12
                    launches a decode step.
12. ``serve_int8`` - the same model and traffic on int8 pools
                    (``cache_dtype="int8"``): float32 streams equal the
                    int8 gather oracle's and offline int8 ``generate``'s,
                    the int8 kernel 12 launches a decode step, no block
                    left; the pressured priority engine on int8 pools
                    preempts and swaps (scales with the values) and
                    matches offline int8 ``generate``; bf16 timed (TTFT,
                    TPOT, decode tokens/s) and profiled (busy share), the
                    int8 kernels' main path, beside the bf16 pools.
13. ``serve_slots`` - the same traffic through ``model.serve()`` without
                    ``paged=`` (the slot arena, 8 slots of 1024 lanes),
                    dense and int8: float32 streams equal offline
                    ``generate``'s at the same ``cache_dtype``, exactly
                    one captured graph, the census flat; bf16 timed and
                    profiled.
14. ``generate``  - the serve phase's float32 GPT-2 small past
                    n_positions: a 1000-token prompt and 40 greedy tokens
                    take the windowed path (12 flash forward launches a
                    token), equal to the KV-cached ``generate`` over the
                    24 tokens that fit; ``min_p`` and
                    ``repetition_penalty`` on the KV-cached path.
15. ``paged_kernels`` - ``paged_attn`` (its split and combine kernels)
                    against ``paged_attn_plain``, on float32, bf16 and
                    float16 pools and on int8 pools with float32, bf16
                    and float16 q, at the edge cases of
                    ``paged_edge_cases`` (block sizes 1 to 32, partial and
                    full last blocks, all-trash and one-block tables, GQA
                    g = 3, D = 16/20/40/80/128/256/640/1024, Q = 4 with a
                    tril mask, GQA groups of 32 query rows and of 6 heads
                    at D = 1024 (launched in groups of heads), Q = 24
                    and 40 query positions (launched in runs of
                    positions), windows, 1000-lane slots, a long slot beside short
                    ones; one split of the key range and several), and at
                    tables of 12 layers' pools: one decode step's real
                    tables from the serve phase with bf16 pools, with
                    int8 pools (bf16 q), with float16 pools and with int8
                    pools (float16 q), and two 1000-lane slots, where it
                    times the kernels, their plain version and SDPA on
                    rows gathered from the pool (the yardstick; the
                    gather, and the dequantization of int8 pools, not
                    timed).
16. ``device``    - the card's name and power limit from nvidia-smi.

Then one line ``{"kernels": [...]}`` with each kernel's launches on the
main path (the graph-mode runs: a replay credits the launches its graph
holds), error, times and bound, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Needs a CUDA GPU; there is no CPU
mode.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import re
from concurrent.futures import ThreadPoolExecutor
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# cuBLAS reads its workspace configuration when it first runs: a fixed one
# keeps its GEMMs deterministic, which ``deterministic`` relies on
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# H100 SXM data-sheet peaks (dense), used for the bound of each kernel;
# float16's tensor-core peak equals bf16's
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

DEVICE = torch.device("cuda")
GPT2_SHAPE = dict(b=8, h=12, s=1024, d=64)
#: BERT-base's attention at bench_bert's batch 16 x 512
BERT_SHAPE = dict(b=16, h=12, s=512, d=64)
FLASH_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
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
#   float16 - inputs and outputs are float16 (11-bit significand, 2^-11 =
#             0.05% relative, 8x finer than bf16), rounded at the same
#             points as bf16; its 5 exponent bits make p and dS terms
#             below 2^-14 subnormal (absolute steps of 2^-24, rounded
#             alike by the plain version): 1e-2 on every output.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2),
       torch.float16: (1e-2, 1e-2),
       "bottleneck": dict(ulps=1, rtol=0.0, rms_atol=2.0 ** -7,
                          max_differing=2e-3)}
# GPT-2 small logits, flash kernels vs the plain attention path, both
# under bf16 amp: 12 blocks of bf16 activations round differently along
# the two paths; logits here are O(1).
LOGITS_ATOL = 0.1
# BERT-base MLM logits, the flash kernels vs the fused path on the same
# weights (``bert_eval_check``, 4 rows of 512).  Near init they are small:
# max |logit| 0.94 at init on the CPU, 1.10 after three SGD steps on an
# H100; rms 0.22.  float32: both paths sum in float32 in other orders,
# 1.3e-6 apart on the CPU and 1.9e-6 on the H100, so 1e-4.  bf16 amp: 12
# blocks of bf16 activations round differently along the two paths, 0.010
# apart on the CPU and 0.0117 on the H100 (3 bf16 ulps of the largest
# logits), so 2^-5, 8 ulps.  Dropping the ragged mask moves the logits by
# 0.134 (CPU, float32) and 0.162-0.167 (H100): over 4x the bf16 limit.
BERT_LOGITS_ATOL = {"float32": 1e-4, "bf16": 2.0 ** -5}
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


def device_ms_by_kernel(fn, iters, warmup=2, attempts=2):
    """Device time of ``fn()`` per call by kernel name: the CUDA kernels
    it launches over ``iters`` calls, by torch.profiler (CUPTI).  A
    recording that holds no device time at all (CUPTI now and then
    returns none for one recording of a run) is taken again;
    ``attempts`` empty ones raise."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                out[e.key] = out.get(e.key, 0.0) + \
                    e.self_device_time_total / 1e3 / iters
        if sum(out.values()) > 0:
            break
        print(f"chip_smoke.py: torch.profiler recorded no device time "
              f"(attempt {attempt + 1} of {attempts})", file=sys.stderr)
    else:
        raise AssertionError(f"torch.profiler recorded no device time in "
                             f"{attempts} attempts")
    return out


def device_ms_per_call(fn, iters, warmup=2):
    """Device time of ``fn()`` per call: every CUDA kernel it launches
    over ``iters`` calls, summed (``device_ms_by_kernel``).  Unlike
    ``cuda_time_ms`` it leaves out the gaps in which the device waits for
    the host, which set the event time of a kernel shorter than its
    wrapper's launch overhead."""
    return sum(device_ms_by_kernel(fn, iters, warmup).values())


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
        # the widest rung of the CUDA-core kernels (16-row tiles, rows of
        # 512): D past 256 and not a multiple of 64, a key mask, a window
        ("d320_key_mask", dict(s=200, d=320, mask=key_mask)),
        ("d512_window", dict(s=96, d=512, causal=True, window=40)),
        # the 8-row rung (a warp a row, rows up to 1792): D past 512 and
        # not a multiple of 32, a window across tiles, a general mask,
        # the widest row
        ("d640_window", dict(s=72, d=640, causal=True, window=20)),
        ("d1000_causal", dict(s=45, d=1000, causal=True)),
        ("d1024_general_mask", dict(s=40, d=1024,
                                    mask=gmask(b, h, 40, 40))),
        ("d1792", dict(s=20, d=1792)),
        # non-causal with no mask at D = 64 (BERT's training route), the
        # last key tile part-filled
        ("full_s200", dict(s=200, d=64)),
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
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
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


def time_full_shape(dtype=torch.bfloat16):
    """Times of each kernel, its plain version and SDPA at GPT-2 small's
    attention shape in ``dtype``, and the kernel-vs-plain errors there."""
    import torch.nn.functional as F

    from singa_tpu_torch.ops import flash_attention as fa

    sh = GPT2_SHAPE
    errs = check_case(f"gpt2_small/{str(dtype)[6:]}", sh["b"], sh["h"],
                      sh["s"], sh["d"], dtype, seed=0, causal=True)
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


def bert_key_mask(b, s, seed=0):
    """A ragged (B, 1, 1, S) additive key-padding mask, as BERT's
    ``attention_mask`` gives it (-1e9 past each row's length): row i keeps
    between S/4 and S keys (the last row all of them), from a numpy
    seed."""
    rng = np.random.RandomState(seed)
    keep = rng.randint(s // 4, s + 1, b)
    keep[-1] = s
    mask = torch.zeros(b, 1, 1, s)
    for i, n in enumerate(keep):
        mask[i, ..., n:] = -1e9
    return mask


def time_bert_shape(dtype):
    """BERT-base's attention at ``bench_bert``'s shape (16 x 12 x 512 x
    64, non-causal), once with no mask (the training step's path: it
    passes no ``attention_mask``) and once under a ragged key-padding
    mask (the masked eval's path: the key-mask edge path of the Hopper
    kernels): the three kernels against their plain versions at ``TOL``,
    their times beside their bounds, and PyTorch's fused attention with
    the same additive mask or none (forward, and forward with backward
    through autograd) as the yardstick."""
    import torch.nn.functional as F

    from singa_tpu_torch.ops import flash_attention as fa

    sh = BERT_SHAPE
    dt = str(dtype)[6:]
    shape = (sh["b"], sh["h"], sh["s"], sh["d"])
    bounds = bounds_ms(*shape, False, dtype)
    out = {"shape": dict(sh, causal=False, dtype=dt),
           "bounds_ms": {n: b for n, (b, _) in bounds.items()}}
    for name, mask in (("no_mask", None),
                       ("ragged_key_mask", bert_key_mask(sh["b"], sh["s"]))):
        errs = check_case(f"bert_base/{name}/{dt}", *shape, dtype, seed=1,
                          mask=mask)
        (q, k, v), cfg, do, dlse = _case_inputs(*shape, dtype, seed=1,
                                                mask=mask)
        o, lse = fa.flash_fwd(q, k, v, *cfg)
        delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
        bwd = (do, lse, delta)
        times = {
            "flash_fwd": cuda_time_ms(lambda: fa.flash_fwd(q, k, v, *cfg),
                                      50),
            "flash_bwd_dq": cuda_time_ms(
                lambda: fa.flash_bwd_dq(q, k, v, *cfg, *bwd), 50),
            "flash_bwd_dkv": cuda_time_ms(
                lambda: fa.flash_bwd_dkv(q, k, v, *cfg, *bwd), 50)}
        q4, k4, v4, do4 = (t.reshape(shape) for t in (q, k, v, do))
        m4 = None if mask is None else mask.to(DEVICE, dtype)
        sdpa_fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4), 50)
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q4, k4, v4))

        def sdpa_fwd_bwd():
            o4 = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=m4)
            torch.autograd.grad(o4, (qg, kg, vg), do4)

        out[name] = {"max_abs_err": errs, "tol": TOL[dtype],
                     "times_ms": times, "fwd_bwd_ms": sum(times.values()),
                     "sdpa_fwd_ms": sdpa_fwd,
                     "sdpa_fwd_bwd_ms": cuda_time_ms(sdpa_fwd_bwd, 10)}
    out["ragged_key_mask"]["rows_keep"] = "128..512 keys"
    return out


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
    """The flash kernels against their plain versions at every edge case
    in float32, bf16 and float16; timed at GPT-2 small's shape in bf16
    (the kernels line's rows) and float16 (its ``_f16`` rows), and at
    BERT-base's shape in both, with no mask and under a ragged key
    mask."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    worst = {str(dt)[6:]: {n: 0.0 for n in kernels} for dt in FLASH_DTYPES}
    n_cases = 0
    for dtype in FLASH_DTYPES:
        for seed, (name, kw) in enumerate(edge_cases()):
            errs = check_case(f"{name}/{str(dtype)[6:]}", dtype=dtype,
                              seed=seed, **kw)
            n_cases += 1
            for kname, e in errs.items():
                w = worst[str(dtype)[6:]]
                w[kname] = max(w[kname], e)
    sh = GPT2_SHAPE
    rows, shapes = {}, {}
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float16, "_f16")):
        full_errs, times, sdpa_fwd, sdpa_train, sdpa_bwd, sdpa_bwd_err = \
            time_full_shape(dtype)
        bounds = bounds_ms(sh["b"], sh["h"], sh["s"], sh["d"], True, dtype)
        for name in kernels:
            ms, plain_ms = times[name]
            bound, by = bounds[name]
            rows[name + suffix] = dict(
                name=name + suffix, route="cuda",
                source="singa_tpu_torch/csrc/flash_attention.cu",
                replaces=REPLACES[name], launches=None,
                max_abs_err=full_errs[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by,
                # the library's backward is one call for dQ, dK and dV
                # together, so both backward rows carry its time
                library_ms=sdpa_fwd if name == "flash_fwd" else sdpa_bwd,
                library_call=LIBRARY_CALL[name], dtype=str(dtype)[6:])
        shapes[str(dtype)[6:]] = {
            "times_ms": {n: {"kernel": rows[n + suffix]["ms"],
                             "plain": rows[n + suffix]["plain_ms"],
                             "bound": rows[n + suffix]["bound_ms"]}
                         for n in kernels},
            "sdpa_fwd_ms": sdpa_fwd, "sdpa_fwd_bwd_ms": sdpa_train,
            "sdpa_bwd_ms": sdpa_bwd,
            "sdpa_bwd_max_abs_diff_vs_kernels": sdpa_bwd_err}
    log({"phase": "kernels", "edge_cases": n_cases,
         "edge_max_abs_err": worst,
         "tol": {str(k)[6:]: v for k, v in TOL.items()
                 if isinstance(k, torch.dtype)},
         "shape": dict(sh, causal=True), "gpt2_shape": shapes,
         "bert_shape": {str(dt)[6:]: time_bert_shape(dt)
                        for dt in (torch.bfloat16, torch.float16)}})
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
    "paged_attn": "singa_tpu/models/gpt2_decode.py:841",
    # _paged_attn's int8 branch: its (values, scales) pools (:861), the
    # scaled scores (:885-889) and current lanes (:909-912)
    "paged_attn_int8": "singa_tpu/models/gpt2_decode.py:861",
}


# ------------------------------------------------------------------ slice

#: eager against captured training from the same weights, the largest
#: difference allowed in losses and weights, relative (a weight tensor's
#: to its largest magnitude).  A replay runs the eager step's kernels in
#: the same order on the same memory, so the two agree to the bit unless
#: cuBLAS or cuDNN choose other algorithms under capture: then float32
#: keeps 1e-5 and bf16 amp, whose activations round to 8 bits, 1e-3.
CAPTURE_RTOL = {"float32": 1e-5, "bf16": 1e-3}


def _relative_diff(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def train_eager_and_captured(build, x, y, steps, rtol, profiles,
                             before_run=None):
    """Train ``build(False)`` (eager) and ``build(True)`` (graph mode: the
    first call eager, the second captured, the rest replays) for
    ``steps`` steps each on the same batch from the same initial state,
    then profile each over 2 more steps (``profiles``: ``profile_steps``
    keywords by mode; None profiles neither).  ``before_run()`` is called
    before each mode's steps (to seed the device generator, so dropout
    draws the same masks in both).  Raises unless losses and weights agree within ``rtol``
    (``_relative_diff``), the flash kernels (if the model runs them)
    launch the same number of times in both and ``graph.cache_miss``
    moves once.  Returns ``(graph-mode model, report)``."""
    from singa_tpu_torch.observe.registry import registry
    from singa_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    misses = registry().counter("graph.cache_miss")
    graph = build(True)
    init = {k: v.detach().clone() for k, v in graph.get_states().items()}
    eager = build(False)
    eager.set_states(init)
    del init
    report = {}

    def run(m, mode):
        if before_run is not None:
            before_run()
        for k in kernels:
            k.launches = k.tensor_core_launches = 0
        miss0 = misses.value
        losses, step_ms, miss = [], [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, loss = m(x, y)
            losses.append(loss.item())  # synchronizes
            step_ms.append((time.perf_counter() - t) * 1e3)
            miss.append(misses.value - miss0)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{mode}: non-finite loss: {losses}")
        # the eager mode's first step, the captured mode's first two
        # (eager warm-up, capture) build and allocate: not steady
        steady = step_ms[1:] if mode == "eager" else step_ms[2:]
        report[mode] = dict(
            losses=losses, step_ms=step_ms,
            median_step_ms=statistics.median(steady),
            cache_miss_after_each_step=miss,
            launches={k.__name__: k.launches for k in kernels},
            tensor_core_launches={k.__name__: k.tensor_core_launches
                                  for k in kernels})
        if profiles is not None:
            report[mode]["profile"] = profile_steps(m, x, y, **profiles[mode])

    run(eager, "eager")
    final = {k: v.detach().clone() for k, v in eager.get_states().items()}
    del eager
    run(graph, "captured")
    e, c = report["eager"], report["captured"]
    if c["cache_miss_after_each_step"] != [1] * steps or any(
            e["cache_miss_after_each_step"]):
        raise AssertionError(f"graph.cache_miss moved after warm-up: "
                             f"{c['cache_miss_after_each_step']}")
    if c["launches"] != e["launches"] or \
            c["tensor_core_launches"] != e["tensor_core_launches"]:
        raise AssertionError(f"replayed steps credited {c['launches']} "
                             f"flash launches, eager steps made "
                             f"{e['launches']}")
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(c["losses"],
                                                        e["losses"]))
    diffs = {k: _relative_diff(v, final[k])
             for k, v in graph.get_states().items()}
    worst = max(diffs, key=diffs.get)
    weight_diff = diffs[worst]
    report["max_loss_rel_diff"] = loss_diff
    report["max_weight_rel_diff"] = weight_diff
    report["bitwise_equal"] = loss_diff == 0 and weight_diff == 0
    report["rtol"] = rtol
    if loss_diff > rtol or weight_diff > rtol:
        raise AssertionError(f"captured steps differ from eager ones: loss "
                             f"{loss_diff}, weights {weight_diff} (at "
                             f"{worst}) > {rtol}")
    return graph, report


def replayed_kernels(m, x, y):
    """The device kernels of one replayed step by name and count
    (torch.profiler): the replay calls no wrapper, so only this shows
    that the kernels ran inside the graph."""
    return {k[:80]: round(v, 6) for k, v in device_ms_by_kernel(
        lambda: m(x, y), 1, warmup=0).items()}


def dropout_pin(dev, seed=0):
    """Graph mode with lr 0: under dropout 0.1 three replays of one batch
    give three losses (the device generator is registered with the graph,
    so each replay draws a fresh mask); under dropout 0 they give one."""
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    ids = np.random.RandomState(seed).randint(0, 256, (2, 64)) \
        .astype(np.int32)
    x = tensor.from_numpy(ids, dev)
    y = tensor.from_numpy(np.roll(ids, -1, axis=1).astype(np.int32), dev)
    out = {}
    for p in (0.1, 0.0):
        m = GPT2LMHead(GPT2Config.tiny(dropout=p, attn_impl="flash"))
        m.set_optimizer(opt.SGD(lr=0.0))
        m.compile([x], is_train=True, use_graph=True)
        out[p] = [m(x, y)[1].item() for _ in range(5)]
    replays = {p: v[2:] for p, v in out.items()}
    if len(set(replays[0.1])) != 3 or len(set(replays[0.0])) != 1:
        raise AssertionError(f"dropout under replay: {out}")
    return {f"dropout_{p}": v for p, v in out.items()}


def phase_slice(rows, steps=5, batch=8, seq=1024, seed=0):
    """GPT-2 small training as ``bench_gpt2`` configures it, graph mode
    (``use_graph=True``): captured steps against eager ones from the same
    weights, the flash launches of the replayed steps, the kernels the
    profiler sees in a replay, the dropout pin; eval logits against the
    plain attention path."""
    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    dev = device.create_cuda_gpu()
    amp.enable()
    cfg = GPT2Config.small(dropout=0.0)
    if cfg.attn_impl != "flash":
        raise AssertionError(f"GPT-2 small resolved attn_impl="
                             f"{cfg.attn_impl!r}, expected 'flash'")
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    x, y = tensor.from_numpy(ids, dev), tensor.from_numpy(labels, dev)
    compile_s = {}

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = GPT2LMHead(cfg)
        m.set_optimizer(opt.SGD(lr=1e-4, momentum=0.9))
        t0 = time.perf_counter()
        m.compile([x], is_train=True, use_graph=use_graph)
        torch.cuda.synchronize()
        compile_s["captured" if use_graph else "eager"] = \
            time.perf_counter() - t0
        return m

    m, report = train_eager_and_captured(
        build, x, y, steps, CAPTURE_RTOL["bf16"],
        {"eager": {}, "captured": {}})
    c = report["captured"]
    want = cfg.n_layer * steps
    if any(n != want for n in (*c["launches"].values(),
                               *c["tensor_core_launches"].values())):
        raise AssertionError(f"kernel launches {c['launches']} (tensor-core "
                             f"route: {c['tensor_core_launches']}) over "
                             f"{steps} steps, expected {want} each")
    for name, n in c["launches"].items():
        rows[name]["launches"] = n
    in_replay = replayed_kernels(m, x, y)
    found = {g: [k for k in in_replay if rx.search(k)]
             for g, rx in KERNEL_GROUPS[:1]}["flash_attention"]
    if not all(any(f"{n}<" in k for k in found)
               for n in TENSOR_CORE_KERNELS["flash_attention"]):
        raise AssertionError(f"a replayed step ran no flash tensor-core "
                             f"kernel: {sorted(in_replay)}")
    logits, _ = m(x, y)
    torch.cuda.synchronize()
    clone_ms = cuda_time_ms(lambda: logits.clone(), 5)
    pin = dropout_pin(dev, seed)

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
    profiles = {mode: report[mode].pop("profile")
                for mode in ("eager", "captured")}
    med = c["median_step_ms"]
    log({"phase": "slice", "model": "gpt2-small", "params": sum(
        p.numel() for p in m.parameters()), "batch": batch, "seq": seq,
        "amp": "bf16", "optimizer": "SGD(lr=1e-4, momentum=0.9)",
        "use_graph": True, "compile_s": compile_s, **report,
        "median_step_ms": med, "tokens_per_s": batch * seq / med * 1e3,
        "launches_per_step": {n: k / steps
                              for n, k in c["launches"].items()},
        "kernels_in_a_replayed_step": in_replay,
        "logits_clone_ms": clone_ms,
        "logits_clone_bytes": logits.numel() * logits.element_size(),
        "dropout_pin": pin,
        "logits_max_abs_err_vs_plain": logits_err,
        "logits_atol": LOGITS_ATOL,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    log(dict(phase="profile", **profiles["captured"],
             eager=profiles["eager"]))
    del m, plain, logits
    log(slice_f16(dev, x, y, rows, seed))
    amp.enable(False)


def slice_f16(dev, x, y, rows, seed=0, steps=2):
    """GPT-2 small under ``amp.set_compute_dtype("float16")``, graph mode,
    ``steps`` steps on the slice's batch (the first eager, the second
    captured): finite losses, and every flash launch on the tensor-core
    route, which credits the kernels line's ``_f16`` rows."""
    from singa_tpu_torch import amp, opt
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.ops import flash_attention as fa

    kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    amp.set_compute_dtype("float16")
    try:
        dev.SetRandSeed(seed)
        m = GPT2LMHead(GPT2Config.small(dropout=0.0))
        m.set_optimizer(opt.SGD(lr=1e-4, momentum=0.9))
        m.compile([x], is_train=True, use_graph=True)
        for k in kernels:
            k.launches = k.tensor_core_launches = 0
        step_ms, losses = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, loss = m(x, y)
            losses.append(loss.item())
            step_ms.append((time.perf_counter() - t) * 1e3)
        launches = {k.__name__: k.launches for k in kernels}
        tc = {k.__name__: k.tensor_core_launches for k in kernels}
    finally:
        amp.enable()
    want = m.cfg.n_layer * steps
    if not all(math.isfinite(v) for v in losses) or \
            logits.dtype != torch.float16:
        raise AssertionError(f"float16 steps: losses {losses}, logits "
                             f"{logits.dtype}")
    if any(n != want for n in (*launches.values(), *tc.values())):
        raise AssertionError(f"float16 flash launches {launches} (tensor-"
                             f"core route: {tc}) over {steps} steps, "
                             f"expected {want} each")
    for name, n in launches.items():
        rows[name + "_f16"]["launches"] = n
    return {"phase": "slice_f16", "model": "gpt2-small", "amp": "float16",
            "steps": steps, "losses": losses, "step_ms": step_ms,
            "launches": launches, "tensor_core_launches": tc}


KERNEL_GROUPS = (
    ("flash_attention",
     re.compile(r"\b(fwd|dq|dkv)(_tc|_wg|_narrow)?_kernel<")),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
)


def profile_steps(m, x, y, steps=2, groups=KERNEL_GROUPS, ranges=()):
    """Device time by kernel over ``steps`` training steps (torch.profiler,
    CUPTI): the sum per group (kernels whose names match a group's
    pattern; then each ``(group, names)`` of ``ranges``, the device time
    of every kernel launched inside the CPU ranges (ops, autograd nodes)
    of those names; everything else), the ten costliest kernels, and the
    device's busy share of the host wall time of the window.  The host's
    ops are traced only for ``ranges``: tracing them slows an eager step
    and takes the profiler seconds a step to read."""
    from torch.profiler import ProfilerActivity, profile

    range_names = {n for _, names in ranges for n in names}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * bool(ranges) +
                 [ProfilerActivity.CUDA]) as prof:
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


# ------------------------------------------------------------ bert

#: bench_bert's configuration: BERT-base masked LM, batch 16 x 512 random
#: ids and labels from a numpy seed, bf16 amp, SGD(1e-4, 0.9), graph mode
BERT_RUN = dict(batch=16, seq=512, steps=3, sgd=dict(lr=1e-4, momentum=0.9))


def phase_bert(seed=0):
    """BERT-base masked-LM training at ``bench_bert``'s configuration
    (``BERT_RUN``, default dropout), once on the fused attention path that
    ``bench_bert`` runs and once with ``use_flash=True``: eager against
    graph mode from one state and one generator seed (dropout draws the
    same masks; deterministic algorithms, so an embedding's gradient is
    summed in one order), within ``CAPTURE_RTOL``; with flash, 12
    launches of each flash kernel a replayed step, all on the
    tensor-core route.  Then each mode timed on a fresh model with the
    deterministic algorithms off, as ``bench_bert`` runs
    (``time_steps``): host ms a step, device ms by group and busy share
    (profiled), samples/s.  Last, ``bert_eval_check``: eval forwards
    through the flash kernels against the fused path on the same
    weights."""
    import gc

    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    from singa_tpu_torch.ops import flash_attention as fa

    dev = device.create_cuda_gpu()
    smi = nvidia_smi()
    amp.enable()
    r = BERT_RUN
    cfg = BertConfig.base()
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (r["batch"], r["seq"]))
    labels = rng.randint(0, cfg.vocab_size, (r["batch"], r["seq"]))
    x = tensor.from_numpy(ids.astype(np.int32), dev)
    y = tensor.from_numpy(labels.astype(np.int32), dev)
    out = {}
    try:
        for use_flash in (False, True):
            def build(use_graph, use_flash=use_flash):
                dev.SetRandSeed(seed)
                m = BertForMaskedLM(BertConfig.base(use_flash=use_flash))
                m.set_optimizer(opt.SGD(**r["sgd"]))
                m.compile([x], is_train=True, use_graph=use_graph)
                return m

            t0 = time.perf_counter()
            with deterministic():
                m, rep = train_eager_and_captured(
                    build, x, y, r["steps"], CAPTURE_RTOL["bf16"], None,
                    before_run=lambda: dev.SetRandSeed(seed + 1))
            c = rep["captured"]
            want = cfg.num_hidden_layers * r["steps"] if use_flash else 0
            if any(n != want for n in (*c["launches"].values(),
                                       *c["tensor_core_launches"].values())):
                raise AssertionError(
                    f"BERT use_flash={use_flash}: flash launches "
                    f"{c['launches']} (tensor-core route: "
                    f"{c['tensor_core_launches']}) over {r['steps']} "
                    f"steps, expected {want} each")
            key = "flash" if use_flash else "fused"
            params = sum(p.numel() for p in m.get_params().values())
            if use_flash:
                out[key] = m
            else:
                states = {k: v.detach().clone()
                          for k, v in m.get_states().items()}
            del m
            gc.collect()
            torch.cuda.empty_cache()
            timed = {mode: time_steps(build, x, y, use_graph,
                                      ZOO_PROFILED_STEPS[mode],
                                      groups=KERNEL_GROUPS)
                     for mode, use_graph in (("eager", False),
                                             ("captured", True))}
            prof = {mode: timed[mode].pop("profile") for mode in timed}
            med = timed["captured"]["median_step_ms"]
            log({"phase": "bert", "attention": key, "params": params,
                 "batch": r["batch"], "seq": r["seq"], "amp": "bf16",
                 "optimizer": "SGD(lr=1e-4, momentum=0.9)",
                 "dropout": cfg.hidden_dropout, "use_graph": True,
                 "compare": rep,
                 "eager_ms": timed["eager"]["median_step_ms"],
                 "captured_ms": med,
                 "step_ms": {mode: timed[mode]["step_ms"] for mode in timed},
                 "samples_per_s": r["batch"] / med * 1e3,
                 "launches_per_step": {n: k / r["steps"]
                                       for n, k in c["launches"].items()},
                 "device_ms": {mode: prof[mode]["device_ms_per_step"]
                               for mode in prof},
                 "busy_share": {mode: prof[mode]["device_busy_share"]
                                for mode in prof},
                 "group_ms_per_step": {mode: prof[mode]["group_ms_per_step"]
                                       for mode in prof},
                 "profiled_steps": ZOO_PROFILED_STEPS,
                 "top_kernels": prof["captured"]["top_kernels"],
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                 "seconds": time.perf_counter() - t0, "nvidia_smi": smi})
            gc.collect()
            torch.cuda.empty_cache()

        # eval: the flash kernels against the fused path on the same
        # weights, with and without a ragged attention_mask
        flash = out.pop("flash")
        fused = BertForMaskedLM(BertConfig.base())
        fused.compile([x[:1, :8]], is_train=False)
        fused.set_states(states)
        flash.set_states(states)
        log(dict(phase="bert_eval", **bert_eval_check(
            flash, fused, x[:min(4, r["batch"])], seed)))
    finally:
        amp.enable(False)


def bert_eval_check(flash, fused, x, seed=0):
    """BERT eval forwards of ``x``'s rows through the flash kernels
    (``flash``: ``use_flash=True``) against the fused path (``fused``) on
    the same weights, in float32 and under bf16 amp, with no mask (the
    route a training step takes) and with a ragged ``attention_mask``
    (the kernels' key-mask row).  Each within ``BERT_LOGITS_ATOL``; and
    the unmasked flash logits against the masked fused ones, the mask
    dropped on purpose, must differ by more than twice the limit, so a
    lost mask could not pass.  Returns the readings; raises on a miss."""
    from singa_tpu_torch import amp
    from singa_tpu_torch.ops import flash_attention as fa

    flash.eval()
    fused.eval()
    prev = amp._compute_dtype
    n, seq = x.shape
    keep = (bert_key_mask(n, seq, seed) == 0)[:, 0, 0, :]
    am = keep.to(x.device, torch.int32)
    layers = flash.cfg.num_hidden_layers
    report = {"rows": n, "keys_kept": keep.sum(-1).tolist(),
              "logits_atol": BERT_LOGITS_ATOL}
    try:
        for dt in ("float32", "bf16"):
            amp.enable(dt == "bf16")
            logits, launched = {}, {}
            with torch.no_grad():
                for name, mask in (("masked", am), ("unmasked", None)):
                    before = fa.flash_fwd.launches
                    logits["flash_" + name] = flash(x, None, mask).float()
                    launched[name] = fa.flash_fwd.launches - before
                    logits["fused_" + name] = fused(x, None, mask).float()
            lf = logits["flash_masked"]
            if lf.shape != (n, seq, flash.cfg.vocab_size) or any(
                    not torch.isfinite(v).all() for v in logits.values()) \
                    or any(k != layers for k in launched.values()):
                raise AssertionError(f"BERT eval, {dt}: shape "
                                     f"{tuple(lf.shape)}, flash forward "
                                     f"launches {launched}")

            def diff(a, b):
                return (logits[a] - logits[b]).abs().max().item()

            want = logits["fused_masked"]
            got = {"masked": diff("flash_masked", "fused_masked"),
                   "unmasked": diff("flash_unmasked", "fused_unmasked"),
                   "mask_dropped": diff("flash_unmasked", "fused_masked")}
            limit = BERT_LOGITS_ATOL[dt]
            report[dt] = dict(
                max_abs_err_vs_fused=got, flash_fwd_launches=launched,
                fused_logits_max_abs=want.abs().max().item(),
                fused_logits_rms=want.pow(2).mean().sqrt().item())
            if got["masked"] > limit or got["unmasked"] > limit:
                raise AssertionError(f"BERT eval logits, flash vs fused, "
                                     f"{dt}: {got} > {limit}")
            if got["mask_dropped"] <= 2 * limit:
                raise AssertionError(f"BERT eval, {dt}: dropping the mask "
                                     f"moves the logits by only "
                                     f"{got['mask_dropped']}, within twice "
                                     f"the limit {limit}")
    finally:
        amp.enable(prev is not None)
    return report


# ---------------------------------------------------------------- onnx

#: the ONNX phase's exports: BERT-base with the masked-LM head, no
#: dropout, ``use_flash=True``, float32, at batch 2 x 512 for the forward
#: checks; the graph bakes its reshape shapes, so the training import is
#: exported again at ``BERT_RUN``'s batch
ONNX_EXPORT = dict(batch=2, seq=512)
ONNX_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_scratch", "chip_smoke_onnx")
#: the repo's foreign ONNX files, with the JAX package's tolerances for
#: them (rtol, atol)
ONNX_FIXTURES = (("gemm", 1e-5, 1e-6), ("ct_lstm", 2e-4, 1e-5),
                 ("trilu_scatternd", 2e-5, 1e-6))
#: the ONNX node types of each recorded op that sonnx decomposes (the rest
#: map one to one through ``sonnx._EXPORT_OPS``); Constant nodes are
#: shared by name, so they are not counted
ONNX_DECOMPOSED = {
    "Embedding": {"Gather": 1}, "FirstToken": {"Gather": 1},
    "AttnMask": {"Sub": 1, "Mul": 1, "Unsqueeze": 1},
    "TPAttention": {"Transpose": 1, "MatMul": 2, "Mul": 1, "Softmax": 1},
    "Attention": {"Transpose": 1, "MatMul": 2, "Mul": 1, "Softmax": 1},
}


def onnx_bert(cfg):
    """BERT-base with the masked-LM head whose forward also returns the
    trunk's sequence and pooled outputs (named ``BertForMaskedLM``, so
    its states are that model's)."""
    from singa_tpu_torch import autograd
    from singa_tpu_torch.models.bert import BertForMaskedLM

    class BertForMaskedLMTrunk(BertForMaskedLM):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.name = "BertForMaskedLM"

        def forward(self, input_ids, token_type_ids=None,
                    attention_mask=None):
            seq, pooled = self.bert.forward(input_ids, token_type_ids,
                                            attention_mask)
            h = self.ln(autograd.gelu(self.transform(seq)))
            return self.decoder(h), seq, pooled

    return BertForMaskedLMTrunk(cfg)


def onnx_predicted_types(ops):
    """Node-type counts that the recorded ``ops`` export as (Constant
    nodes left out)."""
    from collections import Counter

    from singa_tpu_torch import sonnx

    want = Counter()
    for op in ops:
        base = op.name.split("#")[0]
        if base in ONNX_DECOMPOSED:
            want.update(ONNX_DECOMPOSED[base])
            if base.endswith("Attention"):
                want["Add"] += (len(op.src) > 3) + bool(
                    op.params.get("causal"))
        else:
            want[sonnx._EXPORT_OPS[base]] += 1
    return want


def onnx_export(m, inputs, path):
    """Export ``m`` on ``inputs`` to ``path``: the flash forward launches
    it made, its node-type counts against the record's prediction,
    sizes and seconds; returns (report, the model read back)."""
    from collections import Counter

    from singa_tpu_torch import sonnx
    from singa_tpu_torch.ops import flash_attention as fa

    fa.flash_fwd.launches = fa.flash_fwd.tensor_core_launches = 0
    t0 = time.perf_counter()
    proto = sonnx.to_onnx(m, inputs)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "tensor_core": fa.flash_fwd.tensor_core_launches}
    sonnx.save(proto, path)
    t2 = time.perf_counter()
    loaded = sonnx.load(path)
    t3 = time.perf_counter()
    rec, _ = sonnx._record_forward(m, inputs)
    predicted = onnx_predicted_types(rec.ops)
    del rec
    got = Counter(n.op_type for n in loaded.graph.node
                  if n.op_type != "Constant")
    if got != predicted:
        raise AssertionError(f"ONNX import of {path}: node types {got}, "
                             f"the record predicts {predicted}")
    params = {i.name: int(np.prod(i.dims)) for i in loaded.graph.initializer
              if not i.name.startswith("const_")}
    native = {k: v.numel() for k, v in m.get_params().items()}
    if params != native:
        raise AssertionError(f"ONNX initializers {len(params)} differ from "
                             f"the model's {len(native)} parameters")
    return {"nodes": len(loaded.graph.node),
            "node_types": dict(sorted(got.items())),
            "initializers": len(loaded.graph.initializer),
            "float32_params": sum(params.values()),
            "bytes": os.path.getsize(path), "flash_fwd_launches": launches,
            "seconds": {"export": t1 - t0, "save": t2 - t1,
                        "load": t3 - t2}}, loaded


def onnx_forward_check(native, rep, feeds, limits):
    """The imported graph's sequence and pooled outputs against the
    native model's (flash) forward on ``feeds``, in float32 and under
    bf16 amp; each within ``limits[dtype]``.  Returns the readings and
    the flash forward launches (all and tensor-core) of each dtype."""
    from singa_tpu_torch import amp
    from singa_tpu_torch.ops import flash_attention as fa

    report = {}
    prev = amp._compute_dtype
    try:
        for dt, limit in limits.items():
            amp.enable(dt == "bf16")
            k0 = (fa.flash_fwd.launches, fa.flash_fwd.tensor_core_launches)
            with torch.no_grad():
                want = native(*feeds)
                k1 = (fa.flash_fwd.launches,
                      fa.flash_fwd.tensor_core_launches)
                got = rep.run(list(feeds))
            err = {name: (g.float() - w.float()).abs().max().item()
                   for name, g, w in zip(("logits", "seq", "pooled"), got,
                                         want)}
            report[dt] = {"max_abs_err": err, "limit": limit,
                          "native_flash_fwd": k1[0] - k0[0],
                          "native_tensor_core": k1[1] - k0[1]}
            if not all(torch.isfinite(g).all() for g in got) or \
                    err["seq"] > limit or err["pooled"] > limit:
                raise AssertionError(f"ONNX import vs native, {dt}: {err} "
                                     f"> {limit}")
    finally:
        amp.enable(prev is not None)
    return report


def zip_states(path):
    """The model states of a ``save_states`` zip, by name."""
    import io
    import zipfile

    from singa_tpu_torch.model import _from_npy

    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            k = name[:-len(".npy")]
            if not k.startswith(("__opt__", "__aux__")):
                out[k] = _from_npy(np.load(io.BytesIO(zf.read(name))))
    return out


def phase_onnx(seed=0):
    """ONNX interop at BERT-base's full width (docstring, phase 6): export
    through the flash forward kernel, import, forwards against the
    native model, the import trained at ``bench_bert``'s configuration
    eager against captured, and the foreign fixtures."""
    import gc

    from singa_tpu_torch import amp, autograd, device, opt, sonnx, tensor
    from singa_tpu_torch.models.bert import BertConfig, BertForMaskedLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = device.create_cuda_gpu()
    smi = nvidia_smi()
    t_phase = time.perf_counter()
    os.makedirs(ONNX_DIR, exist_ok=True)
    cfg = BertConfig.base(use_flash=True, hidden_dropout=0.0,
                          attn_dropout=0.0)
    layers = cfg.num_hidden_layers
    rng = np.random.RandomState(seed)
    e, r = ONNX_EXPORT, BERT_RUN
    x2 = tensor.from_numpy(
        rng.randint(0, cfg.vocab_size, (e["batch"], e["seq"]))
        .astype(np.int32), dev)
    tt2 = torch.zeros_like(x2)
    am2 = (bert_key_mask(e["batch"], e["seq"], seed) == 0)[:, 0, 0, :].to(
        dev.torch_device, torch.float32)
    x = tensor.from_numpy(rng.randint(0, cfg.vocab_size, (r["batch"],
                                                          r["seq"]))
                          .astype(np.int32), dev)
    y = tensor.from_numpy(rng.randint(0, cfg.vocab_size, (r["batch"],
                                                          r["seq"]))
                          .astype(np.int32), dev)
    dev.SetRandSeed(seed)
    native = onnx_bert(cfg)
    native.compile([x2], is_train=False)
    log_ = {"phase": "onnx", "model": "BertForMaskedLM (base) + trunk "
            "outputs", "use_flash": True, "dropout": 0.0,
            "export_batch": [e["batch"], e["seq"]], "nvidia_smi": smi}

    # 1. export through the flash forward kernel (float32: fwd_kernel)
    exp, loaded = onnx_export(native, [x2],
                              os.path.join(ONNX_DIR, "bert_base.onnx"))
    if exp["flash_fwd_launches"] != {"flash_fwd": layers, "tensor_core": 0}:
        raise AssertionError(f"ONNX export: flash forward launches "
                             f"{exp['flash_fwd_launches']}, expected "
                             f"{layers} on the float32 CUDA-core route")
    t0 = time.perf_counter()
    rep = sonnx.prepare(loaded, dev)
    exp["seconds"]["prepare"] = time.perf_counter() - t0
    log_["export"] = exp

    # 2. imported forwards against the native flash forward
    log_["forward"] = onnx_forward_check(native, rep, [x2],
                                         BERT_LOGITS_ATOL)
    for dt, tc in (("float32", 0), ("bf16", layers)):
        f = log_["forward"][dt]
        if (f["native_flash_fwd"], f["native_tensor_core"]) != (layers, tc):
            raise AssertionError(f"native {dt} forward: flash launches "
                                 f"{f}, expected {layers} ({tc} on tensor "
                                 f"cores)")
    exp_m, loaded_m = onnx_export(
        native, [x2, tt2, am2], os.path.join(ONNX_DIR, "bert_base_mask.onnx"))
    rep_m = sonnx.prepare(loaded_m, dev)
    log_["export_mask"] = exp_m
    log_["forward_mask"] = onnx_forward_check(
        native, rep_m, [x2, tt2, am2],
        {"float32": BERT_LOGITS_ATOL["float32"]})
    with torch.no_grad():
        dropped = (rep.run([x2])[1] - native(x2, tt2, am2)[1]).abs().max()
    log_["forward_mask"]["mask_dropped_err"] = dropped.item()
    if dropped.item() <= 2 * BERT_LOGITS_ATOL["float32"]:
        raise AssertionError(f"ONNX import: dropping the mask moves the "
                             f"sequence output by only {dropped.item()}")
    del rep, rep_m, loaded_m
    gc.collect()

    # 3. the import trained at bench_bert's configuration
    exp_t, loaded_t = onnx_export(
        native, [x], os.path.join(ONNX_DIR, "bert_base_train.onnx"))
    log_["export_train"] = exp_t
    del native
    gc.collect()
    torch.cuda.empty_cache()

    class OnnxMaskedLM(sonnx.SONNXModel):
        def train_one_batch(self, ids, labels):
            logits = self.forward(ids)[0]
            b, s, v = logits.shape
            loss = autograd.softmax_cross_entropy(
                autograd.reshape(logits, (b * s, v)),
                autograd.reshape(labels, (b * s,)))
            self.optimizer(loss)
            return logits, loss

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = OnnxMaskedLM(loaded_t, dev)
        m.set_optimizer(opt.SGD(**r["sgd"]))
        m.compile([x], is_train=True, use_graph=use_graph)
        return m

    amp.enable()
    try:
        t0 = time.perf_counter()
        with deterministic():
            m, rep_t = train_eager_and_captured(
                build, x, y, r["steps"], CAPTURE_RTOL["bf16"], None)
        if not rep_t["bitwise_equal"]:
            raise AssertionError(
                f"imported BERT: captured steps differ from eager ones "
                f"(loss {rep_t['max_loss_rel_diff']}, weights "
                f"{rep_t['max_weight_rel_diff']})")
        zpath = os.path.join(ONNX_DIR, "bert_base_import.zip")
        m.save_states(zpath)
        del m
        gc.collect()
        torch.cuda.empty_cache()
        # a native fused BERT with the imported model's weights
        states = zip_states(zpath)

        def build_native(use_graph):
            dev.SetRandSeed(seed)
            nat = BertForMaskedLM(BertConfig.base(hidden_dropout=0.0,
                                                  attn_dropout=0.0))
            nat.set_optimizer(opt.SGD(**r["sgd"]))
            nat.compile([x], is_train=True, use_graph=use_graph)
            nat.set_states({k: states[k] for k in nat.get_states()})
            return nat

        nat = build_native(False)
        extra = sorted(set(states) - set(nat.get_states()))
        if any(not k.startswith("const_") for k in extra):
            raise AssertionError(f"imported states {extra[:5]} name no "
                                 f"native state")
        with deterministic():
            native_loss = nat(x, y)[1].item()
        del nat
        gc.collect()
        torch.cuda.empty_cache()
        # the same model natively, no dropout either, timed in this call
        native_timed = {mode: time_steps(build_native, x, y, use_graph,
                                         ZOO_PROFILED_STEPS[mode],
                                         groups=KERNEL_GROUPS)
                        for mode, use_graph in (("eager", False),
                                                ("captured", True))}
        gc.collect()
        torch.cuda.empty_cache()
        first = rep_t["eager"]["losses"][0]
        rel = abs(first - native_loss) / abs(native_loss)
        if rel > 1e-2:
            raise AssertionError(f"imported BERT's first loss {first} vs "
                                 f"the native fused model's {native_loss}: "
                                 f"{rel} relative > 1e-2")
        timed = {mode: time_steps(build, x, y, use_graph,
                                  ZOO_PROFILED_STEPS[mode],
                                  groups=KERNEL_GROUPS)
                 for mode, use_graph in (("eager", False),
                                         ("captured", True))}
        prof = {mode: timed[mode].pop("profile") for mode in timed}
        med = timed["captured"]["median_step_ms"]
        log_["train"] = {
            "batch": r["batch"], "seq": r["seq"], "amp": "bf16",
            "optimizer": "SGD(lr=1e-4, momentum=0.9)", "compare": rep_t,
            "native_fused_first_loss": native_loss,
            "first_loss_rel_diff": rel, "baked_constants": extra,
            "eager_ms": timed["eager"]["median_step_ms"],
            "captured_ms": med,
            "step_ms": {mode: timed[mode]["step_ms"] for mode in timed},
            "samples_per_s": r["batch"] / med * 1e3,
            "device_ms": {mode: prof[mode]["device_ms_per_step"]
                          for mode in prof},
            "busy_share": {mode: prof[mode]["device_busy_share"]
                           for mode in prof},
            "group_ms_per_step": {mode: prof[mode]["group_ms_per_step"]
                                  for mode in prof},
            "profiled_steps": ZOO_PROFILED_STEPS,
            "top_kernels": prof["captured"]["top_kernels"],
            "native_fused_no_dropout": {
                mode: {"median_step_ms": t["median_step_ms"],
                       "device_ms": t["profile"]["device_ms_per_step"],
                       "busy_share": t["profile"]["device_busy_share"],
                       "group_ms_per_step":
                           t["profile"]["group_ms_per_step"]}
                for mode, t in native_timed.items()},
            "seconds": time.perf_counter() - t0}
    finally:
        amp.enable(False)
    del loaded_t
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the repo's foreign ONNX files on the card
    fdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "fixtures")
    fixtures = {}
    for name, rtol, atol in ONNX_FIXTURES:
        with open(os.path.join(fdir, f"foreign_{name}.onnx"), "rb") as f:
            blob = f.read()
        io = np.load(os.path.join(fdir, f"foreign_{name}_io.npz"))
        (out,) = sonnx.prepare(blob, dev).run(
            [tensor.from_numpy(io["x"], dev)])
        got = tensor.to_numpy(out)
        fixtures[name] = float(np.abs(got - io["y"]).max())
        if got.shape != io["y"].shape or not np.allclose(
                got, io["y"], rtol=rtol, atol=atol):
            raise AssertionError(f"foreign ONNX fixture {name}: max abs "
                                 f"error {fixtures[name]} (rtol {rtol}, "
                                 f"atol {atol})")
    log_["foreign_fixtures_max_abs_err"] = fixtures
    shutil.rmtree(ONNX_DIR, ignore_errors=True)  # 1.6 GB of exports
    log_["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    log_["seconds"] = time.perf_counter() - t_phase
    log(log_)


# ---------------------------------------------------------------- charrnn

#: bench_charrnn's configuration: batch 64 x 100 one-hot characters,
#: vocab 100, hidden 256, 2 LSTM layers, SGD(0.1), float32
CHARRNN_RUN = dict(batch=64, seq=100, vocab=100, hidden=256, layers=2,
                   steps=3, n_batches=10, lr=0.1)


def cudnn_lstm_ms(m, x):
    """The yardstick: cuDNN's LSTM (``torch._VF.lstm``) over the model's
    own packed weight (``RNNHandle``'s slices viewed in cuDNN's order,
    which is the same: W_ih, W_hh, b_ih, b_hh, gates i, f, g, o), forward
    and backward on the same input; the largest difference of its
    output from the port's LSTM.  The port never calls it."""
    rnn = m.lstm
    h = rnn.handle
    flat = rnn.W.detach().clone().requires_grad_(True)
    weights = [h.unpack(flat, l, 0)[n] for l in range(h.num_layers)
               for n in ("w_ih", "w_hh", "b_ih", "b_hh")]
    zeros = torch.zeros(h.num_layers, x.shape[0], h.hidden_size,
                        device=x.device)

    def run():
        return torch._VF.lstm(x, (zeros, zeros), weights, True,
                              h.num_layers, 0.0, True, False, True)[0]

    def fwd_bwd():
        torch.autograd.grad(run().sum(), flat)

    with torch.no_grad():
        ours = rnn(x)[0]
        err = (run() - ours).abs().max().item()
    return {"fwd_bwd_ms": cuda_time_ms(fwd_bwd, 10),
            "max_abs_diff_vs_port": err}


def phase_charrnn(seed=0):
    """The char-RNN at ``bench_charrnn``'s configuration
    (``CHARRNN_RUN``): eager against graph mode from one state within
    ``CAPTURE_RTOL["float32"]``, host ms a step of both modes, device ms
    and busy share (profiled); then ``train_n_batches`` over
    ``n_batches`` stacked batches (one replay each), its losses finite;
    and cuDNN's LSTM on the same weights as a yardstick."""
    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.char_rnn import CharRNN, one_hot

    amp.enable(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = device.create_cuda_gpu()
    r = CHARRNN_RUN
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, r["vocab"], (r["n_batches"], r["batch"], r["seq"]))
    xs = tensor.from_numpy(one_hot(ids.reshape(-1, r["seq"]), r["vocab"])
                           .reshape(*ids.shape, r["vocab"]), dev)
    ys = tensor.from_numpy(np.roll(ids, -1, axis=2).astype(np.int32), dev)
    x, y = xs[0], ys[0]

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = CharRNN(r["vocab"], r["hidden"], r["layers"], r["seq"])
        m.set_optimizer(opt.SGD(lr=r["lr"]))
        m.compile([x], is_train=True, use_graph=use_graph)
        return m

    t0 = time.perf_counter()
    m, rep = train_eager_and_captured(
        build, x, y, r["steps"], CAPTURE_RTOL["float32"],
        {"eager": {}, "captured": {}})
    prof = {mode: rep[mode].pop("profile") for mode in ("eager", "captured")}
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, losses = m.train_n_batches(xs, ys)
    losses = losses.float().cpu()
    n_ms = (time.perf_counter() - t) * 1e3 / r["n_batches"]
    if losses.shape != (r["n_batches"],) or \
            not torch.isfinite(losses).all():
        raise AssertionError(f"train_n_batches losses: {losses}")
    med = rep["captured"]["median_step_ms"]
    log({"phase": "charrnn", **{k: v for k, v in r.items()},
         "params": sum(p.numel() for p in m.get_params().values()),
         "amp": "float32", "optimizer": f"SGD(lr={r['lr']})", **rep,
         "eager_ms": rep["eager"]["median_step_ms"], "captured_ms": med,
         "samples_per_s": r["batch"] / med * 1e3,
         "device_ms": {mode: prof[mode]["device_ms_per_step"]
                       for mode in prof},
         "busy_share": {mode: prof[mode]["device_busy_share"]
                        for mode in prof},
         "top_kernels": prof["captured"]["top_kernels"],
         "train_n_batches": {"losses": losses.tolist(),
                             "host_ms_per_step": n_ms},
         "cudnn_lstm_yardstick": cudnn_lstm_ms(m, x),
         "seconds": time.perf_counter() - t0, "nvidia_smi": nvidia_smi()})


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
    """ResNet-50 training at ``bench_resnet50``'s configuration, graph mode
    (cuDNN convolutions and the plain-torch batch norm captured), against
    eager steps from the same state; returns the graph-mode model (amp
    still on) and its input batch.  The eager run's profile gives the
    breakdown by group (a replay records no CPU ranges, so the batch
    norm's autograd nodes are found only there)."""
    from singa_tpu_torch import amp, device, opt, tensor
    from singa_tpu_torch.models.resnet import resnet50

    sh = RESNET_SHAPE
    dev = device.create_cuda_gpu()
    amp.enable()
    rng = np.random.RandomState(seed)
    images = rng.randn(sh["batch"], 3, sh["hw"], sh["hw"]).astype(np.float32)
    labels = rng.randint(0, sh["classes"], sh["batch"]).astype(np.int32)
    x, y = tensor.from_numpy(images, dev), tensor.from_numpy(labels, dev)
    compile_s = {}

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = resnet50(num_classes=sh["classes"])
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
        t0 = time.perf_counter()
        m.compile([x], is_train=True, use_graph=use_graph)
        torch.cuda.synchronize()
        compile_s["captured" if use_graph else "eager"] = \
            time.perf_counter() - t0
        return m

    torch.cuda.reset_peak_memory_stats()
    m, report = train_eager_and_captured(
        build, x, y, steps, CAPTURE_RTOL["bf16"],
        {"eager": dict(groups=RESNET_GROUPS, ranges=BN_RANGES),
         "captured": dict(groups=RESNET_GROUPS)})
    stats = {k: v for k, v in m.get_states().items()
             if k.endswith(("running_mean", "running_var"))}
    bad = [k for k, v in stats.items() if not torch.isfinite(v).all()]
    if bad:
        raise AssertionError(f"non-finite running statistics: {bad[:5]}")
    if not any(v.abs().max().item() > 0 for k, v in stats.items()
               if k.endswith("running_mean")):
        raise AssertionError("no running mean moved during training")
    profiles = {mode: report[mode].pop("profile")
                for mode in ("eager", "captured")}
    med = report["captured"]["median_step_ms"]
    log({"phase": "resnet", "model": "resnet50", "params": sum(
        p.numel() for p in m.get_params().values()),
        "running_stat_buffers": len(stats), **sh, "amp": "bf16",
        "optimizer": "SGD(lr=0.1, momentum=0.9)", "use_graph": True,
        "compile_s": compile_s, **report, "median_step_ms": med,
        "images_per_s": sh["batch"] / med * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    log(dict(phase="resnet_profile", **profiles["eager"],
             captured=profiles["captured"]))
    return m, x


# -------------------------------------------------------------------- zoo

ZOO_BATCH = 32
ZOO_SEED = 0
#: (name, module of singa_tpu_torch.models, factory, kwargs, input
#: (C, H, W), classes): the published widths and input sizes
ZOO_MODELS = (
    ("cnn", "cnn", "CNN", {}, (1, 28, 28), 10),
    ("alexnet", "alexnet", "AlexNet", {}, (3, 224, 224), 1000),
    ("vgg16", "vgg", "vgg16", {}, (3, 224, 224), 1000),
    ("mobilenet_v2", "mobilenet", "mobilenet_v2", {}, (3, 224, 224), 1000),
    ("xception", "xceptionnet", "Xception", {}, (3, 299, 299), 1000),
    ("unet", "unet", "UNet", dict(num_classes=2, base_channels=16,
                                  depth=3), (3, 256, 256), 2),
)
#: ``examples/cnn/train_cnn.py``'s optimizer for the zoo (its defaults):
#: ``bench_resnet50``'s SGD(0.1, 0.9) drives AlexNet's and VGG's losses
#: past 1e7 and MobileNetV2's to NaN within three steps (a CPU run at
#: small sizes), as those nets have no batch norm or a thin one
ZOO_SGD = dict(lr=0.005, momentum=0.9, weight_decay=1e-5)
ZOO_GROUPS = RESNET_GROUPS
#: steps of each mode the eager ≡ captured comparison takes (the captured
#: mode's first call runs eagerly, its second captures); steps each
#: mode is then timed over, and profiled over, on a fresh model (an
#: eager step's trace takes the profiler seconds to read)
ZOO_COMPARE_STEPS = 3
ZOO_TIMED_STEPS = 20
ZOO_PROFILED_STEPS = {"eager": 3, "captured": 10}
#: where the zoo phase writes its checkpoints (gitignored), under the
#: checkout it runs from
ZOO_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "_scratch", "chip_smoke_ckpt")


def mlp_data(n=400, seed=0):
    """``examples/mlp/train.py``'s data: two gaussian blobs, 2 classes."""
    rng = np.random.RandomState(seed)
    x0 = rng.randn(n // 2, 2).astype(np.float32) + np.array([2, 2],
                                                            np.float32)
    x1 = rng.randn(n // 2, 2).astype(np.float32) + np.array([-2, -2],
                                                            np.float32)
    x = np.concatenate([x0, x1])
    y = np.concatenate([np.zeros(n // 2), np.ones(n // 2)]).astype(np.int32)
    idx = rng.permutation(n)
    return x[idx], y[idx]


def mlp_flow(dev, epochs=10, batch=64):
    """``examples/mlp/train.py``'s ``run --use-graph`` on the port:
    ``MLP(2, 3, 2)``,
    SGD(0.05, momentum 0.9, weight decay 1e-5), compiled on a
    ``tensor.Tensor((batch, 2), dev)`` placeholder, ``epochs`` passes in
    batches of 64, then the eval accuracy on the held-out fifth, which
    the example requires to pass 0.9.  Returns (model, losses,
    accuracy)."""
    from singa_tpu_torch import opt, tensor
    from singa_tpu_torch.models.mlp import MLP

    x_np, y_np = mlp_data()
    n_train = int(0.8 * len(x_np))
    m = MLP(data_size=2, perceptron_size=3, num_classes=2)
    m.set_optimizer(opt.SGD(lr=0.05, momentum=0.9, weight_decay=1e-5))
    m.compile([tensor.Tensor((batch, 2), dev)], is_train=True,
              use_graph=True, sequential=False)
    losses = []
    for _ in range(epochs):
        for i in range(0, n_train - batch + 1, batch):
            _, loss = m(tensor.from_numpy(x_np[i:i + batch], dev),
                        tensor.from_numpy(y_np[i:i + batch], dev))
            losses.append(loss.item())
    m.eval()
    out = m(tensor.from_numpy(x_np[n_train:], dev))
    acc = float((tensor.to_numpy(out).argmax(-1) == y_np[n_train:]).mean())
    if not all(math.isfinite(v) for v in losses) or acc <= 0.9:
        raise AssertionError(f"examples/mlp flow: accuracy {acc}, losses "
                             f"{losses[:3]} ... {losses[-3:]}")
    return m, losses, acc


def zoo_batch(shape, classes, seed, dev, unet=False):
    """A batch of ``ZOO_BATCH`` random images and labels (per pixel for
    the U-Net) from a numpy seed, on ``dev``."""
    from singa_tpu_torch import tensor

    rng = np.random.RandomState(seed)
    images = rng.randn(ZOO_BATCH, *shape).astype(np.float32)
    lab = (ZOO_BATCH, shape[1], shape[2]) if unet else (ZOO_BATCH,)
    labels = rng.randint(0, classes, lab).astype(np.int32)
    return tensor.from_numpy(images, dev), tensor.from_numpy(labels, dev)


def zoo_maker(module, factory, kwargs, x, dev, seed=ZOO_SEED,
                sgd=ZOO_SGD):
    """``build(use_graph)``: the model from a seeded device generator,
    ``SGD(**sgd)``, compiled on ``x``."""
    import importlib

    from singa_tpu_torch import opt

    make = getattr(importlib.import_module(
        f"singa_tpu_torch.models.{module}"), factory)

    def build(use_graph):
        dev.SetRandSeed(seed)
        m = make(**kwargs)
        m.set_optimizer(opt.SGD(**sgd))
        m.compile([x], is_train=True, use_graph=use_graph)
        return m

    return build


def time_steps(build, x, y, use_graph, profiled, timed=ZOO_TIMED_STEPS,
               groups=ZOO_GROUPS):
    """``build(use_graph)`` after two warm-up steps (graph mode: the eager
    call and the capture), cuDNN free to choose its algorithms: the host
    ms of ``timed`` steps, each read to its loss (which synchronizes),
    their median, and ``profile_steps`` over ``profiled`` more."""
    t0 = time.perf_counter()
    m = build(use_graph)
    for _ in range(2):
        m(x, y)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step_ms, losses = [], []
    for _ in range(timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, loss = m(x, y)
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t) * 1e3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss in timed steps: {losses}")
    t2 = time.perf_counter()
    prof = profile_steps(m, x, y, steps=profiled, groups=groups)
    del m
    return {"step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
            "profile": prof, "seconds": {
                "build_and_warm": t1 - t0, "timed": t2 - t1,
                "profiled": time.perf_counter() - t2}}


def _states_equal(a, b):
    """Names of the persistent tensors (states, optimizer state) of two
    models that differ in any bit."""
    pa, pb = a.persistent_tensors(), b.persistent_tensors()
    if set(pa) != set(pb):
        raise AssertionError(f"state names differ: "
                             f"{sorted(set(pa) ^ set(pb))[:5]}")
    return [k for k in pa if not torch.equal(pa[k], pb[k])]


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms inside the block (cuDNN's
    deterministic convolutions, and an embedding's gradient, which BERT's
    all-zero token types and repeated positions would otherwise sum by
    atomics in a varying order): two runs of one step on equal inputs
    then agree to the bit, which a comparison of eager with captured
    steps, or of a reloaded model with the one that saved it, relies on.
    An op without a deterministic version warns and runs as it is."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def checkpoint_check(build, x, y, dev, path, seed=ZOO_SEED):
    """A graph-mode model trains 3 steps (eager, captured, replay), saves
    its states with momentum and aux, and a fresh model and optimizer
    load the zip; the next step of each (the first a replay, the second
    the fresh model's eager first call), from one generator seed, must
    agree bit for bit in the loss and every state.  Then the same with
    ``async_save`` taken between two replays, the file loaded after the
    second.  Deterministic algorithms run meanwhile (``deterministic``),
    so equal inputs give equal bits.  Returns a report; raises on a mismatch."""
    with deterministic():
        m = build(True)
        for _ in range(3):
            m(x, y)
        m.save_states(path, aux_states={"steps": 3})
        fresh = build(True)
        if fresh.load_states(path)["steps"] != 3:
            raise AssertionError("checkpoint: aux states did not load")
        dev.SetRandSeed(seed + 1)
        _, l1 = m(x, y)
        dev.SetRandSeed(seed + 1)
        _, l2 = fresh(x, y)
        differ = _states_equal(m, fresh)
        if l1.item() != l2.item() or differ:
            raise AssertionError(f"reloaded step differs: loss {l2.item()} "
                                 f"against {l1.item()}, states {differ[:5]}")
        del fresh
        handle = m.save_states(path, aux_states={"steps": 4},
                               async_save=True)
        dev.SetRandSeed(seed + 2)
        _, l3 = m(x, y)                      # a replay, right after the save
        handle.wait()
        fresh = build(True)
        if fresh.load_states(path)["steps"] != 4:
            raise AssertionError("async checkpoint: aux states did not load")
        dev.SetRandSeed(seed + 2)
        _, l4 = fresh(x, y)
        differ = _states_equal(m, fresh)
        if l3.item() != l4.item() or differ:
            raise AssertionError(f"step after an async save differs: loss "
                                 f"{l4.item()} against {l3.item()}, states "
                                 f"{differ[:5]}")
        os.remove(path)
        return {"reload_step_bitwise_equal": True,
                "async_save_step_bitwise_equal": True,
                "losses": [l1.item(), l3.item()],
                "tensors": len(m.persistent_tensors())}


def schedule_probe(dev, steps=6, init=0.1, decay_steps=2, rate=0.5):
    """``ExponentialDecay`` read off a captured step: a bias-free
    ``Linear(1)`` whose loss is the sum of its outputs on ones has
    gradient 1 in every weight, so SGD without momentum moves each weight
    by exactly the step's rate; steps 2 onward are replays.  Each step's
    move must be ``init · rate^(step / decay_steps)`` within rtol 1e-5
    (float32 weights of magnitude < 1).  Returns the rates."""
    from singa_tpu_torch import autograd, layer, model, opt, tensor

    class RateProbe(model.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(1, bias=False)

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x):
            loss = autograd.reduce_sum(self.forward(x))
            self.optimizer(loss)
            return loss

    x = tensor.from_numpy(np.ones((1, 8), np.float32), dev)
    m = RateProbe()
    m.set_optimizer(opt.SGD(lr=opt.ExponentialDecay(init, decay_steps,
                                                     rate)))
    m.compile([x], is_train=True, use_graph=True)
    m.set_states({"RateProbe.fc.W": np.zeros((8, 1), np.float32)})
    w = [np.zeros(8)]
    for _ in range(steps):
        m(x)
        w.append(tensor.to_numpy(m.fc.W)[:, 0].astype(np.float64))
    got = [float(np.mean(a - b)) for a, b in zip(w, w[1:])]
    want = [init * rate ** (k / decay_steps) for k in range(steps)]
    if not np.allclose(got, want, rtol=1e-5, atol=0):
        raise AssertionError(f"ExponentialDecay under replay: {got} "
                             f"against {want}")
    return {"rates": got, "formula": want}


def phase_zoo(seed=ZOO_SEED):
    """The CNN zoo at its published widths and input sizes, each trained
    as ``phase_resnet`` trains ResNet-50 (bf16 amp, a batch of 32, with
    ``examples/cnn/train_cnn.py``'s SGD, ``ZOO_SGD``): eager against
    graph mode from one state (the device generator seeded before each,
    so dropout draws the same masks; deterministic algorithms, so equal
    inputs give equal bits), then each mode timed and profiled on a fresh
    model with those algorithms free (``time_steps``); the VGG-16 checkpoint check; the
    MLP at ``examples/mlp/train.py``'s configuration, then that script's
    flow; and the schedule probe."""
    import gc

    from singa_tpu_torch import amp, device, tensor

    dev = device.create_cuda_gpu()
    smi = nvidia_smi()
    prev_amp = amp._compute_dtype
    os.makedirs(ZOO_CKPT_DIR, exist_ok=True)
    report = {}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def run(name, build, x, y, batch, dtype, optimizer):
        t0 = time.perf_counter()
        with deterministic():
            m, rep = train_eager_and_captured(
                build, x, y, ZOO_COMPARE_STEPS, CAPTURE_RTOL[dtype], None,
                before_run=lambda: dev.SetRandSeed(seed + 1))
        params = sum(p.numel() for p in m.get_params().values())
        del m
        free()
        seconds = {"compare": time.perf_counter() - t0}
        timed = {}
        for mode, use_graph in (("eager", False), ("captured", True)):
            timed[mode] = time_steps(build, x, y, use_graph,
                                     ZOO_PROFILED_STEPS[mode])
            free()
        prof = {mode: timed[mode].pop("profile") for mode in timed}
        seconds.update({mode: timed[mode]["seconds"] for mode in timed})
        med = timed["captured"]["median_step_ms"]
        row = {
            "phase": "zoo", "model": name, "params": params,
            "batch": batch, "input": list(x.shape[1:]), "amp": dtype,
            "optimizer": optimizer, "use_graph": True,
            "eager_ms": timed["eager"]["median_step_ms"], "captured_ms": med,
            "step_ms": {mode: timed[mode]["step_ms"] for mode in timed},
            "device_ms": {mode: prof[mode]["device_ms_per_step"]
                          for mode in prof},
            "busy_share": {mode: prof[mode]["device_busy_share"]
                           for mode in prof},
            "profiled_steps": ZOO_PROFILED_STEPS,
            "images_per_s": batch / med * 1e3,
            "losses": {mode: rep[mode]["losses"] for mode in prof},
            "max_loss_rel_diff": rep["max_loss_rel_diff"],
            "max_weight_rel_diff": rep["max_weight_rel_diff"],
            "bitwise_equal": rep["bitwise_equal"],
            "group_ms_per_step": prof["captured"]["group_ms_per_step"],
            "seconds": dict(seconds, total=time.perf_counter() - t0),
            "nvidia_smi": smi}
        log(row)
        report[name] = row

    try:
        amp.enable()
        for name, module, factory, kwargs, shape, classes in ZOO_MODELS:
            x, y = zoo_batch(shape, classes, seed, dev,
                             unet=factory == "UNet")
            build = zoo_maker(module, factory, kwargs, x, dev, seed)
            run(name, build, x, y, ZOO_BATCH, "bf16",
                "SGD(lr=0.005, momentum=0.9, weight_decay=1e-5)")
            if name == "vgg16":
                t0 = time.perf_counter()
                ck = checkpoint_check(build, x, y, dev, os.path.join(
                    ZOO_CKPT_DIR, "vgg16.zip"), seed)
                log({"phase": "zoo_checkpoint", "model": name, **ck,
                     "seconds": time.perf_counter() - t0})
                free()
        # the MLP at examples/mlp/train.py's configuration (float32)
        amp.enable(False)
        x_np, y_np = mlp_data()
        x = tensor.from_numpy(x_np[:64], dev)
        y = tensor.from_numpy(y_np[:64], dev)
        run("mlp", zoo_maker("mlp", "MLP", dict(
            data_size=2, perceptron_size=3, num_classes=2), x, dev, seed,
            sgd=dict(lr=0.05, momentum=0.9, weight_decay=1e-5)), x, y, 64,
            "float32", "SGD(lr=0.05, momentum=0.9, weight_decay=1e-5)")
        t0 = time.perf_counter()
        _, losses, acc = mlp_flow(dev)
        log({"phase": "zoo_mlp_flow", "steps": len(losses),
             "first_loss": losses[0], "last_loss": losses[-1],
             "eval_accuracy": acc, "seconds": time.perf_counter() - t0})
        log({"phase": "zoo_schedule", **schedule_probe(dev)})
    finally:
        amp.set_compute_dtype(prev_amp)
    return report


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


# ------------------------------------------------------------ paged attn

# paged_attn vs paged_attn_plain, allclose(rtol, atol):
#   float32 - both sum in float32, the kernel in 32-key tiles a warp then
#             across warps, the plain version block by block: outputs are
#             convex combinations of N(0, 1) values, and sums of up to
#             1000 terms differ by a few float32 ulps: 2e-5;
#   bf16    - pools, queries and outputs bf16 (2^-8 relative), sums
#             float32 in both: the outputs differ by at most one bf16
#             rounding, 2^-7 of values below 2: 1e-2;
#   float16 - the same with float16's 2^-11 relative rounding: one
#             rounding is 2^-10 of values below 2: 2e-3.
PAGED_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2),
             torch.float16: (2e-3, 2e-3)}
PAGED_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# value of every element of the trash block in the edge cases: a kernel
# that read it unmasked would move outputs by O(10)
PAGED_TRASH_VALUE = 50.0


def paged_inputs(lens, block, d, n_kv, g, nq, dtype, seed, window=None,
                 spare=3, trash_at=(), from_block0=False, quant=False):
    """Kernel arguments for one paged case, made from a numpy seed: slot
    s attends ``lens[s]`` pool lanes (0: a dead slot with an all-trash
    table) through ``ceil(lens[s] / block)`` distinct random blocks, its
    table trash-padded one entry past the longest slot's; ``spare``
    unused blocks; the trash block filled with ``PAGED_TRASH_VALUE``.
    ``trash_at``: (slot, entry) table entries set to the trash block
    below ``lens[slot]`` (lanes the function masks, as the JAX engine's
    dropped out-of-window blocks).  With a ``window``, ``blk_lo`` is the
    first block holding an in-window lane of any live slot, or None
    (read from block 0) with ``from_block0``.  ``quant``: the same draws,
    the pools and current K/V quantized to int8 (values, scales) pairs
    (``gpt2_decode._quantize_kv``, the trash block's values 127 at scale
    50 / 127), q in ``dtype``."""
    rng = np.random.RandomState(seed)
    need = [-(-p // block) for p in lens]
    n_blocks = sum(need) + spare
    width = max(need + [0]) + 1
    ids = rng.permutation(n_blocks)
    tables = np.full((len(lens), width), n_blocks, np.int32)
    at = 0
    for s, n in enumerate(need):
        tables[s, :n] = ids[at:at + n]
        at += n
    for s, j in trash_at:
        tables[s, j] = n_blocks

    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    pool_k, pool_v = (rand(n_blocks + 1, n_kv, block, d) for _ in range(2))
    pool_k[-1] = pool_v[-1] = PAGED_TRASH_VALUE
    q = rand(len(lens), n_kv, g, nq, d)
    k_cur, v_cur = (rand(len(lens), n_kv, nq, d) for _ in range(2))
    live = [p for p in lens if p > 0]
    blk_lo = None
    if window is not None and not from_block0:
        blk_lo = min((max(0, (p - window + 1) // block) for p in live),
                     default=0)
    if quant:
        from singa_tpu_torch.models.gpt2_decode import _quantize_kv

        def on(t):
            return tuple(x.to(DEVICE).contiguous() for x in _quantize_kv(t))
    else:
        def on(t):
            return t.to(DEVICE, dtype).contiguous()
    return dict(
        q=q.to(DEVICE, dtype).contiguous(), pool_k=on(pool_k),
        pool_v=on(pool_v), tables=torch.from_numpy(tables).to(DEVICE),
        p_limit=torch.tensor(lens, dtype=torch.int32, device=DEVICE),
        k_cur=on(k_cur), v_cur=on(v_cur),
        cur_mask=torch.ones(nq, nq, dtype=torch.bool,
                            device=DEVICE).tril(),
        scale=1.0 / math.sqrt(d), window=window, blk_lo=blk_lo)


def paged_edge_cases():
    """(name, kwargs of ``paged_inputs`` but dtype and seed): the edges of
    ``tests/test_paged.py::test_kernel_edge_geometry`` and of the
    kernel's tiles: whole 32-key tiles masked by the window before any
    live lane (the explicit zero of masked probabilities), trash entries
    inside a table.  GPT-2 small's decode is n_kv 12, g 1, Q 1, D 64."""
    base = dict(d=64, n_kv=2, g=1, nq=1)
    cases = [
        ("b1", dict(lens=[5, 1, 9], block=1)),
        ("b8_partial_last_block", dict(lens=[13, 21, 3], block=8)),
        ("b16_pos_on_boundary", dict(lens=[32, 16, 48], block=16)),
        ("b32_tiles", dict(lens=[100, 64, 31], block=32)),
        ("dead_slots_all_trash", dict(lens=[0, 17, 0], block=8)),
        ("one_block_tables", dict(lens=[7, 16, 1], block=16)),
        ("g3_n_kv4", dict(lens=[40, 9], block=8, n_kv=4, g=3)),
        ("d128", dict(lens=[33, 70], block=16, d=128)),
        ("q4_tril", dict(lens=[12, 30], block=8, nq=4)),
        ("g3_q4_d128", dict(lens=[25, 8], block=8, d=128, g=3, nq=4)),
        ("window", dict(lens=[50, 29, 33], block=8, window=20)),
        ("window_q4_g3", dict(lens=[41, 17], block=8, nq=4, g=3,
                              window=10)),
        ("window_from_block0", dict(lens=[150, 90], block=8, window=16,
                                    from_block0=True)),
        ("trash_inside_table", dict(lens=[40, 20], block=8,
                                    trash_at=[(0, 1), (0, 3), (1, 0)])),
        ("long_b32", dict(lens=[1000, 300, 640], block=32)),
        ("long_b1", dict(lens=[200, 130], block=1)),
        # the split plan: a long slot beside short ones (their higher
        # splits empty), a window whose live keys all fall in the last
        # split of each slot (read from block 0)
        ("long_beside_short", dict(lens=[900, 40, 7], block=16)),
        ("window_in_one_split", dict(lens=[700, 650], block=32, window=50,
                                     from_block0=True)),
        # head dims off the 64 / 128 rows: rounded up to 16 / 64 / 128 /
        # 256 with the tail zero-filled; D = 20 in bf16 is 40 bytes a row,
        # so element copies instead of 16-byte ones
        ("d16", dict(lens=[45, 3, 130], block=8, d=16)),
        ("d40_g3", dict(lens=[70, 20], block=16, d=40, g=3)),
        ("d80_q4", dict(lens=[33, 64], block=8, d=80, nq=4)),
        ("d256_g2_q2", dict(lens=[300, 17], block=32, d=256, g=2, nq=2)),
        ("d20_element_loads", dict(lens=[37, 90], block=8, d=20)),
        # rows past 512: the 1024-wide rung (one stage; float32 takes K
        # and V in turns), and GQA groups of more query rows than a launch
        # holds, launched in groups of heads (32 rows at D = 64 in two
        # groups of 16; 6 heads at D = 1024 in groups of 4 and 2)
        ("d640", dict(lens=[70, 33], block=16, d=640)),
        ("d1024_g6", dict(lens=[45, 100], block=8, d=1024, g=6)),
        ("g8_q4_32_rows", dict(lens=[40, 75], block=8, g=8, nq=4)),
        # more query positions than one launch holds (a speculative
        # verify's Q = spec_k): runs of max_rows(D) positions, each
        # launch taking all Q current lanes and its rows of the tril
        # cur_mask (and, under a window, its positions' offset)
        ("q24_tril", dict(lens=[30, 12], block=8, nq=24)),
        ("q40_d256", dict(lens=[50, 20], block=16, d=256, nq=40)),
        ("q24_g2_window", dict(lens=[60, 33], block=8, g=2, nq=24,
                               window=20)),
        # the combine's scores of 16 rows by 800 current lanes pass the
        # 48 KB of shared memory a launch gets without the attribute
        ("q800_combine_past_48kb", dict(lens=[20, 7], block=8, nq=800)),
    ]
    return [(n, {**base, **kw}) for n, kw in cases]


def check_paged_case(name, dtype, seed, quant=False, **kw):
    """The kernel against its plain version on one case (``quant``: int8
    pools, q in ``dtype``): returns max |kernel - plain| and raises past
    ``PAGED_TOL[dtype]``."""
    from singa_tpu_torch.ops import paged_attention as pa

    args = paged_inputs(dtype=dtype, seed=seed, quant=quant, **kw)
    got = pa.paged_attn(**args).float()
    want = pa.paged_attn_plain(**args).float()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: paged_attn gave non-finite values")
    err = (got - want).abs().max().item()
    rtol, atol = PAGED_TOL[dtype]
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: paged_attn differs from its plain "
                             f"version by {err} (rtol {rtol}, atol {atol})")
    return err


def paged_bound_ms(lens, n_kv, g, nq, d, dtype, quant=False):
    """Least time for one call: the live K/V lanes read once, q and the
    current K/V read and the output written once, over memory bandwidth;
    against 4 FLOPs per (query row, live lane, element) over the peak
    rate for q's dtype.  ``quant``: int8 lanes, D bytes and a float32
    scale each.  Returns ``(ms, "bytes" or "operations")``."""
    elem = torch.finfo(dtype).bits // 8
    row = d + 4 if quant else d * elem                # bytes of a K or V lane
    lanes = int(sum(lens))
    s_ = len(lens)
    nbytes = (2 * lanes * n_kv * row                 # live K and V lanes
              + 2 * s_ * n_kv * g * nq * d * elem    # q and the output
              + 2 * s_ * n_kv * nq * row)            # k_cur and v_cur
    flops = 4 * (lanes + s_ * nq) * n_kv * g * nq * d
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def _rotating(calls):
    """One callable that makes the next of ``calls`` each time, in turn:
    timed over the layers of a decode step, each launch reads another
    layer's pool, as the serve step does, and the working set outgrows
    the 50 MB L2 cache."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def sdpa_yardstick(layers):
    """The library yardstick at one decode step's inputs, layer by layer:
    each slot's live blocks gathered into dense (S, H, n_blk * B + B, D)
    rows
    with the current K/V at lane ``p_limit`` (not timed; int8 pools
    dequantized to q's dtype first, not timed either), then
    ``scaled_dot_product_attention`` with a mask of lanes <= ``p_limit``
    (timed alone, over the layers in turn: no one PyTorch call computes
    paged attention).  Returns (device ms of SDPA, its event ms, event ms
    of one layer's gather, max |SDPA - kernel| at the first layer)."""
    import torch.nn.functional as F

    from singa_tpu_torch.models.gpt2_decode import _dequantize_kv
    from singa_tpu_torch.ops import paged_attention as pa

    kernel_out = pa.paged_attn(**layers[0])
    if isinstance(layers[0]["pool_k"], tuple):
        # int8 pools: SDPA reads them dequantized to q's dtype (not timed)
        layers = [dict(a, **{k: _dequantize_kv(*a[k], a["q"].dtype)
                             for k in ("pool_k", "pool_v", "k_cur",
                                       "v_cur")}) for a in layers]
    a0 = layers[0]
    q = a0["q"]
    s_, n_kv, g, nq, d = q.shape
    block = a0["pool_k"].shape[2]
    n_blk = max(-(-p // block) for p in a0["p_limit"].tolist())
    width = (n_blk + 1) * block
    tbl = torch.cat([a0["tables"][:, :n_blk].long(),
                     torch.full((s_, 1), a0["pool_k"].shape[0] - 1,
                                device=q.device)], 1)
    lanes = torch.arange(s_, device=q.device)
    pos = a0["p_limit"].long()
    mask = (torch.arange(width, device=q.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    qq = q.reshape(s_, n_kv * g, nq, d)

    def gather(a):
        def row(pool, cur):
            r = pool[tbl].permute(0, 2, 1, 3, 4)       # (S, H, nb, B, D)
            r = r.reshape(s_, n_kv, width, d).clone()
            r[lanes, :, pos] = cur[:, :, 0]
            return r.repeat_interleave(g, 1) if g > 1 else r
        return row(a["pool_k"], a["k_cur"]), row(a["pool_v"], a["v_cur"])

    gather_ms = cuda_time_ms(lambda: gather(a0), 10)
    rows = [gather(a) for a in layers]
    calls = [lambda kk=kk, vv=vv: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask) for kk, vv in rows]
    err = (calls[0]().float().reshape(q.shape)
           - kernel_out.float()).abs().max().item()
    sdpa = _rotating(calls)
    return (device_ms_per_call(sdpa, 4 * len(calls)),
            cuda_time_ms(sdpa, 4 * len(calls)), gather_ms, err)


def time_paged_table(layers):
    """Times of ``paged_attn`` at one table over its layers' pools in turn
    (device time: the split and combine kernels summed), on the first
    layer alone (its K/V then stays in L2), of its plain version and of
    the SDPA yardstick, beside the bound; and the kernel's largest
    difference from its plain version there (raises past
    ``PAGED_TOL``)."""
    from singa_tpu_torch.ops import paged_attention as pa

    args = layers[0]
    got = pa.paged_attn(**args)
    want = pa.paged_attn_plain(**args)
    err = (got.float() - want.float()).abs().max().item()
    rtol, atol = PAGED_TOL[args["q"].dtype]
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"paged_attn at a timed table differs from its "
                             f"plain version by {err}")
    n = len(layers)
    kernel = _rotating([functools.partial(pa.paged_attn, **a)
                        for a in layers])
    plain = _rotating([functools.partial(pa.paged_attn_plain, **a)
                       for a in layers])
    sdpa_ms, sdpa_events_ms, gather_ms, sdpa_err = sdpa_yardstick(layers)
    s_, n_kv, g, nq, d = args["q"].shape
    lens = args["p_limit"].tolist()
    quant = isinstance(args["pool_k"], tuple)
    bound, by = paged_bound_ms(lens, n_kv, g, nq, d, args["q"].dtype, quant)
    pool = pa._values(args["pool_k"])
    block = pool.shape[2]
    by_kernel = device_ms_by_kernel(kernel, 4 * n)
    return dict(
        slots=s_, p_limit=lens, table_width=args["tables"].shape[1],
        block=block, layers=n, dtype=str(args["q"].dtype)[6:],
        pool_dtype=str(pool.dtype)[6:],
        n_split=pa.split_count(d, pool.dtype, args["tables"].shape[1],
                               0, block, s_ * n_kv,
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count),
        kernel_device_ms_by_name={k[:60]: v for k, v in by_kernel.items()},
        device_ms={"kernel": sum(by_kernel.values()),
                   "kernel_one_layer_l2_hot": device_ms_per_call(
                       lambda: pa.paged_attn(**args), 4 * n),
                   "plain": device_ms_per_call(plain, n),
                   "sdpa_alone": sdpa_ms, "bound": bound},
        bound_by=by,
        event_ms={"kernel": cuda_time_ms(kernel, 4 * n),
                  "plain": cuda_time_ms(plain, n),
                  "sdpa_alone": sdpa_events_ms,
                  "gather_for_sdpa": gather_ms},
        max_abs_err_vs_plain=err, sdpa_max_abs_diff_vs_kernel=sdpa_err)


#: the few-long-slots table: two slots of 1000 lanes, where a grid of one
#: block a (kv head, slot) would be 24 blocks
LONG_TABLE_LENS = (1000, 1000)


def phase_paged_kernels(real, real8, cfg):
    """``paged_attn`` against its plain version at every edge case in
    float32, bf16 and float16, and on int8 pools with float32, bf16 and
    float16 q (their split counts logged: some take one split of the key
    range, some several), then timed at tables for GPT-2 small's 12
    layers: one decode step of the serve phase (``real``: its tables and
    positions) with bf16 pools, as row 5c with int8 pools and bf16 q,
    with float16 pools (the ``paged_attn_f16`` row; its launches are the
    serve phase's float16 run's) and with int8 pools and float16 q; and
    ``LONG_TABLE_LENS`` with bf16 pools.  The times in the kernels line
    are the serve step's device times (``device_ms_per_call``): the
    wrapper's launch overhead exceeds the kernels' time, so CUDA events
    around back-to-back calls would time the host (logged too, as
    ``event_ms``).  ``real8``: the int8 kernels' launches on the
    ``serve_int8`` main path.  Returns the kernels line's two rows."""
    from singa_tpu_torch.ops import paged_attention as pa

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    worst, splits = {}, {}
    for quant, dtype in itertools.product((False, True), PAGED_DTYPES):
        key = ("int8/" if quant else "") + str(dtype)[6:]
        for seed, (name, kw) in enumerate(paged_edge_cases()):
            e = check_paged_case(f"{name}/{key}", dtype, seed, quant, **kw)
            worst[key] = max(worst.get(key, 0.0), e)
            a = paged_inputs(dtype=dtype, seed=seed, quant=quant, **kw)
            s_, n_kv, _, _, d = a["q"].shape
            pool = pa._values(a["pool_k"])
            splits[f"{name}/{key}"] = pa.split_count(
                d, pool.dtype, a["tables"].shape[1], a["blk_lo"],
                pool.shape[2], s_ * n_kv, n_sm)
    if not {1} < set(splits.values()):
        raise AssertionError(f"the edge cases should take both one split "
                             f"and several: {splits}")
    serve = time_paged_table(real["layers"])
    serve8 = time_paged_table(real_args(real, cfg, seed=2, quant=True))
    serve_h = time_paged_table(real_args(real, cfg, seed=3,
                                         dtype=torch.float16))
    serve8_h = time_paged_table(real_args(real, cfg, seed=4, quant=True,
                                          dtype=torch.float16))
    long = time_paged_table(paged_table(LONG_TABLE_LENS, cfg, seed=1))
    log({"phase": "paged_kernels",
         "edge_cases": 2 * len(PAGED_DTYPES) * len(paged_edge_cases()),
         "edge_max_abs_err": worst, "edge_n_split": splits,
         "tol": {str(k)[6:]: v for k, v in PAGED_TOL.items()},
         "tol_int8": "PAGED_TOL of q's dtype",
         "serve_table": dict(serve, step=real["step"]),
         "serve_table_int8_row_5c": dict(serve8, step=real["step"]),
         "serve_table_float16": dict(serve_h, step=real["step"]),
         "serve_table_int8_float16_q": dict(serve8_h, step=real["step"]),
         "long_table": long})

    def row(name, t, launches, kernels):
        ms = t["device_ms"]
        return dict(
            name=name, route="cuda",
            source="singa_tpu_torch/csrc/paged_attention.cu",
            replaces=REPLACES[name.removesuffix("_f16")], launches=launches,
            max_abs_err=t["max_abs_err_vs_plain"], ms=ms["kernel"],
            plain_ms=ms["plain"], bound_ms=ms["bound"],
            bound_by=t["bound_by"], library_ms=ms["sdpa_alone"],
            library_call="torch.nn.functional.scaled_dot_product_attention"
                         " on rows gathered from the pool (the gather not "
                         "timed: no one PyTorch call computes paged "
                         "attention)" + ("; int8 pools dequantized first, "
                                         "not timed" if "int8" in name
                                         else ""),
            kernels=kernels)

    return [row("paged_attn", serve, real["launches"],
                "paged_attn_kernel<T, T> (split) + paged_combine_kernel<T, "
                "T>, T float or bf16"),
            row("paged_attn_int8", serve8, real8["launches"],
                "paged_attn_kernel<T, int8> (split) + "
                "paged_combine_kernel<T, int8>, T float or bf16 (the int8 "
                "branch)"),
            row("paged_attn_f16", serve_h, real["launches_f16"],
                "paged_attn_kernel<__half, __half> (split) + "
                "paged_combine_kernel<__half, __half>")]


# ------------------------------------------------------------------ serve

SERVE_REQUESTS = 24
SERVE_ENGINE = dict(max_slots=8, block_size=32, num_blocks=256)
# per-step logits of the bf16 engine, paged kernel against the gather
# oracle on the same pool: the two attention outputs differ in float32
# summation order only, so a few of them round to the other bf16
# neighbour (2^-8 of themselves); 12 layers of bf16 activations carry
# that to logits of magnitude O(1) (GPT-2 small, random weights, std
# 0.02).  Streams are compared up to the first step whose top-2 margin
# (of the logits a token is chosen from) is below this.
SERVE_BF16_LOGITS_ATOL = 0.05


def serve_traffic(seed=0, n=SERVE_REQUESTS, vocab=50257):
    """The serve phase's requests: prompts of 16-512 random tokens,
    ``max_new_tokens`` 32-128, alternately greedy and at temperature 0.9,
    each with its own seed."""
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, vocab, rng.randint(16, 513))
                 .astype(np.int32),
                 max_new=int(rng.randint(32, 129)),
                 temperature=0.0 if i % 2 == 0 else 0.9,
                 seed=int(rng.randint(0, 2 ** 31 - 1))) for i in range(n)]


def drain_counting_graphs(eng, max_steps=5000):
    """Drive ``eng`` until it drains; raise unless the serve census
    (``jit_cache_size``) only grows by the engine's own captures, at most
    one per decode-width bucket, and stays flat once every width in use
    has been captured.  Returns ``{"buckets", "census_at_end",
    "census_changes": [(step, census), ...]}``."""
    from singa_tpu_torch.serve import jit_cache_size

    buckets, w = set(), eng.max_slots
    while w >= 1:
        buckets.add(w)
        w //= 2
    base = jit_cache_size() - len(eng._steps)
    changes, last = [], None
    for step in range(max_steps):
        if not eng.pending:
            break
        eng.step()
        census = jit_cache_size() - base
        if census != len(eng._steps) or census > len(buckets) \
                or not set(eng._steps) <= buckets:
            raise AssertionError(f"serve census {census} at step {step}: "
                                 f"captured widths {sorted(eng._steps)}")
        if census != last:
            changes.append((step, census))
            last = census
    else:
        raise AssertionError(f"engine did not drain in {max_steps} steps")
    return {"buckets": sorted(buckets), "census_at_end": last,
            "census_changes": changes}


def run_engine(model, traffic, kernel, dtype=None, trace=False,
               wrap=None, capture=True, cache_dtype=None):
    """Submit ``traffic`` at once to ``model.serve`` with the serve
    phase's engine (its decode steps captured unless ``capture`` is
    False; ``kernel`` None: the slot arena, ``model.serve`` without
    ``paged=``, at ``max_slots`` and ``max_len`` 1024), drain it, and
    check what a drain must leave: every request completed by its length,
    no rejection, no block in use, the serve census flat
    (``drain_counting_graphs``; the slot arena: exactly one graph).
    ``wrap(engine)`` may replace the engine's executor.  Returns
    ``(streams, engine stats snapshot with the census under "graphs",
    seconds, decode-step seconds)``."""
    from singa_tpu_torch.observe import trace as tr
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    c = SERVE_ENGINE
    paged = None if kernel is None else PagedConfig(
        block_size=c["block_size"], num_blocks=c["num_blocks"],
        kernel=kernel)
    eng = model.serve(max_slots=c["max_slots"], dtype=dtype, paged=paged,
                      capture=capture, cache_dtype=cache_dtype)
    if wrap is not None:
        eng._x = wrap(eng)
    if trace:
        tr.drain()
        tr.enable()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["max_new"],
        temperature=w["temperature"], seed=w["seed"], request_id=f"r{i}"))
        for i, w in enumerate(traffic)]
    graphs = drain_counting_graphs(eng)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    decode_s = None
    if trace:
        tr.disable()
        spans = tr.drain()
        decode_s = sum(e["dur"] for e in spans
                       if e["name"] == "serve/decode_step")
        prefill_s = sum(e["dur"] for e in spans
                        if e["name"] == "serve/prefill")
    results = [h.result() for h in hs]
    snap = dict(eng.stats.snapshot(), graphs=graphs)
    if trace:
        snap["prefill_seconds"] = prefill_s
    if kernel is None:
        if capture and graphs["census_at_end"] != 1:
            raise AssertionError(f"the slot arena holds {graphs} graphs, "
                                 f"not one")
    elif eng.paged_arena.blocks_used != 0:
        raise AssertionError(f"{eng.paged_arena.blocks_used} blocks in use "
                             f"after the drain")
    eng.check_block_accounting()
    req = snap["requests"]
    if (req["completed"] != len(traffic) or req["rejected_deadline"]
            or req["rejected_queue_full"]
            or any(r.finish_reason != "length" for r in results)):
        raise AssertionError(f"not every request completed cleanly: {req}")
    streams = [r.tokens for r in results]
    for w, s in zip(traffic, streams):
        if len(s) != len(w["prompt"]) + w["max_new"] \
                or s.min() < 0 or s.max() >= model.cfg.vocab_size:
            raise AssertionError(f"bad stream of length {len(s)}")
    eng.close()
    return streams, snap, seconds, decode_s


def offline_streams(model, traffic, cache_dtype=None):
    """Offline ``generate`` of the traffic, float32: the greedy requests
    in one batch, the sampled ones in another with their seeds, each
    batch to its longest ``max_new_tokens`` and then cut to each
    request's (a stream's prefix does not depend on its length);
    ``cache_dtype="int8"``: on int8 caches."""
    out = [None] * len(traffic)
    for greedy in (True, False):
        idx = [i for i, w in enumerate(traffic)
               if (w["temperature"] <= 0) == greedy]
        n_new = max(traffic[i]["max_new"] for i in idx)
        rows = model.generate(
            [traffic[i]["prompt"] for i in idx], max_new_tokens=n_new,
            temperature=0.0 if greedy else traffic[idx[0]]["temperature"],
            seed=[traffic[i]["seed"] for i in idx], cache_dtype=cache_dtype)
        for i, r in zip(idx, rows):
            out[i] = r[:len(traffic[i]["prompt"]) + traffic[i]["max_new"]]
    return out


class _LogitsProbe:
    """Executor for the bf16 logits check, on an engine that runs its
    decode steps eagerly (``capture=False``: the probe reads the device
    on the host): each decode step runs the gather oracle on a copy of
    the pools, then the paged kernel on the pools themselves, and records,
    per live request, the largest logit difference and the top-2 margin of
    the oracle's logits as the sampler sees them (tempered plus the
    request's noise when sampled).  Keeps one step's tables and positions
    (the step with the most live lanes) as the paged kernel's real serve
    shapes."""

    def __init__(self, eng):
        self.eng = eng
        self.inner = eng._x
        self.max_err = 0.0
        self.first_low = {}     # request id -> first low-margin token index
        self.real = None

    def prefill_batch(self, params, ids):
        return self.inner.prefill_batch(params, ids)

    def paged_decode_step(self, params, pool_k, pool_v, inp, block,
                          kernel="block", n_rb=None):
        from singa_tpu_torch.models import gpt2_decode as gd

        eng = self.eng
        lanes = [i for i, s in enumerate(eng._slots) if s is not None]
        n = len(lanes)
        pos = inp["pos"][:n].cpu().numpy()
        want = self.inner.paged_decode_step(
            params, pool_k.clone(), pool_v.clone(), inp, block,
            kernel="gather", n_rb=int(pos.max()) // block + 1)
        if self.real is None or n > len(self.real["p_limit"]) or (
                n == len(self.real["p_limit"])
                and pos.sum() > sum(self.real["p_limit"])):
            self.real = dict(tables=inp["tables"][:n].cpu().numpy(),
                             p_limit=pos.astype(np.int32).tolist(),
                             step=eng.step_count)
        got = self.inner.paged_decode_step(params, pool_k, pool_v, inp,
                                           block)
        g, w = got[:n].float(), want[:n].float()
        self.max_err = max(self.max_err, (g - w).abs().max().item())
        dev = w.device
        for r, i in enumerate(lanes):
            row = w[r]
            if eng._temps[i] > 0:
                row = gd._filter_logits(row[None], float(eng._temps[i]),
                                        eng._top_p, eng._top_k)[0]
                row = row + gd._gumbel(
                    torch.tensor([int(eng._seeds[i])], device=dev),
                    torch.tensor([int(eng._pos[i]) + 1], device=dev),
                    row.shape[0])[0]
            top2 = torch.topk(row, 2).values
            rid = eng._slots[i].handle.request.request_id
            if (top2[0] - top2[1]).item() < SERVE_BF16_LOGITS_ATOL \
                    and rid not in self.first_low:
                self.first_low[rid] = len(eng._slots[i].emitted)
        return got


def phase_serve(seed=0):
    """GPT-2 small (124M, 12 layers, n_positions 1024, random weights from
    a seed) served by the paged engine: 24 requests at once, float32 and
    bf16, then the pressured engine and the tiny one (module docstring).
    Returns the model and, for the kernel phase, the paged kernel's
    launches on the timed bf16 run and the real tables it times."""
    from singa_tpu_torch import amp, device, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.ops import paged_attention as pa

    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    amp.enable(False)
    dev = device.create_cuda_gpu()
    dev.SetRandSeed(seed)
    cfg = GPT2Config.small(dropout=0.0)
    model = GPT2LMHead(cfg)
    model.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), dev)],
                  is_train=False)
    traffic = serve_traffic(seed, vocab=cfg.vocab_size)
    mark("model")

    # float32: captured == eager == gather == offline generate, launches
    pa.paged_attn.launches = 0
    block32, snap32, sec32, _ = run_engine(model, traffic, "block")
    launches32 = pa.paged_attn.launches
    mark("float32_captured")
    steps32 = snap32["throughput"]["decode_steps"]
    eager32, _, eager_sec32, _ = run_engine(model, traffic, "block",
                                            capture=False)
    mark("float32_eager")
    gather32, _, _, _ = run_engine(model, traffic, "gather")
    mark("float32_gather")
    offline = offline_streams(model, traffic)
    mark("float32_generate")
    for i, (a, e, b, c) in enumerate(zip(block32, eager32, gather32,
                                         offline)):
        if not np.array_equal(a, e):
            raise AssertionError(f"float32 request {i}: the captured "
                                 f"engine's stream differs from the eager "
                                 f"engine's")
        if not np.array_equal(a, b):
            raise AssertionError(f"float32 request {i}: the paged kernel's "
                                 f"stream differs from the gather oracle's")
        if not np.array_equal(a, c):
            raise AssertionError(f"float32 request {i}: the engine's stream "
                                 f"differs from offline generate")
    if launches32 != cfg.n_layer * steps32:
        raise AssertionError(f"paged_attn launched {launches32} times over "
                             f"{steps32} decode steps, expected "
                             f"{cfg.n_layer} a step")
    pressured = serve_pressured(model, pressure_traffic(
        seed, vocab=cfg.vocab_size))
    mark("float32_pressured")
    tiny = serve_tiny(dev, seed)
    mark("float32_tiny_d16")

    # bf16: the timed main path (captured) against the same traffic with
    # eager steps, profiled runs of both, the logits check
    bf = torch.bfloat16
    pa.paged_attn.launches = 0
    block16, snap16, sec16, decode_s = run_engine(model, traffic, "block",
                                                  dtype=bf, trace=True)
    launches16 = pa.paged_attn.launches
    mark("bf16_captured")
    steps16 = snap16["throughput"]["decode_steps"]
    if launches16 != cfg.n_layer * steps16:
        raise AssertionError(f"bf16: paged_attn launched {launches16} times "
                             f"over {steps16} decode steps")
    eager16, esnap16, esec16, edecode_s = run_engine(
        model, traffic, "block", dtype=bf, trace=True, capture=False)
    mark("bf16_eager")
    profile = profile_serve(model, traffic, bf)
    profile_eager = profile_serve(model, traffic, bf, capture=False)
    mark("bf16_profiles")
    probes = []
    probed, _, _, _ = run_engine(
        model, traffic, "block", dtype=bf, capture=False,
        wrap=lambda e: probes.append(_LogitsProbe(e)) or probes[-1])
    probe = probes[0]
    mark("bf16_logits_probe")
    if probe.max_err > SERVE_BF16_LOGITS_ATOL:
        raise AssertionError(f"bf16 logits, paged kernel vs gather oracle: "
                             f"{probe.max_err} > {SERVE_BF16_LOGITS_ATOL}")
    gather16, _, _, _ = run_engine(model, traffic, "gather", dtype=bf)
    mark("bf16_gather")
    # float16: the same traffic captured, paged_attn on float16 pools and
    # q (the kernels line's paged_attn_f16 row)
    pa.paged_attn.launches = 0
    _, snap_h, sec_h, _ = run_engine(model, traffic, "block",
                                     dtype=torch.float16)
    launches_h = pa.paged_attn.launches
    mark("float16_captured")
    steps_h = snap_h["throughput"]["decode_steps"]
    if launches_h != cfg.n_layer * steps_h:
        raise AssertionError(f"float16: paged_attn launched {launches_h} "
                             f"times over {steps_h} decode steps")
    compared = {}
    for i, (w, a, e, b, c) in enumerate(zip(traffic, block16, eager16,
                                            probed, gather16)):
        plen = len(w["prompt"])
        if not (np.array_equal(a, b) and np.array_equal(a, e)):
            raise AssertionError(f"bf16 request {i}: the captured and eager "
                                 f"paged engines gave different streams")
        upto = probe.first_low.get(f"r{i}", w["max_new"])
        compared[i] = upto
        if not np.array_equal(a[:plen + upto], c[:plen + upto]):
            raise AssertionError(
                f"bf16 request {i}: paged and gather streams differ before "
                f"token {upto}, the first whose top-2 margin is under "
                f"{SERVE_BF16_LOGITS_ATOL}")
    real = probe.real

    log({"phase": "serve", "model": "gpt2-small",
         "params": sum(p.numel() for p in model.parameters()),
         "engine": SERVE_ENGINE, "requests": len(traffic),
         "prompt_lens": [len(w["prompt"]) for w in traffic],
         "max_new_tokens": [w["max_new"] for w in traffic],
         "float32": {"decode_steps": steps32, "paged_attn_launches":
                     launches32, "seconds": sec32,
                     "eager_seconds": eager_sec32,
                     "graphs": snap32["graphs"],
                     "streams_equal_eager_gather_and_generate": True},
         "float32_pressured": dict(
             PRESSURE_ENGINE, requests=12, paged=pressured,
             streams_equal_generate=True),
         "float32_tiny": dict(tiny, streams_equal_generate=True),
         "bf16": {"decode_steps": steps16, "paged_attn_launches": launches16,
                  **serve_timing(snap16, sec16, decode_s, len(traffic)),
                  "eager": serve_timing(esnap16, esec16, edecode_s,
                                        len(traffic)),
                  "graphs": snap16["graphs"],
                  "streams_equal_eager": True,
                  "logits_max_abs_diff_kernel_vs_gather": probe.max_err,
                  "logits_atol": SERVE_BF16_LOGITS_ATOL,
                  "streams_compared_up_to_token": compared,
                  "low_margin_requests": len(probe.first_low)},
         "float16": {"decode_steps": steps_h,
                     "paged_attn_launches": launches_h, "seconds": sec_h,
                     "graphs": snap_h["graphs"]},
         "profile_bf16_run": profile,
         "profile_bf16_eager_run": profile_eager,
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
         "nvidia_smi": nvidia_smi()})
    return model, dict(launches=launches16, launches_f16=launches_h,
                       step=real["step"],
                       tables=real["tables"], p_limit=real["p_limit"],
                       layers=real_args(real, model.cfg, seed),
                       traffic=traffic, offline=offline,
                       bf16=dict(serve_timing(snap16, sec16, decode_s,
                                              len(traffic)),
                                 busy_share=profile["device_busy_share"]))


def serve_timing(snap, sec, dec_s, n_requests):
    """The timed figures of one drained engine: wall seconds, TTFT and
    TPOT medians, tokens/s over the drain and decode tokens/s over the
    decode steps' traced seconds (every token but each request's first,
    which its prefill samples)."""
    lat = snap["latency"]
    decode_tokens = snap["throughput"]["tokens_out"] - n_requests
    return {"seconds": sec, "ttft_median_s": lat["ttft"]["p50"],
            "tpot_median_s": lat["tpot"]["p50"],
            "tokens_per_s": snap["throughput"]["tokens_per_s"],
            "decode_tokens_per_s": decode_tokens / dec_s,
            "decode_step_seconds": dec_s,
            "prefill_seconds": snap["prefill_seconds"]}


def _same_streams(what, got, want):
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if not np.array_equal(a, b):
            raise AssertionError(f"request {i}: {what}")


def phase_serve_int8(model, real):
    """The serve phase's model and traffic on int8 pools
    (``cache_dtype="int8"``, ``PagedConfig(block_size=32,
    num_blocks=256)``).  float32: the captured engine's streams equal the
    int8 gather oracle's and offline int8 ``generate``'s, the int8 kernel
    launches 12 times a decode step, no block is left; the pressured
    priority engine on int8 pools preempts, swaps (the scales with the
    values) and matches offline int8 ``generate``.  bf16 (the main path
    of the int8 kernels' launches: every count set to 0 just before, read
    just after): TTFT/TPOT medians, decode tokens/s and the busy share of
    a profiled window, beside the serve phase's bf16 pools.  Returns the
    int8 kernels' launches and the offline int8 streams."""
    from singa_tpu_torch.ops import paged_attention as pa

    marks = [("start", time.perf_counter())]
    cfg, traffic = model.cfg, real["traffic"]
    pa.paged_attn.launches = pa.paged_attn.int8_launches = 0
    block8, snap8, sec8, _ = run_engine(model, traffic, "block",
                                        cache_dtype="int8")
    launches8, all8 = pa.paged_attn.int8_launches, pa.paged_attn.launches
    steps8 = snap8["throughput"]["decode_steps"]
    if not launches8 == all8 == cfg.n_layer * steps8:
        raise AssertionError(f"int8: paged_attn launched {all8} times, the "
                             f"int8 kernel {launches8}, over {steps8} decode "
                             f"steps")
    if not snap8["paged"]["quant"]:
        raise AssertionError("the int8 engine's arena is not quantized")
    marks.append(("float32_captured", time.perf_counter()))
    gather8, _, _, _ = run_engine(model, traffic, "gather",
                                  cache_dtype="int8")
    offline8 = offline_streams(model, traffic, "int8")
    marks.append(("float32_gather_and_generate", time.perf_counter()))
    _same_streams("the int8 kernel's stream differs from the int8 gather "
                  "oracle's", block8, gather8)
    _same_streams("the int8 engine's stream differs from offline int8 "
                  "generate", block8, offline8)
    differ = sum(not np.array_equal(a, b)
                 for a, b in zip(block8, real["offline"]))
    pressured = serve_pressured(model, pressure_traffic(
        0, vocab=cfg.vocab_size), cache_dtype="int8")
    marks.append(("float32_pressured", time.perf_counter()))

    bf = torch.bfloat16
    pa.paged_attn.launches = pa.paged_attn.int8_launches = 0
    b16, snap16, sec16, decode_s = run_engine(
        model, traffic, "block", dtype=bf, trace=True, cache_dtype="int8")
    launches16 = pa.paged_attn.int8_launches
    steps16 = snap16["throughput"]["decode_steps"]
    if launches16 != cfg.n_layer * steps16:
        raise AssertionError(f"bf16 int8: the int8 kernel launched "
                             f"{launches16} times over {steps16} steps")
    profile = profile_serve(model, traffic, bf, cache_dtype="int8")
    marks.append(("bf16_timed_and_profiled", time.perf_counter()))
    log({"phase": "serve_int8", "model": "gpt2-small",
         "engine": dict(SERVE_ENGINE, cache_dtype="int8"),
         "requests": len(traffic),
         "float32": {"decode_steps": steps8, "int8_launches": launches8,
                     "seconds": sec8, "graphs": snap8["graphs"],
                     "streams_equal_gather_and_int8_generate": True,
                     "streams_differing_from_float_pools": differ},
         "float32_pressured": dict(PRESSURE_ENGINE, requests=12,
                                   paged=pressured,
                                   streams_equal_int8_generate=True),
         "bf16": {"decode_steps": steps16, "int8_launches": launches16,
                  **serve_timing(snap16, sec16, decode_s, len(traffic)),
                  "graphs": snap16["graphs"],
                  "busy_share": profile["device_busy_share"]},
         "bf16_pools_same_run": real["bf16"],
         "profile_bf16_run": profile,
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})
    return dict(launches=launches16, offline=offline8)


def phase_serve_slots(model, real, real8):
    """The serve phase's traffic through ``model.serve()`` without
    ``paged=`` (the slot arena: ``max_slots`` 8, ``max_len`` 1024, every
    slot a dense row), dense and int8.  float32: streams equal offline
    ``generate``'s at the same ``cache_dtype`` (the serve phases' own
    offline streams), exactly one captured graph, the census flat.
    bf16: TTFT/TPOT medians, decode tokens/s and the busy share of a
    profiled window."""
    marks = [("start", time.perf_counter())]
    traffic = real["traffic"]
    out = {}
    for cd, want in ((None, real["offline"]), ("int8", real8["offline"])):
        name = cd or "dense"
        streams, snap, sec, _ = run_engine(model, traffic, None,
                                           cache_dtype=cd)
        _same_streams(f"the slot arena's ({name}) stream differs from "
                      f"offline generate", streams, want)
        marks.append((f"float32_{name}", time.perf_counter()))
        b16, snap16, sec16, decode_s = run_engine(
            model, traffic, None, dtype=torch.bfloat16, trace=True,
            cache_dtype=cd)
        profile = profile_serve(model, traffic, torch.bfloat16,
                                cache_dtype=cd, slots=True)
        marks.append((f"bf16_{name}", time.perf_counter()))
        out[name] = {
            "float32": {"decode_steps": snap["throughput"]["decode_steps"],
                        "seconds": sec, "graphs": snap["graphs"],
                        "streams_equal_generate": True},
            "bf16": {"decode_steps": snap16["throughput"]["decode_steps"],
                     **serve_timing(snap16, sec16, decode_s, len(traffic)),
                     "busy_share": profile["device_busy_share"]},
            "profile_bf16_run": profile}
    log({"phase": "serve_slots", "model": "gpt2-small",
         "engine": dict(max_slots=SERVE_ENGINE["max_slots"], max_len=1024,
                        paged=None),
         "requests": len(traffic), **out,
         "bf16_paged_pools_same_run": real["bf16"],
         "seconds": {n: t - marks[i][1]
                     for i, (n, t) in enumerate(marks[1:])},
         "nvidia_smi": nvidia_smi()})


#: the pressured engine: a pool of 2048 lanes for 8 slots of up to 532
PRESSURE_ENGINE = dict(max_slots=8, block_size=32, num_blocks=64)


def pressure_traffic(seed=0, n=12, vocab=50257):
    """Prompts of 200-500 random tokens, 32 new tokens each, alternately
    greedy and at temperature 0.9; the first half at priority 0, the
    rest at 1 and 2 in turn."""
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, vocab, rng.randint(200, 501))
                 .astype(np.int32), max_new=32,
                 temperature=0.0 if i % 2 == 0 else 0.9,
                 seed=int(rng.randint(0, 2 ** 31 - 1)),
                 priority=0 if i < n // 2 else 1 + i % 2)
            for i in range(n)]


def serve_pressured(model, traffic, engine=PRESSURE_ENGINE, lead=4,
                    cache_dtype=None):
    """A priority engine whose pool cannot hold every slot's KV: the
    priority-0 requests of ``traffic`` are submitted first and decode
    ``lead`` steps, then the rest arrive and preempt them (their KV to
    host memory), and every request is resumed and finishes.  Holds every
    stream against offline ``generate``, and checks that preemption and
    resume happened and that no block is left after the drain; returns
    the arena's snapshot.  ``cache_dtype="int8"``: int8 pools, whose
    swaps carry the scales, against offline int8 ``generate``."""
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    eng = model.serve(max_slots=engine["max_slots"], scheduler="priority",
                      paged=PagedConfig(block_size=engine["block_size"],
                                        num_blocks=engine["num_blocks"]),
                      cache_dtype=cache_dtype)

    def submit(w):
        return eng.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"],
            priority=w["priority"]))

    hs = {i: submit(w) for i, w in enumerate(traffic) if w["priority"] == 0}
    for _ in range(lead):
        eng.step()
    hs.update({i: submit(w) for i, w in enumerate(traffic)
               if w["priority"] != 0})
    hs = [hs[i] for i in range(len(traffic))]
    graphs = drain_counting_graphs(eng)
    snap = dict(eng.stats.snapshot()["paged"], graphs=graphs)
    eng.check_block_accounting()
    eng.close()
    if snap["preemptions"] == 0 or snap["swap_in"] == 0:
        raise AssertionError(f"the pressured engine never preempted: {snap}")
    if snap["blocks_used"] != 0:
        raise AssertionError(f"{snap['blocks_used']} blocks in use after "
                             f"the pressured drain")
    for i, (h, want) in enumerate(zip(hs, offline_streams(
            model, traffic, cache_dtype))):
        if not np.array_equal(h.result().tokens, want):
            raise AssertionError(f"pressured request {i}: the resumed "
                                 f"stream differs from offline generate")
    return snap


def serve_tiny(dev, seed=0):
    """``GPT2Config.tiny`` (D = 16) served on the card, float32, greedy:
    streams equal offline ``generate`` and ``paged_attn`` launches once a
    layer a decode step."""
    from singa_tpu_torch import tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.ops import paged_attention as pa
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), dev)],
              is_train=False)
    rng = np.random.RandomState(seed)
    work = [(rng.randint(0, 256, rng.randint(3, 60)).astype(np.int32),
             int(rng.randint(2, 40))) for _ in range(6)]
    eng = m.serve(max_slots=4, paged=PagedConfig(block_size=8,
                                                 num_blocks=64))
    before = pa.paged_attn.launches
    hs = [eng.submit(GenerationRequest(p, max_new_tokens=n))
          for p, n in work]
    eng.run_until_complete(max_steps=500)
    steps = eng.stats.decode_steps
    launches = pa.paged_attn.launches - before
    if launches != m.cfg.n_layer * steps:
        raise AssertionError(f"tiny engine: paged_attn launched {launches} "
                             f"times over {steps} decode steps")
    for i, (h, (p, n)) in enumerate(zip(hs, work)):
        if not np.array_equal(h.result().tokens,
                              m.generate(p, max_new_tokens=n,
                                         temperature=0.0)):
            raise AssertionError(f"tiny engine request {i}: stream differs "
                                 f"from offline generate")
    eng.close()
    return dict(head_dim=m.cfg.n_embd // m.cfg.n_head, requests=len(work),
                decode_steps=steps, paged_attn_launches=launches)


def profile_serve(model, traffic, dtype, warm=40, steps=20, capture=True,
                  cache_dtype=None, slots=False):
    """Device time by kernel group and the device's busy share over
    ``steps`` engine steps of the traffic after ``warm`` steps (the eight
    slots full, decoding), from torch.profiler, with captured or eager
    decode steps (``slots``: the slot arena's engine; ``cache_dtype``:
    int8 KV); then closes the engine undrained (the timed runs hold the
    drain)."""
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    c = SERVE_ENGINE
    paged = None if slots else PagedConfig(block_size=c["block_size"],
                                           num_blocks=c["num_blocks"])
    eng = model.serve(max_slots=c["max_slots"], dtype=dtype, paged=paged,
                      capture=capture, cache_dtype=cache_dtype)
    for w in traffic:
        eng.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"]))
    for _ in range(warm):
        eng.step()
    live = eng.live_slots
    out = profile_steps(lambda _x, _y: eng.step(), None, None, steps=steps,
                        groups=SERVE_GROUPS)
    if capture:
        # one replay of the full-width step alone, by CUDA events: the
        # graph's device span, its kernels and the gaps between them
        out["replay_ms_width_8"] = cuda_time_ms(eng._steps[c["max_slots"]],
                                                20)
    eng.close(force=True)
    return dict(out, warm_steps=warm, live_slots=live)


SERVE_GROUPS = (
    ("paged_attn", re.compile(r"paged_(attn|combine)_kernel<")),
    ("gemm", re.compile(r"gemm|nvjet|xmma|cutlass", re.I)),
)


def phase_generate(model, seed=0, prompt_len=1000, n_new=40):
    """GPT-2 small (the serve phase's float32 model) past n_positions: a
    ``prompt_len``-token prompt and ``n_new`` greedy tokens take
    ``generate``'s windowed path, one 1024-wide forward a token through
    the flash forward kernel (12 launches a token); its tokens equal the
    KV-cached ``generate``'s while the generation fits n_positions.  Then
    ``min_p`` and ``repetition_penalty`` on the KV-cached path: with
    min_p = 1 a sampled stream is the greedy one."""
    from singa_tpu_torch.ops import flash_attention as fa

    cfg = model.cfg
    rng = np.random.RandomState(seed)
    prompt = rng.randint(0, cfg.vocab_size, prompt_len).astype(np.int32)
    before = fa.flash_fwd.launches
    t0 = time.perf_counter()
    windowed = model.generate(prompt, max_new_tokens=n_new, temperature=0.0)
    seconds = time.perf_counter() - t0
    launches = fa.flash_fwd.launches - before
    if launches != cfg.n_layer * n_new:
        raise AssertionError(f"windowed generate launched the flash forward "
                             f"{launches} times for {n_new} tokens")
    fits = cfg.n_positions - prompt_len
    cached = model.generate(prompt, max_new_tokens=fits, temperature=0.0,
                            use_cache=True)
    if len(windowed) != prompt_len + n_new or not np.array_equal(
            windowed[:cfg.n_positions], cached):
        raise AssertionError("windowed generate differs from the KV-cached "
                             "one inside n_positions")
    short = prompt[:200]
    kw = dict(max_new_tokens=24, repetition_penalty=1.3)
    greedy = model.generate(short, temperature=0.0, **kw)
    sampled = model.generate(short, temperature=0.9, min_p=1.0, seed=3, **kw)
    filtered = model.generate(short, temperature=0.9, min_p=0.05, top_k=50,
                              seed=3, **kw)
    if not np.array_equal(sampled, greedy):
        raise AssertionError("min_p = 1 sampling differs from greedy")
    if len(filtered) != len(short) + 24 or filtered.max() >= cfg.vocab_size:
        raise AssertionError("min_p / repetition_penalty generate gave a "
                             "bad stream")
    log({"phase": "generate", "model": "gpt2-small", "dtype": "float32",
         "prompt_len": prompt_len, "max_new_tokens": n_new,
         "windowed_seconds": seconds, "flash_fwd_launches": launches,
         "equal_to_kv_cached_tokens": fits,
         "min_p_one_equals_greedy": True})


def real_args(real, cfg, seed, quant=False, dtype=torch.bfloat16):
    """``paged_attn`` arguments for each layer of one recorded serve step:
    its tables and positions, a bf16 pool of the serve engine's size for
    each layer with random contents, random queries and current K/V, drawn
    on the device from ``seed`` (the kernel's time does not depend on the
    values), in ``dtype``.  ``quant``: the pools and current K/V int8
    (values, scales) pairs (values uniform in [-127, 127], scales in
    [0.005, 0.015)), q in ``dtype``."""
    c = SERVE_ENGINE
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    d = cfg.n_embd // cfg.n_head
    s_ = len(real["p_limit"])

    def rand(*shape):
        if quant:
            return (torch.randint(-127, 128, shape, generator=gen,
                                  device=DEVICE, dtype=torch.int8),
                    0.005 + 0.01 * torch.rand(shape[:-1], generator=gen,
                                              device=DEVICE))
        return torch.randn(shape, generator=gen, device=DEVICE,
                           dtype=dtype)

    block = c["block_size"]
    p_limit = real["p_limit"]
    step = dict(
        q=torch.randn((s_, cfg.n_kv_head, cfg.n_head // cfg.n_kv_head, 1, d),
                      generator=gen, device=DEVICE, dtype=dtype),
        tables=torch.from_numpy(real["tables"]).to(DEVICE),
        p_limit=torch.tensor(p_limit, dtype=torch.int32, device=DEVICE),
        k_cur=rand(s_, cfg.n_kv_head, 1, d),
        v_cur=rand(s_, cfg.n_kv_head, 1, d),
        cur_mask=torch.ones(1, 1, dtype=torch.bool, device=DEVICE),
        scale=1.0 / math.sqrt(d))
    shape = (c["num_blocks"] + 1, cfg.n_kv_head, block, d)
    return [dict(step, pool_k=rand(*shape), pool_v=rand(*shape))
            for _ in range(cfg.n_layer)]


def paged_table(lens, cfg, seed):
    """``real_args`` for slots at positions ``lens``, each holding its
    own random blocks of the serve engine's pool (numpy ``seed``), the
    tables 1024 positions wide."""
    c = SERVE_ENGINE
    block = c["block_size"]
    rng = np.random.RandomState(seed)
    ids = rng.permutation(c["num_blocks"])
    tables = np.full((len(lens), 1024 // block), c["num_blocks"], np.int32)
    at = 0
    for s_, p in enumerate(lens):
        n = -(-p // block)
        tables[s_, :n] = ids[at:at + n]
        at += n
    return real_args(dict(tables=tables, p_limit=list(lens)), cfg, seed)


# ----------------------------------------------------------------- main

#: every kernel source of the port (``singa_tpu_torch/csrc/<name>.cu``)
SOURCES = ("flash_attention", "resnet_bottleneck", "paged_attention")


def kernel_report(lib):
    """Per kernel of a built library, by its name as ``cu++filt``
    demangles it: registers and spill bytes from ptxas's ``-v`` report of
    the build, and the counts of warp-level (HMMA) and warpgroup (HGMMA)
    tensor-core instructions, TMA loads (UTMALDG) and local-memory (LDL,
    STL) instructions in its SASS (``cuobjdump -sass``)."""
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
        for key, rx in (("hmma", r"\bHMMA\."), ("hgmma", r"\bHGMMA\."),
                        ("utmaldg", r"\bUTMALDG\b")):
            row[key] = len(re.findall(rx, body))
        row["local_memory_instructions"] = len(
            re.findall(r"\b(?:LDL|STL)(?:\.\w+)*\s", body))
    names = sorted(out)
    readable = subprocess.run([os.path.join(tools, "cu++filt"), *names],
                              capture_output=True, text=True,
                              check=True).stdout.splitlines()
    return dict(zip(readable, (out[n] for n in names), strict=True))


#: the tensor-core kernels each build must hold, by library; a kernel is
#: known by its demangled name, ``(anonymous namespace)::<name><...>(...)``:
#: ``*_tc_kernel`` on warp-level mma.sync, ``*_wg_kernel`` on Hopper's
#: warpgroup wgmma fed by TMA
TENSOR_CORE_KERNELS = {
    "flash_attention": ("fwd_wg_kernel", "dq_tc_kernel", "dkv_wg_kernel"),
    "resnet_bottleneck": ("bottleneck_tc_kernel",),
    # decode attention does ~1 FLOP a byte: CUDA cores, by design
    "paged_attention": (),
}


def check_tensor_cores(report):
    """Raise unless every kernel of ``TENSOR_CORE_KERNELS`` is in its
    library's ``kernel_report``, every ``*_tc_kernel`` instantiation there
    has tensor-core instructions (HMMA or HGMMA) and every Hopper
    ``*_wg_kernel`` instantiation has both HGMMA and UTMALDG (HMMA alone
    would mean the warpgroup design was lost); returns the tensor-core
    kernels' rows by name."""
    tc = {}
    for lib, names in TENSOR_CORE_KERNELS.items():
        rows = {k: v for k, v in report.get(lib, {}).items()
                if re.search(r"::\w+_(?:tc|wg)_kernel<", k)}
        missing = [n for n in names
                   if not any(f"::{n}<" in k for k in rows)]
        if missing:
            raise AssertionError(f"{lib}: no {missing} in the build report")
        bare = {k: v for k, v in rows.items()
                if not (v.get("hmma") or v.get("hgmma"))}
        if bare:
            raise AssertionError(f"tensor-core kernels without HMMA/HGMMA "
                                 f"in their SASS: {bare}")
        no_tma = {k: v for k, v in rows.items()
                  if re.search(r"::\w+_wg_kernel<", k)
                  and not (v.get("hgmma") and v.get("utmaldg"))}
        if no_tma:
            raise AssertionError(f"Hopper kernels without HGMMA and UTMALDG "
                                 f"in their SASS: {no_tma}")
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


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main():
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; the port's smoke run needs "
              "one GPU", file=sys.stderr)
        return 1
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    timed("slice", phase_slice, rows)
    timed("bert", phase_bert)
    timed("onnx", phase_onnx)
    timed("charrnn", phase_charrnn)
    model, images = timed("resnet", phase_resnet)
    rows["megakernel_block"] = timed("bottleneck", phase_bottleneck, model,
                                     images)
    del model, images
    timed("zoo", phase_zoo)
    model, real = timed("serve", phase_serve)
    real8 = timed("serve_int8", phase_serve_int8, model, real)
    timed("serve_slots", phase_serve_slots, model, real, real8)
    timed("generate", phase_generate, model)
    cfg = model.cfg
    del model
    for row in timed("paged_kernels", phase_paged_kernels, real, real8, cfg):
        rows[row["name"]] = row

    smi = nvidia_smi()
    log({"phase": "device", "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "phase_seconds": seconds,
         "script_seconds": time.perf_counter() - start})
    print(json.dumps({"kernels": list(rows.values())}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
