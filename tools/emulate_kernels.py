#!/usr/bin/env python3
"""Runs the port's CUDA kernel sources on the CPU, through the emulator in
``tools/cuda_emulator/emu.h``, against their plain PyTorch versions:

    python3 tools/emulate_kernels.py [flash|bottleneck|paged] [CASE ...]

Each ``singa_tpu_torch/csrc/<name>.cu`` is turned into C++ (the inline-PTX
helpers ``smem_u32``, ``cp_async*``, ``ldsm_x4*``, ``mma_bf16`` and ``ex2``
give way to the emulator's, ``extern __shared__`` arrays point at its
shared memory and ``<<<...>>>`` launches call ``emu_launch``), built with
the host's C++ compiler into ``_scratch/emulator`` (gitignored) and loaded
with ctypes under the same C interface the GPU library has.  The CLI runs
``chip_smoke.py``'s edge cases: every flash case in bf16 (the tensor-core
kernels; float32 takes the CUDA-core ones), every bottleneck case, and
every paged-attention case in float32 and bf16, and on int8 pools with
float32 and bf16 q; it prints one line a case
and exits 1 if any fails its tolerance (``chip_smoke.TOL``,
``chip_smoke.PAGED_TOL``).

The emulator sums each ``mma`` exactly, so it shows what a kernel computes
and where it reads and writes, not the card's rounding (the tensor cores
truncate a running sum fed back as an ``mma``'s C operand) or its speed.
A run takes seconds a case (one fiber per CUDA thread).
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "singa_tpu_torch", "csrc")
EMU = os.path.join(ROOT, "tools", "cuda_emulator")
CXX_FLAGS = ("-std=c++17", "-O1", "-fPIC", "-shared", "-w")

#: the sources' inline-PTX helpers, replaced by the emulator's
_HELPERS = ("smem_u32", "cp_async16", "cp_async4", "cp_async_commit",
            "cp_async_wait", "cp_async_wait_all", "ldsm_x4", "ldsm_x4_t",
            "mma_bf16", "ex2")
_GLOBALS = """
dim3 threadIdx, blockIdx, gridDim, blockDim;
EmuFiber* emu_cur;
ucontext_t emu_sched;
EmuBarrier emu_block_bar;
std::vector<EmuWarp> emu_warps;
unsigned char* emu_smem_base;
"""


def emulated_source(text):
    """The C++ for the emulator from the text of a ``csrc/*.cu`` file."""
    text = re.sub(r"#include <cuda_runtime.h>\n|#include <cuda_bf16.h>\n",
                  "", text)
    for name in _HELPERS:
        m = re.search(r"(template <int N>\n)?__device__ __forceinline__ "
                      r"[\w ]+?\b" + name + r"\(", text)
        if not m:
            continue
        depth, j = 0, text.index("{", m.end())
        while True:
            depth += {"{": 1, "}": -1}.get(text[j], 0)
            if depth == 0:
                break
            j += 1
        text = text[:m.start()] + text[j + 1:]
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?"
                  r"(unsigned char|float) (\w+)\[\];",
                  r"\1* \2 = (\1*)emu_smem();", text)
    if re.search(r"\basm\b", text):
        raise ValueError("inline PTX outside the emulated helpers: "
                         + re.search(r".*\basm\b.*", text).group(0))
    text = re.sub(r"(\w+(?:<[^<>;]*>)?)<<<([^>]*)>>>\(",
                  r"emu_launch(\1, \2, ", text)
    return '#include "emu.h"\n' + text + _GLOBALS


def build(name, out_dir):
    """Build ``csrc/<name>.cu`` for the emulator into ``out_dir`` (keyed by
    a hash of the source, the header and the flags); returns the path."""
    with open(os.path.join(CSRC, name + ".cu")) as fh:
        src = emulated_source(fh.read())
    with open(os.path.join(EMU, "emu.h")) as fh:
        key = src + fh.read() + " ".join(CXX_FLAGS)
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    lib = os.path.join(out_dir, f"{name}-{digest}.so")
    if os.path.exists(lib):
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on the PATH")
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}"
    with open(tmp + ".cpp", "w") as fh:
        fh.write(src)
    res = subprocess.run([cxx, *CXX_FLAGS, "-I", EMU, "-o", tmp,
                          tmp + ".cpp"], capture_output=True, text=True)
    os.remove(tmp + ".cpp")
    if res.returncode:
        raise RuntimeError(f"{cxx} failed for {name}:\n{res.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def load(name, out_dir):
    """The emulated library of ``csrc/<name>.cu``, with the ctypes types
    of the port's wrapper."""
    sys.path.insert(0, ROOT)
    from singa_tpu_torch.ops import flash_attention as fa

    lib = ctypes.CDLL(build(name, out_dir))
    if name == "flash_attention":
        for fn, argtypes in fa._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    elif name == "paged_attention":
        from singa_tpu_torch.ops import paged_attention as pa

        pa.type_library(lib)
    else:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.resnet_bottleneck.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
        lib.resnet_bottleneck.restype = i32
        lib.resnet_bottleneck_band_rows.argtypes = [i32]
        lib.resnet_bottleneck_band_rows.restype = i32
    return lib


def flash_case(lib, b, h, s, d, dtype, seed, mask=None, causal=False,
               window=None):
    """The emulated flash kernels on one ``chip_smoke`` case (CPU tensors)
    against their plain versions; returns ``{kernel: (max |Δ|, ok)}``."""
    import torch

    import chip_smoke as cs
    from singa_tpu_torch.ops import flash_attention as fa

    (q, k, v), cfg, do, dlse = cs._case_inputs(b, h, s, d, dtype, seed,
                                               mask, causal, window)
    kmask, qmask, qmap, scale, causal, window = cfg
    shape = [*q.shape, float(scale), int(bool(causal)), int(window or 0),
             fa.route(dtype, d), None]
    masks = fa._mask_args(kmask, qmask, qmap)
    rtol, atol = cs.TOL[dtype]
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, *cfg)
    delta = ((do.float() * o_ref.float()).sum(-1) - dlse).contiguous()
    bwd = (do, lse_ref, delta)
    o, lse = torch.empty_like(q), torch.empty(q.shape[:2])
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    rows = (do.data_ptr(), lse_ref.data_ptr(), delta.data_ptr())
    for err in (
            lib.flash_fwd(*qkv, *masks, o.data_ptr(), lse.data_ptr(), *shape),
            lib.flash_bwd_dq(*qkv, *masks, *rows, dq.data_ptr(), *shape),
            lib.flash_bwd_dkv(*qkv, *masks, *rows, dk.data_ptr(),
                              dv.data_ptr(), *shape)):
        if err:
            raise RuntimeError(f"emulated launch returned {err}")
    pairs = {"flash_fwd": [(o, o_ref), (lse, lse_ref)],
             "flash_bwd_dq": [(dq, fa.flash_bwd_dq_plain(q, k, v, *cfg,
                                                          *bwd))],
             "flash_bwd_dkv": list(zip((dk, dv), fa.flash_bwd_dkv_plain(
                 q, k, v, *cfg, *bwd)))}
    out = {}
    for kernel, got_want in pairs.items():
        err, ok = 0.0, True
        for got, want in got_want:
            got, want = got.float(), want.float()
            err = max(err, (got - want).abs().max().item())
            ok = ok and bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, rtol=rtol, atol=atol)
        out[kernel] = (err, ok)
    return out


def bottleneck_case(lib, b, h, w, c, cm, seed, affine="unit"):
    """The emulated bottleneck kernel on one ``chip_smoke`` case against
    its plain version; returns ``chip_smoke.bottleneck_stats``."""
    import torch

    import chip_smoke as cs
    from singa_tpu_torch.ops import bottleneck as bk

    args = cs.bottleneck_inputs(b, h, w, c, cm, seed, affine)
    out = torch.full_like(args[0], float("nan"))
    err = lib.resnet_bottleneck(*(t.data_ptr() for t in args),
                                out.data_ptr(), b, h, w, c, cm, None)
    if err:
        raise RuntimeError(f"emulated launch returned {err}")
    return cs.bottleneck_stats(out, bk.megakernel_block_plain(*args),
                               cs.TOL["bottleneck"])


def paged_case(lib, dtype, seed, n_split=None, quant=False, **kw):
    """The emulated split and combine kernels on one ``chip_smoke`` case
    (CPU tensors, the output and workspace NaN-filled) against their
    plain version, launched as the wrapper launches them (launches of at
    most ``max_rows(D)`` query rows, the table width as the bound of the
    blocks read, which the kernel narrows from ``p_limit``), over
    ``n_split`` splits of the key range (default: what the wrapper would
    choose on an H100's 132 SMs); ``quant``: int8 pools, q in ``dtype``.
    Returns ``(max |Δ|, ok)``."""
    import torch

    import chip_smoke as cs
    from singa_tpu_torch.ops import paged_attention as pa

    a = cs.paged_inputs(dtype=dtype, seed=seed, quant=quant, **kw)

    def nan_filled(shape, dtype, device):
        return torch.full(shape, float("nan"), dtype=dtype, device=device)

    out, _ = pa.launch_groups(
        lib, a["q"], a["pool_k"], a["pool_v"], a["tables"], a["p_limit"],
        a["k_cur"], a["v_cur"], a["cur_mask"], a["scale"], a["window"],
        a["blk_lo"], 132, None, n_split=n_split, empty=nan_filled)
    got, want = out.float(), pa.paged_attn_plain(**a).float()
    rtol, atol = cs.PAGED_TOL[dtype]
    return ((got - want).abs().max().item(),
            bool(torch.isfinite(got).all())
            and torch.allclose(got, want, rtol=rtol, atol=atol))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    which = argv.pop(0) if argv and argv[0] in ("flash", "bottleneck",
                                                 "paged") else None
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs

    cs.DEVICE = torch.device("cpu")
    out_dir = os.path.join(ROOT, "_scratch", "emulator")
    failed = 0
    if which in (None, "flash"):
        lib = load("flash_attention", out_dir)
        for seed, (name, kw) in enumerate(cs.edge_cases()):
            if argv and name not in argv:
                continue
            res = flash_case(lib, dtype=torch.bfloat16, seed=seed, **kw)
            failed += not all(ok for _, ok in res.values())
            print(f"flash {name}: {res}", flush=True)
    if which in (None, "bottleneck"):
        lib = load("resnet_bottleneck", out_dir)
        for seed, (name, kw) in enumerate(cs.bottleneck_edge_cases()):
            if argv and name not in argv:
                continue
            st = bottleneck_case(lib, seed=seed, **kw)
            failed += not st["ok"]
            print(f"bottleneck {name}: share_differing "
                  f"{st['share_differing']:.3g}, max |Δ| "
                  f"{st['max_abs_err']}, ok {st['ok']}", flush=True)
    if which in (None, "paged"):
        lib = load("paged_attention", out_dir)
        for seed, (name, kw) in enumerate(cs.paged_edge_cases()):
            if argv and name not in argv:
                continue
            for quant, dtype in itertools.product(
                    (False, True), (torch.float32, torch.bfloat16)):
                for n_split in (1, None):
                    err, ok = paged_case(lib, dtype, seed, n_split, quant,
                                         **kw)
                    failed += not ok
                    print(f"paged {name}/{'int8/' if quant else ''}"
                          f"{str(dtype)[6:]}/"
                          f"n_split={n_split or 'planned'}: max |Δ| {err}, "
                          f"ok {ok}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
