#!/usr/bin/env python3
"""Times the flash kernels and the bottleneck kernel of one checkout of
the port on one GPU by a fixed method, so that two checkouts can be
compared in one call:

    python3 tools/compare_flash_kernels.py [--tree PATH]

``PATH`` is the root of a checkout (by default this one).  Its
``singa_tpu_torch`` is imported, so its kernels are built from its own
sources into its own ``singa_tpu_torch/_build``.  The inputs (GPT-2
small's attention shape, 8 x 12 x 1024 x 64, causal, bf16, from numpy
seed 0; the bottleneck at ResNet-50's ``layer1[1]`` shape, 128 x 56 x 56 x
256 -> 64, ``chip_smoke.bottleneck_inputs(..., seed=0)``) and the timer
(CUDA events around back-to-back launches, two warm-up calls) come from
this checkout's ``chip_smoke.py``, whichever tree is timed.  Each kernel
is timed over 10 and over 50 launches: the count ``chip_smoke.py`` once
timed kernels over, and the count it times them over now.

Where the checkout has the paged decode attention
(``singa_tpu_torch/ops/paged_attention.py``), ``paged_attn`` is timed too,
at one decode step of ``chip_smoke.py``'s serve traffic (``PAGED_LENS``:
8 slots' positions, block size 32, 12 kv heads, D = 64, bf16, random
tables and a random pool for each of the 12 layers from numpy seed 0):
``paged_attn`` over the layers in turn, as the serve step reads them (the
working set outgrows L2), and ``paged_attn_one_layer`` on the first layer
alone (its K/V stays in L2); besides the event times, their device time
per launch over 48 launches (``chip_smoke.device_ms_per_call``), since
the wrapper's launch overhead exceeds the kernel's time.

Run it once per checkout in alternating order (A, B, B, A) within one
process per run; each run prints one JSON line with the mean ms per
launch of ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``,
``megakernel_block`` (and the paged rows) at each count, and the card's
name and power limit.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHES = (10, 50)
#: the live slots' positions at one decode step of chip_smoke.py's serve
#: traffic (GPT-2 small, 8 slots)
PAGED_LENS = (448, 511, 115, 349, 462, 361, 340, 252)


def _chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded by path so that another
    tree's copy on ``sys.path`` is not picked up instead."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_timer", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _paged_calls(cs):
    """``paged_attn`` over 12 layers in turn and on one layer, at
    ``PAGED_LENS`` (module docstring)."""
    from types import SimpleNamespace

    import numpy as np

    from singa_tpu_torch.ops import paged_attention as pa

    c = cs.SERVE_ENGINE
    block = c["block_size"]
    rng = np.random.RandomState(0)
    ids = rng.permutation(c["num_blocks"])
    tables = np.full((len(PAGED_LENS), 1024 // block), c["num_blocks"],
                     np.int32)
    at = 0
    for s, p in enumerate(PAGED_LENS):
        n = -(-p // block)
        tables[s, :n] = ids[at:at + n]
        at += n
    cfg = SimpleNamespace(n_embd=768, n_head=12, n_kv_head=12, n_layer=12)
    layers = cs.real_args(dict(tables=tables, p_limit=list(PAGED_LENS)),
                          cfg, 0)
    return {"paged_attn": cs._rotating(
                [functools.partial(pa.paged_attn, **a) for a in layers]),
            "paged_attn_one_layer": lambda: pa.paged_attn(**layers[0])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the checkout whose kernels are timed")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("compare_flash_kernels.py: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    cs = _chip_smoke()
    from singa_tpu_torch.ops import bottleneck as bk
    from singa_tpu_torch.ops import flash_attention as fa

    sh = cs.GPT2_SHAPE
    (q, k, v), cfg, do, dlse = cs._case_inputs(
        sh["b"], sh["h"], sh["s"], sh["d"], torch.bfloat16, seed=0,
        causal=True)
    o, lse = fa.flash_fwd(q, k, v, *cfg)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    bwd = (do, lse, delta)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, *cfg),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, *cfg, *bwd),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, *cfg, *bwd),
    }
    block = cs.bottleneck_inputs(128, 56, 56, 256, 64, seed=0)
    calls["megakernel_block"] = lambda: bk.megakernel_block(*block)
    paged = {}
    if os.path.exists(os.path.join(tree, "singa_tpu_torch", "ops",
                                   "paged_attention.py")):
        paged = _paged_calls(cs)
        calls.update(paged)
    ms = {name: {str(n): cs.cuda_time_ms(fn, n) for n in LAUNCHES}
          for name, fn in calls.items()}
    # the paged kernel is shorter than its wrapper's launch overhead:
    # its device time, by the profiler, over 48 launches
    device_ms = {name: cs.device_ms_per_call(fn, 48)
                 for name, fn in paged.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({
        "tree": tree, "package": os.path.dirname(os.path.dirname(
            os.path.abspath(fa.__file__))),
        "shape": dict(sh, causal=True, dtype="bfloat16"),
        "bottleneck_shape": dict(b=128, h=56, w=56, c=256, cm=64),
        "ms_by_launches": ms, "device_ms_48_launches": device_ms,
        "nvidia_smi": smi.splitlines()[0]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
