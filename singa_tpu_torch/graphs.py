"""Captured steps: the port's counterpart of ``jax.jit``.

A :class:`Step` holds one function prepared for repeated calls on fixed
buffers.  On a CUDA device it is a CUDA graph (``torch.cuda.CUDAGraph``)
captured from one call of the function; calling the step replays the
graph, which reruns every kernel of the capture on the same memory
without the Python that launched them.  On the CPU, which has no graphs,
the step calls the function itself: the callers (the training step's
``model._GraphRunner`` and the serve engine's decode steps) then run the
same keying, static buffers and counters, which is what lets the CPU
tests hold them against the JAX package.  There is no fallback: on a
CUDA device a capture or replay that fails raises.

Capture records work without running it, so a caller first runs the
function once eagerly (:func:`warm`): that call builds the kernels,
creates lazily made state and lets cuBLAS and cuDNN choose their
algorithms, and it is a real call, not a rehearsal.

A replay calls no kernel wrapper, so it would add nothing to the
wrappers' launch counts (``flash_fwd.launches``, ``paged_attn.launches``
...).  :class:`Step` therefore records the launches each capture made,
takes them back out of the counts (the capture ran nothing) and credits
them on every replay.
"""

from __future__ import annotations

import torch

__all__ = ["Step", "warm", "launch_counters"]


def launch_counters():
    """``(wrapper, attribute)`` of every kernel launch count of the
    port."""
    from .ops import bottleneck, flash_attention as fa, paged_attention as pa

    out = []
    for fn in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        out += [(fn, "launches"), (fn, "tensor_core_launches")]
    return out + [(pa.paged_attn, "launches"),
                  (pa.paged_attn, "int8_launches"),
                  (bottleneck.megakernel_block, "launches")]


def _counts():
    return [getattr(fn, a) for fn, a in launch_counters()]


def _credit(deltas):
    for (fn, a), n in zip(launch_counters(), deltas):
        setattr(fn, a, getattr(fn, a) + n)


def warm(fn, device):
    """``fn()`` run eagerly; on a CUDA device on a side stream, as a
    capture's warm-up call must be, with the current stream waiting for
    it."""
    if device.type != "cuda":
        return fn()
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    main.wait_stream(side)
    return out


class Step:
    """``fn`` prepared for replay on ``device``: captured as a CUDA graph
    there (into the memory pool ``pool``, with ``generators`` registered
    so that each replay draws fresh random numbers from them), or kept
    as the function on the CPU.  ``fn`` must read its inputs from, and
    return, tensors that outlive the step; calling the step returns
    those outputs, rewritten in place by each replay."""

    def __init__(self, fn, device, pool=None, generators=()):
        self.fn = fn
        self.graph = None
        self.out = None
        self.launches = [0] * len(launch_counters())
        if device.type == "cuda":
            self._capture(pool, generators)

    def _capture(self, pool, generators):
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=pool):
            self.out = self.fn()
        self.launches = [a - b for a, b in zip(_counts(), before)]
        _credit([-n for n in self.launches])
        self.graph = graph

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        _credit(self.launches)
        return self.out
