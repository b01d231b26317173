#!/usr/bin/env python3
"""How well conditioned a zoo model's SGD step is at the states of
``tests/test_torch_zoo.py``'s two-step test, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/probe_zoo_conditioning.py mobilenet_v2 [steps]

For each of the first ``steps`` (default 4) states of the JAX model's
trajectory (the test's ``_pair``, SGD(0.05, 0.9), graph mode), prints the
largest difference after one step between the port's float32 update and
the JAX package's, the port's own float64 update, and the port's float32
update from the state scaled by 1 + r·N(0, 1) for r = 1e-7 and 1e-6; then,
at the second state, how many inputs of each ReLU6 lie within 1e-5 /
1e-4 / 1e-3 of its kinks at 0 and 6, and the smallest per-channel batch
variance a batch norm sees.
"""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import test_torch_zoo as zoo  # noqa: E402
from singa_tpu import tensor as jtensor  # noqa: E402
from singa_tpu_torch import tensor  # noqa: E402


def port_step(m, states, opt_states, x, y, dtype=torch.float32, rel=0.0):
    """The port's states after one step from ``states`` scaled by 1 +
    rel·N(0, 1) (seed 1), in ``dtype``."""
    rng = np.random.RandomState(1)
    m.set_states({k: torch.from_numpy(np.asarray(v, np.float64) * (
        1 + rel * rng.randn(*np.shape(v)))).to(dtype)
        for k, v in states.items()})
    m.optimizer.set_states(opt_states)
    for k, v in m.optimizer._states.items():
        if k not in opt_states:  # a fresh slot: zero, as on a first step
            v.zero_()
    if dtype == torch.float64:
        for k in list(m.optimizer._states):
            m.optimizer._states[k] = m.optimizer._states[k].double()
    cpu = zoo._cpu()
    m(torch.from_numpy(x).to(dtype), tensor.from_numpy(y, cpu))
    return {k: v.detach().double().numpy() for k, v in
            m.get_states().items()}


def worst(a, b):
    return max((float(np.abs(a[k] - b[k]).max()), k) for k in a)


def kinks(m, states, x, y):
    """(layer, [near 0 at 1e-5, 1e-4, 1e-3], [near 6 ...]) of each ReLU6
    input and the smallest batch-norm batch variance, one forward."""
    m.set_states(states)
    rows, var = [], []

    def relu6(mod, inp, out):
        a = inp[0].detach().double()
        rows.append((tuple(a.shape),
                     [int((a.abs() < t).sum()) for t in (1e-5, 1e-4, 1e-3)],
                     [int(((a - 6).abs() < t).sum())
                      for t in (1e-5, 1e-4, 1e-3)]))

    def bn(mod, inp, out):
        a = inp[0].detach().double()
        var.append(float(a.var(dim=[0, *range(2, a.dim())],
                                unbiased=False).min()))

    hooks = [mod.register_forward_hook(relu6 if type(mod).__name__ == "ReLU6"
                                       else bn)
             for mod in m.modules()
             if type(mod).__name__ == "ReLU6"
             or "BatchNorm" in type(mod).__name__]
    m(tensor.from_numpy(x, zoo._cpu()), tensor.from_numpy(y, zoo._cpu()))
    for h in hooks:
        h.remove()
    return rows, min(var) if var else None


def main(name="mobilenet_v2", steps=4):
    jm, tm, x, y = zoo._pair(name, use_graph=True)
    _, t64, _, _ = zoo._pair(name, use_graph=False)
    t64.double()
    _, tk, _, _ = zoo._pair(name, use_graph=False)
    for step in range(int(steps)):
        states = {k: np.array(jtensor.to_numpy(v))
                  for k, v in jm.get_states().items()}
        opt_states = jm.optimizer.get_states()
        f32 = port_step(tm, states, opt_states, x, y)
        f64 = port_step(t64, states, opt_states, x, y, torch.float64)
        moved = {r: worst(port_step(tm, states, opt_states, x, y, rel=r),
                          f32) for r in (1e-7, 1e-6)}
        if step == 1:
            rows, min_var = kinks(tk, states, x, y)
        jm(jtensor.from_numpy(x), jtensor.from_numpy(y))
        jax = {k: np.asarray(jtensor.to_numpy(v), np.float64)
               for k, v in jm.get_states().items()}
        print(f"state {step}: |port32 - jax| {worst(f32, jax)}, "
              f"|port32 - port64| {worst(f32, f64)}, "
              f"|jax - port64| {worst(jax, f64)}, "
              f"moved at 1e-7 {moved[1e-7]}, at 1e-6 {moved[1e-6]}")
    if int(steps) > 1:
        print("state 1, ReLU6 inputs near 0 and 6 (1e-5, 1e-4, 1e-3):")
        for r in rows:
            if any(r[1]) or any(r[2]):
                print("  ", r)
        print("state 1, smallest batch-norm batch variance:", min_var)


if __name__ == "__main__":
    main(*sys.argv[1:])
