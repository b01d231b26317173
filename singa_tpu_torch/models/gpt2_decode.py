"""KV-cached incremental decoding for GPT-2 (counterpart of
``singa_tpu/models/gpt2_decode.py``).

* ``prefill``: one causal forward over a prompt that also returns every
  layer's K/V, ``(L, B, H_kv, S, D)``;
* ``prefill_chunk``: a K-token chunk at an offset against a dense cache
  that holds the positions below it (the prefix cache's admissions and
  the chunked-prefill budget); with per-row positions it is the slot
  arena's speculative verify;
* ``decode_step``: one token per row against a dense cache ``(L, B,
  H_kv, ctx, D)``, writing the step's K/V at each row's position; the
  offline ``generate`` loop, the serve engine's slot-arena step, the
  draft's steps and its gather oracle;
* ``decode_step_paged`` and ``chunk_step_paged``: one token, or a
  K-token chunk (the speculative verify), for every slot of the serve
  engine against the paged pool ``(L, N + 1, H_kv, B, D)``, through the
  ``paged_attn`` kernel (``ops/paged_attention.py``), one launch per
  layer for all slots;
* ``spec_verify``: the verify of a speculative chunk, greedy by argmax
  match or by rejection sampling;
* ``_sample``: the repetition penalty, then greedy, or temperature /
  top-k / top-p / min-p filtering and a draw;
* ``generate``: prefill + decode loop for one prompt or a ragged batch;
  ``generate_beam``: fixed-length beam search on the dense cache;
  ``generate_speculative``: greedy draft-and-verify.

The math follows the JAX module: float32 LayerNorm statistics, tanh gelu,
scale ``1/sqrt(D)``, GQA caches at ``n_kv_head`` heads with the query
group contracted against them, the finite floor ``NEG_INF = -1e30``.
Attention scores and softmax are float32 here whatever the weights'
dtype; the result is cast back to the activations' dtype.  Functions
work on plain tensors and a dict of weight tensors (``extract_params``)
on the caller's device.

Sliding-window models (``GPT2Config(attn_window=W)`` with W below
``n_positions``): query i sees keys (i - W, i].  Offline ``generate``
decodes from a ROLLING cache of W lanes, position p in lane p % W
(``prefill(..., window=W)`` rolls the prompt's K/V into it), so a long
generation reads O(W) lanes a token.  The paged engine keeps its linear
layout (``rolling=False``) and drops the blocks that left the window.

Random numbers: ``jax.random``'s threefry-2x32, keyed as the JAX package
keys it (``ops/prng.py``).  A sampled token is ``argmax(filtered logits +
gumbel(key, (V,)))``, the JAX ``categorical``; ``generate`` keys its rows
``split(PRNGKey(seed), B)`` and splits each row's key every step, sampling
with the first half and carrying the second, and the serve engine keys a
request ``split(PRNGKey(seed), 1)[0]`` and advances it the same way, so a
request's stream is ``generate``'s of its prompt alone and the JAX
package's at the same seed.  Keys live on the host as numpy ``uint32``
pairs; the draws over the vocabulary run on the logits' device, in
masked int64 tensor arithmetic, inside the engine's captured steps.

int8 KV caches (``cache_dtype="int8"``): a cache or pool is then a
``(values, scales)`` pair, int8 values of the dense layout and one
float32 scale a (position, kv head) row over D (``_quantize_kv``:
symmetric, ``max|x| / 127``).  Attention contracts the int8 values and
applies the scales outside the contractions, as the JAX package does: a
score takes its K row's scale, a probability its V row's scale before
the value product (the softmax sums stay unscaled).

A MoE block (``GPT2Config(moe_every=...)``) decodes through
``_moe_ffn``: capacity-free top-k routing over a loop of the experts,
the JAX package's decode FFN.

Sharded serving (``serve/tp.py``, ``serve/ep.py``): a rank's placed
weights carry their process groups in the block dicts, ``"tp"`` (the
Megatron slices: q/k/v/fc1 by columns, out-proj/fc2 by rows) and
``"ep"`` (an :class:`EPContext`: the rank's resident experts).  The
block functions then take the rank's heads off the weights' widths and
close each row-parallel product with one all-reduce (the JAX package's
``_tp_psum`` sites), and a MoE block runs :func:`_moe_ffn_ep`.  Without
those entries every expression is the single-device one.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import prng
from ..ops.paged_attention import paged_attn
from ..parallel.moe import _one_hot

__all__ = ["NEG_INF", "extract_params", "prefill", "prefill_chunk",
           "decode_step", "decode_step_paged", "chunk_step_paged",
           "spec_verify", "generate", "generate_beam",
           "generate_speculative", "kv_zeros"]

NEG_INF = -1e30


def check_decodable(cfg):
    """Raise ``ValueError`` for a configuration the decode path cannot
    take: a MoE model's ``moe_top_k`` must be 1 or 2."""
    k = getattr(cfg, "moe_top_k", 2)
    if getattr(cfg, "moe_every", None) is not None and k not in (1, 2):
        raise ValueError(f"moe_top_k must be 1 (Switch) or 2 (GShard), "
                         f"got {k}")


def _norm_window(cfg):
    """The decode-effective sliding window: None when the model has none
    or it covers every position (a rolling cache would then be the dense
    one with more index arithmetic)."""
    w = getattr(cfg, "attn_window", None)
    if w is None or w >= cfg.n_positions:
        return None
    return int(w)


def _quant_flag(cache_dtype):
    """``cache_dtype`` as a flag: None (the cache in the compute dtype)
    or ``"int8"``; anything else raises."""
    if cache_dtype is None:
        return False
    if cache_dtype == "int8":
        return True
    raise ValueError(f"cache_dtype must be None or 'int8', "
                     f"got {cache_dtype!r}")


def _quantize_kv(x):
    """(..., D) float -> ((..., D) int8, (...) float32 scale), symmetric
    per row: ``scale = max(max|x| / 127, 1e-8)``, values ``round(x /
    scale)`` (half to even, as ``jnp.round``)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def _dequantize_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def _leaves(c):
    """The tensors of a cache: ``(c,)``, or the (values, scales) pair."""
    return c if isinstance(c, tuple) else (c,)


def _cache_layer(c, li):
    """Layer ``li`` of a stacked cache (a tensor or a (values, scales)
    pair)."""
    return (c[0][li], c[1][li]) if isinstance(c, tuple) else c[li]


def extract_params(m, dtype=None):
    """The ``GPT2LMHead`` weights as a dict of tensors (the JAX
    package's pytree layout: ``wte``, ``wpe``, ``blocks`` (a list of
    per-layer dicts), ``lnf_s``, ``lnf_b``, ``head`` (None when tied)).
    ``dtype`` (e.g. ``torch.bfloat16``) casts the floating weights;
    LayerNorm statistics stay float32 inside ``_ln`` either way."""
    check_decodable(m.cfg)
    t = m.transformer

    def w(p):
        p = p.detach()
        return p.to(dtype) if dtype is not None and p.is_floating_point() \
            else p

    blocks = []
    for blk in t.blocks:
        if blk.mlp is None:
            raise RuntimeError("model not initialized: call compile() or "
                               "run one forward first")
        a, mlp = blk.attn, blk.mlp
        p = dict(
            ln1_s=w(blk.ln1.scale), ln1_b=w(blk.ln1.bias),
            wq=w(a.q_proj.W), bq=w(a.q_proj.b),
            wk=w(a.k_proj.W), bk=w(a.k_proj.b),
            wv=w(a.v_proj.W), bv=w(a.v_proj.b),
            wo=w(a.out_proj.W), bo=w(a.out_proj.b),
            ln2_s=w(blk.ln2.scale), ln2_b=w(blk.ln2.bias))
        if hasattr(mlp, "Wg"):  # a MoEFFN block
            p.update(moe_wg=w(mlp.Wg), moe_w1=w(mlp.W1), moe_b1=w(mlp.b1),
                     moe_w2=w(mlp.W2), moe_b2=w(mlp.b2),
                     moe_top_k=mlp.top_k)
        else:
            p.update(w1=w(mlp.fc1.W), b1=w(mlp.fc1.b),
                     w2=w(mlp.fc2.W), b2=w(mlp.fc2.b))
        blocks.append(p)
    head = None if m.cfg.tie_weights else w(m.lm_head.W)
    return dict(wte=w(t.wte.W), wpe=w(t.wpe.W), blocks=blocks,
                lnf_s=w(t.ln_f.scale), lnf_b=w(t.ln_f.bias), head=head)


def _ln(x, s, b, eps):
    """LayerNorm over the last axis; PyTorch keeps the statistics in
    float32 for bf16 inputs, as ``_ln`` of the JAX package does."""
    return F.layer_norm(x, (x.shape[-1],), s, b, eps)


def _linear(x, w, b):
    """``x @ w + b``, the bias added in the product's epilogue."""
    y = torch.addmm(b, x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _row_linear(x, w, b, group):
    """A row-parallel product ``x @ w + b``: with a tensor-parallel
    ``group`` (the block's ``"tp"`` entry, set by ``serve/tp.py``'s
    placement) ``x`` and ``w`` are this rank's input-dim slices, the
    partial product is all-reduced over the group and the bias added
    after the sum (the JAX package's ``_tp_psum`` sites); without one it
    is :func:`_linear`, the single-device path unchanged."""
    if group is None:
        return _linear(x, w, b)
    from ..parallel.communicator import group_all_reduce

    y = x.reshape(-1, x.shape[-1]) @ w
    group_all_reduce(y, group, op="tp_psum")
    return (y + b).reshape(*x.shape[:-1], w.shape[-1])


def _mlp(h, p):
    """The block's FFN: dense (fc2 row-parallel under a ``"tp"`` group),
    or the experts of a MoE block (expert-parallel under an ``"ep"``
    context, ``serve/ep.py``)."""
    if "moe_wg" in p:
        if p.get("ep") is not None:
            return _moe_ffn_ep(h, p, p["moe_top_k"], p["ep"])
        if p.get("tp") is not None:
            raise NotImplementedError(
                "MoE blocks are not tensor-parallel: expert weights shard "
                "over the expert axis; serve this model with "
                "model.serve(ep=EPConfig(ep=, tp=)) "
                "(singa_tpu_torch/serve/ep.py)")
        return _moe_ffn(h, p, p["moe_top_k"])
    return _row_linear(F.gelu(_linear(h, p["w1"], p["b1"]),
                              approximate="tanh"),
                       p["w2"], p["b2"], p.get("tp"))


def _moe_weights(probs, top_k):
    """Per-token combine weights (…, E) from the router softmax
    ``probs`` (float32), zero but at the top-k experts: top-1 keeps the
    chosen probability (Switch), top-2 renormalizes the two gates to sum
    to 1 (GShard), as ``parallel/moe.py`` gates when nothing drops."""
    if top_k not in (1, 2):
        raise ValueError("moe_top_k must be 1 (Switch) or 2 (GShard), "
                         f"got {top_k}")
    e = probs.shape[-1]
    m1 = _one_hot(probs.argmax(-1), e, probs.dtype)
    g1 = (probs * m1).sum(-1)
    if top_k == 1:
        return m1 * g1[..., None]
    p2 = probs * (1.0 - m1)
    m2 = _one_hot(p2.argmax(-1), e, probs.dtype)
    g2 = (p2 * m2).sum(-1)
    den = g1 + g2
    den = torch.where(den <= 0.0, torch.ones_like(den), den)
    return m1 * (g1 / den)[..., None] + m2 * (g2 / den)[..., None]


def _moe_ffn(h, p, top_k):
    """Capacity-free MoE FFN for decode: each token goes to its top-k
    experts, a loop of per-expert products masked by the combine weights
    (memory O(B·S·F), not O(B·S·E·F)).  Decode has no capacity, so it
    drops nothing where training may."""
    probs = torch.softmax((h @ p["moe_wg"].to(h.dtype)).float(), dim=-1)
    w = _moe_weights(probs, top_k).to(h.dtype)
    y = torch.zeros_like(h)
    for e in range(p["moe_w1"].shape[0]):
        he = F.gelu(_linear(h, p["moe_w1"][e], p["moe_b1"][e]),
                    approximate="tanh")
        y = y + w[..., e:e + 1] * _linear(he, p["moe_w2"][e],
                                          p["moe_b2"][e])
    return y


class EPContext:
    """What an expert-parallel MoE block needs besides its weights (the
    block's ``"ep"`` entry, set by ``serve/ep.py``'s placement): the
    ``ep`` process ``group``, its ``world`` size and this rank's
    ``rank`` on it, the GShard ``capacity_factor`` (None: capacity =
    tokens, nothing drops), and the device accumulators of the routed
    load, ``counts`` (E,) and ``dropped`` (), which every application
    adds to in place, so a captured step keeps counting on replay.
    ``live``: the (lanes,) live flags of the decode step being run (its
    dead lanes' clamped tokens route like real ones but are not
    counted), or None to count every token (prefill passes)."""

    def __init__(self, group, world, rank, capacity_factor, n_expert,
                 device):
        self.group, self.world, self.rank = group, int(world), int(rank)
        self.capacity_factor = capacity_factor
        self.counts = torch.zeros(n_expert, dtype=torch.int64, device=device)
        self.dropped = torch.zeros((), dtype=torch.int64, device=device)
        self.live = None


def _moe_ffn_ep(h, p, top_k, ctx):
    """Expert-parallel MoE FFN (the JAX package's ``_moe_ffn_ep``): the
    router and the capacity-bounded dispatch run on every rank over the
    replicated activations (``parallel/moe.py``'s ``_top2_dispatch`` /
    ``_top1_dispatch``), each rank computes its resident experts'
    outputs (``p["moe_w*"]`` hold its E/world slice) through its columns
    of the dispatch and combine one-hots, and ONE all-reduce over the
    ``ep`` group sums each token's top-k contributions.  With
    ``capacity_factor`` None the capacity is the token count and nothing
    drops, so the output is ``_moe_ffn``'s up to the order of the sum; a
    finite factor drops over-capacity assignments to the residual path.
    The kept assignments per expert and the dropped ones add into
    ``ctx.counts`` / ``ctx.dropped``."""
    from ..parallel import moe as _moe
    from ..parallel.communicator import group_all_reduce

    if top_k not in (1, 2):
        raise ValueError("moe_top_k must be 1 (Switch) or 2 (GShard), "
                         f"got {top_k}")
    b, s, dm = h.shape
    n = b * s
    e = p["moe_wg"].shape[-1]
    probs = torch.softmax((h @ p["moe_wg"].to(h.dtype)).float(),
                          dim=-1).reshape(n, e)
    cf = ctx.capacity_factor
    cap = n if cf is None else max(1, int(math.ceil(top_k * n / e * cf)))
    route = _moe._top2_dispatch if top_k == 2 else _moe._top1_dispatch
    dispatch, combine, _ = route(probs, cap)
    kept = dispatch.sum(-1)                              # (n, E)
    drop = top_k - kept.sum(-1)                          # (n,)
    if ctx.live is not None:
        m = (ctx.live != 0).repeat_interleave(s).to(kept.dtype)
        kept, drop = kept * m[:, None], drop * m
    ctx.counts += torch.round(kept.sum(0)).long()
    ctx.dropped += torch.round(drop.sum()).long()
    e_loc = e // ctx.world
    lo = ctx.rank * e_loc
    d_l = dispatch[:, lo:lo + e_loc].to(h.dtype)
    c_l = combine[:, lo:lo + e_loc].to(h.dtype)
    ht = h.reshape(n, dm)
    xin = torch.einsum("nec,nd->ecd", d_l, ht)
    hh = F.gelu(torch.einsum("ecd,edf->ecf", xin, p["moe_w1"])
                + p["moe_b1"][:, None, :], approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", hh, p["moe_w2"]) \
        + p["moe_b2"][:, None, :]
    y = torch.einsum("nec,ecd->nd", c_l, out)
    group_all_reduce(y, ctx.group, op="ep_psum")
    return y.reshape(b, s, dm)


def _logits(x, params):
    head = params["head"]
    return x @ (params["wte"].t() if head is None else head)


def _attn_full(q, k, v, n_head, window=None):
    """Causal attention over a (B, S, E) prefill block; GQA k/v arrive
    n_kv_head * D wide and each K/V head serves its query group.
    ``window``: the sliding band, query i sees keys (i - window, i]."""
    b, s, e = q.shape
    d = e // n_head
    n_kv = k.shape[-1] // d

    def heads(t, nh):
        return t.reshape(b, s, nh, d).transpose(1, 2).float()

    qh, kh, vh = heads(q, n_head), heads(k, n_kv), heads(v, n_kv)
    if n_kv != n_head:
        kh = kh.repeat_interleave(n_head // n_kv, dim=1)
        vh = vh.repeat_interleave(n_head // n_kv, dim=1)
    sc = qh @ kh.transpose(-1, -2) / math.sqrt(d)
    cm = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    if window is not None:
        cm = cm.triu(1 - window)
    sc = torch.where(cm, sc, torch.full_like(sc, NEG_INF))
    o = torch.softmax(sc, -1) @ vh
    return o.transpose(1, 2).reshape(b, s, e).to(q.dtype)


def _block_prefill(x, p, n_head, eps, window=None):
    """One layer of a prefill block; under a ``"tp"`` group the rank's
    heads (q's width over the head dim) and the out-projection's
    all-reduce."""
    h = _ln(x, p["ln1_s"], p["ln1_b"], eps)
    q = _linear(h, p["wq"], p["bq"])
    k = _linear(h, p["wk"], p["bk"])
    v = _linear(h, p["wv"], p["bv"])
    nq = q.shape[-1] // (x.shape[-1] // n_head)
    x = x + _row_linear(_attn_full(q, k, v, nq, window), p["wo"], p["bo"],
                        p.get("tp"))
    h = _ln(x, p["ln2_s"], p["ln2_b"], eps)
    return x + _mlp(h, p), k, v


def _roll_index(s, window, prompt_end, device):
    """Rolling-cache lane w <- prompt position ``pe - ((pe - w) % window)``
    (the last position < ``prompt_end`` congruent to w), clipped into
    [0, s): decode writes position p at lane p % window."""
    pe = (s if prompt_end is None else prompt_end) - 1
    w = torch.arange(window, device=device)
    return torch.clamp(pe - torch.remainder(pe - w, window), 0, s - 1)


def prefill(params, ids, n_head, eps, quant_cache=False, window=None,
            prompt_end=None, rolling=True):
    """ids (B, S) -> (hidden (B, S, E) after the final LN, k caches, v
    caches (L, B, H_kv, S, D); with ``quant_cache`` each a (values,
    scales) pair, ``_quantize_kv`` of the rows).  The caller takes the
    rows it needs before the vocab product.  ``window``: banded
    attention, and with ``rolling`` and S > window the caches are the
    ROLLING layout of ``window`` lanes (``_roll_index``; ``prompt_end``
    the prompt's length within a padded row, default S), as the JAX
    function returns them; ``rolling=False`` keeps the linear layout
    (the paged engine's)."""
    b, s = ids.shape
    pos = torch.arange(s, device=ids.device)
    x = params["wte"][ids.long()] + params["wpe"][pos][None]
    roll = None
    if window is not None and rolling and window < s:
        roll = _roll_index(s, window, prompt_end, ids.device)
    ks, vs = [], []
    for p in params["blocks"]:
        x, k, v = _block_prefill(x, p, n_head, eps, window)
        d = x.shape[-1] // n_head
        n_kv = k.shape[-1] // d
        kh = k.reshape(b, s, n_kv, d).transpose(1, 2)
        vh = v.reshape(b, s, n_kv, d).transpose(1, 2)
        if roll is not None:
            kh, vh = kh[:, :, roll], vh[:, :, roll]
        ks.append(kh)
        vs.append(vh)
    x = _ln(x, params["lnf_s"], params["lnf_b"], eps)
    kc, vc = torch.stack(ks), torch.stack(vs)
    if quant_cache:
        kc, vc = _quantize_kv(kc), _quantize_kv(vc)
    return x, kc, vc


def _block_decode(x, p, k_cache, v_cache, pos, n_head, eps, window=None):
    """x (B, 1, E) at positions ``pos`` (B,); k/v_cache (B, H_kv, ctx,
    D), or (values, scales) pairs.  Writes this step's K/V (quantized
    for int8 caches) at ``pos`` in place (the JAX function returns
    updated caches) and attends positions <= pos of each row.  GQA: the
    query block reshapes to (B, H_kv, g, D), so the cache is never
    repeated.  int8: scores are ``(q . k8) * kscale / sqrt(D)`` and the
    probabilities take ``vscale`` before the value product.  ``window``:
    a ROLLING cache of ``window`` lanes, position p in lane p % window;
    lane t holds position ``pos - ((pos - t) mod window)``, live when
    that is >= 0, so a token reads O(window) lanes however far it is."""
    quant = isinstance(k_cache, tuple)
    kq = k_cache[0] if quant else k_cache
    b, _, e = x.shape
    d = e // n_head
    n_kv, ctx = kq.shape[1], kq.shape[2]
    g = p["wq"].shape[-1] // d // n_kv
    if window is not None and ctx != window:
        raise ValueError(f"rolling cache width {ctx} != window {window}")
    h = _ln(x, p["ln1_s"], p["ln1_b"], eps)
    q = _linear(h, p["wq"], p["bq"]).reshape(b, n_kv, g, d)
    k_new = _linear(h, p["wk"], p["bk"]).reshape(b, n_kv, d)
    v_new = _linear(h, p["wv"], p["bv"]).reshape(b, n_kv, d)
    rows = torch.arange(b, device=x.device)
    lane = pos if window is None else torch.remainder(pos, window)
    if quant:
        k_new, v_new = _quantize_kv(k_new), _quantize_kv(v_new)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        for leaf, val in zip(_leaves(cache), _leaves(new)):
            leaf[rows, :, lane] = val.to(leaf.dtype)
    sc = torch.einsum("bkgd,bktd->bkgt", q.float(), kq.float())
    if quant:
        sc = sc * k_cache[1][:, :, None, :]
    sc = sc / math.sqrt(d)
    t = torch.arange(ctx, device=x.device)[None, :]
    if window is None:
        live = t <= pos[:, None]
    else:
        live = pos[:, None] - torch.remainder(pos[:, None] - t, window) >= 0
    sc = torch.where(live[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    pr = torch.softmax(sc, -1)
    if quant:
        pr = pr * v_cache[1][:, :, None, :]
    a = torch.einsum("bkgt,bktd->bkgd", pr, _leaves(v_cache)[0].float())
    x = x + _row_linear(a.reshape(b, 1, n_kv * g * d).to(x.dtype), p["wo"],
                        p["bo"], p.get("tp"))
    h = _ln(x, p["ln2_s"], p["ln2_b"], eps)
    return x + _mlp(h, p)


def decode_step(params, x, kc, vc, pos, n_head, eps, window=None):
    """One decode step through every block: x (B, 1, E) embedded inputs
    at positions ``pos`` (B,) against caches (L, B, H_kv, ctx, D), or
    (values, scales) pairs, which take this step's K/V in place
    (``window``: rolling caches of ``window`` lanes).  Returns ((B, V)
    logits, kc, vc)."""
    pos = torch.as_tensor(pos, device=x.device).long().reshape(-1)
    pos = pos.expand(x.shape[0])
    for li, p in enumerate(params["blocks"]):
        x = _block_decode(x, p, _cache_layer(kc, li), _cache_layer(vc, li),
                          pos, n_head, eps, window)
    x = _ln(x, params["lnf_s"], params["lnf_b"], eps)
    return _logits(x, params)[:, 0], kc, vc


def _block_chunk(x, p, k_cache, v_cache, pos, n_head, eps, window=None):
    """x (B, K, E): K consecutive tokens at positions pos..pos+K-1;
    k/v_cache (B, H_kv, ctx, D), or (values, scales) pairs, that hold
    K/V below ``pos``.  Writes the chunk's K/V (quantized for int8
    caches) at [pos, pos+K) in place and attends query i to positions
    <= pos + i (and > pos + i - ``window``: the band on a LINEAR cache).
    ``pos`` a host int: reads lanes < pos + K only, so the result does
    not depend on the cache's width (the prefix cache's canonical form).
    ``pos`` a (B,) tensor (the slot arena's speculative verify, each row
    at its own position): reads every lane under a per-row mask, and
    nothing is read on the host.  Scores and softmax in float32, as
    ``_block_decode``; GQA through the same grouped layout."""
    quant = isinstance(k_cache, tuple)
    kq = k_cache[0] if quant else k_cache
    b, klen, e = x.shape
    d = e // n_head
    n_kv = kq.shape[1]
    g = p["wq"].shape[-1] // d // n_kv
    dev = x.device
    ar = torch.arange(klen, device=dev)
    h = _ln(x, p["ln1_s"], p["ln1_b"], eps)
    q = _linear(h, p["wq"], p["bq"]).reshape(b, klen, n_kv, g, d) \
        .permute(0, 2, 3, 1, 4)                         # (B, kv, g, K, d)
    k_new = _linear(h, p["wk"], p["bk"]).reshape(b, klen, n_kv, d) \
        .transpose(1, 2)                                # (B, kv, K, d)
    v_new = _linear(h, p["wv"], p["bv"]).reshape(b, klen, n_kv, d) \
        .transpose(1, 2)
    if quant:
        k_new, v_new = _quantize_kv(k_new), _quantize_kv(v_new)
    if torch.is_tensor(pos):
        end = kq.shape[2]
        qpos = pos.long()[:, None] + ar                 # (B, K)
        rows = torch.arange(b, device=dev)[:, None]
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            for leaf, val in zip(_leaves(cache), _leaves(new)):
                leaf[rows, :, qpos] = val.movedim(2, 1).to(leaf.dtype)
        qpos = qpos[:, :, None]                         # (B, K, 1)
    else:
        end = pos + klen
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            for leaf, val in zip(_leaves(cache), _leaves(new)):
                leaf[:, :, pos:end] = val.to(leaf.dtype)
        qpos = (pos + ar)[None, :, None]
    t = torch.arange(end, device=dev)
    live = t <= qpos
    if window is not None:
        live = live & (t > qpos - window)
    live = live[:, None, None]                          # (B|1, 1, 1, K, t)
    sc = torch.einsum("bkgqd,bktd->bkgqt", q.float(), kq[:, :, :end].float())
    if quant:
        sc = sc * k_cache[1][:, :, None, None, :end]
    sc = sc / math.sqrt(d)
    sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
    pr = torch.softmax(sc, -1)
    if quant:
        pr = pr * v_cache[1][:, :, None, None, :end]
    a = torch.einsum("bkgqt,bktd->bkgqd", pr,
                     _leaves(v_cache)[0][:, :, :end].float())
    a = a.permute(0, 3, 1, 2, 4).reshape(b, klen, n_kv * g * d).to(x.dtype)
    x = x + _row_linear(a, p["wo"], p["bo"], p.get("tp"))
    h = _ln(x, p["ln2_s"], p["ln2_b"], eps)
    return x + _mlp(h, p)


def prefill_chunk(params, x, kc, vc, pos, n_head, eps, window=None):
    """Offset prefill, the prefix cache's contract: advance every layer
    by a K-token chunk, ``x`` (B, K, E) embedded inputs at positions
    ``pos..pos+K-1``, against caches (L, B, H_kv, ctx, D) (or int8
    pairs) that hold K/V for positions < ``pos``; the chunk's K/V rows
    are written at ``pos`` in place (``window``: the sliding band on the
    linear layout).  Returns ``((B, K, E) final-LN hidden, kc, vc)``:
    hidden, not logits, so a caller projects only the row it samples
    from.

    The serve engine prefills every admission of an engine with a prefix
    cache or a chunked-prefill budget in block-width chunks of this
    function from a zero row; a chunk at a host ``pos`` reads the
    cache's lanes below ``pos + K`` only, so its output depends on the
    chunk's tokens and the K/V below ``pos`` alone, whatever the row's
    width, which is what makes a warm admission's stream the cold one
    (``serve/prefix.py``) and a budgeted one the unbudgeted one.  A
    (B,) tensor ``pos`` puts each row at its own position
    (``_block_chunk``)."""
    for li, p in enumerate(params["blocks"]):
        x = _block_chunk(x, p, _cache_layer(kc, li), _cache_layer(vc, li),
                         pos, n_head, eps, window)
    return _ln(x, params["lnf_s"], params["lnf_b"], eps), kc, vc


def _paged_qkv(x, p, n_head, eps):
    """LN and projections of (S, Q, E) inputs -> q (S, n_kv, g, Q, D), k
    and v (S, n_kv, Q, D); n_kv read off the weights' widths."""
    s_, nq, e = x.shape
    d = e // n_head
    h = _ln(x, p["ln1_s"], p["ln1_b"], eps)
    q = _linear(h, p["wq"], p["bq"])
    k = _linear(h, p["wk"], p["bk"])
    v = _linear(h, p["wv"], p["bv"])
    n_kv = k.shape[-1] // d
    g = q.shape[-1] // (n_kv * d)
    q = q.reshape(s_, nq, n_kv, g, d).permute(0, 2, 3, 1, 4)
    k = k.reshape(s_, nq, n_kv, d).transpose(1, 2)
    v = v.reshape(s_, nq, n_kv, d).transpose(1, 2)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _block_paged(x, p, pool_k_l, pool_v_l, tables, pos, n_head, eps,
                 write_at, window):
    """One layer of every slot's Q query positions against the pool: x
    (S, Q, E) at positions ``pos..pos+Q-1`` (``pos`` (S,) int32), one
    layer's pools (N + 1, H_kv, B, D), or (int8 values, float32 scales
    (N + 1, H_kv, B)) pairs, ``tables`` (S, W // B) int32.  Attention
    runs through ``paged_attn`` over each slot's pool lanes < pos plus
    its own Q K/V lanes (quantized on int8 pools; q stays in the compute
    dtype) under ``write_at``'s ``cur_mask`` (Q, Q): ones for a decode
    step, tril for a speculative verify chunk (banded under a
    ``window``).  Then the chunk's K/V rows are written in place at
    ``write_at`` = (blocks (S, Q), offsets (S, Q), cur_mask), every
    leaf: Q <= B, so a chunk touches one or two blocks; a dead slot
    (all-trash table, pos 0) writes the trash block.  (The JAX functions
    ``_block_decode_paged`` and ``_block_chunk_paged`` return the one or
    two blocks with the rows inserted, which their callers scatter.)"""
    s_, nq, e = x.shape
    d = e // n_head
    q, k_new, v_new = _paged_qkv(x, p, n_head, eps)
    if isinstance(pool_k_l, tuple):
        k_cur, v_cur = _quantize_kv(k_new), _quantize_kv(v_new)
    else:
        dt = pool_k_l.dtype
        q, k_cur, v_cur = q.to(dt), k_new.to(dt), v_new.to(dt)
    blk, off, cur_mask = write_at
    a = paged_attn(q, pool_k_l, pool_v_l, tables, pos, k_cur, v_cur,
                   cur_mask, 1.0 / math.sqrt(d), window)
    a = a.to(x.dtype).permute(0, 3, 1, 2, 4).reshape(s_, nq, -1)
    x = x + _row_linear(a, p["wo"], p["bo"], p.get("tp"))
    h = _ln(x, p["ln2_s"], p["ln2_b"], eps)
    x = x + _mlp(h, p)
    for pool, cur in ((pool_k_l, k_cur), (pool_v_l, v_cur)):
        for leaf, val in zip(_leaves(pool), _leaves(cur)):
            leaf[blk, :, off] = val.movedim(2, 1)
    return x


def _paged_layers(params, x, pool_k, pool_v, tables, pos, n_head, eps,
                  block, window):
    """Every layer of (S, Q, E) inputs at ``pos..pos+Q-1`` against the
    pools: (S, Q, E) hidden after the final LN."""
    nq = x.shape[1]
    qp = pos.long()[:, None] + torch.arange(nq, device=x.device)
    cur_mask = torch.ones((nq, nq), dtype=torch.bool,
                          device=x.device).tril()
    if window is not None:
        cur_mask = cur_mask.triu(1 - window)
    write_at = (tables.long().gather(1, qp // block), qp % block, cur_mask)
    for li, p in enumerate(params["blocks"]):
        x = _block_paged(x, p, _cache_layer(pool_k, li),
                         _cache_layer(pool_v, li), tables, pos, n_head, eps,
                         write_at, window)
    return _ln(x, params["lnf_s"], params["lnf_b"], eps)


def decode_step_paged(params, x, pool_k, pool_v, tables, pos, n_head, eps,
                      *, block, window=None):
    """The paged serve engine's decode step: x (S, 1, E) embedded inputs
    at ``pos`` (S,) int32, pools (L, N + 1, H_kv, B, D) (or int8
    (values, scales) pairs), ``tables`` (S, W // B) int32 trash-padded.
    One ``paged_attn`` launch per layer for all slots, which finds the
    blocks to read from ``pos`` on the device; the pools take the step's
    K/V in place.  ``window``: the sliding band on the linear layout
    (the engine's tables hold the trash block where a slot dropped a
    block that left its window); the kernel reads from table entry 0 and
    skips each slot's dead lanes from ``pos`` on the device.  Nothing
    reads a device value on the host, so the step can be captured in a
    CUDA graph.  Returns (S, V) logits."""
    x = _paged_layers(params, x, pool_k, pool_v, tables, pos, n_head, eps,
                      block, window)
    return _logits(x, params)[:, 0]


def chunk_step_paged(params, x, pool_k, pool_v, tables, pos, n_head, eps,
                     *, block, window=None):
    """The speculative verify against the pool: x (S, K, E) embedded
    chunks at ``pos..pos+K-1`` (K <= ``block``).  Pool lanes < pos are
    visible to every query and the chunk's own keys are causal (a tril
    ``cur_mask``, banded under a ``window``): one ``paged_attn`` launch a
    layer at Q = K for all slots.  The chunk's K/V rows land in the one
    or two blocks it spans.  Returns (S, K, V) logits."""
    x = _paged_layers(params, x, pool_k, pool_v, tables, pos, n_head, eps,
                      block, window)
    return _logits(x, params)


# ----------------------------------------------------------------- sampling


def _filter_logits(logit, temperature, top_p, top_k, min_p=None):
    """Temperature, top-k, top-p and min-p filtered float32 logits (N,
    V), in the JAX ``_sample``'s order; ``temperature`` a float or an
    (N, 1) tensor; ``top_k`` 0, ``top_p`` None and ``min_p`` None are
    off.  min-p keeps p >= min_p * p_max, i.e. logit >= max + ln(min_p)."""
    logit = logit.float() / temperature
    if top_k:
        kth = torch.topk(logit, top_k, dim=-1).values[..., -1:]
        logit = torch.where(logit < kth, torch.full_like(logit, NEG_INF),
                            logit)
    if top_p is not None:
        srt, order = torch.sort(logit, dim=-1, descending=True)
        sp = torch.softmax(srt, -1)
        # smallest prefix with mass >= top_p: drop tokens whose
        # preceding mass already reached it (the top token always stays)
        keep_sorted = (sp.cumsum(-1) - sp) < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        logit = torch.where(keep, logit, torch.full_like(logit, NEG_INF))
    if min_p is not None:
        floor = logit.amax(-1, keepdim=True) + math.log(min_p)
        logit = torch.where(logit < floor, torch.full_like(logit, NEG_INF),
                            logit)
    return logit


def _rep_mask_init(rows, vocab, device):
    """(N, V) bool presence mask of each row's prompt tokens: the tokens
    the repetition penalty applies to before anything is emitted."""
    mask = torch.zeros((len(rows), vocab), dtype=torch.bool, device=device)
    for i, r in enumerate(rows):
        mask[i, torch.as_tensor(np.asarray(r, np.int64), device=device)] = True
    return mask


def _penalize(logits, rep_mask, rep_penalty):
    """CTRL / HF repetition penalty: the logits of tokens already in the
    sequence (``rep_mask``) are divided by ``rep_penalty`` when positive
    and multiplied by it when negative."""
    pen = torch.where(logits > 0, logits / rep_penalty,
                      logits * rep_penalty)
    return torch.where(rep_mask, pen, logits)


def _on(x, dtype, device):
    """``x`` (a tensor, an array or a list) as a ``dtype`` tensor on
    ``device``; a tensor already there is not copied."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x), device=device)
    return x.to(device=device, dtype=dtype)


def keys_on(keys, device):
    """Sampling keys ``keys`` (N, 2) (host ``uint32`` words, or an int
    tensor of words, int32 read as unsigned) as an int tensor on
    ``device``; a tensor already there is not copied."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device)
    return prng.key_words(keys, device)


def _sample(logits, temps, keys, top_k=0, top_p=None, min_p=None,
            rep_mask=None, rep_penalty=None, mask=None):
    """One token per row of (N, V) logits.  ``mask`` (N, V) bool is a
    structured request's vocabulary mask: a False lane drops to
    ``NEG_INF`` before everything else, the greedy argmax included
    (None, or an all-True row, leaves the row's bits as they were).
    With ``rep_mask`` (N, V) bool, the repetition penalty applies next,
    before the greedy argmax too.  Then greedy (argmax of the float32
    logits) where ``temps[i] <= 0``, else ``categorical(keys[i], filtered
    logits)``: the argmax of the filtered logits (temperature, top-k,
    top-p, min-p) plus ``gumbel(keys[i], (V,))``, the JAX ``_sample``'s
    draw.  ``temps`` (N,) and ``keys`` (N, 2) (:func:`keys_on`) are
    device tensors or host arrays; ``keys`` None: every row is greedy
    and nothing is drawn (the JAX ``generate``'s static ``greedy``).  Every row is filtered and drawn and
    the two results are selected per row, so the ops have fixed shapes
    and the serve engine's captured decode step samples inside its graph
    (the JAX engine draws for greedy rows too).  Returns an (N,) int64
    tensor on the logits' device."""
    n, vocab = logits.shape
    dev = logits.device
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    if rep_mask is not None:
        logits = _penalize(logits, rep_mask, rep_penalty)
    if keys is None:
        return logits.argmax(-1)
    temps = _on(temps, torch.float32, dev).reshape(n)
    hot = temps > 0
    t = torch.where(hot, temps, torch.ones_like(temps))[:, None]
    filt = _filter_logits(logits, t, top_p, top_k, min_p)
    drawn = prng.categorical_t(keys_on(keys, dev).reshape(n, 2), filt)
    return torch.where(hot, drawn, logits.argmax(-1))


def chosen_logprob(logits, toks):
    """(N,) float32 log-probability of ``toks`` (N,) under the raw
    float32 softmax of (N, V) ``logits``, not the filtered or masked
    distribution they were drawn from: a fork branch's score (the JAX
    engine's ``log_softmax(logits)[nxt]``).  An output only; nothing
    samples from it."""
    lp = torch.log_softmax(logits.float(), -1)
    return lp.gather(-1, toks.long()[:, None])[:, 0]


def _first_false(ok):
    """(N,) index of the first False of each row of (N, M) bool, M when
    none (the JAX package's ``argmin`` over the row and one False)."""
    stop = torch.cat([~ok, torch.ones_like(ok[:, :1])], 1)
    return stop.int().argmax(-1)


def spec_verify(t_logits, d_probs, props, temps, k_acc, k_fix, top_k=0,
                top_p=None):
    """The verify of a speculative chunk for every row: ``t_logits`` (S,
    K, V) target logits at positions pos..pos+K-1, ``d_probs`` (S, K-1,
    V) the filtered draft distributions the proposals ``props`` (S, K-1)
    were drawn from, ``temps`` (S,) float32, ``k_acc`` and ``k_fix`` (S,
    2) each row's keys of the accept test and the correction token (the
    JAX ``split(k_verify)``; :func:`keys_on`).  Returns ``(out (S, K) int64,
    a_draft (S,) int64)``: ``out[:, :a]`` echo the accepted proposals,
    ``out[:, a]`` is the correction token (a resample of the residual,
    or the bonus token on a full accept), the rest is not to be emitted;
    a row emits ``a_draft + 1`` tokens.

    Greedy rows (``temps <= 0``) accept while a proposal is the target's
    argmax and emit the target's argmax where they stop: the stream of
    sequential greedy decoding.  Sampled rows accept proposal i with
    probability min(1, p_i / q_i) of the filtered target and draft
    distributions, resample the normalized residual max(0, p - q) at the
    first rejection, and draw the bonus token from the last position's
    target distribution (the residual against a zero q row), so every
    emitted token is distributed as direct target sampling.  ``p == q``
    leaves no residual mass, and p itself is drawn from then.  The
    accept test draws ``uniform(k_acc, (K - 1,))`` and the correction
    token ``categorical(k_fix, log residual)``.  Every row runs
    both branches and selects, so the step has fixed shapes and is
    captured with the engine's speculative step (the JAX function does
    one row under ``vmap``)."""
    s_, k, vocab = t_logits.shape
    t_logits = t_logits.float()
    cands = t_logits.argmax(-1)
    a_greedy = _first_false(props == cands[:, :-1])
    hot = temps > 0
    t = torch.where(hot, temps, torch.ones_like(temps))
    filt = _filter_logits(t_logits.reshape(s_ * k, vocab),
                          t[:, None].expand(s_, k).reshape(-1, 1), top_p,
                          top_k)
    p = torch.softmax(filt, -1).reshape(s_, k, vocab)
    d_probs = d_probs.float()
    q = torch.cat([d_probs, torch.zeros_like(p[:, :1])], 1)
    dev = t_logits.device
    u = prng.uniform_t(keys_on(k_acc, dev), k - 1)
    p_prop = p[:, :-1].gather(-1, props[..., None])[..., 0]
    q_prop = d_probs.gather(-1, props[..., None])[..., 0]
    # u < p / q without the division: q == 0 accepts iff p > 0, p >= q
    # always
    a_sampled = _first_false(u * q_prop < p_prop)
    at = a_sampled[:, None, None].expand(s_, 1, vocab)
    p_at, q_at = p.gather(1, at)[:, 0], q.gather(1, at)[:, 0]
    res = torch.clamp(p_at - q_at, min=0.0)
    mass = res.sum(-1, keepdim=True)
    res = torch.where(mass > 0, res / torch.clamp(mass, min=1e-38), p_at)
    fix = prng.categorical_t(keys_on(k_fix, dev),
                             torch.log(torch.clamp(res, min=1e-38)))
    out_s = torch.cat([props, torch.zeros_like(props[:, :1])], 1)
    out_s = out_s.scatter(1, a_sampled[:, None], fix[:, None])
    return (torch.where(hot[:, None], out_s, cands),
            torch.where(hot, a_sampled, a_greedy))


# ----------------------------------------------------------------- generate


def _is_batch(prompt_ids):
    if isinstance(prompt_ids, (list, tuple)):
        return len(prompt_ids) > 0 and not np.isscalar(prompt_ids[0])
    return np.asarray(prompt_ids).ndim == 2


def _seed(temperature, rng):
    """The sampling seed when none is given: 0 for greedy (nothing is
    drawn), else one draw from ``rng`` (a numpy RandomState or
    Generator; a fresh draw when None), as the JAX package does."""
    if temperature <= 0:
        return 0
    if rng is None:
        return int(np.random.randint(0, 2 ** 31 - 1))
    if hasattr(rng, "integers"):
        return int(rng.integers(0, 2 ** 31 - 1))
    return int(rng.randint(0, 2 ** 31 - 1))


def _check_sampling(top_k, top_p, vocab, min_p=None,
                    repetition_penalty=None):
    """The JAX package's typed checks of the sampling arguments; returns
    ``top_k`` clamped to the vocabulary (wider means no filter)."""
    if top_k and top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if min_p is not None and not 0.0 < min_p <= 1.0:
        raise ValueError(f"min_p must be in (0, 1], got {min_p}")
    if repetition_penalty is not None and repetition_penalty <= 0.0:
        raise ValueError(f"repetition_penalty must be > 0, "
                         f"got {repetition_penalty}")
    return min(int(top_k or 0), vocab)


def generate(m, prompt_ids, max_new_tokens=20, temperature=1.0, rng=None,
             top_k=0, top_p=None, min_p=None, repetition_penalty=None,
             seed=None, dtype=None, cache_dtype=None):
    """KV-cached sampling for a ``GPT2LMHead`` on the model's device.

    ``prompt_ids``: one 1-D prompt (returns a 1-D int32 array, prompt +
    continuation) or a list / 2-D batch, possibly ragged (returns a
    list).  Each row is prefilled at its own length (rows of one length
    together), then all rows decode in lockstep, each at its own
    position, against one dense cache.  ``repetition_penalty`` (CTRL /
    HF: over the whole sequence so far, prompt included) applies before
    the greedy argmax too.  ``temperature <= 0`` is greedy; otherwise
    ``top_k`` / ``top_p`` / ``min_p`` filter the tempered distribution
    and ``seed`` keys the noise (module docstring): an int keys the rows
    ``split(PRNGKey(seed), B)`` as the JAX ``generate`` does (default
    one draw from ``rng``), one seed a row keys row i ``split(PRNGKey(
    seed[i]), 1)[0]``, the key of a one-prompt ``generate`` and of a
    serve request at that seed.  ``dtype`` casts the
    weights (``torch.bfloat16`` for bf16 inference).  ``cache_dtype=
    "int8"`` keeps the cache as int8 (values, scales) (module
    docstring).  A sliding-window model decodes from a rolling cache of
    ``attn_window`` lanes (module docstring).  Requires prompt +
    ``max_new_tokens`` <= ``n_positions``: ``GPT2LMHead.generate`` takes
    longer generations on its windowed path."""
    cfg = m.cfg
    quant = _quant_flag(cache_dtype)
    single = not _is_batch(prompt_ids)
    rows = [np.asarray(r, np.int32).reshape(-1)
            for r in ([prompt_ids] if single else list(prompt_ids))]
    for r in rows:
        if len(r) + max_new_tokens > cfg.n_positions:
            raise ValueError(f"prompt ({len(r)}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds n_positions "
                             f"({cfg.n_positions}); use the windowed "
                             f"GPT2LMHead.generate")
    if max_new_tokens <= 0:
        out = [r.copy() for r in rows]
        return out[0] if single else out
    top_k = _check_sampling(top_k, top_p, cfg.vocab_size, min_p,
                            repetition_penalty)
    rep = (repetition_penalty if repetition_penalty not in (None, 1.0)
           else None)
    if seed is None:
        seed = _seed(temperature, rng)
    keys = row_keys(seed, len(rows))
    temps = np.full(len(rows), temperature, np.float32)
    was_training = m.training
    m.eval()
    try:
        with torch.no_grad():
            new = _generate_rows(extract_params(m, dtype), rows,
                                 max_new_tokens, cfg, temps, keys,
                                 dict(top_k=top_k, top_p=top_p,
                                      min_p=min_p, rep_penalty=rep),
                                 quant)
    finally:
        m.train(was_training)
    out = [np.concatenate([r, new[i]]).astype(np.int32)
           for i, r in enumerate(rows)]
    return out[0] if single else out


def row_keys(seed, n):
    """(n, 2) ``uint32`` first keys of ``n`` rows: ``split(PRNGKey(seed),
    n)`` for an int ``seed``, ``split(PRNGKey(seed[i]), 1)[0]`` for one
    seed a row (what the JAX package's ``generate`` of that row alone and
    its serve engine's admission key the row with)."""
    if np.ndim(seed) == 0:
        return prng.split(prng.PRNGKey(int(seed)), n)
    seeds = list(np.asarray(seed).reshape(-1))
    if len(seeds) != n:
        raise ValueError(f"{len(seeds)} seeds for {n} rows")
    return np.stack([prng.split(prng.PRNGKey(int(s)), 1)[0] for s in seeds])


def kv_zeros(shape, dtype, quant, device):
    """A zero cache of ``shape`` (..., ctx, D): a ``dtype`` tensor, or
    with ``quant`` the (int8 values, float32 scales (..., ctx)) pair."""
    if quant:
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def _prefill_rows(params, rows, n_new, cfg, quant=False):
    """Prefill of ragged prompts ``rows`` into one dense cache, each row
    at its own length (rows of one length together), its K/V at lanes
    [0, len) of a cache as wide as the longest prompt + ``n_new``
    (windowed models: the rolling cache of ``attn_window`` lanes).
    Returns (kc, vc (L, B, H_kv, ctx, D), or int8 pairs with ``quant``;
    each row's last-position logits (B, V) float32; the lengths)."""
    n_head, eps = cfg.n_head, float(cfg.layer_norm_eps)
    window = _norm_window(cfg)
    dev = params["wte"].device
    b = len(rows)
    lens = np.asarray([len(r) for r in rows], np.int64)
    ctx = int(lens.max()) + n_new if window is None else window
    d = cfg.n_embd // n_head
    shape = (cfg.n_layer, b, cfg.n_kv_head, ctx, d)
    kc = kv_zeros(shape, params["wte"].dtype, quant, dev)
    vc = kv_zeros(shape, params["wte"].dtype, quant, dev)
    first = torch.empty((b, cfg.vocab_size), device=dev)
    for plen in sorted(set(lens.tolist())):
        sel = np.flatnonzero(lens == plen)
        ids = torch.as_tensor(np.stack([rows[i] for i in sel]), device=dev)
        hidden, k, v = prefill(params, ids, n_head, eps, quant_cache=quant,
                               window=window)
        idx = torch.as_tensor(sel, device=dev)
        for cache, new in ((kc, k), (vc, v)):
            for leaf, val in zip(_leaves(cache), _leaves(new)):
                leaf[:, idx, :, :val.shape[3]] = val
        first[idx] = _logits(hidden[:, plen - 1], params).float()
    return kc, vc, first, lens


def _generate_rows(params, rows, n_new, cfg, temps, keys, filters,
                   quant=False):
    """``keys`` (B, 2) ``uint32``: each row's first key, split every step
    (sample with the first half, carry the second); ``filters``:
    ``_sample``'s ``top_k``, ``top_p``, ``min_p`` and ``rep_penalty``
    (None: no penalty); ``quant``: int8 caches."""
    n_head, eps = cfg.n_head, float(cfg.layer_norm_eps)
    window = _norm_window(cfg)
    dev = params["wte"].device
    b = len(rows)
    kc, vc, first, lens = _prefill_rows(params, rows, n_new, cfg, quant)
    if filters["rep_penalty"] is not None:
        filters = dict(filters,
                       rep_mask=_rep_mask_init(rows, cfg.vocab_size, dev))
    rows_t = torch.arange(b, device=dev)
    pos = lens.copy()
    toks = np.empty((b, n_new), np.int64)

    greedy = bool((temps <= 0).all())

    def sample(logits, j):
        nonlocal keys
        step = None
        if not greedy:
            ks = prng.split(keys)
            step, keys = ks[:, 0], ks[:, 1]
        nxt = _sample(logits, temps, step, **filters)
        toks[:, j] = nxt.cpu().numpy()
        if "rep_mask" in filters:  # the emitted tokens join the sequence
            filters["rep_mask"][rows_t, nxt] = True

    sample(first, 0)
    for j in range(1, n_new):
        pos_t = torch.as_tensor(pos, device=dev)
        tok_t = torch.as_tensor(toks[:, j - 1], device=dev)
        x = (params["wte"][tok_t] + params["wpe"][pos_t])[:, None]
        logits, kc, vc = decode_step(params, x, kc, vc, pos_t, n_head, eps,
                                     window)
        pos += 1
        sample(logits, j)
    return toks


def _top_k(x, k, tie):
    """The ``k`` largest of each row of ``x`` and their indices, largest
    first; among equal values the larger ``tie`` first, then the lower
    index (``jax.lax.top_k``'s order).  A beam's total is its score plus
    a log-probability, sums in which float32 rounding can make two
    tokens equal whose logits differ; ``tie`` (the raw logits) orders
    them as greedy decoding's argmax does, so one beam is greedy decoding
    token for token at any vocabulary size."""
    idx = torch.sort(tie, dim=-1, descending=True, stable=True).indices
    vals, order = torch.sort(x.gather(-1, idx), dim=-1, descending=True,
                             stable=True)
    return vals[..., :k], idx.gather(-1, order[..., :k])


def _beam_search(params, rows, n_new, cfg, num_beams, quant=False):
    """Fixed-length beam search over ragged prompts ``rows`` (the JAX
    ``_beam_search_cached``): each row is prefilled at its own length,
    its cache row repeated ``num_beams`` times, and the B·K rows advance
    in lockstep through ``decode_step``, each at its own position (the
    JAX function left-pads to one end position; the attention sees the
    same keys).  Each step keeps every prompt's K best of its K·V
    candidates by total log-probability and reorders the cache rows by
    parent with one block-diagonal gather (row b·K + parent), so beams
    never mix prompts.  With ``num_beams`` > V the beams past V start
    dead, at ``NEG_INF``.  Returns ((B, K, n_new) int64 tokens, (B, K)
    float32 total log-probabilities), best beam first."""
    n_head, eps = cfg.n_head, float(cfg.layer_norm_eps)
    window = _norm_window(cfg)
    dev = params["wte"].device
    b, K, V = len(rows), num_beams, cfg.vocab_size
    kc, vc, first, lens = _prefill_rows(params, rows, n_new, cfg, quant)
    k0 = min(K, V)
    top0, tok0 = _top_k(torch.log_softmax(first, -1), k0, first)
    scores = torch.cat([top0, torch.full((b, K - k0), NEG_INF, device=dev)],
                       1)
    toks = torch.cat([tok0, torch.zeros((b, K - k0), dtype=torch.long,
                                        device=dev)], 1)

    def reorder(c, rows_):
        out = tuple(t[:, rows_] for t in _leaves(c))
        return out if isinstance(c, tuple) else out[0]

    rep = torch.arange(b, device=dev).repeat_interleave(K)
    kc, vc = reorder(kc, rep), reorder(vc, rep)
    seqs = torch.zeros((b, K, n_new), dtype=torch.long, device=dev)
    seqs[:, :, 0] = toks
    pos = torch.as_tensor(np.repeat(lens, K), device=dev)
    base = (torch.arange(b, device=dev) * K)[:, None]
    for t in range(1, n_new):
        x = (params["wte"][toks.reshape(-1)] + params["wpe"][pos])[:, None]
        logits, kc, vc = decode_step(params, x, kc, vc, pos, n_head, eps,
                                     window)
        logits = logits.float()
        logp = torch.log_softmax(logits, -1).reshape(b, K, V)
        scores, flat = _top_k((scores[:, :, None] + logp).reshape(b, K * V),
                              K, logits.reshape(b, K * V))
        parents, toks = flat // V, flat % V
        seqs = seqs.gather(1, parents[:, :, None].expand(b, K, n_new))
        seqs[:, :, t] = toks
        glob = (base + parents).reshape(-1)
        kc, vc = reorder(kc, glob), reorder(vc, glob)
        pos = pos + 1
    return seqs, scores


def generate_beam(m, prompt_ids, max_new_tokens=20, num_beams=4,
                  dtype=None, cache_dtype=None):
    """Fixed-length beam search for a ``GPT2LMHead`` on the model's
    device: the continuation of ``max_new_tokens`` tokens with the
    highest total log-probability that ``num_beams`` beams find.  One
    1-D prompt (returns one int32 array, prompt + continuation) or a
    list / 2-D batch, possibly ragged (returns a list), all prompts'
    beams in one lockstep loop (:func:`_beam_search`).  ``num_beams=1``
    is greedy decoding.  ``dtype`` casts the weights; ``cache_dtype=
    "int8"`` keeps int8 caches; a sliding-window model decodes from its
    rolling cache.  No stop token: sequences are fixed-length, so a
    length penalty would cancel."""
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    cfg = m.cfg
    check_decodable(cfg)
    quant = _quant_flag(cache_dtype)
    single = not _is_batch(prompt_ids)
    rows = [np.asarray(r, np.int32).reshape(-1)
            for r in ([prompt_ids] if single else list(prompt_ids))]
    for r in rows:
        if len(r) + max_new_tokens > cfg.n_positions:
            raise ValueError(f"prompt ({len(r)}) + max_new_tokens "
                             f"({max_new_tokens}) exceeds n_positions "
                             f"({cfg.n_positions})")
    if max_new_tokens <= 0:
        out = [r.copy() for r in rows]
        return out[0] if single else out
    was_training = m.training
    m.eval()
    try:
        with torch.no_grad():
            seqs, _ = _beam_search(extract_params(m, dtype), rows,
                                   int(max_new_tokens), cfg, int(num_beams),
                                   quant)
    finally:
        m.train(was_training)
    seqs = seqs.cpu().numpy()
    out = [np.concatenate([r, seqs[i, 0]]).astype(np.int32)
           for i, r in enumerate(rows)]
    return out[0] if single else out


def _spec_row(t_params, d_params, ids, spec_k, n_new, t_static, d_static,
              quant):
    """Greedy speculative decoding of one prompt ``ids`` (1-D int array)
    with dense caches as wide as its generation needs.  Each chunk: the
    draft decodes ``spec_k`` tokens one by one from the last emitted
    token (the last of them only as an input, so a fully accepted chunk
    leaves the draft's cache one row ahead), the target advances the
    chunk of the last token and the ``spec_k - 1`` proposals in one
    ``prefill_chunk``, and the target's argmax tokens are emitted up to
    and including the first that differs from a proposal.  Rollback is
    free: both caches read only positions <= the query's, and the next
    chunk overwrites the rows a rejected proposal left.  Returns
    (``n_new`` tokens, chunks, accepted proposals)."""
    tn, te = t_static
    dn, de = d_static
    dev = t_params["wte"].device
    plen = len(ids)
    width = plen + n_new + spec_k - 1
    x = torch.as_tensor(np.asarray(ids, np.int64)[None], device=dev)

    def prefill_rows(params, n_head, eps):
        """Prefill ``ids`` into zero rows ``width`` lanes wide."""
        hidden, k, v = prefill(params, x, n_head, eps, quant_cache=quant)
        rows = []
        for c in (k, v):
            v0 = _leaves(c)[0]
            row = kv_zeros((*v0.shape[:3], width, v0.shape[4]),
                           params["wte"].dtype, quant, dev)
            for leaf, val in zip(_leaves(row), _leaves(c)):
                leaf[:, :, :, :plen] = val
            rows.append(row)
        return hidden, rows[0], rows[1]

    hidden, tk_row, tv_row = prefill_rows(t_params, tn, te)
    _, dk, dv = prefill_rows(d_params, dn, de)
    last = _logits(hidden[:, -1], t_params).argmax(-1)          # (1,)
    out = [int(last)]
    pos, chunks, accepted = plen, 0, 0
    ar = torch.arange(spec_k, device=dev)
    while len(out) < n_new:
        tok, props = last, []
        for i in range(spec_k):
            xd = (d_params["wte"][tok] + d_params["wpe"][pos + i])[:, None]
            lg, dk, dv = decode_step(d_params, xd, dk, dv, pos + i, dn, de)
            tok = lg.argmax(-1)
            props.append(tok)
        chunk = torch.cat([last] + props[:-1])
        xs = (t_params["wte"][chunk] + t_params["wpe"][pos + ar])[None]
        h, tk_row, tv_row = prefill_chunk(t_params, xs, tk_row, tv_row, pos,
                                          tn, te)
        cands = _logits(h, t_params)[0].argmax(-1).cpu().numpy()
        match = chunk[1:].cpu().numpy() == cands[:-1]
        a_draft = int(np.argmin(np.concatenate([match, [False]])))
        out.extend(cands[:a_draft + 1].tolist())
        last = torch.as_tensor(cands[a_draft:a_draft + 1], device=dev)
        pos += a_draft + 1
        chunks += 1
        accepted += a_draft
    return out[:n_new], chunks, accepted


def generate_speculative(target, draft, prompt_ids, max_new_tokens=20,
                         spec_k=4, dtype=None, cache_dtype=None):
    """Greedy speculative decoding: ``draft`` (a smaller ``GPT2LMHead``)
    proposes ``spec_k - 1`` tokens a chunk and ``target`` verifies the
    chunk in one cache pass; every emitted token is the target's greedy
    choice, so the stream is ``target.generate(prompt, temperature=0)``
    (at the same ``cache_dtype``) up to argmax near-ties, and the draft
    only changes the speed.  One 1-D prompt (returns one array) or a list
    of them, possibly ragged (returns a list), each decoded on its own.
    Returns ``(ids, stats)``: ids the prompt + continuation, stats
    ``acceptance_rate`` (the share of proposals the target kept; None
    when nothing was verified), ``chunks``, ``tokens_per_chunk`` and
    ``per_row_chunks``, as the JAX function's.  Greedy only (the serve
    engine samples speculatively: ``spec_verify``); sliding-window models
    are refused, as in the JAX package."""
    cfg_t, cfg_d = target.cfg, draft.cfg
    if cfg_t.vocab_size != cfg_d.vocab_size:
        raise ValueError(f"target/draft vocab mismatch: {cfg_t.vocab_size} "
                         f"vs {cfg_d.vocab_size}")
    for name, cfg in (("target", cfg_t), ("draft", cfg_d)):
        if getattr(cfg, "attn_window", None) is not None:
            raise NotImplementedError(
                f"speculative decoding does not support sliding-window "
                f"models ({name} has attn_window={cfg.attn_window})")
    if spec_k < 2:
        raise ValueError(f"spec_k must be >= 2, got {spec_k}")
    quant = _quant_flag(cache_dtype)
    single = not _is_batch(prompt_ids)
    rows = [np.asarray(r, np.int32).reshape(-1)
            for r in ([prompt_ids] if single else list(prompt_ids))]
    ctx = min(cfg_t.n_positions, cfg_d.n_positions)
    for r in rows:
        if len(r) + max_new_tokens + spec_k - 1 > ctx:
            raise ValueError(
                f"prompt ({len(r)}) + max_new_tokens ({max_new_tokens}) + "
                f"spec_k-1 ({spec_k - 1}) exceeds n_positions ({ctx})")
    if max_new_tokens <= 0:
        outs = [r.copy() for r in rows]
        stats = {"acceptance_rate": None, "chunks": 0,
                 "tokens_per_chunk": None, "per_row_chunks": [0] * len(rows)}
        return (outs[0] if single else outs), stats
    models = (target, draft)
    modes = [m.training for m in models]
    for m in models:
        m.eval()
    try:
        with torch.no_grad():
            t_params = extract_params(target, dtype)
            d_params = extract_params(draft, dtype)
            res = [_spec_row(t_params, d_params, r, int(spec_k),
                             int(max_new_tokens),
                             (cfg_t.n_head, float(cfg_t.layer_norm_eps)),
                             (cfg_d.n_head, float(cfg_d.layer_norm_eps)),
                             quant) for r in rows]
    finally:
        for m, mode in zip(models, modes):
            m.train(mode)
    chunks = [c for _, c, _ in res]
    total = sum(chunks)
    stats = {"acceptance_rate": (sum(a for _, _, a in res)
                                 / (total * (spec_k - 1)) if total else None),
             "chunks": total,
             "tokens_per_chunk": (len(rows) * (max_new_tokens - 1) / total
                                  if total else None),
             "per_row_chunks": chunks}
    outs = [np.concatenate([r, np.asarray(o, np.int32)]).astype(np.int32)
            for r, (o, _, _) in zip(rows, res)]
    return (outs[0] if single else outs), stats
