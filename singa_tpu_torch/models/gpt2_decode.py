"""KV-cached incremental decoding for GPT-2 (counterpart of
``singa_tpu/models/gpt2_decode.py``).

* ``prefill``: one causal forward over a prompt that also returns every
  layer's K/V, ``(L, B, H_kv, S, D)``;
* ``decode_step``: one token per row against a dense cache ``(L, B,
  H_kv, ctx, D)``, writing the step's K/V at each row's position; the
  offline ``generate`` loop, the serve engine's slot-arena step and its
  gather oracle;
* ``decode_step_paged``: one token for every slot of the serve engine
  against the paged pool ``(L, N + 1, H_kv, B, D)``, through the
  ``paged_attn`` kernel (``ops/paged_attention.py``), one launch per
  layer for all slots;
* ``_sample``: the repetition penalty, then greedy, or temperature /
  top-k / top-p / min-p filtering and a draw;
* ``generate``: prefill + decode loop for one prompt or a ragged batch.

The math follows the JAX module: float32 LayerNorm statistics, tanh gelu,
scale ``1/sqrt(D)``, GQA caches at ``n_kv_head`` heads with the query
group contracted against them, the finite floor ``NEG_INF = -1e30``.
Attention scores and softmax are float32 here whatever the weights'
dtype; the result is cast back to the activations' dtype.  Functions
work on plain tensors and a dict of weight tensors (``extract_params``)
on the caller's device.

Random numbers: ``jax.random`` is not reproduced.  A sampled token is
``argmax(filtered logits + Gumbel noise)``, the noise over the
vocabulary a counter-based integer hash of (the request's seed, the
token's position, the vocabulary index) alone (``_gumbel``), so a stream
does not depend on the slot or batch it shares: the serve engine's
streams equal ``generate`` at the same seed.  The hash is integer tensor
arithmetic, so its bits are the same on the CPU and the card, and the
whole draw runs inside the engine's captured decode step.  Against the
JAX package only greedy streams compare.

int8 KV caches (``cache_dtype="int8"``): a cache or pool is then a
``(values, scales)`` pair, int8 values of the dense layout and one
float32 scale a (position, kv head) row over D (``_quantize_kv``:
symmetric, ``max|x| / 127``).  Attention contracts the int8 values and
applies the scales outside the contractions, as the JAX package does: a
score takes its K row's scale, a probability its V row's scale before
the value product (the softmax sums stay unscaled).

Not ported yet (each raises ``NotImplementedError``): MoE blocks, tensor
and expert parallelism (slice 4, distributed), sliding-window decode,
the speculative verify through the paged kernel and
``generate_speculative`` (slice 3's fast paths), beam search.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.paged_attention import paged_attn

__all__ = ["NEG_INF", "extract_params", "prefill", "decode_step",
           "decode_step_paged", "generate", "generate_beam",
           "generate_speculative", "kv_zeros"]

NEG_INF = -1e30


def _owed(what, where):
    raise NotImplementedError(f"{what} is not ported yet ({where}; "
                              f"ROADMAP.md)")


def check_decodable(cfg):
    """Raise ``NotImplementedError`` for configurations the port's
    decode path does not take yet."""
    if getattr(cfg, "moe_every", None) is not None:
        _owed("MoE decode", "slice 4, distributed")
    w = getattr(cfg, "attn_window", None)
    if w is not None and w < cfg.n_positions:
        _owed("sliding-window decode", "slice 3's windowed serving")


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
        blocks.append(dict(
            ln1_s=w(blk.ln1.scale), ln1_b=w(blk.ln1.bias),
            wq=w(a.q_proj.W), bq=w(a.q_proj.b),
            wk=w(a.k_proj.W), bk=w(a.k_proj.b),
            wv=w(a.v_proj.W), bv=w(a.v_proj.b),
            wo=w(a.out_proj.W), bo=w(a.out_proj.b),
            ln2_s=w(blk.ln2.scale), ln2_b=w(blk.ln2.bias),
            w1=w(mlp.fc1.W), b1=w(mlp.fc1.b),
            w2=w(mlp.fc2.W), b2=w(mlp.fc2.b)))
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


def _mlp(h, p):
    return _linear(F.gelu(_linear(h, p["w1"], p["b1"]), approximate="tanh"),
                   p["w2"], p["b2"])


def _logits(x, params):
    head = params["head"]
    return x @ (params["wte"].t() if head is None else head)


def _attn_full(q, k, v, n_head):
    """Causal attention over a (B, S, E) prefill block; GQA k/v arrive
    n_kv_head * D wide and each K/V head serves its query group."""
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
    sc = torch.where(cm, sc, torch.full_like(sc, NEG_INF))
    o = torch.softmax(sc, -1) @ vh
    return o.transpose(1, 2).reshape(b, s, e).to(q.dtype)


def _block_prefill(x, p, n_head, eps):
    h = _ln(x, p["ln1_s"], p["ln1_b"], eps)
    q = _linear(h, p["wq"], p["bq"])
    k = _linear(h, p["wk"], p["bk"])
    v = _linear(h, p["wv"], p["bv"])
    x = x + _linear(_attn_full(q, k, v, n_head), p["wo"], p["bo"])
    h = _ln(x, p["ln2_s"], p["ln2_b"], eps)
    return x + _mlp(h, p), k, v


def prefill(params, ids, n_head, eps, quant_cache=False):
    """ids (B, S) -> (hidden (B, S, E) after the final LN, k caches, v
    caches (L, B, H_kv, S, D); with ``quant_cache`` each a (values,
    scales) pair, ``_quantize_kv`` of the rows).  The caller takes the
    rows it needs before the vocab product."""
    b, s = ids.shape
    pos = torch.arange(s, device=ids.device)
    x = params["wte"][ids.long()] + params["wpe"][pos][None]
    ks, vs = [], []
    for p in params["blocks"]:
        x, k, v = _block_prefill(x, p, n_head, eps)
        d = x.shape[-1] // n_head
        n_kv = k.shape[-1] // d
        ks.append(k.reshape(b, s, n_kv, d).transpose(1, 2))
        vs.append(v.reshape(b, s, n_kv, d).transpose(1, 2))
    x = _ln(x, params["lnf_s"], params["lnf_b"], eps)
    kc, vc = torch.stack(ks), torch.stack(vs)
    if quant_cache:
        kc, vc = _quantize_kv(kc), _quantize_kv(vc)
    return x, kc, vc


def _block_decode(x, p, k_cache, v_cache, pos, n_head, eps):
    """x (B, 1, E) at positions ``pos`` (B,); k/v_cache (B, H_kv, ctx,
    D), or (values, scales) pairs.  Writes this step's K/V (quantized
    for int8 caches) at ``pos`` in place (the JAX function returns
    updated caches) and attends positions <= pos of each row.  GQA: the
    query block reshapes to (B, H_kv, g, D), so the cache is never
    repeated.  int8: scores are ``(q . k8) * kscale / sqrt(D)`` and the
    probabilities take ``vscale`` before the value product."""
    quant = isinstance(k_cache, tuple)
    kq = k_cache[0] if quant else k_cache
    b, _, e = x.shape
    d = e // n_head
    n_kv, ctx = kq.shape[1], kq.shape[2]
    g = n_head // n_kv
    h = _ln(x, p["ln1_s"], p["ln1_b"], eps)
    q = _linear(h, p["wq"], p["bq"]).reshape(b, n_kv, g, d)
    k_new = _linear(h, p["wk"], p["bk"]).reshape(b, n_kv, d)
    v_new = _linear(h, p["wv"], p["bv"]).reshape(b, n_kv, d)
    rows = torch.arange(b, device=x.device)
    if quant:
        k_new, v_new = _quantize_kv(k_new), _quantize_kv(v_new)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        for leaf, val in zip(_leaves(cache), _leaves(new)):
            leaf[rows, :, pos] = val.to(leaf.dtype)
    sc = torch.einsum("bkgd,bktd->bkgt", q.float(), kq.float())
    if quant:
        sc = sc * k_cache[1][:, :, None, :]
    sc = sc / math.sqrt(d)
    live = torch.arange(ctx, device=x.device)[None, :] <= pos[:, None]
    sc = torch.where(live[:, None, None, :], sc, torch.full_like(sc, NEG_INF))
    pr = torch.softmax(sc, -1)
    if quant:
        pr = pr * v_cache[1][:, :, None, :]
    a = torch.einsum("bkgt,bktd->bkgd", pr, _leaves(v_cache)[0].float())
    x = x + _linear(a.reshape(b, 1, e).to(x.dtype), p["wo"], p["bo"])
    h = _ln(x, p["ln2_s"], p["ln2_b"], eps)
    return x + _mlp(h, p)


def decode_step(params, x, kc, vc, pos, n_head, eps):
    """One decode step through every block: x (B, 1, E) embedded inputs
    at positions ``pos`` (B,) against caches (L, B, H_kv, ctx, D), or
    (values, scales) pairs, which take this step's K/V in place.
    Returns ((B, V) logits, kc, vc)."""
    pos = torch.as_tensor(pos, device=x.device).long().reshape(-1)
    pos = pos.expand(x.shape[0])
    for li, p in enumerate(params["blocks"]):
        x = _block_decode(x, p, _cache_layer(kc, li), _cache_layer(vc, li),
                          pos, n_head, eps)
    x = _ln(x, params["lnf_s"], params["lnf_b"], eps)
    return _logits(x, params)[:, 0], kc, vc


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


def _block_decode_paged(x, p, pool_k_l, pool_v_l, tables, pos, n_head, eps,
                        write_at):
    """One layer's decode for every slot: x (S, 1, E) at ``pos`` (S,)
    int32, one layer's pools (N + 1, H_kv, B, D), or (int8 values,
    float32 scales (N + 1, H_kv, B)) pairs, ``tables`` (S, W // B)
    int32.  Attention runs through ``paged_attn`` over each slot's pool
    lanes < pos plus its own K/V (quantized on int8 pools; q stays in
    the compute dtype).  Then the step's K/V row is written in place at
    ``write_at`` = (tables[s, pos // B], pos % B), every leaf; a dead
    slot (all-trash table, pos 0) writes the trash block.  (The JAX
    function returns the whole block with the row inserted, which its
    caller scatters back.)"""
    s_, _, e = x.shape
    d = e // n_head
    q, k_new, v_new = _paged_qkv(x, p, n_head, eps)
    if isinstance(pool_k_l, tuple):
        k_cur, v_cur = _quantize_kv(k_new), _quantize_kv(v_new)
    else:
        dt = pool_k_l.dtype
        q, k_cur, v_cur = q.to(dt), k_new.to(dt), v_new.to(dt)
    blk, off, cur_mask = write_at
    a = paged_attn(q, pool_k_l, pool_v_l, tables, pos, k_cur, v_cur,
                   cur_mask, 1.0 / math.sqrt(d))
    a = a.to(x.dtype).permute(0, 3, 1, 2, 4).reshape(s_, 1, e)
    x = x + _linear(a, p["wo"], p["bo"])
    h = _ln(x, p["ln2_s"], p["ln2_b"], eps)
    x = x + _mlp(h, p)
    for pool, cur in ((pool_k_l, k_cur), (pool_v_l, v_cur)):
        for leaf, val in zip(_leaves(pool), _leaves(cur)):
            leaf[blk, :, off] = val[:, :, 0]
    return x


def decode_step_paged(params, x, pool_k, pool_v, tables, pos, n_head, eps,
                      *, block):
    """The paged serve engine's decode step: x (S, 1, E) embedded inputs
    at ``pos`` (S,) int32, pools (L, N + 1, H_kv, B, D) (or int8
    (values, scales) pairs), ``tables`` (S, W // B) int32 trash-padded.
    One ``paged_attn`` launch per layer for all slots, which finds the
    blocks to read from ``pos`` on the device; the pools take the step's
    K/V in place.  Nothing reads a device value on the host, so the step
    can be captured in a CUDA graph.  Returns (S, V) logits."""
    pl = pos.long()
    write_at = (tables.long().gather(1, (pl // block)[:, None])[:, 0],
                pl % block,
                torch.ones((1, 1), dtype=torch.bool, device=x.device))
    for li, p in enumerate(params["blocks"]):
        x = _block_decode_paged(x, p, _cache_layer(pool_k, li),
                                _cache_layer(pool_v, li), tables, pos,
                                n_head, eps, write_at)
    x = _ln(x, params["lnf_s"], params["lnf_b"], eps)
    return _logits(x, params)[:, 0]


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


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash of int64 tensor ``x`` in [0, 2^32): xor-shift
    and multiply rounds whose odd multipliers are below 2^31, so every
    product of a 32-bit value with one fits int64 and the bits are exact
    on every device."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _M32
    return x ^ (x >> 16)


def _gumbel(seeds, positions, vocab):
    """(N, V) Gumbel noise: element (i, v) is a function of
    ``(seeds[i], positions[i], v)`` alone (``seeds`` and ``positions``
    (N,) integer tensors), a counter-based hash turned into a uniform of
    23 bits, so a row's noise does not depend on the batch it is drawn
    in, and tensor ops draw it inside a captured step."""
    s = seeds.long()
    h = _mix32((s & _M32) ^ 0x9E3779B9)
    h = _mix32(h ^ ((s >> 32) & _M32))
    h = _mix32(h ^ (positions.long() & _M32))
    v = torch.arange(vocab, device=s.device)
    h = _mix32(_mix32(h[:, None] ^ v[None]))
    u = ((h >> 9).float() + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


def _on(x, dtype, device):
    """``x`` (a tensor, an array or a list) as a ``dtype`` tensor on
    ``device``; a tensor already there is not copied."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x), device=device)
    return x.to(device=device, dtype=dtype)


def _sample(logits, temps, seeds, positions, top_k=0, top_p=None,
            min_p=None, rep_mask=None, rep_penalty=None):
    """One token per row of (N, V) logits.  With ``rep_mask`` (N, V)
    bool, the repetition penalty applies first, before the greedy argmax
    too.  Then greedy (argmax of the float32 logits) where ``temps[i] <=
    0``, else argmax of the filtered logits (temperature, top-k, top-p,
    min-p) plus Gumbel noise keyed by ``(seeds[i], positions[i])``, a
    draw from the filtered softmax.  ``temps``, ``seeds`` and
    ``positions`` are (N,) device tensors or host arrays.  Every row is
    filtered and drawn and the two results are selected per row, so the
    ops have fixed shapes and the serve engine's captured decode step
    samples inside its graph.  Returns an (N,) int64 tensor on the
    logits' device."""
    n, vocab = logits.shape
    dev = logits.device
    logits = logits.float()
    if rep_mask is not None:
        logits = _penalize(logits, rep_mask, rep_penalty)
    temps = _on(temps, torch.float32, dev).reshape(n)
    hot = temps > 0
    t = torch.where(hot, temps, torch.ones_like(temps))[:, None]
    filt = _filter_logits(logits, t, top_p, top_k, min_p)
    noise = _gumbel(_on(seeds, torch.int64, dev).reshape(n),
                    _on(positions, torch.int64, dev).reshape(n), vocab)
    return torch.where(hot, (filt + noise).argmax(-1), logits.argmax(-1))


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
    and ``seed`` (an int for every row, or one per row; default one draw
    from ``rng``) keys the noise (module docstring).  ``dtype`` casts the
    weights (``torch.bfloat16`` for bf16 inference).  ``cache_dtype=
    "int8"`` keeps the cache as int8 (values, scales) (module
    docstring).  Requires prompt + ``max_new_tokens`` <= ``n_positions``:
    ``GPT2LMHead.generate`` takes longer generations on its windowed
    path."""
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
    seeds = np.broadcast_to(np.asarray(seed, np.int64), (len(rows),))
    temps = np.full(len(rows), temperature, np.float32)
    was_training = m.training
    m.eval()
    try:
        with torch.no_grad():
            new = _generate_rows(extract_params(m, dtype), rows,
                                 max_new_tokens, cfg, temps, seeds,
                                 dict(top_k=top_k, top_p=top_p,
                                      min_p=min_p, rep_penalty=rep),
                                 quant)
    finally:
        m.train(was_training)
    out = [np.concatenate([r, new[i]]).astype(np.int32)
           for i, r in enumerate(rows)]
    return out[0] if single else out


def kv_zeros(shape, dtype, quant, device):
    """A zero cache of ``shape`` (..., ctx, D): a ``dtype`` tensor, or
    with ``quant`` the (int8 values, float32 scales (..., ctx)) pair."""
    if quant:
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def _generate_rows(params, rows, n_new, cfg, temps, seeds, filters,
                   quant=False):
    """``filters``: ``_sample``'s ``top_k``, ``top_p``, ``min_p`` and
    ``rep_penalty`` (None: no penalty); ``quant``: int8 caches."""
    n_head, eps = cfg.n_head, float(cfg.layer_norm_eps)
    dev = params["wte"].device
    b = len(rows)
    lens = np.asarray([len(r) for r in rows], np.int64)
    ctx = int(lens.max()) + n_new
    d = cfg.n_embd // n_head
    shape = (cfg.n_layer, b, cfg.n_kv_head, ctx, d)
    kc = kv_zeros(shape, params["wte"].dtype, quant, dev)
    vc = kv_zeros(shape, params["wte"].dtype, quant, dev)
    first = torch.empty((b, cfg.vocab_size), device=dev)
    for plen in sorted(set(lens.tolist())):
        sel = np.flatnonzero(lens == plen)
        ids = torch.as_tensor(np.stack([rows[i] for i in sel]), device=dev)
        hidden, k, v = prefill(params, ids, n_head, eps, quant_cache=quant)
        idx = torch.as_tensor(sel, device=dev)
        for cache, new in ((kc, k), (vc, v)):
            for leaf, val in zip(_leaves(cache), _leaves(new)):
                leaf[:, idx, :, :plen] = val
        first[idx] = _logits(hidden[:, plen - 1], params).float()
    if filters["rep_penalty"] is not None:
        filters = dict(filters,
                       rep_mask=_rep_mask_init(rows, cfg.vocab_size, dev))
    rows_t = torch.arange(b, device=dev)
    pos = lens.copy()
    toks = np.empty((b, n_new), np.int64)

    def sample(logits, j):
        nxt = _sample(logits, temps, seeds, pos, **filters)
        toks[:, j] = nxt.cpu().numpy()
        if "rep_mask" in filters:  # the emitted tokens join the sequence
            filters["rep_mask"][rows_t, nxt] = True

    sample(first, 0)
    for j in range(1, n_new):
        pos_t = torch.as_tensor(pos, device=dev)
        tok_t = torch.as_tensor(toks[:, j - 1], device=dev)
        x = (params["wte"][tok_t] + params["wpe"][pos_t])[:, None]
        logits, kc, vc = decode_step(params, x, kc, vc, pos_t, n_head, eps)
        pos += 1
        sample(logits, j)
    return toks


def generate_beam(*args, **kwargs):
    """Beam search (``singa_tpu/models/gpt2_decode.py:1533``)."""
    _owed("beam search", "a later slice")


def generate_speculative(*args, **kwargs):
    """Speculative decoding with a draft model."""
    _owed("speculative decoding", "slice 3's fast paths")
