"""GPT-2, decoder-only causal LM (counterpart of
``singa_tpu/models/gpt2.py``): the configuration, the trunk and the LM
head with its training step, KV-cached sampling (``generate``,
``models/gpt2_decode.py``) and the serve engine (``serve``,
``singa_tpu_torch/serve``).

At ``n_positions >= 1024`` the configuration picks ``attn_impl="flash"``,
so every block's attention runs through the flash kernels
(``ops/flash_attention.py``): one forward launch per block per step and
one dQ and one dK/dV launch per block in the backward, and per token of
``generate``'s windowed path.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import autograd, layer, model
from .. import device as device_module
from ..parallel.tensor_parallel import (ParallelTransformerBlock,
                                        VocabParallelEmbedding)

__all__ = ["GPT2Config", "GPT2Model", "GPT2LMHead"]


class GPT2Config:
    def __init__(self, vocab_size=50257, n_positions=1024, n_embd=768,
                 n_layer=12, n_head=12, n_inner=None, dropout=0.1,
                 layer_norm_eps=1e-5, tie_weights=True, moe_every=None,
                 remat=False, attn_impl="auto", n_kv_head=None,
                 attn_window=None):
        self.vocab_size = vocab_size
        self.n_positions = n_positions
        self.n_embd = n_embd
        self.n_layer = n_layer
        self.n_head = n_head
        self.n_kv_head = int(n_kv_head or n_head)
        if n_head % self.n_kv_head != 0:
            raise ValueError(f"n_head {n_head} not divisible by "
                             f"n_kv_head {self.n_kv_head}")
        self.attn_window = None if attn_window is None else int(attn_window)
        if self.attn_window is not None and self.attn_window < 1:
            raise ValueError(f"attn_window must be >= 1, "
                             f"got {attn_window}")
        self.n_inner = n_inner or 4 * n_embd
        self.dropout = dropout
        self.layer_norm_eps = layer_norm_eps
        self.tie_weights = tie_weights
        # MoE blocks are not ported yet: GPT2Model raises for moe_every
        self.moe_every = moe_every
        self.remat = remat
        # "fused": (S, S) scores in memory; "flash": the flash kernels,
        # O(S·D) memory.  "auto" keeps the JAX package's rule (its
        # crossover was measured on a TPU and is not re-measured here).
        if attn_impl == "auto":
            attn_impl = "flash" if n_positions >= 1024 else "fused"
        self.attn_impl = attn_impl

    @classmethod
    def small(cls, **kw):
        """GPT-2 small (124M)."""
        return cls(**kw)

    @classmethod
    def medium(cls, **kw):
        kw.setdefault("n_embd", 1024)
        kw.setdefault("n_layer", 24)
        kw.setdefault("n_head", 16)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """For tests: 2 layers, 64 hidden."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("n_positions", 128)
        kw.setdefault("n_embd", 64)
        kw.setdefault("n_layer", 2)
        kw.setdefault("n_head", 4)
        kw.setdefault("n_inner", 128)
        return cls(**kw)


class GPT2Model(model.Model):
    """Decoder trunk: wte + wpe -> pre-LN causal blocks -> final LN."""

    def __init__(self, cfg=None, plan=None):
        super().__init__()
        self.cfg = c = cfg or GPT2Config.small()
        if c.moe_every is not None:
            raise NotImplementedError(
                "mixture-of-experts GPT-2 is not ported yet")
        self.wte = VocabParallelEmbedding(c.vocab_size, c.n_embd, plan)
        self.wpe = layer.Embedding(c.n_positions, c.n_embd, std=0.01)
        self.blocks = nn.ModuleList(
            ParallelTransformerBlock(
                c.n_head, c.n_inner, plan, dropout=c.dropout, causal=True,
                eps=c.layer_norm_eps, num_kv_heads=c.n_kv_head,
                window=c.attn_window, remat=c.remat,
                use_flash=c.attn_impl == "flash")
            for _ in range(c.n_layer))
        self.ln_f = layer.LayerNorm(c.layer_norm_eps)

    def forward(self, input_ids):
        b, s = input_ids.shape
        pos = torch.arange(s, device=input_ids.device).expand(b, s)
        x = autograd.add(self.wte(input_ids), self.wpe(pos))
        x = autograd.dropout(x, self.cfg.dropout, training=self.training)
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)

    def aux_losses(self):
        """MoE load-balance losses of the last forward, each already
        weighted (none for dense blocks, the only kind ported yet)."""
        return [blk.aux_loss for blk in self.blocks
                if blk.aux_loss is not None]


class GPT2LMHead(model.Model):
    """Causal-LM head; the training workload (next-token prediction)."""

    def __init__(self, cfg=None, plan=None):
        super().__init__()
        self.cfg = cfg or GPT2Config.small()
        self.transformer = GPT2Model(self.cfg, plan)
        if not self.cfg.tie_weights:
            from ..parallel.tensor_parallel import ColumnParallelLinear

            self.lm_head = ColumnParallelLinear(
                self.cfg.vocab_size, plan, bias=False)
        self.loss_fn = layer.SoftMaxCrossEntropy()

    def forward(self, input_ids):
        h = self.transformer.forward(input_ids)
        if self.cfg.tie_weights:
            # logits = h @ wteᵀ (GPT-2 weight tying)
            return autograd.matmul(
                h, autograd.transpose(self.transformer.wte.W, (1, 0)))
        return self.lm_head(h)

    def train_one_batch(self, input_ids, labels):
        """labels: next-token ids shaped like input_ids; label −1 marks a
        position to ignore.  The loss is the mean over valid positions:
        the cross-entropy's mean over all rows is rescaled by
        ``(b·s) / max(#valid, 1)``."""
        logits = self.forward(input_ids)
        b, s, v = logits.shape
        loss = self.loss_fn(autograd.reshape(logits, (b * s, v)),
                            autograd.reshape(labels, (b * s,)))
        n_valid = (labels.reshape(-1) >= 0).sum().float().clamp_min(1.0)
        loss = autograd.mul(loss, (b * s) / n_valid)
        for aux in self.transformer.aux_losses():
            loss = autograd.add(loss, aux)
        self.optimizer(loss)
        return logits, loss

    def generate(self, prompt_ids, max_new_tokens=20, temperature=1.0,
                 rng=None, use_cache=None, top_k=0, top_p=None,
                 min_p=None, repetition_penalty=None, seed=None,
                 dtype=None, cache_dtype=None):
        """Greedy or temperature sampling with optional top-k / top-p /
        min-p filtering and a repetition penalty, routed as the JAX
        package routes it:

        * ``use_cache`` None (auto): a generation that fits
          ``n_positions`` takes the KV-cached path
          (``models/gpt2_decode.generate``), a longer one the windowed
          path below; ``True`` asks for the KV cache and raises
          ``ValueError`` when the generation does not fit; ``False``
          takes the windowed path (one prompt only);
        * ``prompt_ids``: one 1-D prompt (returns a 1-D int32 array,
          prompt + continuation) or a list / 2-D batch, possibly ragged
          (returns a list): KV-cached, or, when any row is too long, every
          row through the windowed path in turn.

        On the KV-cached path ``seed`` keys the sampling noise (an int,
        or one per row), ``dtype`` casts the weights and
        ``cache_dtype="int8"`` keeps the KV cache as int8 values with
        per-row scales.  The windowed path runs one right-padded
        ``n_positions``-wide forward of this model per token (the flash
        kernels at ``n_positions >= 1024``) on the last ``n_positions``
        tokens, and samples as the JAX package does: float64 probabilities and ``rng.choice`` (``rng``
        a numpy RandomState or Generator; default
        ``np.random.RandomState(seed)`` with a ``seed``, else numpy's
        global state), so a numpy ``rng`` draws the JAX package's tokens
        wherever the logits agree."""
        from . import gpt2_decode as gd

        n_pos = self.cfg.n_positions
        kw = dict(max_new_tokens=max_new_tokens, temperature=temperature,
                  rng=rng, top_k=top_k, top_p=top_p, min_p=min_p,
                  repetition_penalty=repetition_penalty, seed=seed,
                  dtype=dtype, cache_dtype=cache_dtype)
        if gd._is_batch(prompt_ids):
            if use_cache is False:
                raise ValueError(
                    "batched generate requires the KV-cached path "
                    "(use_cache=False is single-prompt only); loop over "
                    "rows for the windowed sampler")
            rows = [np.asarray(r, np.int32).reshape(-1)
                    for r in list(prompt_ids)]
            if use_cache is not True and any(
                    len(r) + max_new_tokens > n_pos for r in rows):
                seeds = [None] * len(rows) if seed is None else \
                    np.broadcast_to(np.asarray(seed), (len(rows),)).tolist()
                return [self.generate(r, use_cache=False,
                                      **dict(kw, seed=s))
                        for r, s in zip(rows, seeds)]
            return gd.generate(self, prompt_ids, **kw)
        n0 = np.asarray(prompt_ids).size
        if use_cache is None:
            use_cache = n0 + max_new_tokens <= n_pos
        top_k = gd._check_sampling(top_k, top_p, self.cfg.vocab_size, min_p,
                                   repetition_penalty)
        if use_cache:
            return gd.generate(self, prompt_ids, **dict(kw, top_k=top_k))
        if dtype is not None or cache_dtype is not None:
            raise ValueError("dtype and cache_dtype apply to the KV-cached "
                             "path only; the windowed path runs the model "
                             "as it is")
        if rng is None and seed is not None:
            rng = np.random.RandomState(seed)
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                return self._generate_windowed(
                    prompt_ids, max_new_tokens, temperature, rng, top_k,
                    top_p, min_p, repetition_penalty)
        finally:
            self.train(was_training)

    def _generate_windowed(self, prompt_ids, max_new_tokens, temperature,
                           rng, top_k, top_p, min_p, repetition_penalty):
        """The JAX package's windowed sampler, step for step (its numpy
        filter chain on float64 logits)."""
        ids = list(np.asarray(prompt_ids).reshape(-1).tolist())
        ctx = self.cfg.n_positions
        w = getattr(self.transformer.wte, "W", None)
        dev = w.device if torch.is_tensor(w) else \
            device_module.get_default_device().torch_device
        for _ in range(max_new_tokens):
            live = ids[-ctx:]
            # causal attention ignores positions to the right, so a
            # right-padded window of fixed width gives exact logits at
            # index len(live) - 1
            window = np.zeros((1, ctx), np.int64)
            window[0, :len(live)] = live
            logits = self.forward(torch.from_numpy(window).to(dev))
            last = logits[0, len(live) - 1].float().cpu().numpy() \
                .astype(np.float64)
            if repetition_penalty is not None and repetition_penalty != 1.0:
                seen = np.unique(np.asarray(ids, np.int64))
                last[seen] = np.where(last[seen] > 0,
                                      last[seen] / repetition_penalty,
                                      last[seen] * repetition_penalty)
            if temperature <= 0:
                nxt = int(np.argmax(last))
            else:
                logit = last / temperature
                if top_k:
                    kth = np.sort(logit)[-int(top_k)]
                    logit = np.where(logit < kth, -np.inf, logit)
                if top_p is not None:
                    order = np.argsort(-logit)
                    sp = np.exp(logit[order] - logit[order][0])
                    sp /= sp.sum()
                    cum = np.cumsum(sp)
                    keep = np.zeros(len(logit), bool)
                    keep[order] = (cum - sp) < top_p
                    logit = np.where(keep, logit, -np.inf)
                if min_p is not None:
                    logit = np.where(logit < logit.max() + np.log(min_p),
                                     -np.inf, logit)
                p = np.exp(logit - logit.max())
                p /= p.sum()
                nxt = int((rng or np.random).choice(len(p), p=p))
            ids.append(nxt)
        return np.asarray(ids, np.int32)

    def serve(self, **kw):
        """A continuous-batching inference engine over this model
        (``singa_tpu_torch.serve.InferenceEngine``), on the model's
        device.  Keyword arguments go to the engine: ``paged=`` (a
        ``serve.PagedConfig``; default None, the slot arena),
        ``cache_dtype`` (``"int8"``: int8 KV), ``max_slots``,
        ``max_len``, ``dtype``, ``top_k``, ``top_p``, ``scheduler``,
        ``clock``, ``capture``."""
        from ..serve import InferenceEngine

        return InferenceEngine(self, **kw)
