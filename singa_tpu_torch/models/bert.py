"""BERT (counterpart of ``singa_tpu/models/bert.py``): the configuration,
the post-LN encoder, the trunk with its additive padding mask and pooled
first token, and the masked-LM head with its training step.
``bench.py``'s ``bench_bert`` trains ``BertConfig.base()`` (L 12, H 768,
A 12, 110M parameters) at batch 16 x 512 with bf16 amp and
SGD(1e-4, 0.9).

Attention is ``ops/attention.py``'s ``MultiHeadAttention``: the fused
plain path by default, the flash kernels with ``use_flash=True`` (at
S = 512, D = 64, non-causal; an ``attention_mask`` reaches them as their
key-mask row).  Layer and parameter names match the JAX package's
(``BertForMaskedLM.bert.encoder.layers0.attn.q_proj.W``), so states
interchange, with a ``ShardingPlan`` too (``parallel/sharding.py``): the
word table is vocab-parallel, the projections column/row-parallel over
``model``, attention ``ParallelMHA`` (the ``seq`` ring, a padding mask
rotating with its keys), the MLM decoder column-parallel and gathered;
positions start at the rank's sequence offset, and the pooled first
token is seq rank 0's, broadcast over the ring.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import autograd, layer, model
from ..ops.attention import MultiHeadAttention
from ..parallel.sharding import SEQ
from ..parallel.tensor_parallel import (ColumnParallelLinear, ParallelMHA,
                                        RowParallelLinear,
                                        VocabParallelEmbedding, copy_to_axis,
                                        reduce_from_axis)
from .common import apply_dist_option

__all__ = ["BertConfig", "BertEmbeddings", "BertLayer", "BertEncoder",
           "BertModel", "BertForMaskedLM", "create_model"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, max_position_embeddings=512,
                 type_vocab_size=2, hidden_dropout=0.1, attn_dropout=0.1,
                 layer_norm_eps=1e-12, use_flash=False, remat=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.hidden_dropout = hidden_dropout
        self.attn_dropout = attn_dropout
        self.layer_norm_eps = layer_norm_eps
        self.use_flash = use_flash
        self.remat = remat  # recompute the attention scores in backward

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """For tests: 2 layers, 64 hidden."""
        kw.setdefault("vocab_size", 1000)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)


class BertEmbeddings(layer.Layer):
    def __init__(self, cfg, plan=None):
        super().__init__()
        self.plan = plan
        if plan is not None:
            self.word = VocabParallelEmbedding(cfg.vocab_size,
                                               cfg.hidden_size, plan)
        else:
            self.word = layer.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position = layer.Embedding(cfg.max_position_embeddings,
                                        cfg.hidden_size)
        self.token_type = layer.Embedding(cfg.type_vocab_size,
                                          cfg.hidden_size)
        self.ln = layer.LayerNorm(cfg.layer_norm_eps)
        self.dropout = cfg.hidden_dropout

    def forward(self, input_ids, token_type_ids):
        b, s = input_ids.shape
        start = 0 if self.plan is None else self.plan.seq_offset(s)
        pos = torch.arange(start, start + s, dtype=torch.int32,
                           device=input_ids.device).expand(b, s)
        e = autograd.add(
            autograd.add(self.word(input_ids), self.position(pos)),
            self.token_type(token_type_ids))
        return autograd.dropout(self.ln(e), self.dropout,
                                training=self.training)


class BertLayer(layer.Layer):
    """Post-LN encoder block: ``ln1(x + attn(x))``, then
    ``ln2(x + fc2(gelu(fc1(x))))``."""

    def __init__(self, cfg, plan=None):
        super().__init__()
        if plan is not None:
            self.attn = ParallelMHA(cfg.num_attention_heads, plan,
                                    dropout=cfg.attn_dropout,
                                    use_flash=cfg.use_flash,
                                    remat=cfg.remat)
            self.fc1 = ColumnParallelLinear(cfg.intermediate_size, plan)
            self.fc2 = RowParallelLinear(cfg.hidden_size, plan)
        else:
            self.attn = MultiHeadAttention(cfg.num_attention_heads,
                                           dropout=cfg.attn_dropout,
                                           use_flash=cfg.use_flash,
                                           remat=cfg.remat)
            self.fc1 = layer.Linear(cfg.intermediate_size)
            self.fc2 = layer.Linear(cfg.hidden_size)
        self.ln1 = layer.LayerNorm(cfg.layer_norm_eps)
        self.ln2 = layer.LayerNorm(cfg.layer_norm_eps)
        self.dropout = cfg.hidden_dropout

    def forward(self, x, mask=None):
        a = autograd.dropout(self.attn(x, mask), self.dropout,
                             training=self.training)
        x = self.ln1(autograd.add(x, a))
        h = self.fc2(autograd.gelu(self.fc1(x)))
        h = autograd.dropout(h, self.dropout, training=self.training)
        return self.ln2(autograd.add(x, h))


class BertEncoder(layer.Layer):
    def __init__(self, cfg, plan=None):
        super().__init__()
        self.layers = nn.ModuleList(BertLayer(cfg, plan)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x, mask=None):
        for lyr in self.layers:
            x = lyr(x, mask)
        return x


def _mask(m):
    return (1.0 - m.float())[:, None, None, :] * -1e9


def _mask_op(attention_mask):
    """(B, S) 1/0 mask -> (B, 1, 1, S) additive float32 mask, -1e9 at the
    padded keys (recorded for export as ``AttnMask``)."""
    return autograd._op(_mask, attention_mask, _name="AttnMask")


def _first(x):
    return x[:, 0, :]


def _first_token(x, plan=None):
    """x[:, 0, :] (recorded for export as ``FirstToken``); over a ``seq``
    ring, seq rank 0's, summed to every rank (and the gradients of every
    rank's copy summed back into it)."""
    first = autograd._op(_first, x, _name="FirstToken")
    if plan is None or plan.axis_size(SEQ) == 1:
        return first
    axis = plan.mesh.axis(SEQ)
    first = copy_to_axis(first, axis) * float(axis.index == 0)
    return reduce_from_axis(first, axis)


class BertModel(model.Model):
    """Encoder trunk; forward returns ``(sequence_output,
    pooled_output)``."""

    def __init__(self, cfg=None, plan=None):
        super().__init__()
        self.cfg = cfg or BertConfig.base()
        self.plan = plan
        self.embeddings = BertEmbeddings(self.cfg, plan)
        self.encoder = BertEncoder(self.cfg, plan)
        self.pooler = layer.Linear(self.cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        mask = None if attention_mask is None else _mask_op(attention_mask)
        x = self.encoder(self.embeddings(input_ids, token_type_ids), mask)
        return x, autograd.tanh(self.pooler(_first_token(x, self.plan)))


class BertForMaskedLM(model.Model):
    """The masked-LM head over the trunk: ``bench_bert``'s training
    workload."""

    def __init__(self, cfg=None, plan=None):
        super().__init__()
        self.cfg = cfg or BertConfig.base()
        self.bert = BertModel(self.cfg, plan)
        self.transform = layer.Linear(self.cfg.hidden_size)
        self.ln = layer.LayerNorm(self.cfg.layer_norm_eps)
        self.decoder = layer.Linear(self.cfg.vocab_size) if plan is None \
            else ColumnParallelLinear(self.cfg.vocab_size, plan,
                                      gather_output=True)
        self.softmax_cross_entropy = layer.SoftMaxCrossEntropy()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        # .forward, not the call: Model.__call__ would route the nested
        # Model to train_one_batch while training
        seq, _ = self.bert.forward(input_ids, token_type_ids, attention_mask)
        h = self.ln(autograd.gelu(self.transform(seq)))
        return self.decoder(h)

    def train_one_batch(self, input_ids, labels, dist_option="plain",
                        spars=None):
        logits = self.forward(input_ids)
        b, s, v = logits.shape
        loss = self.softmax_cross_entropy(
            autograd.reshape(logits, (b * s, v)),
            autograd.reshape(labels, (b * s,)))
        apply_dist_option(self.optimizer, loss, dist_option, spars)
        return logits, loss


def create_model(size="base", plan=None, **kw):
    cfg = BertConfig.tiny(**kw) if size == "tiny" else BertConfig.base(**kw)
    return BertForMaskedLM(cfg, plan)
