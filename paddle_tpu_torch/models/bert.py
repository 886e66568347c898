"""BERT — masked-LM pretraining (BASELINE config 2), in PyTorch.

Counterpart of `paddle_tpu/models/bert.py`: `BertConfig` (:34),
`bert_base_config` (:63), `bert_tiny_config` (:70), `BertEmbeddings`
(:79), `BertSelfAttention` (:103), `BertLayer` (:135, post-LN),
`BertModel` (:163) and `BertForMaskedLM` (:193) with `compute_loss`
(:228).  The blocks are the port's nn layers (Linear, Embedding,
LayerNorm, Dropout, LayerList), so parameters keep the reference's
structural names (`bert.layers.0.attention.query.weight`, ...), its
[in, out] layout and its automatic names (`linear_0.weight`), and the
reference's numpy weights load by name (models/convert.py).

Attention is `ops.attention(q, k, v, causal=False)` on [b, s, h, d]: the
Hopper flash kernels, forward and backward, on the card; the plain
version on the CPU.  A 2-D keep-mask `attention_mask` [b, sk] (1 attend,
0 padding) becomes the bool [b, 1, 1, sk] of the reference (:117-122),
which the kernels take as a key-padding mask (the reference sends masked
calls to `xla_attention`; a fully padded sequence attends uniformly, as
there).

`config.dtype` is the COMPUTE dtype: the parameters are fp32 masters
and `nn.set_compute_dtype` switches every Linear, Embedding and
LayerNorm to it (fp32 LayerNorm statistics).  The MLM decoder ties the
word embedding, transposed, with `decoder_bias`.  Under
`FLAGS_fused_ce` a model in training mode returns the transform's
hidden states from `forward`, and `compute_loss` folds the tied decoder
into `nn.functional.fused_cross_entropy(..., transpose_weight=True,
bias=decoder_bias)` — the cross-entropy rows kernel on the card; the
[b, s, V] logits never exist.

Device rule: the models build on `cuda` unless given `device="cpu"`,
and raise with no CUDA device.  Random init draws from a `torch.Generator`
seeded with `seed` (the reference's initializers: XavierNormal weights
and embeddings, zero biases, unit LayerNorm scales); the two packages'
streams differ, so parity tests load the same numpy weights into both.
Dropout (p = `hidden_dropout_prob`, 0 by default) draws its masks from
the same generator.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn, ops
from ..framework.device import init_generator, resolve_device
from ..framework.dtypes import to_torch
from ..framework.flags import get_flag
from ..nn import functional as F
from ..nn.layer import Layer

__all__ = ["BertConfig", "BertModel", "BertForMaskedLM",
           "bert_base_config", "bert_tiny_config"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.0
    layer_norm_eps: float = 1e-12
    # original BERT's gelu is the tanh approximation
    hidden_act: str = "gelu_tanh"
    # the COMPUTE dtype; parameters are always fp32 masters
    dtype: str = "float32"

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def compute_dtype(self):
        return to_torch(self.dtype)


def bert_base_config(**kw):
    cfg = BertConfig()
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def bert_tiny_config(**kw):
    cfg = BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=64, type_vocab_size=2)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h,
                                                  **kw)
        self.layer_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                       **kw)
        self.dropout = nn.Dropout(config.hidden_dropout_prob,
                                  generator=generator)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1],
                           device=input_ids.device)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertSelfAttention(Layer):
    def __init__(self, config: BertConfig, device, generator):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(device=device, generator=generator)
        self.query = nn.Linear(h, h, **kw)
        self.key = nn.Linear(h, h, **kw)
        self.value = nn.Linear(h, h, **kw)
        self.out = nn.Linear(h, h, **kw)

    def forward(self, x, attention_mask=None):
        cfg = self.config
        mask = attention_mask
        if mask is not None:
            if mask.ndim == 2:
                # [batch, seq] keep-mask (1 attend, 0 pad) -> bool
                # [b, 1, 1, sk]
                mask = (mask > 0)[:, None, None, :]
        b, s, h = x.shape
        nh, hd = cfg.num_attention_heads, cfg.head_dim
        q, k, v = (lin(x).reshape(b, s, nh, hd)
                   for lin in (self.query, self.key, self.value))
        ctx = ops.attention(q, k, v, mask=mask, causal=False)
        return self.out(ctx.reshape(b, s, h))


class BertLayer(Layer):
    """Post-LN transformer block (original BERT residual order)."""

    def __init__(self, config: BertConfig, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = BertSelfAttention(config, device, generator)
        self.attn_norm = nn.LayerNorm(h, epsilon=eps, **kw)
        self.intermediate = nn.Linear(h, config.intermediate_size, **kw)
        self.output = nn.Linear(config.intermediate_size, h, **kw)
        self.out_norm = nn.LayerNorm(h, epsilon=eps, **kw)
        self.dropout = nn.Dropout(config.hidden_dropout_prob,
                                  generator=generator)
        self._act = getattr(config, "hidden_act", "gelu_tanh")

    def forward(self, x, attention_mask=None):
        x = self.attn_norm(x + self.dropout(
            self.attention(x, attention_mask)))
        y = self.output(F.gelu(self.intermediate(x),
                               approximate=self._act == "gelu_tanh"))
        return self.out_norm(x + self.dropout(y))


class BertModel(Layer):
    """forward(input_ids, token_type_ids, attention_mask) ->
    (sequence_output [b, s, h], pooled_output [b, h])."""

    embeddings_cls: type = None   # subclass hook (ERNIE's task-type table)

    def __init__(self, config: BertConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = init_generator(dev, seed, generator)
        self.config = config
        emb_cls = type(self).embeddings_cls or BertEmbeddings
        self.embeddings = emb_cls(config, dev, gen)
        self.layers = nn.LayerList(
            [BertLayer(config, dev, gen)
             for _ in range(config.num_hidden_layers)])
        self.pooler = nn.Linear(config.hidden_size, config.hidden_size,
                                device=dev, generator=gen)
        if config.dtype != "float32":
            nn.set_compute_dtype(self, config.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x, self._pool(x)

    def _pool(self, x):
        return F.tanh(self.pooler(x[:, 0]))


class BertForMaskedLM(Layer):
    """MLM head: dense + gelu + LayerNorm + the tied-embedding decoder.
    `device` None means CUDA (raises without one); weights are random
    from `seed` until models.convert loads real ones."""

    backbone_cls: type = None     # subclass hook (ERNIE's backbone)

    def __init__(self, config: BertConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = init_generator(dev, seed)
        self.config = config
        self.bert = (type(self).backbone_cls or BertModel)(
            config, dev, generator=gen)
        h = config.hidden_size
        self.transform = nn.Linear(h, h, device=dev, generator=gen)
        self.transform_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                           device=dev)
        self.decoder_bias = torch.nn.Parameter(
            torch.zeros(config.vocab_size, dtype=torch.float32, device=dev))
        if config.dtype != "float32":
            nn.set_compute_dtype(self, config.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """Logits [b, s, V] in the compute dtype; under FLAGS_fused_ce in
        training mode the transform's hidden states [b, s, h]
        (compute_loss then folds the decoder into the loss)."""
        seq_out, _ = self.bert(input_ids, token_type_ids, attention_mask)
        x = self._transform(seq_out)
        if get_flag("fused_ce") and self.training:
            return x
        return self._decode(x)

    def _transform(self, seq_out):
        return self.transform_norm(F.gelu(
            self.transform(seq_out),
            approximate=self.config.hidden_act == "gelu_tanh"))

    def _decode(self, x):
        """x @ word_embeddingsᵀ + decoder_bias, in x's dtype (one
        `F.linear`: the [V, h] table is already the transposed weight it
        takes, and cuBLAS adds the bias)."""
        w = self.bert.embeddings.word_embeddings.weight
        return torch.nn.functional.linear(x, w.to(x.dtype),
                                          self.decoder_bias.to(x.dtype))

    def compute_loss(self, logits, labels, ignore_index=-100):
        """Masked-position cross entropy with fp32 accumulation (labels
        equal to ignore_index, or negative, are left out).  Fused mode
        follows forward's own gate (the flag and training); the shape
        check only catches logits computed outside it."""
        cfg = self.config
        if get_flag("fused_ce") and self.training \
                and logits.shape[-1] == cfg.hidden_size:
            return F.fused_cross_entropy(
                logits, labels,
                weight=self.bert.embeddings.word_embeddings.weight,
                bias=self.decoder_bias, transpose_weight=True,
                ignore_index=ignore_index)
        return F.fused_cross_entropy(logits, labels,
                                     ignore_index=ignore_index)
