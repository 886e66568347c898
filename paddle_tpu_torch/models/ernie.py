"""ERNIE — BERT's post-LN encoder plus a task-type embedding, in PyTorch.

Counterpart of `paddle_tpu/models/ernie.py`: `ErnieConfig` (:27),
`ernie_tiny_config` (:32), `ErnieEmbeddings` (:42, word + position +
token-type + task-type), `ErnieModel` (:78), `ErnieForSequenceClassification`
(:98) and `ErnieForMaskedLM` (:118).  The encoder blocks, the pooler and
the MLM head are models/bert.py's, through its subclass hooks
(`embeddings_cls`, `backbone_cls`): what models/bert.py says of
attention (a keep-mask reaches the flash kernels as a key-padding
mask), the compute dtype, the device rule and the seeded init holds
here.

As in the reference, `ErnieForMaskedLM.forward` always returns logits
(it has no `FLAGS_fused_ce` gate), and `ernie` is an alias of `bert`:
parameters keep the `bert.` names, and `nn.set_compute_dtype` counts the
aliased layers twice, as the reference's walk does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..framework.device import init_generator, resolve_device
from ..nn import functional as F
from ..nn.layer import Layer
from .bert import BertConfig, BertForMaskedLM, BertModel

__all__ = ["ErnieConfig", "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForMaskedLM", "ernie_tiny_config"]


@dataclass
class ErnieConfig(BertConfig):
    task_type_vocab_size: int = 3
    use_task_id: bool = True


def ernie_tiny_config(**kw):
    cfg = ErnieConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=64)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


class ErnieEmbeddings(Layer):
    """word + position + token-type + task-type embeddings."""

    def __init__(self, config: ErnieConfig, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        h = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, h,
                                                  **kw)
        self.task_type_embeddings = nn.Embedding(
            config.task_type_vocab_size, h, **kw) if config.use_task_id \
            else None
        self.layer_norm = nn.LayerNorm(h, epsilon=config.layer_norm_eps,
                                       **kw)
        self.dropout = nn.Dropout(config.hidden_dropout_prob,
                                  generator=generator)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None,
                position_ids=None):
        seq, dev = input_ids.shape[1], input_ids.device
        pos = position_ids if position_ids is not None \
            else torch.arange(seq, device=dev)[None, :]
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                task_type_ids = torch.zeros((1, seq), dtype=torch.int64,
                                            device=dev)
            x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x))


class ErnieModel(BertModel):
    """forward(input_ids, token_type_ids, position_ids, attention_mask,
    task_type_ids) -> (sequence_output, pooled_output)."""

    embeddings_cls = ErnieEmbeddings

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        x = self.embeddings(input_ids, token_type_ids, task_type_ids,
                            position_ids=position_ids)
        for layer in self.layers:
            x = layer(x, attention_mask)
        return x, self._pool(x)


class ErnieForSequenceClassification(Layer):
    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = init_generator(dev, seed)
        self.ernie = ErnieModel(config, dev, generator=gen)
        self.dropout = nn.Dropout(config.hidden_dropout_prob, generator=gen)
        self.classifier = nn.Linear(config.hidden_size, num_classes,
                                    device=dev, generator=gen)
        if config.dtype != "float32":
            nn.set_compute_dtype(self, config.dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids=token_type_ids,
                               attention_mask=attention_mask,
                               task_type_ids=task_type_ids)
        return self.classifier(self.dropout(pooled))

    def compute_loss(self, logits, labels):
        return F.cross_entropy(logits, labels)


class ErnieForMaskedLM(BertForMaskedLM):
    """BertForMaskedLM's head (transform + tied decoder + the loss) over
    an ErnieModel; forward returns logits."""

    backbone_cls = ErnieModel

    def __init__(self, config: ErnieConfig, device=None, seed: int = 0):
        super().__init__(config, device, seed)
        self.ernie = self.bert              # the reference's attribute name

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        seq_out, _ = self.bert(input_ids, token_type_ids=token_type_ids,
                               attention_mask=attention_mask,
                               task_type_ids=task_type_ids)
        return self._decode(self._transform(seq_out))
