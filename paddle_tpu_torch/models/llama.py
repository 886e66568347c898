"""Llama — the training forward and the decode surface, in PyTorch.

Counterpart of `paddle_tpu/models/llama.py`: `LlamaConfig` (:60),
`llama_tiny_config` (:112), `llama_7b_config` (:132); the training
forward of `LlamaAttention` (:197-246), `LlamaMLP` (:362),
`LlamaDecoderLayer._block` (:466) with the fused mid-block add + norm
`_add_norm_mid` (:428), full and selective recompute
(`LlamaDecoderLayer.forward` / `_forward_selective`, :377-425),
`LlamaModel.forward` (:532) and `LlamaForCausalLM.forward` (:649) /
`compute_loss` (:708) in both loss modes; and the cached decode paths
(:248-310, :475-515, :554-634, :673-692), with the early-exit draft
of speculative decoding (`early_exit_draft` :694, `EarlyExitDraft`
:749-785).  Not ported yet (they raise
NotImplementedError): MoE experts and sequence-parallel ring attention.

Recompute (`recompute=True`, the first `recompute_layers` layers, all
when None) goes through `distributed.fleet.recompute`
(`torch.utils.checkpoint`, non-reentrant).  "full" checkpoints the whole
block: only its input is saved and the backward replays it.
"selective" splits the block as the reference does: region A (input
norm, q/k/v projections, rope) is recomputed, flash attention runs
outside any region (it saves q, k, v, out and lse for its backward), and
region B (o_proj, the fused mid-block add + norm, the MLP, the residual)
is recomputed.  What a selective layer keeps is therefore its input x
and the attention's own residuals; the reference also keeps the
mid-block residual (`save_only_these_names("resid_mid")`), which the
port rebuilds by replaying o_proj in region B.

Under `FLAGS_fused_ce` a model in training mode returns the final hidden
states from `forward`, and `compute_loss` folds the lm head (the tied
embedding, transposed, when `tie_word_embeddings`) into the chunked
fused linear + cross-entropy — the [B, S, V] logits never exist.

Parameters are trainable (`requires_grad=True`).  Serving runs under
`torch.inference_mode()` (inference/generation.py, serving.py), so the
decode paths record no graph; their blocks stay unfused, as the
reference's `_block_cached` is.

Parameters keep the reference's names and its [in, out] layout
(`x @ w`) — `llama.embed_tokens`, `llama.layers.N.self_attn.q_proj`,
…, `lm_head` — so weights carry over by name with no transposes
(models/convert.py).  Each parameter also carries the reference's
automatic name (`auto_name`, e.g. `llamarmsnorm_0.weight`; nn/layer.py),
which `apply_decay_param_fun` sees.  Random init draws from a seeded
`torch.Generator` at std 1/sqrt(fan-in) as the reference's
`_init_weight` (:139) does (the two packages' random streams differ;
parity tests load the same numpy weights into both).

The KV state (dense ring buffers or the paged pool) is updated IN
PLACE: the reference's pure functions return new buffers that the
compiled program donates back; here `forward_cached(_paged)` writes
into the caller's tensors and returns the same objects.  An int8 paged
pool (`kv_dtype="int8"`, reference :573-582) carries per-page per-head
scales; its rows land through the quantizing page write and attention
dequantizes in the kernel.

Weight-only quantization (quantization/weight_only.py) packs the
projections, the MLP and an untied lm head in place; every matmul of
those weights goes through `_wo_mm` (reference :43-56), which runs
`ops.quant_matmul` on a packed layer and the plain `x @ w.to(x.dtype)`
otherwise.  A quantized model is serving-only: `forward` raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import ops
from ..nn import functional as F
from ..nn.layer import Layer
from ..distributed.fleet.recompute import recompute
from ..framework.device import resolve_device
from ..framework.flags import get_flag

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "EarlyExitDraft", "llama_tiny_config", "llama_7b_config"]


def _wo_mm(layer, name, x):
    """`x @ W` for weight `name` of `layer`: through ops.quant_matmul
    when quantize_model packed the layer (the packed weight and its
    `<name>_scale` sibling), else the plain `x @ w.to(x.dtype)`."""
    w = getattr(layer, name)
    wo = getattr(layer, "_wo_dtype", None)
    if wo is None:
        return x @ w.to(x.dtype)
    return ops.quant_matmul(x, w, getattr(layer, name + "_scale"), wo,
                            layer._wo_group)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # storage dtype of the parameters; None = the compute dtype
    param_dtype: str | None = None
    # training-only fields, with the reference's defaults; MoE experts
    # are not ported yet (a model built with them raises)
    recompute: bool = False
    recompute_layers: int | None = None
    recompute_granularity: str = "full"
    moe_num_experts: int = 0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def compute_dtype(self):
        return _DTYPES[self.dtype]

    @property
    def storage_dtype(self):
        return _DTYPES[self.param_dtype or self.dtype]


def llama_tiny_config(**kw):
    cfg = LlamaConfig(vocab_size=512, hidden_size=128,
                      intermediate_size=384, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=4,
                      max_position_embeddings=256)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def llama_7b_config(**kw):
    cfg = LlamaConfig()
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _resolve_kv_dtype(cfg, kv_dtype=None):
    """(torch dtype, quantized?) for the paged KV pool: explicit arg
    beats FLAGS_kv_cache_dtype beats the model compute dtype."""
    name = kv_dtype if kv_dtype is not None \
        else get_flag("kv_cache_dtype", "auto")
    name = str(name)
    if name in ("auto", "", "None"):
        return cfg.compute_dtype, False
    table = {"int8": (torch.int8, True),
             "bfloat16": (torch.bfloat16, False),
             "bf16": (torch.bfloat16, False),
             "float16": (torch.float16, False),
             "fp16": (torch.float16, False),
             "float32": (torch.float32, False),
             "fp32": (torch.float32, False)}
    if name not in table:
        raise ValueError(f"unknown kv_cache_dtype {name!r}; one of "
                         f"auto|{'|'.join(table)}")
    return table[name]


def _param(shape, std, cfg, device, gen):
    w = torch.empty(shape, dtype=cfg.storage_dtype, device=device)
    w.normal_(0.0, std, generator=gen)
    return nn.Parameter(w)


class LlamaRMSNorm(Layer):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        self.weight = nn.Parameter(
            torch.ones(config.hidden_size, dtype=config.storage_dtype,
                       device=device))
        self.eps = config.rms_norm_eps

    def forward(self, x):
        return ops.rms_norm(x, self.weight.to(x.dtype), self.eps)


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        nh, nkv = config.num_attention_heads, config.num_key_value_heads
        std = 1.0 / math.sqrt(h)
        self.q_proj = _param((h, nh * hd), std, config, device, gen)
        self.k_proj = _param((h, nkv * hd), std, config, device, gen)
        self.v_proj = _param((h, nkv * hd), std, config, device, gen)
        self.o_proj = _param((nh * hd, h), std, config, device, gen)

    def qkv_rope(self, x, cos, sin):
        """Projection + rope shared by training and BOTH KV layouts, so
        the paths differ only in where K/V land and how they attend."""
        cfg = self.config
        b, s, _ = x.shape
        q = _wo_mm(self, "q_proj", x).reshape(
            b, s, cfg.num_attention_heads, cfg.head_dim)
        k = _wo_mm(self, "k_proj", x).reshape(
            b, s, cfg.num_key_value_heads, cfg.head_dim)
        v = _wo_mm(self, "v_proj", x).reshape(
            b, s, cfg.num_key_value_heads, cfg.head_dim)
        q, k = ops.apply_rope(q, k, cos, sin)
        return q, k, v

    def core_attention(self, q, k, v):
        """Causal GQA attention over the whole sequence (training):
        `ops.attention`, the flash kernels on the card."""
        return ops.attention(q, k, v, causal=True)

    def output_proj(self, attn):
        b, s = attn.shape[:2]
        return _wo_mm(self, "o_proj", attn.reshape(b, s, -1))

    def forward(self, x, cos, sin):
        return self.output_proj(self.core_attention(
            *self.qkv_rope(x, cos, sin)))

    def forward_cached(self, x, cos, sin, k_cache, v_cache, pos):
        """Dense decode attention: write this step's K/V into the ring
        buffers at `pos` (in place), attend against the whole buffer."""
        q, k, v = self.qkv_rope(x, cos, sin)
        ops.dense_kv_update(k_cache, v_cache, pos, k, v)
        return self.output_proj(ops.cached_attention(q, k_cache, v_cache,
                                                     pos))

    def forward_cached_paged(self, x, cos, sin, cache, page_table, pos,
                             layer, where):
        """Paged decode attention: K/V land in the shared page pool, in
        place — at the flat rows `where` (ops.paged_write_rows) for a
        pool of the compute dtype, or through the quantizing page write
        over the window `where` (ops.paged_write_window) for an int8
        pool; attention walks the pages."""
        q, k, v = self.qkv_rope(x, cos, sin)
        ks, vs = cache.get("k_scale"), cache.get("v_scale")
        if ks is None:
            ops.paged_kv_write(cache["k"], cache["v"], where, k, v, layer)
        else:
            ops.paged_kv_write_int8(cache["k"], cache["v"], ks, vs, where,
                                    k, v, layer)
        return self.output_proj(ops.paged_attention(
            q, cache["k"], cache["v"], page_table, pos, layer, ks, vs))


class LlamaMLP(Layer):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        std = 1.0 / math.sqrt(h)
        self.gate_proj = _param((h, i), std, config, device, gen)
        self.up_proj = _param((h, i), std, config, device, gen)
        self.down_proj = _param((i, h), 1.0 / math.sqrt(i), config, device,
                                gen)

    def forward(self, x):
        return _wo_mm(self, "down_proj",
                      ops.swiglu(_wo_mm(self, "gate_proj", x),
                                 _wo_mm(self, "up_proj", x)))


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, device, gen, layer_idx=0):
        super().__init__()
        self.config = config
        self._recompute = config.recompute and (
            config.recompute_layers is None
            or layer_idx < config.recompute_layers)
        self.self_attn = LlamaAttention(config, device, gen)
        self.mlp = LlamaMLP(config, device, gen)
        self.input_layernorm = LlamaRMSNorm(config, device)
        self.post_attention_layernorm = LlamaRMSNorm(config, device)

    def forward(self, x, cos, sin):
        if self._recompute:
            if self.config.recompute_granularity == "selective":
                return self._forward_selective(x, cos, sin)
            return recompute(self._block, x, cos, sin)
        return self._block(x, cos, sin)

    def _forward_selective(self, x, cos, sin):
        """Region A (norm + q/k/v + rope) and region B (o_proj + add +
        norm + MLP) are recomputed; flash attention between them is not."""
        q, k, v = recompute(self._qkv_part, x, cos, sin)
        attn = self.self_attn.core_attention(q, k, v)
        return recompute(self._post_attention, x, attn)

    def _qkv_part(self, x, cos, sin):
        return self.self_attn.qkv_rope(self.input_layernorm(x), cos, sin)

    def _post_attention(self, x, attn):
        x, h = self._add_norm_mid(x, self.self_attn.output_proj(attn))
        return x + self.mlp(h)

    def _add_norm_mid(self, x, delta):
        """The fused mid-block residual add + RMSNorm: (x + delta, its
        norm) in one kernel pass on the card."""
        norm = self.post_attention_layernorm
        return ops.fused_add_rms_norm(x, delta, norm.weight.to(x.dtype),
                                      norm.eps)

    def _block(self, x, cos, sin):
        a = self.self_attn(self.input_layernorm(x), cos, sin)
        x, h = self._add_norm_mid(x, a)
        return x + self.mlp(h)

    def _block_cached(self, x, attend):
        """norm → attend(h) → residual → norm → MLP → residual;
        `attend` is the only point where the KV layouts differ."""
        x = x + attend(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward_cached(self, x, cos, sin, k_cache, v_cache, pos):
        return self._block_cached(x, lambda h: self.self_attn.forward_cached(
            h, cos, sin, k_cache, v_cache, pos))

    def forward_cached_paged(self, x, cos, sin, cache, page_table, pos,
                             layer, where):
        return self._block_cached(
            x, lambda h: self.self_attn.forward_cached_paged(
                h, cos, sin, cache, page_table, pos, layer, where))


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, device, gen):
        super().__init__()
        self.config = config
        self.embed_tokens = _param((config.vocab_size, config.hidden_size),
                                   1.0 / math.sqrt(config.hidden_size),
                                   config, device, gen)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, gen, i)
             for i in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config, device)

    def forward(self, input_ids):
        """input_ids [b, s] → final hidden states [b, s, h]; rope tables
        [s, head_dim] shared by every batch row."""
        cfg = self.config
        dev = self.embed_tokens.device
        cos, sin = ops.rope_cos_sin(input_ids.shape[1], cfg.head_dim,
                                    cfg.rope_theta, torch.float32,
                                    device=dev)
        x = self.embed_tokens[input_ids.to(torch.int64)].to(cfg.compute_dtype)
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)

    def _embed_rope(self, input_ids, pos):
        """Token embeddings and per-position cos/sin [b, s, d] for
        input_ids [b, s] starting at `pos` (int or [b] tensor)."""
        cfg = self.config
        dev = self.embed_tokens.device
        s = input_ids.shape[1]
        lanes = torch.arange(s, dtype=torch.int32, device=dev)
        if torch.is_tensor(pos) and pos.ndim == 1:
            positions = pos.to(torch.int32)[:, None] + lanes[None]
        else:
            positions = int(pos) + lanes
        cos, sin = ops.rope_cos_sin(s, cfg.head_dim, cfg.rope_theta,
                                    torch.float32, position_ids=positions)
        x = self.embed_tokens[input_ids.to(torch.int64)].to(cfg.compute_dtype)
        return x, cos.contiguous(), sin.contiguous()

    def _depth(self, num_layers):
        """The decoder blocks a cached walk runs: all, or the first
        `num_layers` (an early-exit draft's)."""
        n = len(self.layers) if num_layers is None else int(num_layers)
        if not 0 < n <= len(self.layers):
            raise ValueError(f"num_layers must be 1..{len(self.layers)} "
                             f"(got {n})")
        return n

    def init_cache(self, batch: int, max_len: int,
                   num_layers: Optional[int] = None):
        """Dense KV ring buffers [batch, max_len, n_kv, hd] in the
        compute dtype, one pair a layer of the first `num_layers` (None:
        every layer)."""
        cfg = self.config
        shape = (batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
        dev = self.embed_tokens.device
        return [(torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
                 torch.zeros(shape, dtype=cfg.compute_dtype, device=dev))
                for _ in range(self._depth(num_layers))]

    def init_paged_cache(self, num_pages: int, page_size: int,
                         kv_dtype=None):
        """ONE page pool per K and V, [num_pages, page_size, layers,
        n_kv, head_dim], shared by every serving slot through per-slot
        page tables.  Page 0 is the reserved null page (unmapped table
        entries point there; reads of its rows are position-masked).
        kv_dtype None reads FLAGS_kv_cache_dtype; "int8" adds per-page
        per-head fp32 scales k_scale/v_scale [num_pages, layers, n_kv],
        filled with ones so a zero page dequantizes to zeros."""
        cfg = self.config
        dt, quant = _resolve_kv_dtype(cfg, kv_dtype)
        shape = (num_pages, page_size, len(self.layers),
                 cfg.num_key_value_heads, cfg.head_dim)
        dev = self.embed_tokens.device
        cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev)}
        if quant:
            sshape = shape[:1] + shape[2:4]
            cache["k_scale"] = torch.ones(sshape, dtype=torch.float32,
                                          device=dev)
            cache["v_scale"] = torch.ones(sshape, dtype=torch.float32,
                                          device=dev)
        return cache

    def forward_cached_paged(self, input_ids, cache, page_table, pos):
        """input_ids [b, s]; cache from init_paged_cache (updated in
        place); page_table [b, P_slot] int32; pos [b] int32.  Returns
        (hidden [b, s, h], cache)."""
        x, cos, sin = self._embed_rope(input_ids, pos)
        # where this step's K/V rows land: the same for every layer
        plan = ops.paged_write_window if "k_scale" in cache \
            else ops.paged_write_rows
        where = plan(page_table, pos, input_ids.shape[1],
                     cache["k"].shape[1])
        for li, layer in enumerate(self.layers):
            x = layer.forward_cached_paged(x, cos, sin, cache, page_table,
                                           pos, li, where)
        return self.norm(x), cache

    def forward_cached(self, input_ids, cache, pos,
                       num_layers: Optional[int] = None):
        """input_ids [b, s]; cache from init_cache with the same
        num_layers (updated in place); pos an int (uniform depth) or a
        [b] tensor.  Runs the first `num_layers` blocks (None: all), then
        the final norm.  Returns (hidden, cache)."""
        n = self._depth(num_layers)
        if len(cache) != n:
            raise ValueError(f"a cache of {len(cache)} layers for a walk "
                             f"of {n}")
        x, cos, sin = self._embed_rope(input_ids, pos)
        for layer, (kc, vc) in zip(self.layers[:n], cache):
            x = layer.forward_cached(x, cos, sin, kc, vc, pos)
        return self.norm(x), cache


class LlamaForCausalLM(Layer):
    """Llama with an lm head.  `device` None means CUDA (raises without
    one); pass device="cpu" to run the plain versions on the host.
    Weights are random from `seed` until models.convert loads real
    ones."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        if config.moe_num_experts > 0:
            raise NotImplementedError(
                "MoE experts are not ported yet (moe_num_experts="
                f"{config.moe_num_experts})")
        if config.recompute_granularity not in ("full", "selective"):
            raise ValueError("recompute_granularity must be 'full' or "
                             "'selective', not "
                             f"{config.recompute_granularity!r}")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.config = config
        self.llama = LlamaModel(config, dev, gen)
        if not config.tie_word_embeddings:
            self.lm_head = _param((config.hidden_size, config.vocab_size),
                                  1.0 / math.sqrt(config.hidden_size),
                                  config, dev, gen)

    def forward(self, input_ids):
        """input_ids [b, s] → logits [b, s, V] in the compute dtype; under
        FLAGS_fused_ce in training mode, the final hidden states [b, s,
        h] (compute_loss then folds the lm head into the loss).  A
        weight-only quantized model is serving-only and raises."""
        wo = getattr(self, "_weight_only", None)
        if wo is not None:
            raise RuntimeError(
                f"this model is weight-only quantized ({wo['dtype']}, group "
                f"{wo['group_size']}) and so serving-only: its packed "
                f"weights serve the decode paths (forward_cached, "
                f"forward_cached_paged, ContinuousBatcher); train an "
                f"unquantized model")
        x = self.llama(input_ids)
        if get_flag("fused_ce") and self.training:
            return x
        return self._lm_logits(x)

    def compute_loss(self, logits, labels):
        """Next-token cross entropy in fp32.  Fused mode follows
        forward's own gate (the flag and training), not a guess from
        shapes; the shape check only catches logits computed outside
        it."""
        cfg = self.config
        if get_flag("fused_ce") and self.training \
                and logits.shape[-1] == cfg.hidden_size:
            if cfg.tie_word_embeddings:
                w, tw = self.llama.embed_tokens, True
            else:
                w, tw = self.lm_head, False
            return F.fused_cross_entropy(logits, labels, weight=w,
                                         transpose_weight=tw, shift=True)
        return F.fused_cross_entropy(logits, labels, shift=True)

    def init_cache(self, batch: int, max_len: int,
                   num_layers: Optional[int] = None):
        return self.llama.init_cache(batch, max_len, num_layers)

    def init_paged_cache(self, num_pages: int, page_size: int,
                         kv_dtype=None):
        return self.llama.init_paged_cache(num_pages, page_size, kv_dtype)

    def _lm_logits(self, x):
        """Tied embeddings stay unquantized (the embedding is gathered
        elsewhere); an untied head rides `_wo_mm` like every other
        decode matmul."""
        if self.config.tie_word_embeddings:
            return x @ self.llama.embed_tokens.t().to(x.dtype)
        return _wo_mm(self, "lm_head", x)

    @torch.no_grad()
    def forward_cached_paged(self, input_ids, cache, page_table, pos):
        """Returns (logits [b, s, V], cache) — the pool updated in
        place.  Decode records no graph, as the reference's raw-array
        decode path is not taped."""
        x, cache = self.llama.forward_cached_paged(input_ids, cache,
                                                   page_table, pos)
        return self._lm_logits(x), cache

    @torch.no_grad()
    def forward_cached(self, input_ids, cache, pos,
                       num_layers: Optional[int] = None):
        """Returns (logits [b, s, V], cache) — the ring buffers updated
        in place; no graph is recorded.  num_layers: the first blocks
        only (LlamaModel.forward_cached), as an early-exit draft runs."""
        x, cache = self.llama.forward_cached(input_ids, cache, pos,
                                             num_layers)
        return self._lm_logits(x), cache

    @torch.no_grad()
    def fill_cache(self, input_ids, cache, pos,
                   num_layers: Optional[int] = None):
        """forward_cached without the lm head: writes the KV rows of
        input_ids into the dense cache and returns it.  A draft's
        prefill needs only its cache, and eager PyTorch, unlike the
        reference's compiler, would not drop an unused [b, s, V]
        product."""
        self.llama.forward_cached(input_ids, cache, pos, num_layers)
        return cache

    def early_exit_draft(self, num_layers: int) -> "EarlyExitDraft":
        """Self-drafting draft of speculative decoding: a decode-capable
        view over this model's FIRST `num_layers` decoder blocks + the
        final norm and lm head — no weights of its own."""
        return EarlyExitDraft(self, num_layers)


class EarlyExitDraft:
    """Early-exit draft over a LlamaForCausalLM: embed -> layers[:n] ->
    final norm -> lm head, with its OWN dense KV cache (n layers deep).
    A plain adapter, not a Layer: it owns no parameters and reads the
    target's."""

    def __init__(self, model: LlamaForCausalLM, num_layers: int):
        self._model = model
        self.num_layers = model.llama._depth(num_layers)
        self.config = model.config

    def init_cache(self, batch: int, max_len: int):
        return self._model.init_cache(batch, max_len, self.num_layers)

    def forward_cached(self, input_ids, cache, pos):
        return self._model.forward_cached(input_ids, cache, pos,
                                          self.num_layers)

    def fill_cache(self, input_ids, cache, pos):
        return self._model.fill_cache(input_ids, cache, pos,
                                      self.num_layers)
