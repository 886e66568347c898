"""Diffusion UNet — BASELINE config 5 (a Stable-Diffusion-style
conditional UNet trained on epsilon prediction), in PyTorch.

Counterpart of `paddle_tpu/models/unet.py`: `UNetConfig` (:33),
`unet_tiny_config` (:46), `unet_sd_config` (:56), `timestep_embedding`
(:63, fp32), `ResnetBlock` (:73, GroupNorm + SiLU, the timestep added
per channel), `AttentionBlock` (:97: GroupNorm, then self-attention over
the spatial tokens, LayerNorm and cross-attention over
`encoder_hidden_states`, LayerNorm and the GELU MLP, each a residual on
the raw tokens), `UNet2DConditionModel` (:151: conv_in, the down path
with its skips, a mid block, the up path concatenating the skips,
nearest x2 upsampling, GroupNorm + SiLU + conv_out) and `compute_loss`
(:263, fp32 MSE).  NCHW, as the reference.  The blocks are the port's
nn layers, so parameters keep the reference's structural names
(`down_attns.2.cross_k.weight`; a level without attention holds None in
its LayerList slot, as the reference's) and its [in, out] Linear layout,
and the reference's numpy weights load by name (models/convert.py).

Attention is `ops.attention(q, k, v, causal=False)` on [b, s, heads,
channels / heads]: the Hopper flash kernels, forward and backward, on the
card (`unet_sd_config`'s 640 and 1280 channels over 8 heads are head
dims 80 and 160; the cross-attention's keys are the 77 context tokens);
the plain version on the CPU.

`config.dtype` is the COMPUTE dtype: the parameters are fp32 masters
and `nn.set_compute_dtype` switches every Linear, convolution, LayerNorm
and GroupNorm to it (fp32 normalization statistics), as the reference
does (:195-198).  The timestep embedding stays fp32 until `temb1`.

Device rule: the model builds on `cuda` unless given `device="cpu"`, and
raises with no CUDA device.  Random init draws from a `torch.Generator`
seeded with `seed` (the layers' initializers: XavierNormal Linear
weights, Kaiming-uniform convolutions, unit norm scales); the two
packages' streams differ, so parity tests load the same numpy weights
into both.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import nn, ops
from ..framework.device import init_generator, resolve_device
from ..nn import functional as F
from ..nn.layer import Layer

__all__ = ["UNetConfig", "UNet2DConditionModel", "unet_tiny_config",
           "unet_sd_config", "timestep_embedding"]


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: tuple = (320, 640, 1280)
    layers_per_block: int = 2
    attention_levels: tuple = (1, 2)   # indices into block_channels
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_groups: int = 32
    # the COMPUTE dtype; parameters are always fp32 masters
    dtype: str = "float32"


def unet_tiny_config(**kw):
    cfg = UNetConfig(in_channels=4, out_channels=4,
                     block_channels=(32, 64), layers_per_block=1,
                     attention_levels=(1,), num_attention_heads=4,
                     cross_attention_dim=32, norm_groups=8)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def unet_sd_config(**kw):
    cfg = UNetConfig()
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def timestep_embedding(t, dim, max_period=10000.0):
    """Sinusoidal timestep embedding [b, dim] in fp32 (DDPM recipe):
    cos then sin of t x exp(-ln(max_period) i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock(Layer):
    def __init__(self, in_c, out_c, temb_c, groups, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.GroupNorm(groups, in_c, **kw)
        self.conv1 = nn.Conv2D(in_c, out_c, 3, padding=1, **kw)
        self.temb_proj = nn.Linear(temb_c, out_c, **kw)
        self.norm2 = nn.GroupNorm(groups, out_c, **kw)
        self.conv2 = nn.Conv2D(out_c, out_c, 3, padding=1, **kw)
        self.skip = nn.Conv2D(in_c, out_c, 1, **kw) if in_c != out_c \
            else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.temb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (self.skip(x) if self.skip is not None else x)


class AttentionBlock(Layer):
    """Self-attention + cross-attention over flattened spatial tokens
    (the transformer block of SD's UNet, single depth)."""

    def __init__(self, channels, heads, cross_dim, groups, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.heads = heads
        self.norm = nn.GroupNorm(groups, channels, **kw)
        self.to_q = nn.Linear(channels, channels, bias_attr=False, **kw)
        self.to_k = nn.Linear(channels, channels, bias_attr=False, **kw)
        self.to_v = nn.Linear(channels, channels, bias_attr=False, **kw)
        self.to_out = nn.Linear(channels, channels, **kw)
        self.norm_cross = nn.LayerNorm(channels, **kw)
        self.cross_q = nn.Linear(channels, channels, bias_attr=False, **kw)
        self.cross_k = nn.Linear(cross_dim, channels, bias_attr=False, **kw)
        self.cross_v = nn.Linear(cross_dim, channels, bias_attr=False, **kw)
        self.cross_out = nn.Linear(channels, channels, **kw)
        self.norm_ff = nn.LayerNorm(channels, **kw)
        self.ff1 = nn.Linear(channels, channels * 4, **kw)
        self.ff2 = nn.Linear(channels * 4, channels, **kw)

    def _attend(self, q, k, v):
        b, sq, c = q.shape
        sk, hd = k.shape[1], c // self.heads
        out = ops.attention(q.reshape(b, sq, self.heads, hd),
                            k.reshape(b, sk, self.heads, hd),
                            v.reshape(b, sk, self.heads, hd), causal=False)
        return out.reshape(b, sq, c)

    def forward(self, x, context):
        b, c, hgt, wid = x.shape

        def to_tokens(v):
            return v.reshape(b, c, hgt * wid).transpose(1, 2)

        # pre-norm transformer block over spatial tokens: each branch
        # normalizes its own input; the residual stream carries the raw
        # tokens (SD's proj-out residual shape)
        h = to_tokens(x)
        normed = to_tokens(self.norm(x))
        h = h + self.to_out(self._attend(
            self.to_q(normed), self.to_k(normed), self.to_v(normed)))
        hc = self.norm_cross(h)
        h = h + self.cross_out(self._attend(
            self.cross_q(hc), self.cross_k(context), self.cross_v(context)))
        h = h + self.ff2(F.gelu(self.ff1(self.norm_ff(h))))
        return h.transpose(1, 2).reshape(b, c, hgt, wid)


class UNet2DConditionModel(Layer):
    """forward(sample [b, in, H, W], timesteps [b], encoder_hidden_states
    [b, ctx, cross_dim]) -> the predicted noise [b, out, H, W]."""

    def __init__(self, config: UNetConfig, device=None, seed: int = 0,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = init_generator(dev, seed, generator)
        kw = dict(device=dev, generator=gen)
        cfg = self.config = config
        chans = cfg.block_channels
        temb_c = chans[0] * 4
        g = cfg.norm_groups
        self.temb1 = nn.Linear(chans[0], temb_c, **kw)
        self.temb2 = nn.Linear(temb_c, temb_c, **kw)
        self.conv_in = nn.Conv2D(cfg.in_channels, chans[0], 3, padding=1,
                                 **kw)

        def attn(c):
            return AttentionBlock(c, cfg.num_attention_heads,
                                  cfg.cross_attention_dim, g, dev, gen)

        self.down_blocks = nn.LayerList()
        self.down_attns = nn.LayerList()
        self.downsamplers = nn.LayerList()
        in_c = chans[0]
        for level, out_c in enumerate(chans):
            for _ in range(cfg.layers_per_block):
                self.down_blocks.append(ResnetBlock(in_c, out_c, temb_c, g,
                                                    dev, gen))
                self.down_attns.append(
                    attn(out_c) if level in cfg.attention_levels else None)
                in_c = out_c
            self.downsamplers.append(
                nn.Conv2D(out_c, out_c, 3, stride=2, padding=1, **kw)
                if level < len(chans) - 1 else None)

        self.mid_block1 = ResnetBlock(in_c, in_c, temb_c, g, dev, gen)
        self.mid_attn = attn(in_c)
        self.mid_block2 = ResnetBlock(in_c, in_c, temb_c, g, dev, gen)

        self.up_blocks = nn.LayerList()
        self.up_attns = nn.LayerList()
        self.upsamplers = nn.LayerList()
        skip_chans = self._skip_channels()
        for level in reversed(range(len(chans))):
            out_c = chans[level]
            for _ in range(cfg.layers_per_block + 1):
                skip_c = skip_chans.pop()
                self.up_blocks.append(ResnetBlock(in_c + skip_c, out_c,
                                                  temb_c, g, dev, gen))
                self.up_attns.append(
                    attn(out_c) if level in cfg.attention_levels else None)
                in_c = out_c
            self.upsamplers.append(
                nn.Conv2D(out_c, out_c, 3, padding=1, **kw)
                if level > 0 else None)

        self.norm_out = nn.GroupNorm(g, chans[0], **kw)
        self.conv_out = nn.Conv2D(chans[0], cfg.out_channels, 3, padding=1,
                                  **kw)
        if cfg.dtype != "float32":
            nn.set_compute_dtype(self, cfg.dtype)

    def _skip_channels(self):
        cfg = self.config
        chans = cfg.block_channels
        skips = [chans[0]]
        for level, out_c in enumerate(chans):
            skips.extend([out_c] * cfg.layers_per_block)
            if level < len(chans) - 1:
                skips.append(out_c)
        return skips

    def forward(self, sample, timesteps, encoder_hidden_states):
        cfg = self.config
        dev = self.conv_in.weight.device
        t = torch.as_tensor(timesteps, device=dev)
        temb = timestep_embedding(t, cfg.block_channels[0])
        temb = self.temb2(F.silu(self.temb1(temb)))

        h = self.conv_in(sample)
        skips = [h]
        i = 0
        for level in range(len(cfg.block_channels)):
            for _ in range(cfg.layers_per_block):
                h = self.down_blocks[i](h, temb)
                if self.down_attns[i] is not None:
                    h = self.down_attns[i](h, encoder_hidden_states)
                skips.append(h)
                i += 1
            ds = self.downsamplers[level]
            if ds is not None:
                h = ds(h)
                skips.append(h)

        h = self.mid_block1(h, temb)
        h = self.mid_attn(h, encoder_hidden_states)
        h = self.mid_block2(h, temb)

        i = 0
        for li in range(len(cfg.block_channels)):
            for _ in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = self.up_blocks[i](h, temb)
                if self.up_attns[i] is not None:
                    h = self.up_attns[i](h, encoder_hidden_states)
                i += 1
            us = self.upsamplers[li]
            if us is not None:
                # jax.image.resize "nearest" at exactly x2 repeats each
                # pixel, as this does
                h = us(torch.nn.functional.interpolate(h, scale_factor=2,
                                                       mode="nearest"))

        return self.conv_out(F.silu(self.norm_out(h)))

    def compute_loss(self, pred_eps, true_eps):
        return torch.mean((pred_eps.float() - true_eps.float()) ** 2)
