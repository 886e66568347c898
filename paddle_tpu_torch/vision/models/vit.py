"""Vision Transformer.

Counterpart of `paddle_tpu/vision/models/vit.py`: `_MHA` (:23, one
[dim, 3 dim] qkv projection, attention through `ops.attention`),
`_Block` (:44, pre-LN, GELU in its tanh form), `VisionTransformer`
(:62: the patches cut by one stride-`patch_size` convolution, a zero
class token and a N(0, 0.02) position table as parameters, the encoder,
a final LayerNorm and a Linear head on the class token) and `vit_b_16`,
`vit_s_16` and `vit_tiny_patch4` (:107-129).  NCHW input, fp32
parameters; the structural names are the reference's (`blocks.3.attn.
qkv.weight`, `cls_token`, `pos_embed`), so its `state_dict()` loads by
name.  Attention is non-causal and unmasked: the Hopper flash kernels
on the card (ViT-B/16: 197 tokens, 12 heads of 64), the plain version
on the CPU.
"""
from __future__ import annotations

import torch

from ... import nn, ops
from ...nn import functional as F
from ...nn.initializer import Normal
from ._init import device_and_generator

__all__ = ["VisionTransformer", "vit_b_16", "vit_s_16", "vit_tiny_patch4"]


class _MHA(nn.Layer):
    """Encoder self-attention over [B, N, D] token streams."""

    def __init__(self, dim, num_heads, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3, **kw)
        self.proj = nn.Linear(dim, dim, **kw)

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = (t.contiguous() for t in self.qkv(x).reshape(
            b, n, 3, self.num_heads, self.head_dim).unbind(2))
        out = ops.attention(q, k, v, causal=False)
        return self.proj(out.reshape(b, n, self.num_heads * self.head_dim))


class _Block(nn.Layer):
    """Pre-LN transformer block (ViT standard)."""

    def __init__(self, dim, num_heads, mlp_ratio=4.0, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, **kw)
        self.attn = _MHA(dim, num_heads, **kw)
        self.norm2 = nn.LayerNorm(dim, **kw)
        hidden = int(dim * mlp_ratio)
        self.fc1 = nn.Linear(dim, hidden, **kw)
        self.fc2 = nn.Linear(hidden, dim, **kw)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x)),
                                   approximate=True))


class VisionTransformer(nn.Layer):
    def __init__(self, image_size=224, patch_size=16, embed_dim=768,
                 depth=12, num_heads=12, mlp_ratio=4.0, num_classes=1000,
                 in_channels=3, *, device=None, seed=0, generator=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple "
                             f"of patch_size {patch_size}")
        dev, gen = device_and_generator(device, seed, generator)
        kw = dict(device=dev, generator=gen)
        n_patches = (image_size // patch_size) ** 2
        self.patch_embed = nn.Conv2D(in_channels, embed_dim,
                                     kernel_size=patch_size,
                                     stride=patch_size, **kw)
        self.cls_token = torch.nn.Parameter(
            torch.zeros(1, 1, embed_dim, device=dev))
        self.pos_embed = torch.nn.Parameter(Normal(0.0, 0.02)(
            (1, n_patches + 1, embed_dim), device=dev, generator=gen))
        self.blocks = nn.LayerList(
            [_Block(embed_dim, num_heads, mlp_ratio, **kw)
             for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, **kw)
        self.head = nn.Linear(embed_dim, num_classes, **kw)

    def forward(self, x):
        x = self.patch_embed(x)                      # [B, D, H', W']
        b, d = x.shape[0], x.shape[1]
        tok = x.reshape(b, d, -1).transpose(1, 2)    # [B, N, D]
        cls = self.cls_token.to(tok.dtype).expand(b, 1, d)
        x = torch.cat([cls, tok], dim=1) + self.pos_embed.to(tok.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x)[:, 0])


def vit_b_16(**kw):
    cfg = dict(image_size=224, patch_size=16, embed_dim=768, depth=12,
               num_heads=12)
    cfg.update(kw)
    return VisionTransformer(**cfg)


def vit_s_16(**kw):
    cfg = dict(image_size=224, patch_size=16, embed_dim=384, depth=12,
               num_heads=6)
    cfg.update(kw)
    return VisionTransformer(**cfg)


def vit_tiny_patch4(**kw):
    """Test-scale ViT (32x32 input, 4x4 patches)."""
    cfg = dict(image_size=32, patch_size=4, embed_dim=64, depth=2,
               num_heads=4, num_classes=10)
    cfg.update(kw)
    return VisionTransformer(**cfg)
