"""The DINOv2 vision transformer of DepthAnything V2
(``ptlflow_tpu/models/waft/dinov2.py``): tokens (B, N, D), images NCHW.

Patch-14 embedding, the cls token, the position embedding resized
bicubically with explicit scale factors (h0 + 0.1) / sqrt(N) (DINOv2's
0.1-offset quirk, ``ops.interpolate_bicubic``), pre-norm blocks with
LayerScale, and the final LayerNorm applied to every tapped block's tokens.
Attention is ``F.scaled_dot_product_attention`` in the tokens' dtype
(float32: no model of the zoo runs these ViTs in another); every layer
casts its weights to its input's dtype.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, CastLinear, LayerNorm
from ...ops.grid_sample import interpolate_bicubic


class VitAttention(nn.Module):
    """Fused ``qkv`` projection, multi-head attention, ``proj``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 proj_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = CastLinear(dim, dim * 3, bias=qkv_bias)
        self.proj = CastLinear(dim, dim, bias=proj_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, h, c // h).permute(
            2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(q, k, v, scale=self.scale)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class VitMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = CastLinear(dim, hidden)
        self.fc2 = CastLinear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class LayerScale(nn.Module):
    """A learnable per-channel ``gamma``, ``init_values`` at init."""

    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.gamma.fill_(self.init_values)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class VitBlock(nn.Module):
    """Pre-norm attention and MLP, each scaled by a LayerScale where
    ``init_values`` is given (DINOv2's; timm's ViT block without)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, init_values=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = VitAttention(dim, num_heads, qkv_bias=qkv_bias)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = VitMlp(dim, int(dim * mlp_ratio))
        self.ls1 = LayerScale(dim, init_values) if init_values else None
        self.ls2 = LayerScale(dim, init_values) if init_values else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.attn(self.norm1(x))
        if self.ls1 is not None:
            a = self.ls1(a)
        x = x + a
        m = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            m = self.ls2(m)
        return x + m


class VitPatchEmbed(nn.Module):
    """Patchify by a stride-``patch_size`` convolution: (B, C, H, W) ->
    (B, h*w, D)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = CastConv2d(in_chans, embed_dim, patch_size,
                               stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)


class DinoVisionTransformer(nn.Module):
    """DepthAnything V2's DINOv2: patch 14, image 518, LayerScale 1.0, no
    register tokens, interpolation offset 0.1.  ``mask_token`` is never
    read; it is kept for the checkpoints."""

    CONFIGS = {
        "vits": dict(embed_dim=384, depth=12, num_heads=6),
        "vitb": dict(embed_dim=768, depth=12, num_heads=12),
        "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
    }

    def __init__(self, model_name: str = "vits", img_size: int = 518,
                 patch_size: int = 14, init_values: float = 1.0,
                 interpolate_offset: float = 0.1):
        super().__init__()
        cfg = self.CONFIGS[model_name]
        self.embed_dim = cfg["embed_dim"]
        self.depth = cfg["depth"]
        self.patch_size = patch_size
        self.interpolate_offset = interpolate_offset
        self.num_patches = (img_size // patch_size) ** 2
        self.patch_embed = VitPatchEmbed(patch_size, 3, self.embed_dim)
        self.blocks = nn.ModuleList([
            VitBlock(self.embed_dim, cfg["num_heads"], 4.0, qkv_bias=True,
                     init_values=init_values) for _ in range(self.depth)])
        self.norm = LayerNorm(self.embed_dim, eps=1e-6)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, self.embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.num_patches + 1, self.embed_dim))
        self.mask_token = nn.Parameter(torch.zeros(1, self.embed_dim))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.cls_token.zero_()
        self.mask_token.zero_()
        nn.init.trunc_normal_(self.pos_embed, std=1.0, a=-2.0, b=2.0,
                              generator=gen)
        self.pos_embed.mul_(0.02)

    def _pos_encoding(self, npatch: int, h: int, w: int) -> torch.Tensor:
        """The position embedding for an (h, w) image: bicubically resized
        with the explicit factors (h0 + 0.1) / sqrt(N), (w0 + 0.1) /
        sqrt(N) to (h0, w0) patches, in float32."""
        pos_embed = self.pos_embed
        n = pos_embed.shape[1] - 1
        if npatch == n and w == h:
            return pos_embed
        dim = pos_embed.shape[-1]
        h0, w0 = h // self.patch_size, w // self.patch_size
        sqrt_n = int(math.sqrt(n))
        sy = (h0 + self.interpolate_offset) / sqrt_n
        sx = (w0 + self.interpolate_offset) / sqrt_n
        grid = pos_embed[:, 1:].float().reshape(1, sqrt_n, sqrt_n, dim)
        grid = interpolate_bicubic(grid.permute(0, 3, 1, 2), (sy, sx),
                                   size=(h0, w0))
        patch_pos = grid.flatten(2).transpose(1, 2).to(pos_embed.dtype)
        return torch.cat([pos_embed[:, :1], patch_pos], dim=1)

    def get_intermediate_layers(self, x: torch.Tensor, idx: Sequence[int]
                                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """(B, 3, H, W) image -> [(patch tokens (B, N, D), cls token (B,
        D))] after each block in ``idx``, each normed by ``norm``."""
        b, _, h, w = x.shape
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(tokens.dtype).expand(b, 1, self.embed_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self._pos_encoding(tokens.shape[1] - 1, h,
                                             w).to(tokens.dtype)
        outs = []
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in idx:
                outs.append(tokens)
        outs = [self.norm(t) for t in outs]
        return [(t[:, 1:], t[:, 0]) for t in outs]
