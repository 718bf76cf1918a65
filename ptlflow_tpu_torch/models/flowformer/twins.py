"""Twins-SVT backbone, its first two stages
(``ptlflow_tpu/models/flowformer/twins_tpu.py``).

The reference keeps stages 0-1 of timm's ``twins_svt_large``, so its
checkpoints store the backbone under ``svt.``: timm's locally-grouped
attention with a fused ``qkv``, its global sub-sampled attention with ``q``
and a fused ``kv``, the positional convolutions and the final ``norm`` of
the whole model, which the two stages never run and which is kept for the
checkpoints.  Tokens are (B, N, C) in raster order; images and features
are NCHW.

Every layer casts its weights to its input's dtype (``CastLinear``,
``CastConv2d``), as the JAX package's layers do, so a model whose weights
were cast to bfloat16 by ``cast_params`` still computes in its input's
dtype; attention logits and their softmax are taken in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, CastLinear, LayerNorm


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int = None):
        super().__init__()
        self.fc1 = CastLinear(in_features, hidden_features)
        self.fc2 = CastLinear(hidden_features, out_features or in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
         scale: float) -> torch.Tensor:
    """(B, N, C) multi-head attention of q against (B, M, C) k and v: the
    logits and their softmax in float32, the weights then cast to v's dtype
    and applied in it.  v may be wider or narrower than q and k."""
    b, n, c = q.shape
    m, cv = k.shape[1], v.shape[2]
    q = q.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)
    k = k.reshape(b, m, num_heads, c // num_heads).transpose(1, 2)
    v = v.reshape(b, m, num_heads, cv // num_heads).transpose(1, 2)
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    out = torch.matmul(attn, v)
    return out.transpose(1, 2).reshape(b, n, cv)


def windows(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, Hp, Wp, C) with sides divisible by ``ws`` -> (B*nh*nw, ws*ws, C),
    window by window in raster order."""
    b, hp, wp, c = x.shape
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).transpose(2, 3)
    return x.reshape(-1, ws * ws, c)


def unwindow(x: torch.Tensor, b: int, hp: int, wp: int,
             ws: int) -> torch.Tensor:
    """The inverse of :func:`windows`: -> (B, Hp, Wp, C)."""
    c = x.shape[-1]
    x = x.reshape(b, hp // ws, wp // ws, ws, ws, c).transpose(2, 3)
    return x.reshape(b, hp, wp, c)


def pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad (B, H, W, C) at the bottom and right to multiples of
    ``mult``."""
    h, w = x.shape[1:3]
    return F.pad(x, (0, 0, 0, (mult - w % mult) % mult,
                     0, (mult - h % mult) % mult))


class LocallyGroupedAttn(nn.Module):
    """timm's LSA: attention inside ws x ws windows of the zero-padded
    map."""

    def __init__(self, dim: int, num_heads: int = 8, ws: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.ws = ws
        self.qkv = CastLinear(dim, dim * 3, bias=True)
        self.proj = CastLinear(dim, dim)

    def forward(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        h, w = size
        xp = pad_to(x.reshape(b, h, w, c), self.ws)
        hp, wp = xp.shape[1:3]
        q, k, v = self.qkv(windows(xp, self.ws)).chunk(3, dim=-1)
        out = _mha(q, k, v, self.num_heads, self.scale)
        out = unwindow(out, b, hp, wp, self.ws)[:, :h, :w]
        return self.proj(out.reshape(b, n, c))


class GlobalSubSampleAttn(nn.Module):
    """timm's GSA: every token against the map sub-sampled by an sr x sr
    stride-sr convolution and normalised."""

    def __init__(self, dim: int, num_heads: int = 8, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.q = CastLinear(dim, dim, bias=True)
        self.kv = CastLinear(dim, dim * 2, bias=True)
        self.proj = CastLinear(dim, dim)
        self.sr_ratio = sr_ratio
        if sr_ratio > 1:
            self.sr = CastConv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        h, w = size
        kv_in = x
        if self.sr_ratio > 1:
            xi = x.transpose(1, 2).reshape(b, c, h, w)
            kv_in = self.norm(self.sr(xi).flatten(2).transpose(1, 2))
        k, v = self.kv(kv_in).chunk(2, dim=-1)
        out = _mha(self.q(x), k, v, self.num_heads, self.scale)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 sr_ratio: int = 1, ws: int = 1):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        if ws == 1:
            self.attn = GlobalSubSampleAttn(dim, num_heads, sr_ratio)
        else:
            self.attn = LocallyGroupedAttn(dim, num_heads, ws)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), size)
        return x + self.mlp(self.norm2(x))


class PosConv(nn.Module):
    """A depthwise 3x3 convolution added to its input."""

    def __init__(self, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Sequential(
            CastConv2d(in_chans, embed_dim, 3, 1, 1, groups=embed_dim,
                       bias=True))

    def forward(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        b, n, c = x.shape
        feat = x.transpose(1, 2).reshape(b, c, *size)
        return (self.proj(feat) + feat).flatten(2).transpose(1, 2)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = CastConv2d(in_chans, embed_dim, patch_size,
                               stride=patch_size)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor):
        """(B, C_in, H, W) -> tokens (B, h*w, C) and (h, w)."""
        y = self.proj(x)
        size = tuple(y.shape[-2:])
        return self.norm(y.flatten(2).transpose(1, 2)), size


class TwinsSVT(nn.Module):
    """``twins_svt_large`` cut to 2 stages (dims 128/256)."""

    def __init__(self, embed_dims=(128, 256), num_heads=(4, 8),
                 mlp_ratios=(4, 4), depths=(2, 2), sr_ratios=(8, 4),
                 wss=(7, 7), in_chans=3, patch_size=4):
        super().__init__()
        self.depths = depths
        self.patch_embeds = nn.ModuleList([
            PatchEmbed(patch_size if i == 0 else 2,
                       in_chans if i == 0 else embed_dims[i - 1],
                       embed_dims[i])
            for i in range(len(depths))])
        self.blocks = nn.ModuleList([
            nn.ModuleList([
                Block(embed_dims[k], num_heads[k], mlp_ratios[k],
                      sr_ratio=sr_ratios[k],
                      ws=1 if i % 2 == 1 else wss[k])
                for i in range(depths[k])])
            for k in range(len(depths))])
        self.pos_block = nn.ModuleList([PosConv(d, d) for d in embed_dims])
        # timm's final norm of the whole model: never run by two stages,
        # kept so that the reference's checkpoints load strictly
        self.norm = LayerNorm(1024, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, C_last, H/8, W/8)."""
        b = x.shape[0]
        for i in range(len(self.depths)):
            x, size = self.patch_embeds[i](x)
            for j, blk in enumerate(self.blocks[i]):
                x = blk(x, size)
                if j == 0:
                    x = self.pos_block[i](x, size)
            x = x.transpose(1, 2).reshape(b, -1, *size)
        return x


class twins_svt_large(nn.Module):
    """The backbone under the checkpoints' ``svt.`` prefix."""

    def __init__(self):
        super().__init__()
        self.svt = TwinsSVT()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.svt(x)
