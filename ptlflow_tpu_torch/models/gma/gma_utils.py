"""GMA's attention (``ptlflow_tpu/models/gma/gma_utils.py``), NCHW: the
relative-position embedding, the attention over the context features and
the global motion aggregation.

Attribute names, and the reference's persistent ``rel_ind`` buffer, are the
reference's, so its checkpoints load with ``strict=True``.  The attention
products are plain matrix products (``torch.matmul``/``einsum``), as the
JAX package computes them outside any Pallas kernel; the similarity and
its softmax are taken in float32.  The convolutions cast their weights to
their input's dtype, as the JAX package's do.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import CastConv2d


class RelPosEmb(nn.Module):
    def __init__(self, max_pos_size: int, dim_head: int):
        super().__init__()
        self.rel_height = nn.Embedding(2 * max_pos_size - 1, dim_head)
        self.rel_width = nn.Embedding(2 * max_pos_size - 1, dim_head)
        deltas = (torch.arange(max_pos_size).view(1, -1)
                  - torch.arange(max_pos_size).view(-1, 1))
        # rel_ind[x, u] = u - x + max_pos_size - 1
        self.register_buffer("rel_ind", deltas + max_pos_size - 1)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        """q (B, heads, h, w, d) -> scores (B, heads, h, w, h, w)."""
        h, w = q.shape[2:4]
        height_emb = self.rel_height(self.rel_ind[:h, :h]).to(q.dtype)
        width_emb = self.rel_width(self.rel_ind[:w, :w]).to(q.dtype)
        height_score = torch.einsum("bhxyd,xud->bhxyu", q, height_emb)
        width_score = torch.einsum("bhxyd,yvd->bhxyv", q, width_emb)
        return height_score[..., :, None] + width_score[..., None, :]


class Attention(nn.Module):
    def __init__(self, dim: int, position_only: bool = False,
                 position_and_content: bool = False, max_pos_size: int = 100,
                 heads: int = 4, dim_head: int = 128):
        super().__init__()
        self.position_only = position_only
        self.position_and_content = position_and_content
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.to_qk = CastConv2d(dim, heads * dim_head * 2, 1, bias=False)
        self.pos_emb = RelPosEmb(max_pos_size, dim_head)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        """fmap (B, C, H, W) -> attention (B, heads, HW, HW) in fmap's
        dtype, rows over the query pixels in (y, x) order."""
        b, _, h, w = fmap.shape
        heads, d = self.heads, self.dim_head
        q, k = self.to_qk(fmap).chunk(2, dim=1)
        # channel head*d + i of q and k is feature i of that head
        q = self.scale * q.reshape(b, heads, d, h * w).transpose(-1, -2)
        k = k.reshape(b, heads, d, h * w)
        if self.position_only:
            sim = self.pos_emb(q.reshape(b, heads, h, w, d))
        elif self.position_and_content:
            sim = torch.matmul(q, k) + self.pos_emb(
                q.reshape(b, heads, h, w, d)).reshape(b, heads, h * w, h * w)
        else:
            sim = torch.matmul(q.float(), k.float())
        sim = sim.reshape(b, heads, h * w, h * w)
        return torch.softmax(sim.float(), dim=-1).to(fmap.dtype)


class Aggregate(nn.Module):
    """``fmap + gamma * project(attention @ to_v(fmap))``; ``gamma``
    starts at 0, so an untrained aggregator adds nothing."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 128):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.to_v = CastConv2d(dim, inner, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.project = (CastConv2d(inner, dim, 1, bias=False)
                        if dim != inner else None)

    def init_own_params(self, gen: torch.Generator) -> None:
        self.gamma.zero_()

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        b, _, h, w = fmap.shape
        v = self.to_v(fmap).reshape(b, self.heads, self.dim_head, h * w)
        out = torch.matmul(attn, v.transpose(-1, -2))  # (B, heads, HW, d)
        out = out.transpose(-1, -2).reshape(b, self.heads * self.dim_head,
                                            h, w)
        if self.project is not None:
            out = self.project(out)
        return fmap + self.gamma.to(fmap.dtype) * out
