"""NeuFlow's shared pieces (``ptlflow_tpu/models/neuflow/neuflow.py``):
the leaky ReLU, scaled dot-product attention and the cross-attention
transformer layer, which NeuFlow v2 reuses.  The rest of ``neuflow`` is
not ported yet (ROADMAP.md, queue 1).

``sdpa`` is the JAX function's arithmetic: float32 scores scaled by
1/sqrt(C), their softmax, then the product with the values, as plain
matrix products (the JAX package computes it outside any Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastLinear, LayerNorm


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention of (B, L, C) queries against (B, M, C) keys over (B, M, D)
    values -> (B, L, D) in v's dtype."""
    scale = torch.rsqrt(torch.tensor(float(q.shape[-1])))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(v.dtype)


class TransformerLayer(nn.Module):
    """``source`` attends to ``target``; the message, normalised, and with
    ``ffn`` passed with the source through an MLP and normalised again, is
    added to the source.  Tokens (B, N, C)."""

    def __init__(self, feature_dim: int, ffn: bool = True,
                 ffn_dim_expansion: int = 1):
        super().__init__()
        self.q_proj = CastLinear(feature_dim, feature_dim)
        self.k_proj = CastLinear(feature_dim, feature_dim)
        self.v_proj = CastLinear(feature_dim, feature_dim)
        self.merge = CastLinear(feature_dim, feature_dim)
        self.norm1 = LayerNorm(feature_dim)
        self.use_ffn = ffn
        if ffn:
            in_ch = feature_dim * 2
            self.mlp = nn.Sequential(
                CastLinear(in_ch, in_ch * ffn_dim_expansion, bias=False),
                nn.GELU(),
                CastLinear(in_ch * ffn_dim_expansion, feature_dim,
                           bias=False))
            self.norm2 = LayerNorm(feature_dim)

    def forward(self, source: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
        message = self.merge(sdpa(self.q_proj(source), self.k_proj(target),
                                  self.v_proj(target)))
        message = self.norm1(message)
        if self.use_ffn:
            message = self.norm2(self.mlp(torch.cat([source, message],
                                                    dim=-1)))
        return source + message
