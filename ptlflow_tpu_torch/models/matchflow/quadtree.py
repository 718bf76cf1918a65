"""MatchFlow's quadtree-attention matching encoder
(``ptlflow_tpu/models/matchflow/quadtree.py``), NCHW maps and (B, N, C)
tokens.

Quadtree attention (type B) over a 3-level pyramid of the q/k/v
projections: the coarsest level attends over all its tokens; each finer
level lets the 2x2 children of a query's parent attend over the 2x2
children of the parent's top-k keys of the level above, and passes its own
top-k on.  The messages are summed with ``softmax(weight)`` over the
levels.  The top-k runs on the raw scores (softmax keeps their order).
The next level reads only the set of selected keys, and its softmax and
weighted sum do not depend on their order, so ``torch.topk``'s order of
equal scores need not be ``lax.top_k``'s.  The gathers and products are
plain PyTorch: the JAX package computes them in XLA (its parent-block
tables for one wide gather are a TPU layout, not ported).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import nn as pnn
from ...nn import CastConv2d, CastLinear


def _tokens(t: torch.Tensor, nhead: int) -> torch.Tensor:
    """(B, C, h, w) -> (B, h*w, heads, C/heads), row-major pixels."""
    b, c, h, w = t.shape
    return t.flatten(2).transpose(1, 2).reshape(b, h * w, nhead,
                                                c // nhead)


class QTAttB(nn.Module):
    """Quadtree attention type B over maps finest first; ``weight`` blends
    the levels' messages."""

    def __init__(self, nhead: int, dim: int, scale: int,
                 topks: Sequence[int] = (32, 32, 32, 32)):
        super().__init__()
        self.nhead = nhead
        self.dim = dim
        self.scale = scale
        self.topks = list(topks)
        self.weight = nn.Parameter(torch.zeros(scale))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.weight.copy_(torch.randn(self.scale, generator=gen))

    def _coarse(self, query, key, value, topk):
        """Every query over every key: the message (B, L, H, D) and each
        query's top-k keys (B, L, H, K), as token indices."""
        q, k, v = (_tokens(t, self.nhead) for t in (query, key, value))
        qk = torch.einsum("nlhd,nshd->nlhs", q.float(), k.float())
        a = torch.softmax(qk / math.sqrt(q.shape[-1]), dim=-1)
        message = torch.einsum("nlhs,nshd->nlhd", a, v.float())
        top = torch.topk(qk, min(topk, qk.shape[-1]), dim=-1).indices
        return message.to(query.dtype), top

    def _fine(self, query, key, value, parents, topk):
        """One finer level: ``parents`` (B, Lp, H, K) are the keys chosen on
        the level above (Lp = its h/2 * w/2 pixels).  The 4 children of
        each parent pixel attend over the 4K children of its K keys.
        Returns the message (B, Lp, 4, H, D), children in (y, x) order, and
        each child's top-k of those candidates (B, h*w, H, K') as token
        indices of this level."""
        b, c, h, w = key.shape
        nh = self.nhead
        d = c // nh
        hp, wp = h // 2, w // 2
        lp, kk = parents.shape[1], parents.shape[3]
        # the candidates' positions on this level: child (y, x) of parent
        # pid, candidate j = 4 * slot + 2 * y + x; integers throughout
        child = torch.arange(4, device=key.device)
        pos = ((parents // wp * 2)[..., None] + child // 2) * w \
            + (parents % wp * 2)[..., None] + child % 2  # (B, Lp, H, K, 4)
        pos = pos.reshape(b, lp, nh, 4 * kk)
        k, v = _tokens(key, nh), _tokens(value, nh)

        def gather(t):  # (B, L, H, D) -> (B, Lp, H, 4K, D)
            idx = pos.permute(0, 2, 1, 3).reshape(b, nh, lp * 4 * kk, 1)
            g = torch.gather(t.permute(0, 2, 1, 3), 2,
                             idx.expand(-1, -1, -1, d))
            return g.reshape(b, nh, lp, 4 * kk, d).permute(0, 2, 1, 3, 4)

        gk, gv = gather(k), gather(v)
        q = query.reshape(b, nh, d, hp, 2, wp, 2).permute(
            0, 3, 5, 4, 6, 1, 2).reshape(b, lp, 4, nh, d)
        qk = torch.einsum("blthd,blhjd->blthj", q.float(), gk.float())
        a = torch.softmax(qk / math.sqrt(d), dim=-1)
        message = torch.einsum("blthj,blhjd->blthd", a, gv.float())
        sel = torch.topk(qk, min(topk, qk.shape[-1]), dim=-1).indices
        cand = pos[:, :, None].expand(b, lp, 4, nh, 4 * kk)
        top = torch.gather(cand, 4, sel)  # (B, Lp, 4, H, K')
        # children back to row-major pixels of this level
        top = top.reshape(b, hp, wp, 2, 2, nh, -1).permute(
            0, 1, 3, 2, 4, 5, 6).reshape(b, h * w, nh, -1)
        return message.to(query.dtype), top

    def forward(self, queries: List[torch.Tensor], keys: List[torch.Tensor],
                values: List[torch.Tensor]) -> torch.Tensor:
        """Maps (B, C, h_l, w_l), finest first -> the blended message of
        the finest level, (B, h0*w0, C)."""
        messages = []
        top = None
        for i, (query, key, value) in enumerate(
                zip(reversed(queries), reversed(keys), reversed(values))):
            if i == 0:
                message, top = self._coarse(query, key, value, self.topks[0])
            else:
                message, top = self._fine(query, key, value, top,
                                          self.topks[i])
            messages.append(message)
        weight = torch.softmax(self.weight.float(), dim=0).to(
            messages[0].dtype)
        final = messages[0] * weight[0]
        for i, m in enumerate(messages[1:], 1):
            final = final[:, :, None] + m * weight[i]  # (B, Lp, 4, H, D)
            _, _, hq, wq = queries[len(queries) - i].shape  # the parents
            b, _, _, nh, d = final.shape
            final = final.reshape(b, hq, wq, 2, 2, nh, d).permute(
                0, 1, 3, 2, 4, 5, 6).reshape(b, hq * wq * 4, nh, d)
        return final.flatten(2)


class QuadtreeAttention(nn.Module):
    """1x1 q/k/v projections average-pooled into ``scale`` levels, then
    :class:`QTAttB` and the output projection."""

    def __init__(self, dim: int, num_heads: int, topks: Sequence[int],
                 scale: int = 1, qkv_bias: bool = False):
        super().__init__()
        self.scale = scale
        self.q_proj = CastConv2d(dim, dim, 1, bias=qkv_bias)
        self.k_proj = CastConv2d(dim, dim, 1, bias=qkv_bias)
        self.v_proj = CastConv2d(dim, dim, 1, bias=qkv_bias)
        self.py_att = QTAttB(num_heads, dim // num_heads, scale=scale,
                             topks=topks)
        self.proj = CastLinear(dim, dim)

    def forward(self, x: torch.Tensor, target: torch.Tensor, h: int,
                w: int) -> torch.Tensor:
        """x, target (B, N = h*w, C) tokens -> (B, N, C)."""
        b, n, c = x.shape
        q = self.q_proj(x.transpose(1, 2).reshape(b, c, h, w))
        tm = target.transpose(1, 2).reshape(b, c, h, w)
        k, v = self.k_proj(tm), self.v_proj(tm)
        queries, keys, values = [q], [k], [v]
        for _ in range(self.scale - 1):
            q, k, v = (F.avg_pool2d(t, 2, 2) for t in (q, k, v))
            queries.append(q)
            keys.append(k)
            values.append(v)
        return self.proj(self.py_att(queries, keys, values))


class DWConv(nn.Module):
    def __init__(self, dim: int = 768):
        super().__init__()
        self.dwconv = CastConv2d(dim, dim, 3, stride=1, padding=1, bias=True,
                                 groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        y = self.dwconv(x.transpose(1, 2).reshape(b, c, h, w))
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> ReLU -> 3x3 depthwise conv -> exact GELU -> fc2."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = CastLinear(in_features, hidden_features)
        self.dwconv = DWConv(hidden_features)
        self.fc2 = CastLinear(hidden_features, in_features)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = self.dwconv(torch.relu(self.fc1(x)), h, w)
        return self.fc2(F.gelu(x))


class QuadtreeBlock(nn.Module):
    """``norm1`` normalises both the tokens and the target."""

    def __init__(self, dim: int, num_heads: int, topks: Sequence[int],
                 mlp_ratio: float = 4.0, scale: int = 1):
        super().__init__()
        self.norm1 = pnn.LayerNorm(dim)
        self.attn = QuadtreeAttention(dim, num_heads, topks, scale=scale)
        self.norm2 = pnn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, target: torch.Tensor, h: int,
                w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), self.norm1(target), h, w)
        return x + self.mlp(self.norm2(x), h, w)


class LocalFeatureTransformer(nn.Module):
    """LoFTR-style self and cross quadtree attention; a cross layer updates
    both frames from the old pair."""

    def __init__(self, layer_names: Sequence[str],
                 topks: Sequence[int] = (16, 8, 8), d_model: int = 256):
        super().__init__()
        self.layer_names = list(layer_names)
        self.layers = nn.ModuleList([
            QuadtreeBlock(d_model, 8, topks=list(topks), scale=3)
            for _ in self.layer_names])

    def forward(self, feat0: torch.Tensor, feat1: torch.Tensor, h: int,
                w: int) -> Tuple[torch.Tensor, torch.Tensor]:
        for name, layer in zip(self.layer_names, self.layers):
            if name == "self":
                feat0 = layer(feat0, feat0, h, w)
                feat1 = layer(feat1, feat1, h, w)
            else:
                feat0, feat1 = (layer(feat0, feat1, h, w),
                                layer(feat1, feat0, h, w))
        return feat0, feat1


def sine_pos_encoding(d_model: int, h: int, w: int, scale_y: float = 1.0,
                      scale_x: float = 1.0) -> np.ndarray:
    """(1, C, H, W) float32 sinusoidal encoding of the 1-based pixel
    positions, x in channels 4k and 4k+1, y in 4k+2 and 4k+3; ``scale_*``
    rescale the positions by the train/eval resolution ratio.  Built in
    numpy as the JAX package builds it."""
    pe = np.zeros((d_model, h, w), np.float32)
    y_pos = np.cumsum(np.ones((h, w)), axis=0)[None] * scale_y
    x_pos = np.cumsum(np.ones((h, w)), axis=1)[None] * scale_x
    div = np.exp(np.arange(0, d_model // 2, 2)
                 * (-math.log(10000.0) / (d_model // 2)))[:, None, None]
    pe[0::4] = np.sin(x_pos * div)
    pe[1::4] = np.cos(x_pos * div)
    pe[2::4] = np.sin(y_pos * div)
    pe[3::4] = np.cos(y_pos * div)
    return pe[None]


class _FPNBasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, planes, 3, stride=stride,
                                padding=1, bias=False)
        self.conv2 = CastConv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = pnn.BatchNorm2d(planes)
        self.bn2 = pnn.BatchNorm2d(planes)
        self.downsample = None if stride == 1 else nn.Sequential(
            CastConv2d(in_planes, planes, 1, stride=stride, bias=False),
            pnn.BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class ResNetFPN_8_2(nn.Module):
    """The ResNet backbone to 1/8, 256 channels."""

    def __init__(self):
        super().__init__()
        dims = [128, 196, 256]
        self.conv1 = CastConv2d(3, 128, 7, stride=2, padding=3, bias=False)
        self.bn1 = pnn.BatchNorm2d(128)
        self.layer1 = nn.Sequential(_FPNBasicBlock(128, dims[0], 1),
                                    _FPNBasicBlock(dims[0], dims[0], 1))
        self.layer2 = nn.Sequential(_FPNBasicBlock(dims[0], dims[1], 2),
                                    _FPNBasicBlock(dims[1], dims[1], 1))
        self.layer3 = nn.Sequential(_FPNBasicBlock(dims[1], dims[2], 2),
                                    _FPNBasicBlock(dims[2], dims[2], 1))
        self.layer3_outconv = CastConv2d(dims[2], dims[2], 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.layer3_outconv(x)


class MatchingModel(nn.Module):
    """ResNet-FPN features of both frames in one batch, on (x + 1) / 2,
    plus the sine positions, through 4 self/cross quadtree layer pairs."""

    def __init__(self, train_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.image_size = train_size
        self.backbone = ResNetFPN_8_2()
        self.loftr_coarse = LocalFeatureTransformer(
            layer_names=["self", "cross"] * 4, topks=[16, 8, 8])

    def forward(self, image1: torch.Tensor, image2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, H, W) frames in [-1, 1] -> two (B, 256, H/8, W/8) maps.
        In eval with a ``train_size`` the positions are rescaled by the
        train/eval resolution ratio."""
        feats = self.backbone((torch.cat([image1, image2]) + 1) / 2.0)
        b2, c, h, w = feats.shape
        b = b2 // 2
        if self.training or self.image_size is None:
            pe = sine_pos_encoding(c, h, w)
        else:
            pe = sine_pos_encoding(
                c, h, w, scale_y=self.image_size[0] / image1.shape[-2],
                scale_x=self.image_size[1] / image1.shape[-1])
        feats = feats + torch.from_numpy(pe).to(feats)
        tokens = feats.flatten(2).transpose(1, 2)
        feat0, feat1 = self.loftr_coarse(tokens[:b], tokens[b:], h, w)
        return (feat0.transpose(1, 2).reshape(b, c, h, w),
                feat1.transpose(1, 2).reshape(b, c, h, w))
