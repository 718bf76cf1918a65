"""GMFlow's feature transformer (``ptlflow_tpu/models/gmflow/
transformer.py``): the sine position embedding (which Flow1D also adds to
its features), single-head full and split-window self/cross attention
(Swin's shifted windows on every second layer), and the flow propagation
by attention, global or over 3 x 3 windows.

The attention works on (B, H*W, C) tokens, as the JAX package's does; the
split windows are channels-last (B, H, W, C) views of them.  Scores and
softmaxes are at least float32, the products plain matrix products (the JAX package
computes them outside any Pallas kernel).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastLinear, LayerNorm, at_least_float32


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64,
                            temperature: float = 10000.0,
                            dtype=torch.float32, device=None
                            ) -> torch.Tensor:
    """(2*num_pos_feats, H, W) sine embedding of the normalised pixel
    positions, the y channels first, computed in float32 with numpy as the
    JAX package computes it."""
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, 1)
    x_embed = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, 0)
    eps = 1e-6
    scale = 2 * math.pi
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2).transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(pos)).to(dtype=dtype,
                                                          device=device)


def split_feature(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*K*K, H/K, W/K, C), the windows row-major within
    each sample."""
    b, h, w, c = x.shape
    k = num_splits
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_splits(x: torch.Tensor, num_splits: int) -> torch.Tensor:
    """The inverse of :func:`split_feature`."""
    b, h, w, c = x.shape
    k = num_splits
    x = x.reshape(b // (k * k), k, k, h, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b // (k * k), k * h, k * w, c)


def feature_add_position(feature0: torch.Tensor, feature1: torch.Tensor,
                         attn_splits: int, channels: int):
    """Both (B, C, H, W) maps plus the sine embedding of each split
    window's own positions (of the whole map where ``attn_splits`` is 1)."""
    h, w = feature0.shape[-2:]
    k = attn_splits
    pos = position_embedding_sine(h // k, w // k, channels // 2,
                                  dtype=feature0.dtype,
                                  device=feature0.device).repeat(1, k, k)
    return feature0 + pos, feature1 + pos


@functools.lru_cache(maxsize=8)
def _shift_window_mask(h: int, w: int, window_h: int, window_w: int,
                       shift_h: int, shift_w: int) -> np.ndarray:
    img_mask = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, h - window_h), slice(h - window_h, h - shift_h),
               slice(h - shift_h, h)):
        for ws in (slice(0, w - window_w), slice(w - window_w, w - shift_w),
                   slice(w - shift_w, w)):
            img_mask[hs, ws] = cnt
            cnt += 1
    kh, kw = h // window_h, w // window_w
    m = img_mask.reshape(kh, window_h, kw, window_w).transpose(0, 2, 1, 3)
    m = m.reshape(kh * kw, window_h * window_w)
    return np.where(m[:, None, :] != m[:, :, None], -100.0,
                    0.0).astype(np.float32)


def generate_shift_window_attn_mask(h: int, w: int, window_h: int,
                                    window_w: int, shift_h: int, shift_w: int,
                                    device=None) -> torch.Tensor:
    """Swin's shifted-window mask (K*K, L, L): -100 between two tokens of
    one window that the roll brought from different regions, else 0;
    computed once per shape (a copy of it on ``device``)."""
    return torch.tensor(_shift_window_mask(h, w, window_h, window_w, shift_h,
                                           shift_w), device=device)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(C) + mask) v, the scores and the softmax in at
    least float32, the result in v's dtype."""
    scores = torch.matmul(at_least_float32(q),
                          at_least_float32(k).transpose(-1, -2))
    scores = scores / (q.shape[-1] ** 0.5)
    if mask is not None:
        scores = scores + mask
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(at_least_float32(attn),
                        at_least_float32(v)).to(v.dtype)


def single_head_full_attention(q, k, v):
    """(B, L, C) tokens attending to all (B, M, C) tokens."""
    return _attend(q, k, v)


def single_head_split_window_attention(q, k, v, num_splits: int,
                                       with_shift: bool, h: int, w: int,
                                       attn_mask: Optional[torch.Tensor]):
    """(B, H*W, C) tokens attending within their window of a K x K split of
    the (H, W) map; with ``with_shift`` the map is rolled by half a window
    first (and back after), and ``attn_mask`` keeps apart the regions that
    the roll brought together."""
    b, _, c = q.shape
    wh, ww = h // num_splits, w // num_splits
    q, k, v = (t.reshape(b, h, w, c) for t in (q, k, v))
    if with_shift:
        sh, sw = wh // 2, ww // 2
        q, k, v = (torch.roll(t, (-sh, -sw), (1, 2)) for t in (q, k, v))
    qs, ks, vs = (split_feature(t, num_splits).reshape(-1, wh * ww, c)
                  for t in (q, k, v))
    mask = attn_mask.repeat(b, 1, 1) if with_shift else None
    out = merge_splits(_attend(qs, ks, vs, mask).view(-1, wh, ww, c),
                       num_splits)
    if with_shift:
        out = torch.roll(out, (sh, sw), (1, 2))
    return out.reshape(b, h * w, c)


class TransformerLayer(nn.Module):
    """``source`` attends to ``target`` (in split windows where
    ``attention_type`` is swin and the splits more than 1); the merged
    message, normalised, and unless ``no_ffn`` passed with the source
    through an MLP and normalised again, is added to the source."""

    def __init__(self, d_model: int = 256, attention_type: str = "swin",
                 no_ffn: bool = False, ffn_dim_expansion: int = 4,
                 with_shift: bool = False):
        super().__init__()
        self.attention_type = attention_type
        self.no_ffn = no_ffn
        self.with_shift = with_shift
        self.q_proj = CastLinear(d_model, d_model, bias=False)
        self.k_proj = CastLinear(d_model, d_model, bias=False)
        self.v_proj = CastLinear(d_model, d_model, bias=False)
        self.merge = CastLinear(d_model, d_model, bias=False)
        self.norm1 = LayerNorm(d_model)
        if not no_ffn:
            in_ch = d_model * 2
            self.mlp = nn.Sequential(
                CastLinear(in_ch, in_ch * ffn_dim_expansion, bias=False),
                nn.GELU(),
                CastLinear(in_ch * ffn_dim_expansion, d_model, bias=False))
            self.norm2 = LayerNorm(d_model)

    def forward(self, source, target, height, width, shifted_window_attn_mask,
                attn_num_splits):
        query = self.q_proj(source)
        key = self.k_proj(target)
        value = self.v_proj(target)
        if self.attention_type == "swin" and attn_num_splits > 1:
            message = single_head_split_window_attention(
                query, key, value, attn_num_splits, self.with_shift, height,
                width, shifted_window_attn_mask)
        else:
            message = single_head_full_attention(query, key, value)
        message = self.norm1(self.merge(message))
        if not self.no_ffn:
            message = self.norm2(self.mlp(torch.cat([source, message], -1)))
        return source + message


class TransformerBlock(nn.Module):
    """Self-attention, then cross-attention with the MLP."""

    def __init__(self, d_model=256, attention_type="swin",
                 ffn_dim_expansion=4, with_shift=False):
        super().__init__()
        self.self_attn = TransformerLayer(
            d_model=d_model, attention_type=attention_type, no_ffn=True,
            ffn_dim_expansion=ffn_dim_expansion, with_shift=with_shift)
        self.cross_attn_ffn = TransformerLayer(
            d_model=d_model, attention_type=attention_type,
            ffn_dim_expansion=ffn_dim_expansion, with_shift=with_shift)

    def forward(self, source, target, **kw):
        source = self.self_attn(source, source, **kw)
        return self.cross_attn_ffn(source, target, **kw)


class FeatureTransformer(nn.Module):
    """``num_layers`` blocks over both frames' (B, C, H, W) features in one
    batch, each frame attending to itself and then to the other; every
    second block's windows shifted."""

    def __init__(self, num_layers=6, d_model=128, attention_type="swin",
                 ffn_dim_expansion=4):
        super().__init__()
        self.attention_type = attention_type
        self.layers = nn.ModuleList([
            TransformerBlock(
                d_model=d_model, attention_type=attention_type,
                ffn_dim_expansion=ffn_dim_expansion,
                with_shift=(attention_type == "swin" and i % 2 == 1))
            for i in range(num_layers)])

    def forward(self, feature0: torch.Tensor, feature1: torch.Tensor,
                attn_num_splits: int):
        b, c, h, w = feature0.shape
        attn_mask = None
        if self.attention_type == "swin" and attn_num_splits > 1:
            wh, ww = h // attn_num_splits, w // attn_num_splits
            attn_mask = generate_shift_window_attn_mask(
                h, w, wh, ww, wh // 2, ww // 2, device=feature0.device)
        f0 = feature0.flatten(2).transpose(1, 2)
        f1 = feature1.flatten(2).transpose(1, 2)
        concat0 = torch.cat([f0, f1], 0)
        concat1 = torch.cat([f1, f0], 0)
        for layer in self.layers:
            concat0 = layer(concat0, concat1, height=h, width=w,
                            shifted_window_attn_mask=attn_mask,
                            attn_num_splits=attn_num_splits)
            c0, c1 = concat0.chunk(2, 0)
            concat1 = torch.cat([c1, c0], 0)
        f0, f1 = (t.transpose(1, 2).reshape(b, c, h, w)
                  for t in concat0.chunk(2, 0))
        return f0, f1


class FeatureFlowAttention(nn.Module):
    """The flow propagated by attention over frame 0's features, the flow
    as the values: over the whole map, or over each pixel's zero-padded
    (2r+1)^2 window."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.q_proj = CastLinear(in_channels, in_channels)
        self.k_proj = CastLinear(in_channels, in_channels)

    def forward(self, feature0: torch.Tensor, flow: torch.Tensor,
                local_window_attn: bool = False,
                local_window_radius: int = 1) -> torch.Tensor:
        if local_window_attn:
            return self.forward_local_window_attn(feature0, flow,
                                                  local_window_radius)
        b, c, h, w = feature0.shape
        query = self.q_proj(feature0.flatten(2).transpose(1, 2))
        # the reference chains k_proj after q_proj on the same tensor
        key = self.k_proj(query)
        out = _attend(query, key, flow.flatten(2).transpose(1, 2))
        return out.transpose(1, 2).reshape(b, flow.shape[1], h, w)

    def forward_local_window_attn(self, feature0: torch.Tensor,
                                  flow: torch.Tensor,
                                  local_window_radius: int = 1
                                  ) -> torch.Tensor:
        b, c, h, w = feature0.shape
        r = local_window_radius
        n = (2 * r + 1) ** 2
        f = feature0.flatten(2).transpose(1, 2)

        def nchw(t):
            return t.transpose(1, 2).reshape(b, c, h, w)

        q, f_proj = nchw(self.q_proj(f)), nchw(self.k_proj(f))
        feat_win = F.unfold(f_proj, 2 * r + 1, padding=r).view(b, c, n, h, w)
        flow_win = F.unfold(flow, 2 * r + 1, padding=r).view(
            b, flow.shape[1], n, h, w)
        scores = (at_least_float32(q)[:, :, None]
                  * at_least_float32(feat_win)).sum(1) / (c ** 0.5)
        prob = torch.softmax(scores, dim=1)
        out = (prob[:, None] * at_least_float32(flow_win)).sum(2)
        return out.to(flow.dtype)
