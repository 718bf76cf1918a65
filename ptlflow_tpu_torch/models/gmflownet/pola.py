"""POLA, patch-based overlapping attention, for GMFlowNet
(``ptlflow_tpu/models/gmflownet/pola.py``): the window helpers, the
neighbour-window and plain multi-head attentions, the POLA and mixed
axial-POLA blocks and stacks, and the stride-8 conv encoder.

Tokens are (B, H, W, C) inside the blocks; the stacks take and return NCHW
maps.  Each ws x ws window of queries attends to the (3 ws)^2 patch around
it: the patches are ``F.unfold`` of the zero-padded map (kernel 3 ws,
stride ws), in unfold's row-major patch order, and padded key positions
get -100 logits in POLA's stack (``_pola_attn_mask``), none in the mixed
stack, as in the reference.  Logits and softmax are taken in float32;
every layer casts its weights to its input's dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ... import nn as pnn
from ...nn import CastConv2d, CastLinear


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) with H, W multiples of ``ws`` -> (B*nH*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).transpose(2, 3)
    return x.reshape(-1, ws * ws, c)


def window_reverse(wins: torch.Tensor, ws: int, b: int, h: int,
                   w: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    c = wins.shape[-1]
    x = wins.reshape(b, h // ws, w // ws, ws, ws, c).transpose(2, 3)
    return x.reshape(b, h, w, c)


def gather_neighbor_windows(x: torch.Tensor, ws: int,
                            n_win: int) -> torch.Tensor:
    """For each ws x ws window of ``x`` (B, Hp, Wp, C), the surrounding
    (n_win*ws)^2 patch of the map zero-padded by (n_win-1)/2 windows:
    (B*nH*nW, (n_win*ws)^2, C), rows of the patch in order."""
    b, hp, wp, c = x.shape
    k = n_win * ws
    pad = (n_win - 1) // 2 * ws
    cols = F.unfold(x.permute(0, 3, 1, 2), k, padding=pad, stride=ws)
    n = cols.shape[-1]  # windows, row-major
    return cols.reshape(b, c, k * k, n).permute(0, 3, 2, 1).reshape(
        b * n, k * k, c)


def _pad_to_multiple(x: torch.Tensor, ws: int) -> torch.Tensor:
    """Zero-pad (B, H, W, C) at the bottom and right to multiples of ws."""
    h, w = x.shape[1:3]
    return F.pad(x, (0, 0, 0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws))


def _attend(q, k, v, bias=None, mask=None):
    """(B_, heads, N, d) attention: logits in float32 plus ``bias`` (heads,
    Nq, Nk) and ``mask`` (nW, Nq, Nk) of each window in turn; softmax in
    float32, weights cast to q's dtype, output accumulated in float32 and
    cast to q's dtype."""
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        attn = attn + bias[None].float()
    if mask is not None:
        b_, h, nq, nk = attn.shape
        nw = mask.shape[0]
        attn = (attn.view(b_ // nw, nw, h, nq, nk)
                + mask[None, :, None].float()).view(b_, h, nq, nk)
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.matmul(attn.float(), v.float()).to(q.dtype)


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = CastLinear(in_features, hidden_features)
        self.fc2 = CastLinear(hidden_features, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def relative_position_index(ws: int, n_win: int) -> torch.Tensor:
    """(ws*ws, (n_win*ws)^2) index into the bias table of each query of a
    window and each key of its neighbourhood."""
    ci = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                              indexing="ij")).reshape(2, -1)
    cn = np.stack(np.meshgrid(np.arange(n_win * ws), np.arange(n_win * ws),
                              indexing="ij")).reshape(2, -1)
    rel = (ci[:, :, None] - cn[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += n_win * ws - 1
    rel[:, :, 1] += n_win * ws - 1
    rel[:, :, 0] *= (n_win + 1) * ws - 1
    return torch.from_numpy(rel.sum(-1).astype(np.int64))


class NeighborWindowAttention(nn.Module):
    """Attention of each window's queries to its neighbourhood's keys with a
    learned relative-position bias; ``relative_position_index`` is a buffer
    of the reference's checkpoints, rebuilt here."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 neig_win_num: int = 1, qkv_bias: bool = True,
                 use_proj: bool = True):
        super().__init__()
        self.dim = dim
        self.ws = window_size
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.n_win = 2 * neig_win_num + 1
        table_len = ((self.n_win + 1) * window_size - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_len, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window_size, self.n_win))
        self.Wq = CastLinear(dim, dim, bias=qkv_bias)
        self.Wk = CastLinear(dim, dim, bias=qkv_bias)
        self.Wv = CastLinear(dim, dim, bias=qkv_bias)
        self.proj = CastLinear(dim, dim) if use_proj else None

    def init_own_params(self, gen: torch.Generator) -> None:
        nn.init.trunc_normal_(self.relative_position_bias_table, std=1.0,
                              a=-2.0, b=2.0, generator=gen)
        self.relative_position_bias_table.mul_(0.02)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b_, nq, c = q.shape
        nk = k.shape[1]
        h = self.num_heads
        q = self.Wq(q).reshape(b_, nq, h, c // h).transpose(1, 2) * self.scale
        k = self.Wk(k).reshape(b_, nk, h, c // h).transpose(1, 2)
        v = self.Wv(v).reshape(b_, nk, h, c // h).transpose(1, 2)
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(nq, nk, h)
        x = _attend(q, k, v, bias.permute(2, 0, 1), mask)
        x = x.transpose(1, 2).reshape(b_, nq, c)
        return x if self.proj is None else self.proj(x)


class MultiHeadAttention(nn.Module):
    """Plain multi-head attention, ``proj`` optional."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 use_proj: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.Wq = CastLinear(dim, dim, bias=qkv_bias)
        self.Wk = CastLinear(dim, dim, bias=qkv_bias)
        self.Wv = CastLinear(dim, dim, bias=qkv_bias)
        self.proj = CastLinear(dim, dim) if use_proj else None

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        b, nq, c = q.shape
        nk = k.shape[1]
        h = self.num_heads
        q = self.Wq(q).reshape(b, nq, h, c // h).transpose(1, 2) * self.scale
        k = self.Wk(k).reshape(b, nk, h, c // h).transpose(1, 2)
        v = self.Wv(v).reshape(b, nk, h, c // h).transpose(1, 2)
        x = _attend(q, k, v).transpose(1, 2).reshape(b, nq, c)
        return x if self.proj is None else self.proj(x)


class POLATransBlock(nn.Module):
    """Pre-norm POLA attention and MLP on (B, H, W, C) tokens."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 neig_win_num: int = 1, mlp_ratio: float = 4.0):
        super().__init__()
        self.ws = window_size
        self.n_win = 2 * neig_win_num + 1
        self.norm1 = pnn.LayerNorm(dim)
        self.attn = NeighborWindowAttention(dim, window_size, num_heads,
                                            neig_win_num)
        self.norm2 = pnn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        xp = _pad_to_multiple(self.norm1(x), self.ws)
        hp, wp = xp.shape[1:3]
        kv = gather_neighbor_windows(xp, self.ws, self.n_win)
        out = self.attn(window_partition(xp, self.ws), kv, kv, mask=attn_mask)
        x = x + window_reverse(out, self.ws, b, hp, wp)[:, :h, :w]
        return x + self.mlp(self.norm2(x))


class MixAxialPOLABlock(nn.Module):
    """POLA attention on the first channels, row and column attention on
    two heads each of the rest, a projection, then the MLP."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 7,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.ws = window_size
        dim_per_head = dim // num_heads
        axis_head = 2
        local_head = num_heads - 2 * axis_head
        self.local_chl = local_head * dim_per_head
        self.axis_chl = axis_head * dim_per_head
        self.n_win = 3
        self.norm1 = pnn.LayerNorm(dim)
        self.localAttn = NeighborWindowAttention(
            self.local_chl, window_size, local_head, neig_win_num=1)
        self.vertiAttn = MultiHeadAttention(self.axis_chl, axis_head,
                                            use_proj=False)
        self.horizAttn = MultiHeadAttention(self.axis_chl, axis_head,
                                            use_proj=False)
        self.proj = CastLinear(dim, dim)
        self.norm2 = pnn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        y = self.norm1(x)
        lc, ac = self.local_chl, self.axis_chl
        xp = _pad_to_multiple(y[..., :lc], self.ws)
        hp, wp = xp.shape[1:3]
        kv = gather_neighbor_windows(xp, self.ws, self.n_win)
        local = window_reverse(self.localAttn(window_partition(xp, self.ws),
                                              kv, kv),
                               self.ws, b, hp, wp)[:, :h, :w]
        xh = y[..., lc:lc + ac].reshape(b * h, w, ac)
        horiz = self.horizAttn(xh, xh, xh).reshape(b, h, w, ac)
        xv = y[..., lc + ac:].transpose(1, 2).reshape(b * w, h, ac)
        verti = self.vertiAttn(xv, xv, xv).reshape(b, w, h, ac).transpose(1, 2)
        x = x + self.proj(torch.cat([local, horiz, verti], dim=-1))
        return x + self.mlp(self.norm2(x))


def _pola_attn_mask(h: int, w: int, ws: int, neig: int,
                    device=None) -> torch.Tensor:
    """(windows, ws*ws, (3 ws)^2) additive mask: -100 at the padded key
    positions of each window's neighbourhood, 0 elsewhere."""
    valid = _pad_to_multiple(torch.ones((1, h, w, 1), device=device), ws)
    kv = gather_neighbor_windows(valid, ws, 2 * neig + 1)[..., 0]
    return ((kv - 1.0) * 100.0)[:, None, :].expand(-1, ws * ws, -1)


class POLAUpdate(nn.Module):
    """A stack of POLA blocks and a LayerNorm over an NCHW map."""

    def __init__(self, embed_dim: int = 256, depth: int = 6,
                 num_head: int = 8, window_size: int = 7,
                 neig_win_num: int = 1, mlp_ratio: float = 4.0):
        super().__init__()
        self.ws = window_size
        self.neig = neig_win_num
        self.blocks = nn.ModuleList([
            POLATransBlock(embed_dim, num_head, window_size, neig_win_num,
                           mlp_ratio) for _ in range(depth)])
        self.norm = pnn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        mask = _pola_attn_mask(x.shape[1], x.shape[2], self.ws, self.neig,
                               x.device)
        for blk in self.blocks:
            x = blk(x, attn_mask=mask)
        return self.norm(x).permute(0, 3, 1, 2)


class MixAxialPOLAUpdate(nn.Module):
    """A stack of mixed axial-POLA blocks and a LayerNorm over an NCHW map
    (no attention mask, as in the reference)."""

    def __init__(self, embed_dim: int = 256, depth: int = 6,
                 num_head: int = 8, window_size: int = 7,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.blocks = nn.ModuleList([
            MixAxialPOLABlock(embed_dim, num_head, window_size, mlp_ratio)
            for _ in range(depth)])
        self.norm = pnn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x).permute(0, 3, 1, 2)


class BasicConvEncoder(nn.Module):
    """Three stride-2 conv-norm-ReLUs (7x7, 3x3, 3x3): stride 8."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance"):
        super().__init__()
        half = max(output_dim // 2, 64)
        make = {"instance": pnn.InstanceNorm2d, "batch": pnn.BatchNorm2d,
                "none": lambda c: nn.Identity()}[norm_fn]
        self.norm1 = make(64)
        self.norm2 = make(half)
        self.norm3 = make(output_dim)
        self.conv1 = CastConv2d(3, 64, 7, stride=2, padding=3)
        self.conv2 = CastConv2d(64, half, 3, stride=2, padding=1)
        self.conv3 = CastConv2d(half, output_dim, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = torch.relu(self.norm2(self.conv2(x)))
        return torch.relu(self.norm3(self.conv3(x)))
