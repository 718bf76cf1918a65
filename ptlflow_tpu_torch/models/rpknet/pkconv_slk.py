"""Partial-kernel convolutions and sparse-large-kernel blocks
(``ptlflow_tpu/models/rpknet/pkconv_slk.py``), NCHW.

A :class:`PKConv2d` stores one full-size kernel and each call slices it to
the input's channel count and the ``out_ch`` it is given: a dense
convolution keeps ``weight[:out_ch, :in_ch]``, a depthwise one the leading
``out_ch`` kernels with ``groups = in_ch``; both keep ``bias[:out_ch]``.
The ``state_dict`` holds the full kernel.  The norms are affine-free and
take the population variance with eps 1e-6.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

IntOr2 = Union[int, Sequence[int]]


def group_norm(x: torch.Tensor, num_groups: int = 8,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm without affine parameters over (B, C, H, W), in the
    input's dtype."""
    b, c, h, w = x.shape
    xg = x.reshape(b, num_groups, c // num_groups, h, w)
    mean = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = xg.var(dim=(2, 3, 4), keepdim=True, correction=0)
    return ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)


def layer_norm2d(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine parameters over the channels of each pixel
    of (B, C, H, W), in the input's dtype."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


class GroupNorm(nn.Module):
    """:func:`group_norm` as a module (no parameters)."""

    def __init__(self, num_groups: int = 8):
        super().__init__()
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups)


class LayerNorm2dNoAffine(nn.Module):
    """:func:`layer_norm2d` as a module (no parameters)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm2d(x)


def make_norm(norm_type: Optional[str], num_groups: int = 8) -> nn.Module:
    """The affine-free norm of ``norm_type``: "group", "layer" or "none"
    (the published configs use no affine norms)."""
    if norm_type == "group":
        return GroupNorm(num_groups)
    if norm_type == "layer":
        return LayerNorm2dNoAffine()
    if norm_type == "none" or norm_type is None:
        return nn.Identity()
    raise ValueError(f"unsupported norm '{norm_type}' (affine norms TBD)")


class PKConv2d(nn.Conv2d):
    """Partial-kernel convolution: dense (``groups`` 1) or depthwise
    (``groups`` = ``in_channels``).  ``forward(x, out_ch)`` slices the full
    kernel to ``x``'s channels and ``out_ch`` outputs (all of them by
    default) and casts it to ``x``'s dtype.  Its seeded init is the JAX
    one: normal with std sqrt(2 / fan_out) over the full kernel (fan_out
    per group for a depthwise one), bias 0."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr2, stride: IntOr2 = 1,
                 padding: IntOr2 = 0, groups: int = 1, bias: bool = True):
        if groups not in (1, in_channels):
            raise ValueError("PKConv2d supports groups == 1 or depthwise "
                             "only")
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, groups=groups,
                         bias=bias)
        self.depthwise = groups > 1

    def init_own_params(self, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        fan_out = kh * kw * self.out_channels
        if self.depthwise:
            fan_out //= self.in_channels
        std = math.sqrt(2.0 / fan_out)
        self.weight.copy_(torch.empty(self.weight.shape).normal_(
            0.0, std, generator=gen))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor,
                out_ch: Optional[int] = None) -> torch.Tensor:
        in_ch = x.shape[1]
        out_ch = self.out_channels if out_ch is None else out_ch
        if self.depthwise:
            w, groups = self.weight[:out_ch], in_ch
        else:
            w, groups = self.weight[:out_ch, :in_ch], 1
        bias = None if self.bias is None else self.bias[:out_ch].to(x.dtype)
        return F.conv2d(x, w.to(x.dtype), bias, self.stride, self.padding,
                        1, groups)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = PKConv2d(dim, dim, 3, 1, 1, bias=True, groups=dim)

    def forward(self, x: torch.Tensor,
                out_ch: Optional[int] = None) -> torch.Tensor:
        return self.dwconv(x, out_ch=out_ch)


class Mlp(nn.Module):
    """fc1, the 3x3 depthwise convolution, exact GELU, fc2, each sliced to
    the widths the input's channel count gives."""

    def __init__(self, in_features: int, hidden_features: int,
                 skip_dw: bool = False):
        super().__init__()
        self.fc1 = PKConv2d(in_features, hidden_features, 1)
        self.dwconv = None if skip_dw else DWConv(hidden_features)
        self.fc2 = PKConv2d(hidden_features, in_features, 1)
        self.in_hid_factor = float(hidden_features) / in_features
        self.hid_out_factor = float(in_features) / hidden_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_ch = int(self.in_hid_factor * x.shape[1])
        x = self.fc1(x, out_ch=out_ch)
        if self.dwconv is not None:
            x = self.dwconv(x, out_ch=out_ch)
        x = F.gelu(x)
        return self.fc2(x, out_ch=int(self.hid_out_factor * x.shape[1]))


class SLKUnitCore(nn.Module):
    """The separable large kernel: x + a ksize x 1 depthwise convolution,
    plus a 1 x ksize one, a 1x1 convolution, and the input again."""

    def __init__(self, dim: int, ksize: int = 23):
        super().__init__()
        self.conv1_branches = nn.ModuleList([
            PKConv2d(dim, dim, (ksize, 1), padding=(ksize // 2, 0),
                     groups=dim)])
        self.conv2_branches = nn.ModuleList([
            PKConv2d(dim, dim, (1, ksize), padding=(0, ksize // 2),
                     groups=dim)])
        self.conv_out = PKConv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor,
                out_ch: Optional[int] = None) -> torch.Tensor:
        y = x + self.conv1_branches[0](x, out_ch=out_ch)
        y = y + self.conv2_branches[0](y, out_ch=out_ch)
        return self.conv_out(y, out_ch=out_ch) + x


class SLKUnit(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj_1 = PKConv2d(dim, dim, 1)
        self.spatial_gating_unit = SLKUnitCore(dim)
        self.proj_2 = PKConv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_ch = x.shape[1]
        y = F.gelu(self.proj_1(x, out_ch=out_ch))
        y = self.spatial_gating_unit(y, out_ch=out_ch)
        return self.proj_2(y, out_ch=out_ch) + x


class SLK(nn.Module):
    """VAN-style block: x + layer_scale_1 * attn(norm(x)), then
    x + layer_scale_2 * mlp(norm(x)), the scales sliced to x's width."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 norm: Optional[nn.Module] = None):
        super().__init__()
        self.norm = GroupNorm() if norm is None else norm
        self.attn = SLKUnit(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-2))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.layer_scale_1.fill_(1e-2)
        self.layer_scale_2.fill_(1e-2)

    def forward(self, x: torch.Tensor,
                out_ch: Optional[int] = None) -> torch.Tensor:
        c = x.shape[1]
        x = x + self.layer_scale_1[:c, None, None] * self.attn(self.norm(x))
        return x + self.layer_scale_2[:c, None, None] * self.mlp(self.norm(x))


class LayerTransition(nn.Module):
    """The patch-embedding downsample: a partial convolution and the norm."""

    def __init__(self, patch_size: int, stride: int, in_chans: int,
                 embed_dim: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.proj = PKConv2d(in_chans, embed_dim, patch_size, stride=stride,
                             padding=patch_size // 2)
        self.norm_fn = GroupNorm() if norm is None else norm

    def forward(self, x: torch.Tensor,
                out_ch: Optional[int] = None) -> torch.Tensor:
        return self.norm_fn(self.proj(x, out_ch=out_ch))


class PKConvSLK(nn.Module):
    """``down`` (where the stride or width changes), ``depth`` SLK blocks
    and the norm."""

    def __init__(self, in_chs: int, out_chs: int, mlp_ratio: float = 4.0,
                 norm: Optional[nn.Module] = None, stride: int = 1,
                 depth: int = 2):
        super().__init__()
        norm = GroupNorm() if norm is None else norm
        self.down = None
        if stride > 1 or in_chs != out_chs:
            self.down = LayerTransition(3 if stride > 1 else 1, stride,
                                        in_chs, out_chs, norm=norm)
        self.blocks = nn.ModuleList([
            SLK(out_chs, mlp_ratio=mlp_ratio, norm=norm)
            for _ in range(depth)])
        self.norm_fn = norm

    def forward(self, x: torch.Tensor,
                out_ch: Optional[int] = None) -> torch.Tensor:
        if self.down is not None:
            x = self.down(x, out_ch=out_ch)
        for blk in self.blocks:
            x = blk(x, out_ch=out_ch)
        return self.norm_fn(x)
