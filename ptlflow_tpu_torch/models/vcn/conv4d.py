"""VCN's separable 4-D convolutions over (B, C, U, V, H, W) cost volumes
(``ptlflow_tpu/models/vcn/conv4d.py``, the reference's ``full=False``
form).

The volume stays channels-first, as the reference keeps it, and every 4-D
convolution is the reference's ``Conv3d`` with a kernel that is 1 along
one axis, on a view of the volume: (k, k, 1) over (U, V, H*W) for the
displacement axes, (1, k, k) over (U*V, H, W) for the image axes.  No
transpose runs between them (the JAX package folds the complementary
axes into the batch of a 2-D convolution instead, which needs one around
each displacement convolution).  The weights keep the reference's 5-D
shapes, (O, I, k, k, 1) and (O, I, 1, k, k).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm3d, CastConv3d


def uv_conv(in_planes: int, out_planes: int, ksize: int, stride: int = 1,
            bias: bool = True) -> CastConv3d:
    """A (k, k, 1) convolution over (U, V, H*W), strided on (U, V)."""
    return CastConv3d(in_planes, out_planes, (ksize, ksize, 1),
                      stride=(stride, stride, 1),
                      padding=(ksize // 2, ksize // 2, 0), bias=bias)


def hw_conv(in_planes: int, out_planes: int, ksize: int,
            bias: bool = True) -> CastConv3d:
    """A (1, k, k) convolution over (U*V, H, W)."""
    return CastConv3d(in_planes, out_planes, (1, ksize, ksize),
                      padding=(0, ksize // 2, ksize // 2), bias=bias)


def over_uv(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``mod`` of (B, C, U, V, H, W) viewed as (B, C, U, V, H*W)."""
    b, c, u, v, h, w = x.shape
    y = mod(x.reshape(b, c, u, v, h * w))
    return y.view(b, y.shape[1], y.shape[2], y.shape[3], h, w)


def over_hw(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``mod`` of (B, C, U, V, H, W) viewed as (B, C, U*V, H, W)."""
    b, c, u, v, h, w = x.shape
    y = mod(x.reshape(b, c, u * v, h, w))
    return y.view(b, y.shape[1], u, v, h, w)


class projfeat4d(nn.Module):
    """A 1x1 channel projection, strided on (U, V), then BatchNorm."""

    def __init__(self, in_planes: int, out_planes: int, stride: int):
        super().__init__()
        self.conv1 = uv_conv(in_planes, out_planes, 1, stride=stride,
                             bias=False)
        self.bn = BatchNorm3d(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return over_uv(self.bn, over_uv(self.conv1, x))


class sepConv4d(nn.Module):
    """The (U, V) convolution (``conv2``, strided), a ReLU, the (H, W)
    convolution (``conv1``), each followed by a BatchNorm where
    ``with_bn``, else with a bias.  (The reference's 1x1 projection for a
    change of width, ``proj``, is left out: every VCN separable
    convolution keeps its width.)"""

    def __init__(self, planes: int, stride: int = 1, with_bn: bool = True):
        super().__init__()
        conv1 = hw_conv(planes, planes, 3, bias=not with_bn)
        conv2 = uv_conv(planes, planes, 3, stride=stride, bias=not with_bn)
        if with_bn:
            self.conv1 = nn.Sequential(conv1, BatchNorm3d(planes))
            self.conv2 = nn.Sequential(conv2, BatchNorm3d(planes))
        else:
            self.conv1, self.conv2 = conv1, conv2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return over_hw(self.conv1, F.relu(over_uv(self.conv2, x)))


class sepConv4dBlock(nn.Module):
    """Two ``sepConv4d`` with BatchNorms and a residual, projected by
    ``projfeat4d`` where the first is strided."""

    def __init__(self, planes: int, stride: int = 1):
        super().__init__()
        self.downsample = (None if stride == 1
                           else projfeat4d(planes, planes, stride))
        self.conv1 = sepConv4d(planes, stride)
        self.conv2 = sepConv4d(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + self.conv2(out))


def resize_uv(x: torch.Tensor, uo: int, vo: int) -> torch.Tensor:
    """Bilinear resize (``align_corners=False``) of the (U, V) axes of
    (B, C, U, V, H, W): the reference's trilinear interpolation over
    (U, V, H*W), whose third axis keeps its size and so its values."""
    b, c, u, v, h, w = x.shape
    y = F.interpolate(x.reshape(b, c, u, v, h * w), size=(uo, vo, h * w),
                      mode="trilinear", align_corners=False)
    return y.view(b, c, uo, vo, h, w)


class butterfly4D(nn.Module):
    """A U-Net over the displacement axes: a 1x1 projection to ``fdimb``
    channels, two (U, V)-strided blocks down (9 -> 5 -> 3 displacements),
    one at the bottom, and two up, each after a bilinear (U, V) resize
    added to the skip."""

    def __init__(self, fdima: int, fdimb: int):
        super().__init__()
        self.proj = nn.Sequential(projfeat4d(fdima, fdimb, 1), nn.ReLU())
        self.conva1 = sepConv4dBlock(fdimb, stride=2)
        self.conva2 = sepConv4dBlock(fdimb, stride=2)
        self.convb3 = sepConv4dBlock(fdimb)
        self.convb2 = sepConv4dBlock(fdimb)
        self.convb1 = sepConv4dBlock(fdimb)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.proj(x)
        u, v = out.shape[2:4]
        out1 = self.conva1(out)
        u1, v1 = out1.shape[2:4]
        out2 = self.convb3(self.conva2(out1))
        out1 = self.convb2(resize_uv(out2, u1, v1) + out1)
        return self.convb1(resize_uv(out1, u, v) + out)
