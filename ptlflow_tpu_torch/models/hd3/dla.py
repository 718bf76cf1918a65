"""HD3's DLA-34 encoder with iterative deep aggregation upsampling
(``ptlflow_tpu/models/hd3/dla.py``), NCHW: the residual blocks, the
aggregation roots and trees of DLA-34, the ``IDAUp`` nodes whose
upsampling is a channel-wise transposed convolution that starts as
bilinear interpolation, and ``DLAEncoder``, which gives the feature
pyramid fine to coarse."""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm2d, CastConv2d, CastConvTranspose2d


def conv_bn_relu(cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0) -> nn.Sequential:
    return nn.Sequential(CastConv2d(cin, cout, kernel, stride=stride,
                                    padding=padding, bias=False),
                         BatchNorm2d(cout), nn.ReLU())


class DLABasicBlock(nn.Module):
    """Two 3x3 convolutions with BatchNorm; the residual comes from the
    caller (``Tree``) or is the input."""

    def __init__(self, inplanes, planes, stride=1, dilation=1):
        super().__init__()
        self.conv1 = CastConv2d(inplanes, planes, 3, stride=stride,
                                padding=dilation, dilation=dilation,
                                bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = CastConv2d(planes, planes, 3, padding=dilation,
                                dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + residual)


class Root(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, residual):
        super().__init__()
        self.conv = CastConv2d(in_channels, out_channels, 1, bias=False,
                               padding=(kernel_size - 1) // 2)
        self.bn = BatchNorm2d(out_channels)
        self.residual = residual

    def forward(self, *x):
        out = self.bn(self.conv(torch.cat(x, 1)))
        if self.residual:
            out = out + x[0]
        return F.relu(out)


class Tree(nn.Module):
    """DLA's hierarchical aggregation tree: two blocks and a root at one
    level, else two subtrees whose last root takes every child."""

    def __init__(self, levels, block, in_channels, out_channels, stride=1,
                 level_root=False, root_dim=0, root_kernel_size=1,
                 dilation=1, root_residual=False):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_channels
        if level_root:
            root_dim += in_channels
        if levels == 1:
            self.tree1 = block(in_channels, out_channels, stride,
                               dilation=dilation)
            self.tree2 = block(out_channels, out_channels, 1,
                               dilation=dilation)
            self.root = Root(root_dim, out_channels, root_kernel_size,
                             root_residual)
        else:
            self.tree1 = Tree(levels - 1, block, in_channels, out_channels,
                              stride, root_dim=0,
                              root_kernel_size=root_kernel_size,
                              dilation=dilation, root_residual=root_residual)
            self.tree2 = Tree(levels - 1, block, out_channels, out_channels,
                              root_dim=root_dim + out_channels,
                              root_kernel_size=root_kernel_size,
                              dilation=dilation, root_residual=root_residual)
            self.root = None
        self.level_root = level_root
        self.levels = levels
        self.stride = stride
        self.project = (nn.Sequential(
            CastConv2d(in_channels, out_channels, 1, bias=False),
            BatchNorm2d(out_channels))
            if in_channels != out_channels else None)

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        residual = (self.project(bottom) if self.project is not None
                    else bottom)
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    def __init__(self, levels, channels, block=DLABasicBlock):
        super().__init__()
        self.base_layer = conv_bn_relu(3, channels[0], 7, padding=3)
        self.level0 = self._conv_level(channels[0], channels[0], levels[0])
        self.level1 = self._conv_level(channels[0], channels[1], levels[1],
                                       stride=2)
        self.level2 = Tree(levels[2], block, channels[1], channels[2], 2,
                           level_root=False)
        self.level3 = Tree(levels[3], block, channels[2], channels[3], 2,
                           level_root=True)
        self.level4 = Tree(levels[4], block, channels[3], channels[4], 2,
                           level_root=True)
        self.level5 = Tree(levels[5], block, channels[4], channels[5], 2,
                           level_root=True)
        self.level6 = Tree(levels[6], block, channels[5], channels[6], 2,
                           level_root=True)

    @staticmethod
    def _conv_level(inplanes, planes, convs, stride=1) -> nn.Sequential:
        mods = []
        for i in range(convs):
            mods += list(conv_bn_relu(inplanes, planes, 3,
                                      stride=stride if i == 0 else 1,
                                      padding=1))
            inplanes = planes
        return nn.Sequential(*mods)

    def forward(self, x) -> List[torch.Tensor]:
        y = []
        x = self.base_layer(x)
        for i in range(7):
            x = getattr(self, f"level{i}")(x)
            y.append(x)
        return y


def dla34(planes: Sequence[int]) -> DLA:
    assert len(planes) == 7
    return DLA([1, 1, 1, 2, 2, 1, 1], planes, block=DLABasicBlock)


def _bilinear_up_weight(f: int, channels: int) -> torch.Tensor:
    """The (channels, 1, 2f, 2f) weight of a channel-wise transposed
    convolution of stride ``f`` that interpolates bilinearly (the
    reference's ``fill_up_weights``)."""
    k = 2 * f
    fe = math.ceil(k / 2)
    c = (2 * fe - 1 - fe % 2) / (2.0 * fe)
    i = np.arange(k, dtype=np.float32)
    w1 = 1 - np.abs(i / fe - c)
    w = torch.from_numpy((w1[:, None] * w1[None, :]).astype(np.float32))
    return w.expand(channels, 1, k, k).clone()


class BilinearUp(CastConvTranspose2d):
    """IDAUp's channel-wise transposed convolution; its seeded init is
    bilinear interpolation, as the JAX package's ``IDAUp.init`` sets it."""

    def __init__(self, channels: int, f: int):
        super().__init__(channels, channels, f * 2, stride=f, padding=f // 2,
                         groups=channels, bias=False)
        self.f = f

    def init_own_params(self, gen: torch.Generator) -> None:
        self.weight.copy_(_bilinear_up_weight(self.f, self.out_channels))


class IDAUp(nn.Module):
    """Each input projected to ``out_dim`` (1x1, BatchNorm, ReLU; identity
    where it has that width) and upsampled by its factor, then merged left
    to right by the ``node_i`` convolutions."""

    def __init__(self, node_kernel, out_dim, channels, up_factors):
        super().__init__()
        self.channels = list(channels)
        self.out_dim = out_dim
        for i, c in enumerate(self.channels):
            proj = (nn.Identity() if c == out_dim
                    else conv_bn_relu(c, out_dim, 1))
            f = int(up_factors[i])
            up = nn.Identity() if f == 1 else BilinearUp(out_dim, f)
            setattr(self, f"proj_{i}", proj)
            setattr(self, f"up_{i}", up)
        for i in range(1, len(self.channels)):
            setattr(self, f"node_{i}", conv_bn_relu(
                out_dim * 2, out_dim, node_kernel, padding=node_kernel // 2))

    def forward(self, layers):
        layers = [getattr(self, f"up_{i}")(getattr(self, f"proj_{i}")(v))
                  for i, v in enumerate(layers)]
        x = layers[0]
        y = []
        for i in range(1, len(layers)):
            x = getattr(self, f"node_{i}")(torch.cat([x, layers[i]], 1))
            y.append(x)
        return x, y


class DLAUp(nn.Module):
    def __init__(self, channels, scales=(1, 2, 4, 8, 16), in_channels=None):
        super().__init__()
        channels = list(channels)
        in_channels = list(channels if in_channels is None else in_channels)
        scales = np.array(scales, dtype=int)
        self.num = len(channels) - 1
        for i in range(self.num):
            j = -i - 2
            setattr(self, f"ida_{i}",
                    IDAUp(3, channels[j], in_channels[j:],
                          scales[j:] // scales[j]))
            scales[j + 1:] = scales[j]
            in_channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]

    def forward(self, layers):
        layers = list(layers)
        ms_feat = [layers[-1]]
        for i in range(self.num):
            x, y = getattr(self, f"ida_{i}")(layers[-i - 2:])
            layers[-i - 1:] = y
            ms_feat.append(x)
        return ms_feat


class DLAEncoder(nn.Module):
    """DLA-34 and DLAUp: the pyramid fine to coarse, 1/2 to 1/64."""

    def __init__(self, planes: Sequence[int]):
        super().__init__()
        self.first_level = 1
        self.base = dla34(planes)
        scales = [2 ** i for i in range(len(planes[self.first_level:]))]
        self.dla_up = DLAUp(planes[self.first_level:], scales=scales)

    def forward(self, x) -> List[torch.Tensor]:
        feats = self.base(x)
        return self.dla_up(feats[self.first_level:])[::-1]
