"""SEA-RAFT building blocks (``ptlflow_tpu/models/sea_raft/layer.py``),
NCHW: the ResNet-FPN basic block and encoder, and the ConvNeXt block.

Attribute names are the reference's, so ``state_dict()`` keys equal its
checkpoint names.  The reference's ``GradClip`` (a gradient NaN-zeroing and
clamp) is not here: the JAX package defines it and never calls it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ... import nn as pnn


def conv1x1(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    return pnn.CastConv2d(in_planes, out_planes, 1, stride=stride, padding=0)


def conv3x3(in_planes: int, out_planes: int, stride: int = 1) -> nn.Conv2d:
    return pnn.CastConv2d(in_planes, out_planes, 3, stride=stride, padding=1)


class ConvNextBlock(nn.Module):
    """Depthwise 7x7 convolution; LayerNorm, Linear, GELU and Linear over
    the channels of each pixel; the layer scale ``gamma``; a residual; and
    the ``final`` 1x1 convolution to ``output_dim`` channels.  The layers
    cast their weights to their input's dtype (MEMFOF's bf16 weight
    cast)."""

    def __init__(self, dim: int, output_dim: int,
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.layer_scale_init_value = layer_scale_init_value
        self.dwconv = pnn.CastConv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = pnn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = pnn.CastLinear(dim, 4 * output_dim)
        self.pwconv2 = pnn.CastLinear(4 * output_dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)
        self.final = pnn.CastConv2d(dim, output_dim, 1, padding=0)

    def init_own_params(self, gen: torch.Generator) -> None:
        if self.gamma is not None:
            self.gamma.fill_(self.layer_scale_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dwconv(x).permute(0, 2, 3, 1)  # NHWC for the channel ops
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y))))
        if self.gamma is not None:
            y = self.gamma.to(y.dtype) * y
        return self.final(x + y.permute(0, 3, 1, 2))


class BasicBlock(nn.Module):
    """Two 3x3 conv-BatchNorm-ReLUs and a residual.  Where the block changes
    the stride or the width, the residual goes through ``downsample``, a
    1x1 convolution and ``bn3``: one BatchNorm registered under both names,
    as in the reference, whose checkpoints list it twice."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv3x3(in_planes, planes, stride)
        self.conv2 = conv3x3(planes, planes)
        self.bn1 = pnn.BatchNorm2d(planes)
        self.bn2 = pnn.BatchNorm2d(planes)
        if stride == 1 and in_planes == planes:
            self.downsample = None
        else:
            self.bn3 = pnn.BatchNorm2d(planes)
            self.downsample = nn.Sequential(
                conv1x1(in_planes, planes, stride=stride), self.bn3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class ResNetFPN(nn.Module):
    """ResNet18- or ResNet34-style encoder, output at 1/8 resolution.  Its
    convolutions cast their weights to their input's dtype (FlowSeek's
    bf16 weight cast)."""

    def __init__(self, block_dims: Sequence[int], initial_dim: int,
                 pretrain: str = "resnet18", input_dim: int = 3,
                 output_dim: int = 256):
        super().__init__()
        self.conv1 = pnn.CastConv2d(input_dim, initial_dim, 7, stride=2,
                                    padding=3)
        self.bn1 = pnn.BatchNorm2d(initial_dim)
        n_block = {"resnet18": [2, 2, 2], "resnet34": [3, 4, 6]}[pretrain]
        in_planes = initial_dim
        layers = []
        for li, (dim, num) in enumerate(zip(block_dims, n_block)):
            blocks = [BasicBlock(in_planes, dim, stride=1 if li == 0 else 2)]
            blocks += [BasicBlock(dim, dim) for _ in range(num - 1)]
            layers.append(nn.Sequential(*blocks))
            in_planes = dim
        self.layer1, self.layer2, self.layer3 = layers
        self.final_conv = conv1x1(block_dims[2], output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.final_conv(x)
