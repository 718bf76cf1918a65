"""GMFlow's CNN backbone (``ptlflow_tpu/models/gmflow/backbone.py``),
NCHW: an instance-norm residual encoder to 1/8 (to 1/4 with two output
scales), and the trident convolution that applies one shared weight at
several strides."""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, InstanceNorm2d


class ResidualBlock(nn.Module):
    """Two 3x3 convolutions, each followed by an instance norm and a
    ReLU, added to the input (projected by a 1x1 convolution and an
    instance norm where the stride or the width changes), then a ReLU."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, planes, 3, dilation=dilation,
                                padding=dilation, stride=stride, bias=False)
        self.conv2 = CastConv2d(planes, planes, 3, dilation=dilation,
                                padding=dilation, bias=False)
        self.norm1 = InstanceNorm2d(planes)
        self.norm2 = InstanceNorm2d(planes)
        if stride == 1 and in_planes == planes:
            self.downsample = None
        else:
            self.downsample = nn.Sequential(
                CastConv2d(in_planes, planes, 1, stride=stride),
                InstanceNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class MultiScaleTridentConv(nn.Module):
    """One (O, I, k, k) weight, without bias, applied to each input at its
    branch's stride, with one padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 strides: Sequence[int], padding: int):
        super().__init__()
        self.strides = list(strides)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))

    def init_own_params(self, gen: torch.Generator) -> None:
        """Kaiming-uniform (ReLU gain) over the fan-in, as the JAX
        package draws it."""
        fan_in = self.weight[0].numel()
        bound = math.sqrt(3.0) * math.sqrt(2.0) / math.sqrt(fan_in)
        self.weight.copy_(torch.empty(self.weight.shape).uniform_(
            -bound, bound, generator=gen))

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [F.conv2d(x, self.weight.to(x.dtype), None, s, self.padding)
                for x, s in zip(inputs, self.strides)]


class CNNEncoder(nn.Module):
    """Images -> a list of (B, output_dim, H, W) feature maps, fine to
    coarse: 1/8, or with two output scales 1/4 and 1/8."""

    def __init__(self, output_dim: int = 128, num_output_scales: int = 1):
        super().__init__()
        self.num_branch = num_output_scales
        dims = [64, 96, 128]
        self.conv1 = CastConv2d(3, dims[0], 7, stride=2, padding=3,
                                bias=False)
        self.norm1 = InstanceNorm2d(dims[0])
        self.layer1 = nn.Sequential(ResidualBlock(dims[0], dims[0]),
                                    ResidualBlock(dims[0], dims[0]))
        self.layer2 = nn.Sequential(ResidualBlock(dims[0], dims[1], stride=2),
                                    ResidualBlock(dims[1], dims[1]))
        stride = 2 if num_output_scales == 1 else 1
        self.layer3 = nn.Sequential(
            ResidualBlock(dims[1], dims[2], stride=stride),
            ResidualBlock(dims[2], dims[2]))
        self.conv2 = CastConv2d(dims[2], output_dim, 1, 1, 0)
        if self.num_branch > 1:
            self.trident_conv = MultiScaleTridentConv(
                output_dim, output_dim, kernel_size=3,
                strides=[2 ** i for i in range(self.num_branch)], padding=1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.conv2(self.layer3(self.layer2(self.layer1(x))))
        if self.num_branch > 1:
            return self.trident_conv([x] * self.num_branch)
        return [x]
