"""RAFT feature and context encoders (``ptlflow_tpu/models/raft/
extractor.py``), NCHW.

The attribute trees are the JAX package's, so ``state_dict()`` keys equal
its flattened parameter names and the reference checkpoint names.  Blocks
of stride 2 keep the ``norm3`` (ResidualBlock) or ``norm4``
(BottleneckBlock) that the forward never uses, because the checkpoints
carry it.  The convolutions cast their weights to their input's dtype
(``CastConv2d``), as the JAX package's do: a no-op on weights of the
input's dtype, and float32 arithmetic on bfloat16-cast weights for float32
images (``infer --bf16`` and ``validate --bf16`` on a model without a
mixed-precision mode).
"""

from __future__ import annotations

import torch
from torch import nn

from ... import nn as pnn
from ...nn import CastConv2d


def make_norm(norm_fn: str, planes: int) -> nn.Module:
    if norm_fn == "group":
        return nn.GroupNorm(num_groups=planes // 8, num_channels=planes)
    if norm_fn == "batch":
        return pnn.BatchNorm2d(planes)
    if norm_fn == "instance":
        return pnn.InstanceNorm2d(planes)
    if norm_fn == "none":
        return nn.Sequential()
    raise ValueError(norm_fn)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = CastConv2d(planes, planes, 3, padding=1)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        if stride == 1:
            self.downsample = None
        else:
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                CastConv2d(in_planes, planes, 1, stride=stride),
                make_norm(norm_fn, planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BottleneckBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, planes // 4, 1, padding=0)
        self.conv2 = CastConv2d(planes // 4, planes // 4, 3, padding=1,
                               stride=stride)
        self.conv3 = CastConv2d(planes // 4, planes, 1, padding=0)
        self.norm1 = make_norm(norm_fn, planes // 4)
        self.norm2 = make_norm(norm_fn, planes // 4)
        self.norm3 = make_norm(norm_fn, planes)
        if stride == 1:
            self.downsample = None
        else:
            self.norm4 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                CastConv2d(in_planes, planes, 1, stride=stride),
                make_norm(norm_fn, planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = torch.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        self.norm_fn = norm_fn
        self.norm1 = make_norm(norm_fn, 64)
        self.conv1 = CastConv2d(3, 64, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn, 1),
                                    ResidualBlock(64, 64, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm_fn, 2),
                                    ResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = CastConv2d(128, output_dim, 1)
        self.dropout_p = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class SmallEncoder(nn.Module):
    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0):
        super().__init__()
        self.norm_fn = norm_fn
        self.norm1 = make_norm(norm_fn, 32)
        self.conv1 = CastConv2d(3, 32, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(BottleneckBlock(32, 32, norm_fn, 1),
                                    BottleneckBlock(32, 32, norm_fn, 1))
        self.layer2 = nn.Sequential(BottleneckBlock(32, 64, norm_fn, 2),
                                    BottleneckBlock(64, 64, norm_fn, 1))
        self.layer3 = nn.Sequential(BottleneckBlock(64, 96, norm_fn, 2),
                                    BottleneckBlock(96, 96, norm_fn, 1))
        self.conv2 = CastConv2d(96, output_dim, 1)
        self.dropout_p = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)
