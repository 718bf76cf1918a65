"""SCV's feature and context encoders (``ptlflow_tpu/models/scv/
extractor.py``), NCHW.

Unlike RAFT's, every residual block projects its input (a 1x1
convolution and a norm), even at stride 1.  The reference registers that
norm twice, as ``norm3`` and as ``downsample.1``: here too one module
holds both names, so reference checkpoints load strictly.  The quarter
encoder stops at stride 4.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import CastConv2d
from ..raft.extractor import make_norm


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, planes, 3, padding=1,
                                stride=stride)
        self.conv2 = CastConv2d(planes, planes, 3, padding=1)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.norm3 = make_norm(norm_fn, planes)
        self.downsample = nn.Sequential(
            CastConv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        return torch.relu(self.downsample(x) + y)


class BasicEncoder(nn.Module):
    """To stride 8, or to stride 4 where ``quarter``."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0, quarter: bool = False):
        super().__init__()
        self.norm_fn = norm_fn
        self.norm1 = make_norm(norm_fn, 64)
        self.conv1 = CastConv2d(3, 64, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm_fn, 1),
                                    ResidualBlock(64, 64, norm_fn, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm_fn, 2),
                                    ResidualBlock(96, 96, norm_fn, 1))
        self.layer3 = nn.Sequential(
            ResidualBlock(96, 128, norm_fn, 1 if quarter else 2),
            ResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = CastConv2d(128, output_dim, 1, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BasicEncoderQuarter(BasicEncoder):
    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 dropout: float = 0.0):
        super().__init__(output_dim, norm_fn, dropout, quarter=True)
