"""The DPT feature-fusion heads of WAFT's and FlowSeek's backbones
(``ptlflow_tpu/models/waft/dpt.py``), NCHW: DepthAnything V2's head with its
fixed resize layers (``DPTHeadA1``) and WAFT-a2's head whose resize layers
follow ``lvl`` (``DPTHeadLvl``).  Every resize is bilinear with
align_corners=True.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...nn import CastConv2d, CastConvTranspose2d
from ...ops.grid_sample import interpolate


class ResidualConvUnit(nn.Module):
    """ReLU, 3x3 conv, ReLU, 3x3 conv, and the residual (no BatchNorm)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = CastConv2d(features, features, 3, padding=1)
        self.conv2 = CastConv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(torch.relu(x))
        return self.conv2(torch.relu(out)) + x


class FeatureFusionBlock(nn.Module):
    """``x`` plus the refined ``res``, refined again, resized to ``size``
    (twice its size by default) and projected by a 1x1 conv."""

    def __init__(self, features: int):
        super().__init__()
        self.out_conv = CastConv2d(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            size = (2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(interpolate(x, tuple(size), align_corners=True))


def tokens_to_map(tokens: torch.Tensor, patch_h: int,
                  patch_w: int) -> torch.Tensor:
    """(B, N, D) tokens in raster order -> (B, D, patch_h, patch_w)."""
    return tokens.transpose(1, 2).reshape(tokens.shape[0], -1, patch_h,
                                          patch_w)


class DPTHeadA1(nn.Module):
    """DepthAnything V2's head: 1x1 projections of four token maps, resized
    x4, x2, x1 and x1/2, fused coarse to fine; returns (out, path_1,
    path_2, path_3, path_4), ``out`` resized to the patches' pixel size.
    ``scratch.output_conv2`` is the depth head proper, which only FlowSeek
    runs."""

    def __init__(self, in_channels: int, features: int = 256,
                 out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 patch_size: int = 14):
        super().__init__()
        self.patch_size = patch_size
        self.projects = nn.ModuleList(
            [CastConv2d(in_channels, oc, 1) for oc in out_channels])
        self.resize_layers = nn.ModuleList([
            CastConvTranspose2d(out_channels[0], out_channels[0], 4,
                                stride=4),
            CastConvTranspose2d(out_channels[1], out_channels[1], 2,
                                stride=2),
            nn.Identity(),
            CastConv2d(out_channels[3], out_channels[3], 3, stride=2,
                       padding=1),
        ])
        scratch = nn.Module()
        for i, oc in enumerate(out_channels):
            setattr(scratch, f"layer{i + 1}_rn",
                    CastConv2d(oc, features, 3, padding=1, bias=False))
        for i in range(4):
            setattr(scratch, f"refinenet{i + 1}", FeatureFusionBlock(features))
        scratch.output_conv1 = CastConv2d(features, features // 2, 3,
                                          padding=1)
        scratch.output_conv2 = nn.Sequential(
            CastConv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            CastConv2d(32, 1, 1), nn.ReLU())
        self.scratch = scratch

    def forward(self, features, patch_h: int, patch_w: int):
        """``features``: four (tokens, cls) pairs."""
        maps = [resize(proj(tokens_to_map(tokens, patch_h, patch_w)))
                for (tokens, _), proj, resize in zip(
                    features, self.projects, self.resize_layers)]
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(m)
                          for i, m in enumerate(maps))
        path4 = s.refinenet4(l4, size=l3.shape[-2:])
        path3 = s.refinenet3(path4, l3, size=l2.shape[-2:])
        path2 = s.refinenet2(path3, l2, size=l1.shape[-2:])
        path1 = s.refinenet1(path2, l1)
        out = interpolate(s.output_conv1(path1),
                          (patch_h * self.patch_size,
                           patch_w * self.patch_size), align_corners=True)
        return out, path1, path2, path3, path4


class DPTHeadLvl(nn.Module):
    """WAFT-a2's head: resize layers from ``lvl`` (-3: transposed convs of
    kernel 8, 4 and 2, then a 1x1 conv), fused coarse to fine at each
    level's own size; returns the fused maps, finest first."""

    def __init__(self, in_channels: int, features: int = 64,
                 out_channels: Sequence[int] = (48, 96, 192, 384),
                 lvl: int = -3):
        super().__init__()
        self.projects = nn.ModuleList(
            [CastConv2d(in_channels, oc, 1) for oc in out_channels])
        resize = []
        for i, oc in enumerate(out_channels):
            if i + lvl < 0:
                k = 2 ** (-i - lvl)
                resize.append(CastConvTranspose2d(oc, oc, k, stride=k))
            else:
                k = 2 ** (i + lvl)
                resize.append(CastConv2d(oc, oc, k, stride=k))
        self.resize_layers = nn.ModuleList(resize)
        self.scratch = nn.ModuleList(
            [CastConv2d(oc, features, 3, padding=1, bias=False)
             for oc in out_channels])
        self.refine = nn.ModuleList(
            [FeatureFusionBlock(features) for _ in out_channels])

    def forward(self, features, patch_h: int,
                patch_w: int) -> List[torch.Tensor]:
        maps = [resize(proj(tokens_to_map(tokens, patch_h, patch_w)))
                for (tokens, _), proj, resize in zip(
                    features, self.projects, self.resize_layers)]
        return fuse_pyramid(self.scratch, self.refine, maps)


def fuse_pyramid(scratch: nn.ModuleList, refine: nn.ModuleList,
                 maps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A 3x3 ``scratch`` conv a level, then coarse-to-fine fusion: the
    coarsest refined at its size, each finer one fused with the refined
    coarser level upsampled x2 (bilinear, align_corners=True), at its own
    size.  Returns the fused maps, finest first."""
    n = len(maps)
    out = [conv(m) for conv, m in zip(scratch, maps)]
    out[-1] = refine[n - 1](out[-1], size=out[-1].shape[-2:])
    for i in range(n - 2, -1, -1):
        coarse = out[i + 1]
        up = interpolate(coarse, (2 * coarse.shape[-2], 2 * coarse.shape[-1]),
                         align_corners=True)
        out[i] = refine[i](out[i], up, size=out[i].shape[-2:])
    return out
