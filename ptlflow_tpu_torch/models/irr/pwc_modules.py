"""The IRR-PWC building blocks (``ptlflow_tpu/models/irr/pwc_modules.py``),
NCHW: the warp that takes flows in full-image units over ``div_flow``, the
mean-over-channel cost volume, the flow rescaling, the feature pyramid, the
dense flow and occlusion estimators, the dilated context networks, the
bilateral refinements of flow and occlusion and the occlusion upsampler.
The convolutions cast their weights to their input's dtype."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import coords_grid, local_correlation
from ...ops.grid_sample import bilinear_sampler, interpolate


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def conv(in_planes, out_planes, kernel_size=3, stride=1, dilation=1,
         isReLU=True):
    pad = ((kernel_size - 1) * dilation) // 2
    layers = [CastConv2d(in_planes, out_planes, kernel_size, stride=stride,
                         dilation=dilation, padding=pad, bias=True)]
    if isReLU:
        layers.append(nn.LeakyReLU(0.1))
    return nn.Sequential(*layers)


def irr_warp(x: torch.Tensor, flow: torch.Tensor, height_im: int,
             width_im: int, div_flow: float) -> torch.Tensor:
    """``x`` (B, C, h, w) sampled at the grid plus ``flow`` (B, 2, h, w),
    which is in full-image units over ``div_flow``: x moves by flow_x (w -
    1) / ((W_im - 1) div_flow).  Zero where the sample point lies outside
    [0, w - 1] x [0, h - 1], an analytic mask in place of the reference's
    sampled ones."""
    b, _, h, w = x.shape
    sx = (w - 1) / (max(width_im - 1, 1) * div_flow)
    sy = (h - 1) / (max(height_im - 1, 1) * div_flow)
    scale = torch.tensor([sx, sy], dtype=flow.dtype, device=flow.device)
    coords = (coords_grid(b, h, w, dtype=flow.dtype, device=flow.device)
              + flow * scale[:, None, None])
    out = bilinear_sampler(x, coords)
    inside = ((coords[:, 0] >= 0) & (coords[:, 0] <= w - 1)
              & (coords[:, 1] >= 0) & (coords[:, 1] <= h - 1))
    return out * inside[:, None].to(x.dtype)


def compute_cost_volume(feat1: torch.Tensor, feat2: torch.Tensor,
                        max_disp: int) -> torch.Tensor:
    """The (2d+1)^2-channel local correlation, averaged over channels."""
    return local_correlation(feat1, feat2, max_disp)


def upsample2d_as(x: torch.Tensor, target_hw: Tuple[int, int]
                  ) -> torch.Tensor:
    return interpolate(x, target_hw, mode="bilinear", align_corners=True)


def rescale_flow(flow: torch.Tensor, div_flow: float, width_im: int,
                 height_im: int, to_local: bool = True) -> torch.Tensor:
    """Full-image units over ``div_flow`` to the flow's own grid
    (``to_local``), or back."""
    h, w = flow.shape[-2:]
    if to_local:
        scale = (w / width_im / div_flow, h / height_im / div_flow)
    else:
        scale = (width_im * div_flow / w, height_im * div_flow / h)
    return flow * torch.tensor(scale, dtype=flow.dtype,
                               device=flow.device)[:, None, None]


class FeatureExtractor(nn.Module):
    """Two convolutions a level, the first of stride 2; coarse first."""

    def __init__(self, num_chs: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Sequential(conv(ch_in, ch_out, stride=2), conv(ch_out, ch_out))
            for ch_in, ch_out in zip(num_chs[:-1], num_chs[1:])])

    def forward(self, x: torch.Tensor):
        pyramid = []
        for c in self.convs:
            x = c(x)
            pyramid.append(x)
        return pyramid[::-1]


class FlowEstimatorDense(nn.Module):
    """Five dense convolutions then a ``ch_out`` one: (features, output)."""

    def __init__(self, ch_in: int, ch_out: int = 2):
        super().__init__()
        self.conv1 = conv(ch_in, 128)
        self.conv2 = conv(ch_in + 128, 128)
        self.conv3 = conv(ch_in + 256, 96)
        self.conv4 = conv(ch_in + 352, 64)
        self.conv5 = conv(ch_in + 416, 32)
        self.conv_last = conv(ch_in + 448, ch_out, isReLU=False)

    def forward(self, x: torch.Tensor):
        for name in ("conv1", "conv2", "conv3", "conv4", "conv5"):
            x = torch.cat([getattr(self, name)(x), x], dim=1)
        return x, self.conv_last(x)


def OccEstimatorDense(ch_in: int) -> FlowEstimatorDense:
    return FlowEstimatorDense(ch_in, ch_out=1)


class ContextNetwork(nn.Module):
    """Dilations 1, 2, 4, 8, 16, 1, then a ``ch_out`` convolution."""

    def __init__(self, ch_in: int, ch_out: int = 2):
        super().__init__()
        self.convs = nn.Sequential(
            conv(ch_in, 128, 3, 1, 1), conv(128, 128, 3, 1, 2),
            conv(128, 128, 3, 1, 4), conv(128, 96, 3, 1, 8),
            conv(96, 64, 3, 1, 16), conv(64, 32, 3, 1, 1),
            conv(32, ch_out, isReLU=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


def OccContextNetwork(ch_in: int) -> ContextNetwork:
    return ContextNetwork(ch_in, ch_out=1)


def _neighbors3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) -> (B, 9, H, W): the replicate-padded 3x3
    neighbourhood, row-major (``nn.Unfold``'s channel order)."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    return torch.cat([xp[:, :, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=1)


def _refine_convs(ch_in: int) -> nn.Sequential:
    return nn.Sequential(
        conv(ch_in, 128), conv(128, 128), conv(128, 64), conv(64, 64),
        conv(64, 32), conv(32, 32), conv(32, 9))


class RefineFlow(nn.Module):
    """Each flow channel replaced by a softmax(-f^2)-weighted sum of its
    3x3 neighbourhood, f from the mean-free flow, the image difference's
    norm and the features."""

    def __init__(self, ch_in: int):
        super().__init__()
        self.convs = _refine_convs(ch_in)

    def forward(self, flow, diff_img, feature):
        flow_m = flow - flow.mean(dim=(2, 3), keepdim=True)
        norm2_img = torch.linalg.vector_norm(diff_img, dim=1, keepdim=True)
        feat = self.convs(torch.cat([flow_m, norm2_img, feature], dim=1))
        kernel = torch.softmax(-(feat ** 2), dim=1)
        return torch.cat([(_neighbors3x3(flow[:, i:i + 1]) * kernel).sum(
            1, keepdim=True) for i in range(2)], dim=1)


class RefineOcc(nn.Module):
    """The occlusion as a softmax(-f^2)-weighted sum of its 3x3
    neighbourhood."""

    def __init__(self, ch_in: int):
        super().__init__()
        self.convs = _refine_convs(ch_in)

    def forward(self, occ, feat1, feat2):
        feat = self.convs(torch.cat([occ, feat1, feat2], dim=1))
        kernel = torch.softmax(-(feat ** 2), dim=1)
        return (_neighbors3x3(occ) * kernel).sum(1, keepdim=True)


class OccUpsampleNetwork(nn.Module):
    """Nearest x2 occlusion (bilinear to the target where sizes differ)
    plus a residual network on it and the features."""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.init_conv = conv(ch_in, 32)
        self.res_convs = nn.Sequential(conv(32, 32),
                                       conv(32, 32, isReLU=False))
        self.res_end_conv = conv(32, 32)
        self.out_convs = conv(32, ch_out)

    def forward(self, occ: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        occ2 = interpolate(occ, (occ.shape[-2] * 2, occ.shape[-1] * 2),
                           mode="nearest")
        if tuple(occ2.shape[-2:]) != (h, w):
            occ2 = interpolate(occ2, (h, w), mode="bilinear",
                               align_corners=False)
        x_init = self.init_conv(torch.cat([occ2, x], dim=1))
        x_res = x_init
        for _ in range(3):
            x_res = x_res + 0.1 * self.res_convs(x_res)
        x_init = x_init + self.res_end_conv(x_res)
        return self.out_convs(x_init) + occ2
