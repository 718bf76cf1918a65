"""LiteFlowNet (``ptlflow_tpu/models/liteflownet/liteflownet.py``), NCHW:
a six-stage feature extractor shared by both frames (five levels used,
1/32 to 1/2), and at each level a cascade of descriptor matching (a 7x7
local correlation, strided and dilated at the two finest levels and
upsampled back by a grouped transposed convolution), sub-pixel refinement
and feature-driven regularization (a learned distance over each pixel's
k x k flow neighbourhood, softmax-weighted).

The warp moves by the flow times a level's multiplier, samples with
``align_corners=True`` and zeroes every sample that is not fully inside
the map; the regularization's brightness error takes only the warped
green channel, as the reference does.  The correlations are
``ops.local_correlation`` over C; no lookup kernel runs here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ...nn import CastConv2d, CastConvTranspose2d
from ...ops.correlation import coords_grid, local_correlation
from ...ops.grid_sample import bilinear_sampler, interpolate
from ...utils.registry import register_model
from ..base import BaseModel

# the input's BGR shift (liteflownet.py:292-296)
BGR_ADD = (-0.454253, -0.434631, -0.411618)


def lrelu() -> nn.Module:
    return nn.LeakyReLU(0.1)


def conv_stack(*specs) -> nn.Sequential:
    """Convolutions (in, out, kernel, stride, padding), each followed by a
    leaky ReLU, except where a spec ends in ``False``."""
    layers = []
    for spec in specs:
        act = spec[-1] is not False
        layers.append(CastConv2d(*(spec if act else spec[:-1])))
        if act:
            layers.append(lrelu())
    return nn.Sequential(*layers)


def lfn_warp(x: torch.Tensor, flow: torch.Tensor, mult: float) -> torch.Tensor:
    """``x`` (B, C, H, W) sampled at the grid plus ``flow`` * ``mult``
    (align_corners=True, warp.py:25-45), zero where the sample is not
    fully inside the map: 0 <= x <= W - 1 and 0 <= y <= H - 1, in closed
    form (the reference thresholds a ``grid_sample`` of ones at 1, which
    rounding can miss)."""
    b, _, h, w = x.shape
    coords = coords_grid(b, h, w, dtype=flow.dtype,
                         device=flow.device) + flow * mult
    out = bilinear_sampler(x, coords)
    cx, cy = coords[:, 0], coords[:, 1]
    mask = (cx >= 0) & (cx <= w - 1) & (cy >= 0) & (cy <= h - 1)
    return out * mask[:, None].to(x.dtype)


def smooth_flow(flow: torch.Tensor, dist: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Each pixel's k x k flow neighbourhood (zero outside the map, (dy, dx)
    row-major, as ``F.unfold`` orders it) weighted by exp(-d^2) of the
    (B, k * k, H, W) distances, less their maximum, over the weights'
    sum."""
    dist = -dist.square()
    dist = torch.exp(dist - dist.amax(dim=1, keepdim=True))
    div = dist.sum(dim=1, keepdim=True)
    b, _, h, w = flow.shape
    neigh = torch.nn.functional.unfold(flow, k, padding=k // 2).view(
        b, 2, k * k, h, w)
    return (neigh * dist[:, None]).sum(dim=2) / div


def images_pyramid(images: torch.Tensor, feats_pyr) -> List[torch.Tensor]:
    """(B, N, 3, H, W) images resized bilinearly to each level's size."""
    b, n = images.shape[:2]
    flat = images.flatten(0, 1)
    return [interpolate(flat, f.shape[-2:], mode="bilinear",
                        align_corners=False).view(b, n, 3, *f.shape[-2:])
            for f in feats_pyr]


class FeatureExtractor(nn.Module):
    """Six stages (1 to 1/32); ``first`` is the first stage kept."""

    def __init__(self, first: int = 1):
        super().__init__()
        self.first = first
        self.convs = nn.ModuleList([
            conv_stack((3, 32, 7, 1, 3)),
            conv_stack((32, 32, 3, 2, 1), (32, 32, 3, 1, 1),
                       (32, 32, 3, 1, 1)),
            conv_stack((32, 64, 3, 2, 1), (64, 64, 3, 1, 1)),
            conv_stack((64, 96, 3, 2, 1), (96, 96, 3, 1, 1)),
            conv_stack((96, 128, 3, 2, 1)),
            conv_stack((128, 192, 3, 2, 1)),
        ])

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        """(B, 2, 3, H, W) -> (B, 2, c, h, w) a level, coarse first."""
        b, n = images.shape[:2]
        x = images.flatten(0, 1)
        feats = []
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i >= self.first:
                feats.append(x.view(b, n, *x.shape[1:]))
        return feats[::-1]


def correlate(f1: torch.Tensor, f2: torch.Tensor, radius: int,
              dilation: int = 1, stride: int = 1) -> torch.Tensor:
    """The unnormalised local correlation of the family's every cost volume
    (``ops.local_correlation``), its leaky ReLU taken, over C."""
    return nn.functional.leaky_relu(local_correlation(
        f1, f2, radius, normalize=False, dilation=dilation, stride=stride),
        0.1) / f1.shape[1]


class Matching(nn.Module):
    def __init__(self, level: int, num_levels: int = 5,
                 div_flow: float = 20.0):
        super().__init__()
        self.corr_stride = [1, 1, 1, 2, 2][level]
        k = [3, 3, 5, 5, 7][level]
        self.mult = div_flow / 2 ** (num_levels - level)
        self.up_flow = None if level == 0 else CastConvTranspose2d(
            2, 2, 4, 2, 1, bias=False, groups=2)
        self.up_corr = None if level < 3 else CastConvTranspose2d(
            49, 49, 4, 2, 1, bias=False, groups=49)
        self.flow_net = conv_stack((49, 128, 3, 1, 1), (128, 64, 3, 1, 1),
                                   (64, 32, 3, 1, 1),
                                   (32, 2, k, 1, k // 2, False))

    def forward(self, feats: torch.Tensor,
                flow: Optional[torch.Tensor]) -> torch.Tensor:
        warped = feats[:, 1]
        if flow is not None:
            flow = self.up_flow(flow)
            warped = lfn_warp(feats[:, 1], flow, self.mult)
        # divided by C before the leaky ReLU, as the JAX package does
        corr = nn.functional.leaky_relu(local_correlation(
            feats[:, 0], warped, 3, normalize=False, dilation=self.corr_stride,
            stride=self.corr_stride) / feats.shape[2], 0.1)
        if self.up_corr is not None:
            corr = self.up_corr(corr)
        new_flow = self.flow_net(corr)
        return new_flow if flow is None else flow + new_flow


class SubPixel(nn.Module):
    def __init__(self, level: int, num_levels: int = 5,
                 div_flow: float = 20.0):
        super().__init__()
        dims = [386, 258, 194, 130, 130][level]
        k = [3, 3, 5, 5, 7][level]
        self.mult = div_flow / 2 ** (num_levels - level)
        self.flow_net = conv_stack((dims, 128, 3, 1, 1), (128, 64, 3, 1, 1),
                                   (64, 32, 3, 1, 1),
                                   (32, 2, k, 1, k // 2, False))

    def forward(self, feats: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
        warped = lfn_warp(feats[:, 1], flow, self.mult)
        return flow + self.flow_net(torch.cat([feats[:, 0], warped, flow], 1))


class RegularizationBase(nn.Module):
    """The regularization shared by LiteFlowNet 1, 2 and 3: the feature
    network over the brightness error, the mean-free flow and the first
    frame's features (through a 1x1 convolution from level 2 on), and the
    distance head, a k x k convolution at levels 0-1 and a separable
    (k x 1, 1 x k) pair after."""

    def __init__(self, level: int, dims: int, k: int, mult: float,
                 green_only: bool):
        super().__init__()
        self.k = k
        self.mult = mult
        self.green_only = green_only
        if level < 2:
            self.feat_conv = nn.Sequential()
        else:
            self.feat_conv = conv_stack((dims - 3, 128, 1, 1, 0))
            dims = 131
        self.feat_net = conv_stack(
            (dims, 128, 3, 1, 1), (128, 128, 3, 1, 1), (128, 64, 3, 1, 1),
            (64, 64, 3, 1, 1), (64, 32, 3, 1, 1), (32, 32, 3, 1, 1))
        if level < 2:
            self.dist = CastConv2d(32, k * k, 3, 1, 1)
        else:
            self.dist = nn.Sequential(
                CastConv2d(32, k * k, (k, 1), 1, (k // 2, 0)),
                CastConv2d(k * k, k * k, (1, k), 1, (0, k // 2)))

    def features(self, images: torch.Tensor, feats: torch.Tensor,
                 flow: torch.Tensor) -> torch.Tensor:
        warped = lfn_warp(images[:, 1], flow, self.mult)
        if self.green_only:
            # the reference broadcasts the warped green channel alone
            # (liteflownet.py:214-229)
            warped = warped[:, 1:2]
        diff = torch.linalg.vector_norm(images[:, 0] - warped, dim=1,
                                        keepdim=True)
        flow_nomean = flow - flow.mean(dim=(2, 3), keepdim=True)
        x = torch.cat([diff, flow_nomean, self.feat_conv(feats[:, 0])], 1)
        return self.feat_net(x)


class Regularization(RegularizationBase):
    def __init__(self, level: int, num_levels: int = 5,
                 div_flow: float = 20.0):
        super().__init__(level, [195, 131, 99, 67, 35][level],
                         [3, 3, 5, 5, 7][level],
                         div_flow / 2 ** (num_levels - level), True)

    def forward(self, images: torch.Tensor, feats: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
        x = self.features(images, feats, flow)
        return smooth_flow(flow, self.dist(x), self.k)


class LiteFlowNet(BaseModel):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/liteflownet-kitti-49f1991a.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/liteflownet-sintel-17991e50.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/liteflownet-things-a4d066e2.ckpt",
    }

    def __init__(self, div_flow: float = 20.0, **kwargs):
        super().__init__(loss_fn=None, output_stride=32, **kwargs)
        self.div_flow = div_flow
        self.num_levels = 5
        self.feature_net = FeatureExtractor()
        self.matching_nets = nn.ModuleList(
            [Matching(i, self.num_levels, div_flow)
             for i in range(self.num_levels)])
        self.subpixel_nets = nn.ModuleList(
            [SubPixel(i, self.num_levels, div_flow)
             for i in range(self.num_levels)])
        self.regularization_nets = nn.ModuleList(
            [Regularization(i, self.num_levels, div_flow)
             for i in range(self.num_levels)])
        self.feat2_conv = conv_stack((32, 64, 1, 1, 0))

    def preprocess(self, images: torch.Tensor):
        """BGR shifted, RGB, resized by interpolation to a multiple of 32."""
        return self.preprocess_images(
            images, bgr_add=BGR_ADD, bgr_mult=1.0, bgr_to_rgb=True,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=False)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds``, the
        five levels' flows in units of 1/``div_flow``, 1/32 to 1/2."""
        images, resizer = self.preprocess(inputs["images"])
        feats_pyr = self.feature_net(images)
        images_pyr = images_pyramid(images, feats_pyr)
        flow = None
        flow_preds = []
        for i in range(self.num_levels):
            feats = feats_pyr[i]
            if i == self.num_levels - 1:
                feats = self.feat2_conv(feats.flatten(0, 1)).view(
                    *feats.shape[:2], -1, *feats.shape[-2:])
            flow = self.matching_nets[i](feats, flow)
            flow = self.subpixel_nets[i](feats, flow)
            flow = self.regularization_nets[i](images_pyr[i], feats_pyr[i],
                                               flow)
            flow_preds.append(flow)
        flow = flow * self.div_flow
        h, w = flow.shape[-2:]
        flow = interpolate(flow, (2 * h, 2 * w), mode="bilinear",
                           align_corners=False)
        flow = self.postprocess_predictions(flow, resizer, is_flow=True)
        outputs = {"flows": flow[:, None]}
        if training:
            outputs["flow_preds"] = flow_preds
        return outputs


@register_model
class liteflownet(LiteFlowNet):
    pass
