"""Deformable convolution (``ptlflow_tpu/ops/deform_conv.py``), NCHW, with
torchvision's ``ops.deform_conv2d`` semantics at stride 1 and dilation 1:
MaskFlowNet's warp (its flow repeated over the taps as the offsets).

Offsets are (B, 2 K^2, H, W), channel-major over the taps, (dy, dx) a tap,
as torchvision lays them out.  Each tap samples the input bilinearly (zero
outside the map, ``bilinear_sampler``: float32 even for a bfloat16 map) at
the pixel plus the tap's place less ``padding`` plus the tap's offset; the
(C, K^2) samples of a pixel then meet the (O, C, kh, kw) weight in one 1x1
convolution, torchvision's im2col form.  Plain PyTorch on autograd, on
either device: the offsets are read at the output pixel, not at the pixel
plus the tap, so warping the map first and convolving after is not the
same computation.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .correlation import coords_grid
from .grid_sample import bilinear_sampler


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  padding: int = 1) -> torch.Tensor:
    """x (B, C, H, W); offset (B, 2 kh kw, H, W), (dy, dx) a tap; weight
    (O, C, kh, kw); bias (O,).  Returns (B, O, H, W) in ``x``'s dtype."""
    b, c, h, w = x.shape
    o, _, kh, kw = weight.shape
    taps = kh * kw
    dy, dx = torch.meshgrid(torch.arange(kh, dtype=offset.dtype,
                                         device=offset.device) - padding,
                            torch.arange(kw, dtype=offset.dtype,
                                         device=offset.device) - padding,
                            indexing="ij")
    # (B, taps, 2, H, W) as (x, y): the grid, the tap's place, its offset
    off = offset.view(b, taps, 2, h, w).flip(2)
    place = torch.stack([dx.reshape(-1), dy.reshape(-1)], 1)
    coords = (coords_grid(b, h, w, dtype=offset.dtype,
                          device=offset.device)[:, None]
              + place[None, :, :, None, None] + off)
    # every tap in one sampler call: (B, 2, taps * H, W)
    coords = coords.transpose(1, 2).reshape(b, 2, taps * h, w)
    cols = bilinear_sampler(x, coords).view(b, c * taps, h, w)
    return F.conv2d(cols, weight.reshape(o, c * taps, 1, 1).to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


class DeformConv2d(nn.Module):
    """torchvision's ``DeformConv2d`` parameters, ``weight`` (O, C, k, k)
    and ``bias`` (O,), at stride 1.  Its seeded init is the JAX package's:
    both uniform in +-1/sqrt(C k^2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 bias: bool = True):
        super().__init__()
        if stride != 1:
            raise ValueError("stride-1 deformable convolution is what the "
                             "zoo uses")
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = (nn.Parameter(torch.empty(out_channels)) if bias
                     else None)

    def init_own_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        for t in (self.weight, self.bias):
            if t is not None:
                t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                                      generator=gen))

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        return deform_conv2d(x, offset, self.weight, self.bias, self.padding)
