"""SeparableFlow's cost aggregation (``ptlflow_tpu/models/separableflow/
cost_agg.py``): two 3-D U-Nets with semi-global aggregation over a
separated (B, C, D, H, W) volume, the shift regressions and the banded
resampling between them.

The 3-D convolutions are ``nn.Conv3d`` and ``nn.ConvTranspose3d`` (cuDNN on
the card) with ``BatchNorm3d``; every convolution casts its weights to its
input's dtype.  The resizes are separable 1-D linear interpolations with
aligned corners, as the JAX package computes them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm3d, CastConv3d, CastConvTranspose3d
from ...ops.grid_sample import interpolate
from .ganet import _l1_normalize, sga


def linear_resize_axis(x: torch.Tensor, dim: int,
                       out_size: int) -> torch.Tensor:
    """1-D linear resize of ``x`` along ``dim`` to ``out_size``, aligned
    corners."""
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    pos = torch.arange(out_size, dtype=torch.float32, device=x.device)
    if out_size > 1:
        pos = pos * ((in_size - 1) / (out_size - 1))
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp(max=in_size - 1)
    shape = [1] * x.dim()
    shape[dim] = out_size
    frac = (pos - lo).to(x.dtype).view(shape)
    return (x.index_select(dim, lo) * (1 - frac)
            + x.index_select(dim, hi) * frac)


def trilinear_resize(x: torch.Tensor,
                     size: Tuple[int, int, int]) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, C, *size), aligned corners: D, then H, then
    W."""
    for dim, n in zip((2, 3, 4), size):
        x = linear_resize_axis(x, dim, n)
    return x


class BasicConv(nn.Module):
    """3-D convolution (or transposed convolution) without bias, then
    ``BatchNorm3d`` and optionally a ReLU."""

    def __init__(self, in_channels, out_channels, deconv=False, relu=True,
                 kernel_size=3, stride=1, padding=1):
        super().__init__()
        self.do_relu = relu
        conv = CastConvTranspose3d if deconv else CastConv3d
        self.conv = conv(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, bias=False)
        self.bn = BatchNorm3d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.do_relu else x


class Conv2x(nn.Module):
    """Stride-2 transposed convolution, then the skip input concatenated
    and a 3x3x3 convolution."""

    def __init__(self, in_channels, out_channels, kernel=4):
        super().__init__()
        self.conv1 = BasicConv(in_channels, out_channels, deconv=True,
                               kernel_size=kernel, stride=2, padding=1)
        self.conv2 = BasicConv(out_channels * 2, out_channels, kernel_size=3,
                               padding=1)

    def forward(self, x: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.cat([self.conv1(x), rem], dim=1))


class SGABlock(nn.Module):
    """Residual semi-global aggregation (the reference's ``refine`` form,
    the one every block of the model takes): ``sga`` under the
    L1-normalised (B, 20, H, W) guidance, BatchNorm and ReLU, a refining
    convolution, then ReLU of the sum with the input."""

    def __init__(self, channels=32):
        super().__init__()
        self.bn_relu = nn.Sequential(BatchNorm3d(channels), nn.ReLU())
        self.conv_refine = BasicConv(channels, channels, relu=False,
                                     kernel_size=3, padding=1)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        gs = [_l1_normalize(k) for k in torch.split(g, 5, dim=1)]
        return torch.relu(self.conv_refine(self.bn_relu(sga(x, *gs))) + x)


class ShiftRegression(nn.Module):
    """Soft argmax over the 2m+1 shift bins of a softmaxed (B, 2m+1, H,
    W) volume: (B, 1, H, W)."""

    def forward(self, x: torch.Tensor, max_shift: int) -> torch.Tensor:
        shift = torch.arange(-max_shift, max_shift + 1, dtype=x.dtype,
                             device=x.device).view(1, -1, 1, 1)
        return (x * shift).sum(1, keepdim=True)


class ShiftEstimate2(nn.Module):
    """A volume -> its shift map at 8x: a 3-D convolution to one channel,
    a trilinear resize to (2m+1, 2H, 2W) with m = max_shift // 4, the
    softmax over the bins in float32, the soft argmax, then bilinear x4
    (aligned corners) times 4."""

    def __init__(self, in_channel=24):
        super().__init__()
        self.conv3d_2d = CastConv3d(in_channel, 1, 3, stride=1, padding=1,
                                    bias=True)
        self.regression = ShiftRegression()

    def forward(self, x: torch.Tensor, max_shift: int) -> torch.Tensor:
        m = max_shift // 4
        x = self.conv3d_2d(x)
        x = trilinear_resize(x, (2 * m + 1, x.shape[3] * 2, x.shape[4] * 2))
        x = torch.softmax(x[:, 0].float(), dim=1).to(x.dtype)
        y = self.regression(x, m)
        h, w = y.shape[-2:]
        return interpolate(y, (h * 4, w * 4), mode="bilinear",
                           align_corners=True) * 4


class Corr2Cost(nn.Module):
    """A (B, C, D, H, W) volume resampled to centred shift bins: ``out[b,
    c, j, h, w] = corr[b, c, base + j - m, h, w]`` for j in [0, 2m], base
    the pixel's x (``is_ux``) or y, zero outside the volume.  The bins are
    whole, so the reference's bilinear resampling is an integer banded
    extraction, taken as the JAX package takes it: D padded by m to dp =
    base_len + 2m + 1 bins, each base row flattened, padded by base_len and
    read back with rows of dp + 1, which skews row ``base`` by ``base``
    bins.  Pads, reshapes and slices only, so autograd's backward is theirs
    on either device."""

    def forward(self, corr: torch.Tensor, maxdisp: int,
                is_ux: bool) -> torch.Tensor:
        d = corr.shape[2]
        m = int(maxdisp)
        # (B, H, C, W, D) for x, (B, W, C, H, D) for y: the base axis last
        # but one
        z = corr.permute(0, 3, 1, 4, 2) if is_ux else corr.permute(
            0, 4, 1, 3, 2)
        lead, base_len = z.shape[:3], z.shape[3]
        dp = base_len + 2 * m + 1
        z = F.pad(z, (m, max(0, dp - m - d)))[..., :dp]
        flat = F.pad(z.reshape(lead + (base_len * dp,)), (0, base_len))
        skew = flat.reshape(lead + (base_len, dp + 1))[..., :2 * m + 1]
        return (skew.permute(0, 2, 4, 1, 3) if is_ux
                else skew.permute(0, 2, 4, 3, 1)).contiguous()


class CostAggregation(nn.Module):
    """The dual 3-D U-Net with SGA blocks over a (B, C_in, D, H, W)
    volume, guided by the (B, 20, .) maps of ``g``: eval (shift map at 8x,
    (B, 1, D, H, W) volume); training (two earlier shift maps, the shift
    map, the volume)."""

    def __init__(self, in_channel=8):
        super().__init__()
        ic = 8
        self.conv0 = BasicConv(in_channel, ic, kernel_size=3, padding=1)
        self.conv1a = BasicConv(ic, ic * 2, kernel_size=3, stride=2,
                                padding=1)
        self.conv2a = BasicConv(ic * 2, ic * 4, kernel_size=3, stride=2,
                                padding=1)
        self.conv3a = BasicConv(ic * 4, ic * 6, kernel_size=3, stride=2,
                                padding=1)
        self.deconv1a = Conv2x(ic * 2, ic)
        self.deconv2a = Conv2x(ic * 4, ic * 2)
        self.deconv3a = Conv2x(ic * 6, ic * 4)
        self.conv1b = BasicConv(ic, ic * 2, kernel_size=3, stride=2,
                                padding=1)
        self.conv2b = BasicConv(ic * 2, ic * 4, kernel_size=3, stride=2,
                                padding=1)
        self.conv3b = BasicConv(ic * 4, ic * 6, kernel_size=3, stride=2,
                                padding=1)
        self.deconv1b = Conv2x(ic * 2, ic, kernel=(3, 4, 4))
        self.deconv2b = Conv2x(ic * 4, ic * 2, kernel=(3, 4, 4))
        self.deconv3b = Conv2x(ic * 6, ic * 4, kernel=(3, 4, 4))
        self.shift0 = ShiftEstimate2(ic)
        self.shift1 = ShiftEstimate2(ic)
        self.shift2 = ShiftEstimate2(ic)
        self.sga1 = SGABlock(channels=ic)
        self.sga2 = SGABlock(channels=ic)
        self.sga3 = SGABlock(channels=ic)
        self.sga11 = SGABlock(channels=ic * 2)
        self.sga12 = SGABlock(channels=ic * 2)
        self.corr_output = BasicConv(ic, 1, kernel_size=3, padding=1,
                                     relu=False)
        self.corr2cost = Corr2Cost()

    def forward(self, x: torch.Tensor, g: Dict[str, torch.Tensor],
                max_shift: int, is_ux: bool, training: bool = False):
        x = self.sga1(self.conv0(x), g["sg1"])
        rem0 = x
        if training:
            shift0 = self.shift0(self.corr2cost(x, max_shift // 8, is_ux),
                                 max_shift)
        x = self.sga11(self.conv1a(x), g["sg11"])
        rem1 = x
        x = self.conv2a(x)
        rem2 = x
        x = self.deconv3a(self.conv3a(x), rem2)
        x = self.sga12(self.deconv2a(x, rem1), g["sg12"])
        x = self.sga2(self.deconv1a(x, rem0), g["sg2"])
        cost = self.corr2cost(x, max_shift // 8, is_ux)
        if training:
            shift1 = self.shift1(cost, max_shift)
        corr = self.corr_output(x)
        x = self.conv1b(cost)
        rem1 = x
        x = self.conv2b(x)
        rem2 = x
        x = self.deconv3b(self.conv3b(x), rem2)
        x = self.deconv2b(x, rem1)
        x = self.sga3(self.deconv1b(x, cost), g["sg3"])
        shift2 = self.shift2(x, max_shift)
        if training:
            return shift0, shift1, shift2, corr
        return shift2, corr
