"""VCN's encoder pieces (``ptlflow_tpu/models/vcn/submodule.py``), NCHW:
the convolution + BatchNorm (+ leaky ReLU 0.1) units, the residual block,
the pyramid pooling and the PSPNet feature pyramids ``pspnet`` (1/64 to
1/4, five levels) and ``pspnet_s`` (1/64 to 1/8, four), whose names are
the reference's (``cbr_unit``/``cb_unit`` Sequential indices included).
The options no VCN sets (BatchNorm-free units, dilated residual blocks,
the pyramids' projections) are left out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm2d, CastConv2d
from ...ops.grid_sample import interpolate


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def conv(in_planes, out_planes, kernel_size=3, stride=1, padding=1,
         dilation=1) -> nn.Sequential:
    """Convolution with bias, BatchNorm, leaky ReLU 0.1."""
    return nn.Sequential(
        CastConv2d(in_planes, out_planes, kernel_size, stride=stride,
                   padding=padding, dilation=dilation, bias=True),
        BatchNorm2d(out_planes), nn.LeakyReLU(0.1))


class conv2DBatchNorm(nn.Module):
    """Convolution without bias, then BatchNorm."""

    def __init__(self, in_channels, n_filters, k_size, stride, padding):
        super().__init__()
        self.cb_unit = nn.Sequential(
            CastConv2d(in_channels, n_filters, k_size, stride=stride,
                       padding=padding, bias=False),
            BatchNorm2d(n_filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cb_unit(x)


class conv2DBatchNormRelu(nn.Module):
    """Convolution without bias, BatchNorm, leaky ReLU 0.1."""

    def __init__(self, in_channels, n_filters, k_size, stride, padding):
        super().__init__()
        self.cbr_unit = nn.Sequential(
            CastConv2d(in_channels, n_filters, k_size, stride=stride,
                       padding=padding, bias=False),
            BatchNorm2d(n_filters), nn.LeakyReLU(0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbr_unit(x)


class residualBlock(nn.Module):
    def __init__(self, in_channels, n_filters, stride=1, downsample=None):
        super().__init__()
        self.convbnrelu1 = conv2DBatchNormRelu(in_channels, n_filters, 3,
                                               stride, 1)
        self.convbn2 = conv2DBatchNorm(n_filters, n_filters, 3, 1, 1)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.convbn2(self.convbnrelu1(x))
        residual = x if self.downsample is None else self.downsample(x)
        return lrelu(out + residual)


class pyramidPooling(nn.Module):
    """The map plus the mean of ``levels`` average-pooled, projected and
    bilinearly re-expanded copies of itself, halved, leaky ReLU."""

    def __init__(self, in_channels, levels=4):
        super().__init__()
        self.levels = levels
        self.path_module_list = nn.ModuleList([
            conv2DBatchNormRelu(in_channels, in_channels, 1, 1, 0)
            for _ in range(levels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        k_sizes = [(int(h / p), int(w / p)) for p in
                   np.linspace(1, min(h, w) // 2, self.levels, dtype=int)]
        pp_sum = x
        for k, mod in zip(k_sizes[::-1], self.path_module_list):
            out = mod(F.avg_pool2d(x, k, k))
            out = interpolate(out, (h, w), mode="bilinear",
                              align_corners=False)
            pp_sum = pp_sum + 1.0 / self.levels * out
        return lrelu(pp_sum / 2.0)


class _PSPBase(nn.Module):
    """The PSPNet pyramid: a stride-2 stem and max-pool, four strided
    residual blocks down to 1/64, pyramid pooling, then a decoder that
    upsamples each level bilinearly to the next finer one and fuses it
    with that level's skip.  Returns the levels coarse to fine (1/64,
    1/32, 1/16, 1/8 and, unless ``small``, 1/4).  (The reference's 1x1
    projections of the levels, ``is_proj``, are left out: VCN builds both
    pyramids without them.)"""

    def __init__(self, small=False):
        super().__init__()
        self.small = small
        self.inplanes = 32
        self.convbnrelu1_1 = conv2DBatchNormRelu(3, 16, 3, 2, 1)
        self.convbnrelu1_2 = conv2DBatchNormRelu(16, 16, 3, 1, 1)
        self.convbnrelu1_3 = conv2DBatchNormRelu(16, 32, 3, 1, 1)
        self.res_block3 = self._make_layer(64, stride=2)
        self.res_block5 = self._make_layer(128, stride=2)
        self.res_block6 = self._make_layer(128, stride=2)
        self.res_block7 = self._make_layer(128, stride=2)
        self.pyramid_pooling = pyramidPooling(128, levels=3)
        # the reference's Sequential holds its upsampler at index 0
        self.upconv6 = nn.Sequential(nn.Identity(),
                                     conv2DBatchNormRelu(128, 64, 3, 1, 1))
        self.iconv5 = conv2DBatchNormRelu(192, 128, 3, 1, 1)
        self.upconv5 = nn.Sequential(nn.Identity(),
                                     conv2DBatchNormRelu(128, 64, 3, 1, 1))
        self.iconv4 = conv2DBatchNormRelu(192, 128, 3, 1, 1)
        self.upconv4 = nn.Sequential(nn.Identity(),
                                     conv2DBatchNormRelu(128, 64, 3, 1, 1))
        self.iconv3 = conv2DBatchNormRelu(128, 64, 3, 1, 1)
        if not small:
            self.upconv3 = nn.Sequential(
                nn.Identity(), conv2DBatchNormRelu(64, 32, 3, 1, 1))
            self.iconv2 = conv2DBatchNormRelu(64, 64, 3, 1, 1)

    def _make_layer(self, planes, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes:
            downsample = nn.Sequential(
                CastConv2d(self.inplanes, planes, 1, stride=stride,
                           bias=False),
                BatchNorm2d(planes))
        layer = nn.Sequential(residualBlock(self.inplanes, planes, stride,
                                            downsample))
        self.inplanes = planes
        return layer

    def forward(self, x: torch.Tensor):
        conv1 = self.convbnrelu1_3(self.convbnrelu1_2(self.convbnrelu1_1(x)))
        pool1 = F.max_pool2d(conv1, 3, 2, 1)
        rconv3 = self.res_block3(pool1)
        conv4 = self.res_block5(rconv3)
        conv5 = self.res_block6(conv4)
        conv6 = self.pyramid_pooling(self.res_block7(conv5))

        def fuse(iconv, upconv, src, skip):
            up = upconv[1](interpolate(src, skip.shape[-2:], mode="bilinear",
                                       align_corners=False))
            return iconv(torch.cat([skip, up], 1))

        conv5 = fuse(self.iconv5, self.upconv6, conv6, conv5)
        conv4 = fuse(self.iconv4, self.upconv5, conv5, conv4)
        conv3 = fuse(self.iconv3, self.upconv4, conv4, rconv3)
        outs = [conv6, conv5, conv4, conv3]
        if not self.small:
            outs.append(fuse(self.iconv2, self.upconv3, conv3, pool1))
        return tuple(outs)


class pspnet(_PSPBase):
    def __init__(self):
        super().__init__(small=False)


class pspnet_s(_PSPBase):
    def __init__(self):
        super().__init__(small=True)
