"""NeXt1D blocks (``ptlflow_tpu/models/rapidflow/next1d.py``), NCHW:
ConvNeXt-style stages whose depthwise kernel is the outer product of a
vertical and a horizontal 1-D factor, and the recurrent pyramid encoder
that applies one such stage again and again.

``Next1dConv`` builds the k x k kernel from its two factors on every call
(``weight_v * weight_h``), so one depthwise convolution runs and the
gradients reach both factors; with ``fuse_weights`` the module holds the
dense ``weight`` instead.  Either way the kernel is cast to the input's
dtype after the product, as the JAX package does: bf16 factors multiply in
bf16.  The factors start at zero, as the reference registers them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, LayerNorm2d


class Next1dConv(nn.Module):
    """Depthwise (``groups``) convolution with the kernel
    ``weight_v`` (O, I/g, k, 1) times ``weight_h`` (O, I/g, 1, k), or a
    dense ``weight`` (O, I/g, k, k) with ``fuse_weights``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 groups: int = 1, bias: bool = True,
                 fuse_weights: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.fuse_weights = fuse_weights
        k, ig = kernel_size, in_channels // groups
        if fuse_weights:
            self.weight = nn.Parameter(torch.zeros(out_channels, ig, k, k))
        else:
            self.weight_h = nn.Parameter(torch.zeros(out_channels, ig, 1, k))
            self.weight_v = nn.Parameter(torch.zeros(out_channels, ig, k, 1))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if bias
                     else None)

    def init_own_params(self, gen: torch.Generator) -> None:
        """Zeros, as the JAX package and the reference initialise it."""
        for p in self.parameters(recurse=False):
            p.zero_()

    def kernel(self) -> torch.Tensor:
        if self.fuse_weights:
            return self.weight
        # fused[o, i, kh, kw] = v[o, i, kh, 0] * h[o, i, 0, kw]
        return self.weight_v * self.weight_h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.kernel().to(x.dtype), bias, self.stride,
                        self.padding, 1, self.groups)


class ConvMlp(nn.Module):
    """1x1 convolution, exact (erf) GELU, 1x1 convolution."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = CastConv2d(in_features, hidden_features, 1)
        self.fc2 = CastConv2d(hidden_features, in_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Next1dBlock(nn.Module):
    """x + gamma * mlp(norm(conv_dw(x))), with the layer scale ``gamma``
    where ``ls_init_value`` > 0."""

    def __init__(self, in_chs: int, out_chs: Optional[int] = None,
                 kernel_size: int = 7, stride: int = 1,
                 mlp_ratio: float = 4, ls_init_value: float = 1e-6,
                 fuse_next1d_weights: bool = False):
        super().__init__()
        out_chs = out_chs or in_chs
        self.ls_init_value = ls_init_value
        self.conv_dw = Next1dConv(in_chs, out_chs, kernel_size, stride=stride,
                                  padding=kernel_size // 2, groups=in_chs,
                                  bias=True, fuse_weights=fuse_next1d_weights)
        self.norm = LayerNorm2d(out_chs, eps=1e-6)
        self.mlp = ConvMlp(out_chs, int(mlp_ratio * out_chs))
        self.gamma = (nn.Parameter(torch.full((out_chs,), ls_init_value))
                      if ls_init_value > 0 else None)

    def init_own_params(self, gen: torch.Generator) -> None:
        if self.gamma is not None:
            self.gamma.fill_(self.ls_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp(self.norm(self.conv_dw(x)))
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)[:, None, None]
        return y + x


class Next1dStage(nn.Module):
    """A downsample (LayerNorm and a 2x2 stride-2 convolution, or a 1x1
    one where only the width changes) and ``depth`` blocks."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 7,
                 stride: int = 2, depth: int = 2, ls_init_value: float = 1.0,
                 mlp_ratio: float = 4, fuse_next1d_weights: bool = False):
        super().__init__()
        if in_chs != out_chs or stride > 1:
            ds_ks = 2 if stride > 1 else 1
            self.downsample = nn.Sequential(
                LayerNorm2d(in_chs, eps=1e-6),
                CastConv2d(in_chs, out_chs, ds_ks, stride=stride, padding=0))
        else:
            self.downsample = nn.Identity()
        self.blocks = nn.Sequential(*[
            Next1dBlock(out_chs, out_chs, kernel_size=kernel_size,
                        ls_init_value=ls_init_value, mlp_ratio=mlp_ratio,
                        fuse_next1d_weights=fuse_next1d_weights)
            for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class Next1dEncoder(nn.Module):
    """The recurrent pyramid encoder: a stride-``stem_stride`` stem, then
    one shared ``rec_stage`` applied again and again, each time halving the
    resolution with the same weights.  Returns ``out_layer`` of every level
    whose stride lies in ``max_pyr_range``, coarsest first."""

    def __init__(self, max_pyr_range: Sequence[int], stem_stride: int,
                 num_recurrent_layers: int, hidden_chs: int, out_chs: int,
                 mlp_ratio: float = 4.0, depth: int = 2,
                 fuse_next1d_weights: bool = False):
        super().__init__()
        self.max_pyr_range: Tuple[int, int] = tuple(max_pyr_range)
        self.stem_stride = stem_stride
        self.num_recurrent_layers = num_recurrent_layers
        self.stem = nn.Sequential(
            CastConv2d(3, hidden_chs, 7, stride=stem_stride, padding=3),
            LayerNorm2d(hidden_chs, eps=1e-6))
        self.rec_stage = Next1dStage(
            hidden_chs, hidden_chs, stride=2, depth=depth,
            mlp_ratio=mlp_ratio, fuse_next1d_weights=fuse_next1d_weights)
        self.out_layer = CastConv2d(hidden_chs, out_chs, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        pyramid = []
        stride = 1
        n_iters = (self.num_recurrent_layers + 2
                   - int(math.log2(self.stem_stride)))
        for i in range(n_iters):
            if i == 0:
                x = self.stem(x)
                stride *= self.stem_stride
            else:
                x = self.rec_stage(x)
                stride *= 2
            if stride >= self.max_pyr_range[0]:
                pyramid.append(x)
        return [self.out_layer(f) for f in pyramid[::-1]]
