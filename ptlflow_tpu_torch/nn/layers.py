"""Layers with the JAX package's eval arithmetic.

Convolutions are ``torch.nn.Conv2d`` (OIHW weights; the JAX package stores
HWIO, see ``utils/convert.py``), linear layers ``torch.nn.Linear`` ((out,
in) weights; the JAX package stores (in, out)), GELU ``F.gelu`` (exact
erf, as the JAX package's ``gelu``) and pooling ``F.avg_pool2d``.  The
modules below are ``torch.nn`` modules with the same parameters and
buffers, so their ``state_dict`` keys are torch's and the JAX package's; they
only change how the eval forward computes, to follow
``ptlflow_tpu/nn/layers.py`` in reduced precision too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is where its type is wider: the float32
    islands of a reduced-precision forward (softmaxes, norms' statistics)
    stay float64 in a float64 one."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class CastConv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs in its input's dtype: weight and bias are
    cast to ``x.dtype`` on every call, as every convolution of the JAX
    package does.  A bfloat16 input then gives a bfloat16 output while the
    stored weights stay float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class CastConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that runs in its input's dtype, as
    ``CastConv2d``: the JAX package's ``ConvTranspose2d`` casts its weight
    to ``x.dtype``.  Its seeded init is the JAX one: weight and bias
    uniform in +-1/sqrt(in_channels / groups * kh * kw)."""

    def init_own_params(self, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        bound = 1.0 / math.sqrt(self.in_channels // self.groups * kh * kw)
        for t in (self.weight, self.bias):
            if t is not None:
                t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                                      generator=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


class CastLinear(nn.Linear):
    """``nn.Linear`` that runs in its input's dtype, as ``CastConv2d``: the
    JAX package's ``Linear`` casts its weight and bias to ``x.dtype``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d``.  In eval mode it folds the running statistics
    into one scale and shift in float32 and applies them in the input's
    dtype, as the JAX package does, so bfloat16 inputs work with the
    float32 running statistics that mixed precision keeps.

    In training mode it is ``nn.BatchNorm2d``'s: batch statistics, and
    ``running_mean``/``running_var`` updated with momentum 0.1 and the
    unbiased variance, as the JAX package's ``BatchNorm2d`` with
    ``training=True``.  A model's forward sets the mode from its
    ``training`` argument (``nn.train_mode``), so the statistics move
    exactly when the JAX package's do."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or not self.track_running_stats:
            return super().forward(x)
        scale = torch.rsqrt(self.running_var.float() + self.eps)
        shift = -self.running_mean.float() * scale
        if self.affine:
            scale = scale * self.weight.float()
            shift = shift * self.weight.float() + self.bias.float()
        return (x * scale.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class InstanceNorm2d(nn.InstanceNorm2d):
    """``nn.InstanceNorm2d`` (affine=False, no running stats), with the
    statistics taken in at least float32 whatever the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(at_least_float32(x)).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the last dimension(s), with the statistics and
    the affine transform taken in at least float32 whatever the input's
    dtype, and the result rounded once to the input's dtype, as the JAX
    package's ``LayerNorm`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_float32(x)
        weight = None if self.weight is None else self.weight.to(xf.dtype)
        bias = None if self.bias is None else self.bias.to(xf.dtype)
        return F.layer_norm(xf, self.normalized_shape, weight, bias,
                            self.eps).to(x.dtype)


class LayerNorm2d(LayerNorm):
    """:class:`LayerNorm` over the channels of each pixel of an NCHW
    tensor: the JAX package's ``LayerNorm`` of an NHWC tensor, with the
    same parameters."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class CastConv3d(nn.Conv3d):
    """``nn.Conv3d`` that runs in its input's dtype, as ``CastConv2d``.
    Its seeded init is the JAX package's ``Conv3d``: weight kaiming-normal
    (fan_out, relu), bias uniform in +-1/sqrt(fan_in)."""

    def init_own_params(self, gen: torch.Generator) -> None:
        kd, kh, kw = self.kernel_size
        std = math.sqrt(2.0 / (self.out_channels * kd * kh * kw))
        self.weight.copy_(torch.empty(self.weight.shape).normal_(
            0.0, std, generator=gen))
        if self.bias is not None:
            bound = 1.0 / math.sqrt(self.in_channels // self.groups
                                    * kd * kh * kw)
            self.bias.copy_(torch.empty(self.bias.shape).uniform_(
                -bound, bound, generator=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class CastConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` that runs in its input's dtype.  Its seeded
    init is the JAX package's: weight and bias uniform in
    +-1/sqrt(in_channels * kd * kh * kw)."""

    def init_own_params(self, gen: torch.Generator) -> None:
        kd, kh, kw = self.kernel_size
        bound = 1.0 / math.sqrt(self.in_channels * kd * kh * kw)
        for t in (self.weight, self.bias):
            if t is not None:
                t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                                      generator=gen))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose3d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with :class:`BatchNorm2d`'s eval arithmetic (the
    running statistics folded into a float32 scale and shift, applied in
    the input's dtype) and training statistics (batch statistics, momentum
    0.1, the unbiased variance), as the JAX package's ``_BN3d``."""

    def init_own_params(self, gen: torch.Generator) -> None:
        self.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or not self.track_running_stats:
            return super().forward(x)
        scale = torch.rsqrt(self.running_var.float() + self.eps)
        shift = -self.running_mean.float() * scale
        if self.affine:
            scale = scale * self.weight.float()
            shift = shift * self.weight.float() + self.bias.float()
        view = (-1, 1, 1, 1)
        return x * scale.to(x.dtype).view(view) + shift.to(x.dtype).view(view)
