"""Cross-gated unit blocks of DPFlow (``ptlflow_tpu/models/dpflow/cgu.py``),
NCHW, on the affine-free norms shared with RPKNet.

A :class:`CGU` with ``use_cross`` runs on two streams (the two frames):
each goes through the gated MLP ``conv_self``, then ``x`` takes the
cross-gated MLP of (x, y) and ``y`` that of (y, the updated x), each
scaled by ``layer_scale`` and added to its shortcut.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d
from ..rpknet.pkconv_slk import GroupNorm


class DWConv(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 3):
        super().__init__()
        self.dwconv = CastConv2d(dim, dim, kernel_size, 1, kernel_size // 2,
                                 bias=True, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dwconv(x)


class ActGLU(nn.Module):
    """fc2(gelu(dw(fc1_g(x))) * dw(fc1_x(x))), exact GELU."""

    def __init__(self, in_features: int, hidden_features: int,
                 mlp_use_dw_conv: bool = True, mlp_dw_kernel_size: int = 3,
                 mlp_in_kernel_size: int = 1, mlp_out_kernel_size: int = 1):
        super().__init__()
        self.fc1_g = CastConv2d(in_features, hidden_features,
                                mlp_in_kernel_size,
                                padding=mlp_in_kernel_size // 2)
        self.fc1_x = CastConv2d(in_features, hidden_features,
                                mlp_in_kernel_size,
                                padding=mlp_in_kernel_size // 2)
        self.dwconv_g = self.dwconv_x = None
        if mlp_use_dw_conv:
            self.dwconv_g = DWConv(hidden_features, mlp_dw_kernel_size)
            self.dwconv_x = DWConv(hidden_features, mlp_dw_kernel_size)
        self.fc2 = CastConv2d(hidden_features, in_features,
                              mlp_out_kernel_size,
                              padding=mlp_out_kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_gate = self.fc1_g(x)
        x = self.fc1_x(x)
        if self.dwconv_g is not None:
            x_gate = self.dwconv_g(x_gate)
            x = self.dwconv_x(x)
        return self.fc2(F.gelu(x_gate) * x)


class CrossActGLU(nn.Module):
    """fc2(gelu(dw(fc1_g(merge_fc_g([x, y])))) * dw(fc1_y(y)))."""

    def __init__(self, in_features: int, hidden_features: int,
                 mlp_use_dw_conv: bool = True, mlp_dw_kernel_size: int = 3,
                 mlp_in_kernel_size: int = 1, mlp_out_kernel_size: int = 1):
        super().__init__()
        self.merge_fc_g = CastConv2d(2 * in_features, in_features, 1)
        self.fc1_g = CastConv2d(in_features, hidden_features,
                                mlp_in_kernel_size,
                                padding=mlp_in_kernel_size // 2)
        self.fc1_y = CastConv2d(in_features, hidden_features,
                                mlp_in_kernel_size,
                                padding=mlp_in_kernel_size // 2)
        self.dwconv_g = self.dwconv_y = None
        if mlp_use_dw_conv:
            self.dwconv_g = DWConv(hidden_features, mlp_dw_kernel_size)
            self.dwconv_y = DWConv(hidden_features, mlp_dw_kernel_size)
        self.fc2 = CastConv2d(hidden_features, in_features,
                              mlp_out_kernel_size,
                              padding=mlp_out_kernel_size // 2)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        xy_gate = self.fc1_g(self.merge_fc_g(torch.cat([x, y], dim=1)))
        y = self.fc1_y(y)
        if self.dwconv_g is not None:
            xy_gate = self.dwconv_g(xy_gate)
            y = self.dwconv_y(y)
        return self.fc2(F.gelu(xy_gate) * y)


class LayerTransition(nn.Module):
    """The strided patch embedding: one convolution."""

    def __init__(self, patch_size: int, stride: int, in_chans: int,
                 embed_dim: int):
        super().__init__()
        self.proj = CastConv2d(in_chans, embed_dim, patch_size, stride=stride,
                               padding=patch_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class CGU(nn.Module):
    """The cross-gated unit (see the module docstring); without
    ``use_cross``, x + layer_scale * conv_self(norm(x)).  ``layer_scale``
    exists where ``layer_scale_init_value`` >= 1e-4."""

    def __init__(self, dim: int, norm: Optional[nn.Module] = None,
                 use_cross: bool = False, mlp_ratio: float = 4,
                 mlp_use_dw_conv: bool = True, mlp_dw_kernel_size: int = 7,
                 mlp_in_kernel_size: int = 1, mlp_out_kernel_size: int = 1,
                 layer_scale_init_value: float = 1e-2):
        super().__init__()
        self.use_cross = use_cross
        self.norm_fn = GroupNorm() if norm is None else norm
        self.layer_scale_init_value = layer_scale_init_value
        kw = dict(mlp_use_dw_conv=mlp_use_dw_conv,
                  mlp_dw_kernel_size=mlp_dw_kernel_size,
                  mlp_in_kernel_size=mlp_in_kernel_size,
                  mlp_out_kernel_size=mlp_out_kernel_size)
        hidden = int(dim * mlp_ratio)
        self.conv_self = ActGLU(dim, hidden, **kw)
        if use_cross:
            self.conv_cross = CrossActGLU(dim, hidden, **kw)
        self.layer_scale = (
            nn.Parameter(torch.full((dim,), layer_scale_init_value))
            if layer_scale_init_value >= 1e-4 else None)

    def init_own_params(self, gen: torch.Generator) -> None:
        if self.layer_scale is not None:
            self.layer_scale.fill_(self.layer_scale_init_value)

    def _scale(self, x: torch.Tensor) -> torch.Tensor:
        if self.layer_scale is None:
            return x
        return x * self.layer_scale[:x.shape[1], None, None]

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if not self.use_cross:
            return x + self._scale(self.conv_self(self.norm_fn(x))), y
        x_short, y_short = x, y
        x = self.conv_self(self.norm_fn(x))
        y = self.conv_self(self.norm_fn(y))
        x = x_short + self._scale(self.conv_cross(x, y))
        # the second cross call reads the updated x, as the reference's
        y = y_short + self._scale(self.conv_cross(y, x))
        return x, y


class CGUStage(nn.Module):
    """``conv_transition`` (where the stride or width changes), ``depth``
    CGU blocks and the norm, on one stream or, with ``use_cross``, two."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 2,
                 norm: Optional[nn.Module] = None, depth: int = 2,
                 use_cross: bool = False, mlp_ratio: float = 4,
                 mlp_use_dw_conv: bool = True, mlp_dw_kernel_size: int = 7,
                 mlp_in_kernel_size: int = 1, mlp_out_kernel_size: int = 1,
                 layer_scale_init_value: float = 1e-2):
        super().__init__()
        norm = GroupNorm() if norm is None else norm
        self.use_cross = use_cross
        self.norm_fn = norm
        self.conv_transition = None
        if stride > 1 or in_chs != out_chs:
            self.conv_transition = LayerTransition(
                3 if stride > 1 else 1, stride, in_chs, out_chs)
        self.blocks = nn.ModuleList([
            CGU(out_chs, norm=norm, use_cross=use_cross, mlp_ratio=mlp_ratio,
                mlp_use_dw_conv=mlp_use_dw_conv,
                mlp_dw_kernel_size=mlp_dw_kernel_size,
                mlp_in_kernel_size=mlp_in_kernel_size,
                mlp_out_kernel_size=mlp_out_kernel_size,
                layer_scale_init_value=layer_scale_init_value)
            for _ in range(depth)])

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None):
        """``norm(x)``, or ``(norm(x), norm(y))`` with ``use_cross``."""
        if self.conv_transition is not None:
            x = self.conv_transition(x)
            if self.use_cross:
                y = self.conv_transition(y)
        for blk in self.blocks:
            x, y = blk(x, y)
        if self.use_cross:
            return self.norm_fn(x), self.norm_fn(y)
        return self.norm_fn(x)
