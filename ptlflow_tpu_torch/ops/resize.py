"""Input padding and scaling to stride multiples, with exact inverses
(``ptlflow_tpu/ops/resize.py``), on NCHW tensors: (..., C, H, W)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .grid_sample import interpolate


class InputPadder:
    """Pads (..., C, H, W) tensors so H and W are divisible by ``stride``."""

    def __init__(self, dims: Sequence[int], stride: Optional[int] = 8,
                 size: Optional[Tuple[int, int]] = None,
                 two_side_pad: bool = True, pad_mode: str = "replicate",
                 pad_value: float = 0.0):
        ht, wd = int(dims[-2]), int(dims[-1])
        self.ht, self.wd = ht, wd
        self.pad_mode = pad_mode
        self.pad_value = pad_value
        if size is None:
            pad_ht = (((ht // stride) + 1) * stride - ht) % stride
            pad_wd = (((wd // stride) + 1) * stride - wd) % stride
        else:
            pad_ht = size[0] - ht
            pad_wd = size[1] - wd
        if two_side_pad:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2)
        else:
            self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)

    def fill(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x4 = x.reshape((-1,) + tuple(x.shape[-3:]))
        if self.pad_mode in ("replicate", "reflect"):
            y = F.pad(x4, self._pad, mode=self.pad_mode)
        else:
            y = F.pad(x4, self._pad, mode="constant", value=self.pad_value)
        return y.reshape(lead + y.shape[-3:])

    pad = fill

    def unfill(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        ht, wd = x.shape[-2:]
        return x[..., t:ht - b, l:wd - r]

    unpad = unfill


class InputScaler:
    """Bilinearly scales (..., C, H, W) input to a target size and back;
    flows are rescaled in magnitude too."""

    def __init__(self, orig_shape: Sequence[int], stride: Optional[int] = None,
                 size: Optional[Tuple[int, int]] = None,
                 scale_factor: Optional[float] = 1.0,
                 interpolation_mode: str = "bilinear",
                 interpolation_align_corners: bool = False):
        self.orig_height = int(orig_shape[-2])
        self.orig_width = int(orig_shape[-1])
        if stride is not None:
            if size is not None:
                raise ValueError("give either stride or size, not both")
            self.tgt_height = int(math.ceil(self.orig_height / stride)) * stride
            self.tgt_width = int(math.ceil(self.orig_width / stride)) * stride
        elif size is not None:
            self.tgt_height, self.tgt_width = size
        else:
            self.tgt_height = int(self.orig_height * scale_factor)
            self.tgt_width = int(self.orig_width * scale_factor)
        self.mode = interpolation_mode
        self.align_corners = interpolation_align_corners

    def fill(self, x: torch.Tensor, is_flow: bool = False) -> torch.Tensor:
        return self._scale(x, (self.tgt_height, self.tgt_width), is_flow)

    def unfill(self, x: torch.Tensor, is_flow: bool = False) -> torch.Tensor:
        return self._scale(x, (self.orig_height, self.orig_width), is_flow)

    def _scale(self, x: torch.Tensor, size: Tuple[int, int],
               is_flow: bool) -> torch.Tensor:
        lead = x.shape[:-3]
        in_h, in_w = x.shape[-2:]
        y = interpolate(x.reshape((-1,) + tuple(x.shape[-3:])), size,
                        mode=self.mode, align_corners=self.align_corners)
        if is_flow:
            s = torch.tensor([size[1] / in_w, size[0] / in_h], dtype=y.dtype,
                             device=y.device)
            y = y * s[:, None, None]
        return y.reshape(lead + y.shape[-3:])
