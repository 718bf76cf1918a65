"""Resampling of NCHW tensors (``ptlflow_tpu/ops/grid_sample.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def interpolate(x: torch.Tensor, size: Tuple[int, int],
                mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """``F.interpolate`` of an NCHW tensor to an explicit (H, W) size, in
    float32 at least; returns the input unchanged when the size already
    matches."""
    oh, ow = size
    if tuple(x.shape[-2:]) == (oh, ow):
        return x
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(mode)
    xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    y = F.interpolate(xf, size=(oh, ow), mode=mode,
                      align_corners=align_corners if mode == "bilinear"
                      else None)
    return y.to(x.dtype)
