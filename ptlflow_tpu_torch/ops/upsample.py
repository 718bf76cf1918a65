"""Flow upsampling of the RAFT family (``ptlflow_tpu/ops/upsample.py``),
NCHW."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..nn import at_least_float32
from .grid_sample import interpolate


def _convex_weights(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, 9*f*f, h, w) logits -> (B, 1, 9, f, f, h, w) weights in at
    least float32, softmaxed over the 9 neighbours."""
    b, _, h, w = mask.shape
    f = factor
    return torch.softmax(at_least_float32(mask).view(b, 1, 9, f, f, h, w),
                         dim=2)


def _convex_combine(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, f*h, f*w): each output pixel the
    ``m``-weighted sum of its coarse pixel's 3x3 zero-padded neighbours."""
    b, c, h, w = x.shape
    f = m.shape[3]
    neigh = F.unfold(x, [3, 3], padding=1).view(b, c, 9, 1, 1, h, w)
    up = torch.sum(m * neigh, dim=2)  # (B, C, f, f, h, w)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, c, f * h, f * w)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """Upsample flow (B, 2, h, w) to (B, 2, f*h, f*w) by a learned convex
    combination of each pixel's 3x3 neighbours.

    mask: (B, 9*f*f, h, w) logits; channel k*f*f + i*f + j weighs 3x3
    neighbour k (row-major dy, dx) for subpixel (i, j).  Computed in
    at least float32; returns the flow's dtype.
    """
    m = _convex_weights(mask, factor)
    return _convex_combine(factor * at_least_float32(flow), m).to(flow.dtype)


def convex_upsample_data(flow: torch.Tensor, info: torch.Tensor,
                         mask: torch.Tensor, factor: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SEA-RAFT's upsampling: the flow (B, 2, h, w), scaled by ``factor``,
    and an info map (B, C, h, w), unscaled, each convex-upsampled with the
    one softmaxed ``mask`` of :func:`convex_upsample`.  Computed in at
    least float32; returns each input's dtype."""
    m = _convex_weights(mask, factor)
    return (_convex_combine(factor * at_least_float32(flow), m).to(
        flow.dtype), _convex_combine(at_least_float32(info), m).to(
            info.dtype))


def upflow(flow: torch.Tensor, factor: int = 8,
           mode: str = "bilinear") -> torch.Tensor:
    """Bilinear (align_corners=True) upsampling with the flow scaled by
    ``factor``."""
    h, w = flow.shape[-2:]
    return factor * interpolate(flow, (factor * h, factor * w), mode=mode,
                                align_corners=True)
