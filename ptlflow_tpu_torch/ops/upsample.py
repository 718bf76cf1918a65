"""Flow upsampling of the RAFT family (``ptlflow_tpu/ops/upsample.py``),
NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .grid_sample import interpolate


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor,
                    factor: int = 8) -> torch.Tensor:
    """Upsample flow (B, 2, h, w) to (B, 2, f*h, f*w) by a learned convex
    combination of each pixel's 3x3 neighbours.

    mask: (B, 9*f*f, h, w) logits; channel k*f*f + i*f + j weighs 3x3
    neighbour k (row-major dy, dx) for subpixel (i, j).  Computed in
    float32; returns the flow's dtype.
    """
    b, c, h, w = flow.shape
    f = factor
    m = torch.softmax(mask.float().view(b, 1, 9, f, f, h, w), dim=2)
    neigh = F.unfold(f * flow.float(), [3, 3], padding=1)
    neigh = neigh.view(b, c, 9, 1, 1, h, w)
    up = torch.sum(m * neigh, dim=2)  # (B, C, f, f, h, w)
    up = up.permute(0, 1, 4, 2, 5, 3).reshape(b, c, f * h, f * w)
    return up.to(flow.dtype)


def upflow(flow: torch.Tensor, factor: int = 8,
           mode: str = "bilinear") -> torch.Tensor:
    """Bilinear (align_corners=True) upsampling with the flow scaled by
    ``factor``."""
    h, w = flow.shape[-2:]
    return factor * interpolate(flow, (factor * h, factor * w), mode=mode,
                                align_corners=True)
