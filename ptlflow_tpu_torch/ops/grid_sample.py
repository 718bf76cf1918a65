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


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor,
                     mask: bool = False):
    """Sample ``img`` (N, C, H, W) bilinearly at pixel coordinates
    ``coords`` (N, 2, Ho, Wo; x then y), align_corners=True, zero padding
    (``ptlflow_tpu/ops/grid_sample.py::bilinear_sampler``).  The coords are
    normalised to [-1, 1] as the JAX package normalises them; with
    ``mask``, also returns (N, 1, Ho, Wo), 1 where the normalised
    coordinates lie strictly inside (-1, 1) on both axes, else 0."""
    h, w = img.shape[-2:]
    xgrid = 2.0 * coords[:, 0] / (w - 1) - 1.0
    ygrid = 2.0 * coords[:, 1] / (h - 1) - 1.0
    grid = torch.stack([xgrid, ygrid], dim=-1)
    out = F.grid_sample(img, grid.to(img.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    if mask:
        m = (xgrid > -1) & (ygrid > -1) & (xgrid < 1) & (ygrid < 1)
        return out, m[:, None].to(coords.dtype)
    return out
