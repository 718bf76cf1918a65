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
    normalised to [-1, 1] in float32 at least, as the JAX package normalises
    them, and a reduced-precision image is sampled in float32: only the
    output is cast back to the image's dtype, as the JAX package's
    ``grid_sample`` does (a bfloat16 grid would put the samples of a map
    1024 px wide up to 4 px off).  With ``mask``, also returns
    (N, 1, Ho, Wo) in the coords' dtype, 1 where the normalised coordinates
    lie strictly inside (-1, 1) on both axes, else 0."""
    h, w = img.shape[-2:]
    cdtype = torch.promote_types(coords.dtype, torch.float32)
    c = coords.to(cdtype)
    xgrid = 2.0 * c[:, 0] / (w - 1) - 1.0
    ygrid = 2.0 * c[:, 1] / (h - 1) - 1.0
    grid = torch.stack([xgrid, ygrid], dim=-1)
    compute = torch.promote_types(img.dtype, cdtype)
    out = F.grid_sample(img.to(compute), grid.to(compute), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    out = out.to(img.dtype)
    if mask:
        m = (xgrid > -1) & (ygrid > -1) & (xgrid < 1) & (ygrid < 1)
        return out, m[:, None].to(coords.dtype)
    return out
