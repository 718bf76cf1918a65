"""Warping ops of ``ptlflow_tpu/ops/warp.py``, NCHW: ``backward_warp`` and
the forward-backward occlusion check ``fb_check`` (the augmentations'
``GenerateFBCheckFlowOcclusion``), and the forward projection of a flow
field for RAFT's warm start (``forward_interpolate``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .correlation import coords_grid
from .grid_sample import bilinear_sampler


def backward_warp(img: torch.Tensor, flow: torch.Tensor,
                  return_mask: bool = False):
    """Sample ``img`` (B, C, H, W) at (grid + ``flow``), flow (B, 2, H, W);
    with ``return_mask`` also the (B, 1, H, W) in-frame mask of
    ``bilinear_sampler``."""
    b, _, h, w = flow.shape
    coords = coords_grid(b, h, w, dtype=flow.dtype, device=flow.device) + flow
    return bilinear_sampler(img, coords, mask=return_mask)


def fb_check(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
             alpha_1: float = 0.01, alpha_2: float = 0.5) -> torch.Tensor:
    """Forward-backward consistency check: (B, 1, H, W), 1 where
    |fw + bw(warped)|^2 exceeds alpha_1 * (|fw|^2 + |bw_warped|^2) +
    alpha_2 (an occlusion), else 0."""
    bw_warped = backward_warp(flow_bw, flow_fw)
    diff = flow_fw + bw_warped
    mag_sq = (flow_fw ** 2).sum(1, keepdim=True) + \
        (bw_warped ** 2).sum(1, keepdim=True)
    occ = (diff ** 2).sum(1, keepdim=True) > alpha_1 * mag_sq + alpha_2
    return occ.to(flow_fw.dtype)


def _box3_sum(x: torch.Tensor) -> torch.Tensor:
    """3x3 box-filter sum over the H, W axes of a (B, C, H, W) tensor, zero
    padded as ``SAME``; the nine terms are added in row-major window
    order."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1))
    acc = p[..., 0:h, 0:w]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                acc = acc + p[..., dy:dy + h, dx:dx + w]
    return acc


def forward_interpolate(flow: torch.Tensor,
                        fill_iters: int = 12) -> torch.Tensor:
    """Forward-project a flow field: out[round(p + flow(p))] = flow(p).

    flow: (B, 2, H, W).  Targets are rounded half to even, and those not
    strictly inside the frame (x in (0, W-1), y in (0, H-1)) are dropped.
    Target cells that no source hits are then filled by ``fill_iters``
    rounds of 3x3 dilation (zero padded): each unhit cell next to a hit one
    takes the mean of its hit neighbours and counts as hit from then on.
    Cells still unhit stay 0.  Where several sources round to one cell,
    which of them wins is unspecified, as in the JAX package.
    """
    b, _, h, w = flow.shape
    tgt = coords_grid(b, h, w, dtype=flow.dtype, device=flow.device) + flow
    tx = torch.round(tgt[:, 0]).long()
    ty = torch.round(tgt[:, 1]).long()
    valid = ((tgt[:, 0] > 0) & (tgt[:, 0] < w - 1)
             & (tgt[:, 1] > 0) & (tgt[:, 1] < h - 1))
    # dropped sources go to a dump cell past the end of the map
    flat = torch.where(valid, ty * w + tx, h * w).reshape(b, 1, h * w)
    vals1 = torch.cat([flow, torch.ones_like(flow[:, :1])], dim=1)
    out = flow.new_zeros((b, 3, h * w + 1)).scatter_(
        2, flat.expand(b, 3, h * w), vals1.reshape(b, 3, h * w))
    out = out[:, :, :h * w].reshape(b, 3, h, w)
    vals, hit = out[:, :2], out[:, 2:]
    for _ in range(fill_iters):
        num = _box3_sum(vals * hit)
        den = _box3_sum(hit)
        neighbor = num / torch.clamp(den, min=1.0)
        grown = (den > 0).to(hit.dtype)
        vals = torch.where(hit > 0, vals, neighbor)
        hit = torch.maximum(hit, grown)
    return vals * (hit > 0)
