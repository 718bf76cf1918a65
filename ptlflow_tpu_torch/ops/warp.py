"""Warping ops of ``ptlflow_tpu/ops/warp.py``, NCHW: ``backward_warp`` and
the forward-backward occlusion check ``fb_check`` (the augmentations'
``GenerateFBCheckFlowOcclusion``), the forward projection of a flow
field for RAFT's warm start (``forward_interpolate``) and SplatFlow's
average-mode forward splatting (``softsplat_average``)."""

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


def softsplat_average(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Average-mode soft forward splatting (``ptlflow_tpu/ops/warp.py::
    softsplat_average``, SplatFlow's): each pixel p of ``x`` (B, C, H, W)
    and a ones channel scatter to the four integer corners of
    p + ``flow``(p) (flow (B, 2, H, W)) with bilinear weights; corners
    outside the frame go to a spare row that is dropped.  The sum is
    divided by the splatted weight, 1 where that weight is 0.  Accumulated
    in ``x``'s dtype, the four corners in turn, each source in order: one
    ``index_add_`` over the flattened (B * (H*W + 1), C + 1) buffer, in
    plain PyTorch on either device (on the card its float atomics add in no
    fixed order)."""
    b, c, h, w = x.shape
    hw = h * w
    coords = coords_grid(b, h, w, dtype=flow.dtype, device=flow.device) + flow
    x0, y0 = torch.floor(coords[:, 0]), torch.floor(coords[:, 1])
    fx, fy = coords[:, 0] - x0, coords[:, 1] - y0
    vals = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    vals = vals.reshape(b, c + 1, hw).transpose(1, 2)  # (B, HW, C+1)
    base = (torch.arange(b, device=x.device) * (hw + 1))[:, None]
    index, source = [], []
    for dx, dy, wgt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                        (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        tx, ty = (x0 + dx).long(), (y0 + dy).long()
        valid = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
        index.append(base + torch.where(valid, ty * w + tx, hw).reshape(b, hw))
        source.append((vals * wgt.reshape(b, hw, 1)).to(x.dtype))
    out = x.new_zeros((b * (hw + 1), c + 1)).index_add_(
        0, torch.cat(index, dim=1).reshape(-1),
        torch.cat(source, dim=1).reshape(-1, c + 1))
    out = out.reshape(b, hw + 1, c + 1)[:, :hw]
    den = out[..., -1:]
    out = out[..., :-1] / torch.where(den == 0, torch.ones_like(den), den)
    return out.transpose(1, 2).reshape(b, c, h, w)
