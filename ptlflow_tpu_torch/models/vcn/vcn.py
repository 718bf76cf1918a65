"""VCN, volumetric correspondence networks (``ptlflow_tpu/models/vcn/
vcn.py``), NCHW.  Coarse to fine over a PSPNet pyramid (``vcn``: 1/64 to
1/4, ``vcn_small``: 1/64 to 1/8): at each level the second frame's
normalised features are warped by the upsampled flow, the two frames'
features make a per-channel (B, C, U, V, H, W) cost volume of U x V shifts
(``corrf``), a butterfly U-Net of separable 4-D convolutions and one more
separable convolution filter it, each channel's volume gives a flow
hypothesis by the truncated soft winner-take-all (``flow_reg``), and a
dilated convolution stack weighs the hypotheses of this level and the
coarser ones into the level's flow.

The volume comes from one zero pad of the second frame's features and
U x V slices of it (no strided views), and the winner-take-all's 7 x 7
window from the argmax's (u, v) index (the JAX package dilates a one-hot
by a max window).  No lookup kernel runs here.

The two frames go through the pyramid as one batch, the first frames
then the second, and each sample's first frame is matched with its own
second frame.  (The JAX package stacks the frames sample by sample and
splits the batch in halves, which pairs the frames of different samples
where the batch holds more than one.)
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, at_least_float32
from ...ops.correlation import coords_grid
from ...ops.grid_sample import bilinear_sampler, interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from .conv4d import butterfly4D, sepConv4d
from .submodule import conv, pspnet, pspnet_s


def warp_with_mask(x: torch.Tensor, flow: torch.Tensor):
    """``x`` (B, C, H, W) sampled bilinearly at the grid plus ``flow``, and
    the (B, 1, H, W) mask of the samples strictly inside the map (0 < x <
    W - 1, 0 < y < H - 1), which multiplies them."""
    b, _, h, w = x.shape
    coords = coords_grid(b, h, w, dtype=flow.dtype, device=flow.device) + flow
    out = bilinear_sampler(x, coords)
    cx, cy = coords[:, 0], coords[:, 1]
    mask = ((cx > 0) & (cx < w - 1) & (cy > 0) & (cy < h - 1))
    mask = mask[:, None].to(x.dtype)
    return out * mask, mask


def corrf(ref: torch.Tensor, target: torch.Tensor, maxdisp: int,
          fac: int = 1) -> torch.Tensor:
    """The per-channel shifted products of (B, C, H, W) maps: (B, C, U, V,
    H, W), U = 2 maxdisp + 1 x-shifts and V = 2 (maxdisp // fac) + 1
    y-shifts, cost[u, v](y, x) = ref(y, x) target(y + v - V // 2,
    x + u - U // 2), 0 outside the map, then a leaky ReLU (0.1)."""
    b, c, h, w = ref.shape
    mdx, mdy = maxdisp, int(maxdisp // fac)
    tpad = F.pad(target, (mdx, mdx, mdy, mdy))
    shifted = torch.stack([tpad[:, :, j:j + h, i:i + w]
                           for i in range(2 * mdx + 1)
                           for j in range(2 * mdy + 1)], 2)
    cost = ref[:, :, None] * shifted
    return F.leaky_relu(cost, 0.1).view(b, c, 2 * mdx + 1, 2 * mdy + 1, h, w)


class flow_reg(nn.Module):
    """Truncated soft winner-take-all over (N, U, V, H, W) scores: the
    softmax (in at least float32) over the 7 x 7 (u, v) window around the
    argmax (the first index of a tie), whose expected displacement is the
    flow (N, 2, H, W); and the entropies of that softmax and of the one
    over all U V displacements, each over its log size (N, 2, H, W)."""

    def __init__(self, maxdisp: int = 4, fac: int = 1):
        super().__init__()
        self.md = maxdisp
        self.fac = fac
        self.wsize = 3
        self.flow_max = float(maxdisp)

    def forward(self, x: torch.Tensor):
        n, u, v, h, w = x.shape
        idx = torch.argmax(x.reshape(n, u * v, h, w), dim=1)
        iu = torch.div(idx, v, rounding_mode="floor")[:, None, None]
        iv = (idx % v)[:, None, None]
        au = torch.arange(u, device=x.device).view(1, u, 1, 1, 1)
        av = torch.arange(v, device=x.device).view(1, 1, v, 1, 1)
        inside = (((au - iu).abs() <= self.wsize)
                  & ((av - iv).abs() <= self.wsize))
        masked = torch.where(inside, x, torch.full_like(x, -math.inf))
        probs = torch.softmax(at_least_float32(masked).reshape(
            n, u * v, h, w), dim=1).view(n, u, v, h, w)
        mdy = int(self.md // self.fac)
        dispx = torch.arange(-self.md, self.md + 1, dtype=probs.dtype,
                             device=x.device).view(1, u, 1, 1, 1)
        dispy = torch.arange(-mdy, mdy + 1, dtype=probs.dtype,
                             device=x.device).view(1, 1, v, 1, 1)
        flow = torch.stack([(probs * dispx).sum((1, 2)),
                            (probs * dispy).sum((1, 2))], 1).to(x.dtype)
        local = (-probs * torch.log(probs.clamp(1e-9, 1 - 1e-9))).sum((1, 2))
        local = local / math.log((2 * self.wsize + 1) ** 2)
        gprobs = torch.softmax(at_least_float32(x).reshape(n, u * v, h, w),
                               dim=1)
        glob = (-gprobs * torch.log(gprobs.clamp(1e-9, 1 - 1e-9))).sum(1)
        glob = glob / math.log(u * v)
        return flow, torch.stack([local, glob], 1).to(x.dtype)


def _dc_head(in_ch: int, out_ch: int):
    """The hypotheses' fusion stack: six convolution units at dilations
    1, 2, 4, 8, 16, 1, then a plain 3x3 convolution to ``out_ch``."""
    return [conv(in_ch, 128, 3, 1, 1, 1),
            conv(128, 128, 3, 1, 2, 2),
            conv(128, 128, 3, 1, 4, 4),
            conv(128, 96, 3, 1, 8, 8),
            conv(96, 64, 3, 1, 16, 16),
            conv(64, 32, 3, 1, 1, 1),
            CastConv2d(32, out_ch, 3, stride=1, padding=1, bias=True)]


class VCNLoss:
    """The levels' flows, upsampled and scaled to pixels (x64, x32, ...),
    each one's mean L2 distance from the ground truth over the valid
    pixels whose flow is within ``maxdisp``, weighted (0.25, 0.25, 0.25,
    0.5, 1); plus, per level, a class-balanced logistic loss of the
    out-of-range logits against the pixels whose residual flow leaves
    that level's search range or whose warped second image differs from
    the first by more than 0.3.  The L2 norm is the JAX package's (the
    reference's ``torch.norm(x, 0, 1)`` counts nonzero components)."""

    def __init__(self, maxdisp: float, fac: float):
        self.maxdisp = maxdisp
        self.fac = fac

    def __call__(self, outputs: Dict[str, Any],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        flow_gt = inputs["flows"][:, 0]
        valid = inputs["valids"][:, 0, 0]
        mask = ((valid == 1) & (flow_gt[:, 0].abs() < self.maxdisp)
                & (flow_gt[:, 1].abs() < (self.maxdisp // self.fac)))
        mask = mask.to(flow_gt.dtype)
        denom = mask.sum().clamp(min=1.0)
        im1, im2 = inputs["images"][:, 0], inputs["images"][:, 1]
        im_warp, _ = warp_with_mask(im2, flow_gt)
        occ_mask = torch.linalg.vector_norm(im_warp - im1, dim=1) > 0.3

        loss = 0.0
        m = 64.0
        ws = [0.25, 0.25, 0.25, 0.5, 1.0]
        for wgt, pred in zip(ws, outputs["flow_preds"]):
            err = torch.linalg.vector_norm(pred * m - flow_gt, dim=1)
            loss = loss + wgt * (err * mask).sum() / denom
            m /= 2

        h, w = flow_gt.shape[-2:]
        up_flows = [0.0]
        m = 32.0
        for uf in outputs["up_flows_preds"]:
            up_flows.append(interpolate(uf, (h, w), mode="bilinear",
                                        align_corners=False) * m)
            m /= 2
        m = 64.0
        for i, oor in enumerate(outputs["oors_preds"]):
            oor = interpolate(oor[:, None], (h, w), mode="bilinear",
                              align_corners=False)[:, 0]
            loss = loss + self._oor_loss(
                flow_gt - up_flows[i], oor,
                m * outputs["flow_reg_maxs_preds"][i], occ_mask)
            m /= 2
        return loss

    @staticmethod
    def _oor_loss(flow_res, oor, maxdisp, occ_mask):
        oor_gt = (flow_res.abs() > maxdisp).sum(1) > 0
        oor_gt = (oor_gt | occ_mask).to(flow_res.dtype)
        frac = oor_gt.mean()
        weights = oor_gt * (1 - frac) + (1 - oor_gt) * frac
        ce = (oor.clamp(min=0) - oor * oor_gt
              + torch.log1p(torch.exp(-oor.abs())))
        return (weights * ce).mean()


class VCNSmall(BaseModel):
    """4-level VCN (1/64 to 1/8)."""

    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/vcn_small-chairs-56243688.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/vcn_small-things-2f19af2d.ckpt",
    }

    _n_levels = 4

    def __init__(self, fac: float = 1.0, maxdisp: int = 256,
                 md: Sequence[int] = (4, 4, 4, 4, 4),
                 train_batch_size: Optional[int] = None, **kwargs):
        super().__init__(loss_fn=VCNLoss(maxdisp, fac), output_stride=64,
                         **kwargs)
        self.md = list(md)
        self.fac = int(fac)
        fdima1, fdima2, fdimb1 = 128, 64, 16
        self.pspnet = pspnet_s() if self._n_levels == 4 else pspnet()
        self.f6 = butterfly4D(fdima1, fdimb1)
        self.p6 = sepConv4d(fdimb1, with_bn=False)
        self.f5 = butterfly4D(fdima1, fdimb1)
        self.p5 = sepConv4d(fdimb1, with_bn=False)
        self.f4 = butterfly4D(fdima1, fdimb1)
        self.p4 = sepConv4d(fdimb1, with_bn=False)
        self.f3 = butterfly4D(fdima2, fdimb1)
        self.p3 = sepConv4d(fdimb1, with_bn=False)
        self.flow_reg64 = flow_reg(maxdisp=self.md[0], fac=self.fac)
        self.flow_reg32 = flow_reg(maxdisp=self.md[1])
        self.flow_reg16 = flow_reg(maxdisp=self.md[2])
        self.flow_reg8 = flow_reg(maxdisp=self.md[3])
        for lvl, k in (("6", 1), ("5", 2), ("4", 3)):
            self._dc_heads(lvl, 128 + 4 * fdimb1 * k, 2 * fdimb1 * k)
        self._dc_heads("3", 64 + 16 * fdimb1, 8 * fdimb1)

    def _dc_heads(self, lvl: str, in_ch: int, out_ch: int) -> None:
        """``dc{lvl}_conv1``..``7`` (the hypotheses' weights) and
        ``dc{lvl}_convo`` (the out-of-range logit, trained only)."""
        for k, mod in enumerate(_dc_head(in_ch, out_ch)):
            setattr(self, f"dc{lvl}_conv{k + 1}", mod)
        setattr(self, f"dc{lvl}_convo", nn.Sequential(*_dc_head(in_ch, 1)))

    def filter_volume(self, lvl: str, feat: torch.Tensor) -> torch.Tensor:
        """Level ``lvl``'s butterfly U-Net, then its separable
        convolution."""
        return getattr(self, f"p{lvl}")(getattr(self, f"f{lvl}")(feat))

    def _level(self, lvl, reg, c1, c1n, c2n, up_flow, prev_flowh, prev_enth,
               maxdisp, fac, training):
        """One level: (flow, hypotheses, their entropies, out-of-range
        logit or None)."""
        warped = c2n if up_flow is None else warp_with_mask(c2n, up_flow)[0]
        cost = self.filter_volume(lvl, corrf(c1n, warped, maxdisp, fac=fac))
        b, c, u, v, h, w = cost.shape
        flowh, enth = reg(cost.reshape(b * c, u, v, h, w))
        flowh = flowh.view(b, c, 2, h, w)
        if up_flow is not None:
            flowh = flowh + up_flow[:, None]
        flowh = flowh.reshape(b, c * 2, h, w)
        enth = enth.reshape(b, c * 2, h, w)
        if prev_flowh is not None:
            flowh = torch.cat([flowh, interpolate(
                prev_flowh.detach() * 2, (h, w), mode="bilinear",
                align_corners=False)], 1)
            enth = torch.cat([enth, interpolate(
                prev_enth, (h, w), mode="bilinear", align_corners=False)], 1)
        x = torch.cat([enth.detach(), flowh.detach(), c1], 1)
        oor = getattr(self, f"dc{lvl}_convo")(x)[:, 0] if training else None
        y = x
        for k in range(1, 8):
            y = getattr(self, f"dc{lvl}_conv{k}")(y)
        nhyp = y.shape[1] // 2
        weights = torch.softmax(at_least_float32(y).view(b, nhyp, 2, h, w),
                                dim=1).to(y.dtype)
        flow = (flowh.view(b, nhyp, 2, h, w) * weights).sum(1)
        return flow, flowh, enth, oor

    def _forward_levels(self, inputs, training, levels):
        mean_bgr = [0.33, 0.33, 0.33]
        if self.extra_params is not None and "mean_bgr_L" in self.extra_params:
            mean_bgr = list(self.extra_params["mean_bgr_L"])
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=[-x for x in mean_bgr], bgr_mult=1.0,
            bgr_to_rgb=True, resize_mode="interpolation",
            interpolation_mode="bilinear", interpolation_align_corners=True)
        bs = images.shape[0]
        feats = self.pspnet(torch.cat([images[:, 0], images[:, 1]], 0))
        h_full, w_full = images.shape[-2:]
        regs = {"6": self.flow_reg64, "5": self.flow_reg32,
                "4": self.flow_reg16, "3": self.flow_reg8,
                "2": getattr(self, "flow_reg4", None)}
        up_flows, oors, flow_reg_maxs, flows_lr = [], [], [], []
        up_flow = prev_flowh = prev_enth = None
        for li, lvl in enumerate(levels):
            c1, c2 = feats[li][:bs], feats[li][bs:]
            c1n = c1 / (torch.linalg.vector_norm(c1, dim=1, keepdim=True)
                        + 1e-9)
            c2n = c2 / (torch.linalg.vector_norm(c2, dim=1, keepdim=True)
                        + 1e-9)
            if up_flow is not None:
                stride = {"5": 32, "4": 16, "3": 8, "2": 4}[lvl]
                up_flow = interpolate(
                    up_flow, (h_full // stride, w_full // stride),
                    mode="bilinear", align_corners=False) * 2
                up_flows.append(up_flow)
            flow, prev_flowh, prev_enth, oor = self._level(
                lvl, regs[lvl], c1, c1n, c2n, up_flow, prev_flowh,
                prev_enth, self.md[li], self.fac if lvl == "6" else 1,
                training)
            flow_reg_maxs.append(regs[lvl].flow_max)
            if oor is not None:
                oors.append(oor)
            flows_lr.append(flow)
            up_flow = flow

        def full(flow):
            f = interpolate(flow, (h_full, w_full), mode="bilinear",
                            align_corners=False)
            return self.postprocess_predictions(f, resizer, is_flow=True)

        # every level's flow at full size in training, the finest's in
        # eval; VCNSmall's finest (1/8) counts twice as a synthetic 1/4
        # entry, and the output is the last entry in pixels (x4)
        flows_full = [full(f) for f in (flows_lr if training
                                        else flows_lr[-1:])]
        if len(levels) == 4:
            flows_full.append(flows_full[-1] * 2)
        outputs = {"flows": (flows_full[-1] * 4)[:, None]}
        if training:
            outputs["flow_preds"] = flows_full
            outputs["up_flows_preds"] = up_flows
            outputs["oors_preds"] = oors
            outputs["flow_reg_maxs_preds"] = flow_reg_maxs
        return outputs

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds`` (each
        level's flow at full size, in units of that level's pixels),
        ``up_flows_preds``, ``oors_preds`` and ``flow_reg_maxs_preds``, what
        ``VCNLoss`` reads."""
        return self._forward_levels(inputs, training, ("6", "5", "4", "3"))


class VCN(VCNSmall):
    """5-level VCN (1/64 to 1/4)."""

    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/vcn-chairs-db33dc85.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/vcn-things-25524737.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/vcn-sintel-eeeee701.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/vcn-kitti-5d050b7a.ckpt",
    }

    _n_levels = 5

    def __init__(self, fac: float = 1.0, maxdisp: int = 256,
                 md: Sequence[int] = (4, 4, 4, 4, 4),
                 train_batch_size: Optional[int] = None, **kwargs):
        super().__init__(fac=fac, maxdisp=maxdisp, md=md,
                         train_batch_size=train_batch_size, **kwargs)
        fdima2, fdimb1, fdimb2 = 64, 16, 12
        self.f2 = butterfly4D(fdima2, fdimb2)
        self.p2 = sepConv4d(fdimb2, with_bn=False)
        self.flow_reg4 = flow_reg(maxdisp=self.md[4])
        self._dc_heads("2", 64 + 16 * fdimb1 + 4 * fdimb2,
                       2 * fdimb2 + 8 * fdimb1)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        return self._forward_levels(inputs, training,
                                    ("6", "5", "4", "3", "2"))


@register_model
@trainable
class vcn(VCN):
    pass


@register_model
@trainable
class vcn_small(VCNSmall):
    pass
