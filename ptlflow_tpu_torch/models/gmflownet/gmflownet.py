"""GMFlowNet (``ptlflow_tpu/models/gmflownet/gmflownet.py``), NCHW: global
matching and overlapping attention on RAFT; its eval forward with the warm
start, its training forward, and the sequence loss with the optional
matching loss.

The feature net is a stride-8 conv encoder and a 6-deep POLA (or mixed
axial-POLA) stack.  The all-pairs correlation volume (float32) is pooled
into RAFT's 4-level pyramid, whose lookup is prepared once per forward
(``make_corr_lookup``: one launch of ``csrc/corr_lookup.cu`` an iteration
on the card, its gradient ``csrc/corr_lookup_backward.cu`` in training).
Without a warm start the coords start at the mutual-argmax matches of the
soft correlation map (the product of its softmaxes over both frames): a
pixel keeps its own position where the best match is not mutual, tested by
exact equality as in the reference.  The update block is RAFT's.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ...ops.correlation import (all_pairs_correlation, coords_grid,
                                make_corr_lookup, pool_volume_pyramid)
from ...ops.grid_sample import bilinear_sampler
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..raft.extractor import BasicEncoder
from ..raft.raft import SequenceLoss as RAFTSequenceLoss
from ..raft.update import BasicUpdateBlock
from .pola import BasicConvEncoder, MixAxialPOLAUpdate, POLAUpdate


def compute_supervision_coarse(flow: torch.Tensor, occlusions: torch.Tensor,
                               scale: int) -> torch.Tensor:
    """The ground-truth match matrix (B, L, L) at 1/``scale``: one-hot at
    the rounded flow target of every pixel that is not occluded and lands
    inside the map.  flow (B, 2, H, W), occlusions (B, 1, H, W)."""
    b, _, h, w = flow.shape
    hc, wc = -(-h // scale), -(-w // scale)
    occ_c = occlusions[:, 0, ::scale, ::scale].reshape(b, hc * wc)
    flow_c = flow[:, :, ::scale, ::scale] / scale
    gy, gx = torch.meshgrid(
        torch.arange(hc, dtype=flow.dtype, device=flow.device),
        torch.arange(wc, dtype=flow.dtype, device=flow.device), indexing="ij")
    warp_x = torch.round(gx[None] + flow_c[:, 0]).long()
    warp_y = torch.round(gy[None] + flow_c[:, 1]).long()
    oob = (warp_x < 0) | (warp_x >= wc) | (warp_y < 0) | (warp_y >= hc)
    occ_c = torch.maximum(occ_c, oob.reshape(b, hc * wc).to(occ_c.dtype))
    j_ids = (warp_x + warp_y * wc).reshape(b, hc * wc).clamp(0, hc * wc - 1)
    one_hot = torch.nn.functional.one_hot(j_ids, hc * wc).to(flow.dtype)
    return one_hot * (occ_c == 0).to(flow.dtype)[..., None]


def compute_coarse_loss(conf: torch.Tensor,
                        conf_gt: torch.Tensor) -> torch.Tensor:
    """Balanced cross entropy of the match matrix: the confidences clipped
    to [1e-6, 1 - 1e-6], the positives' and the negatives' mean negative
    log-likelihood summed."""
    conf = conf.clamp(1e-6, 1 - 1e-6)
    pos = (conf_gt == 1).to(conf.dtype)
    neg = (conf_gt == 0).to(conf.dtype)
    loss_pos = -(torch.log(conf) * pos).sum() / torch.clamp(pos.sum(), min=1)
    loss_neg = -(torch.log(1 - conf) * neg).sum() / torch.clamp(neg.sum(),
                                                                min=1)
    return loss_pos + loss_neg


class SequenceLoss(RAFTSequenceLoss):
    """RAFT's sequence loss, plus 0.01 times the matching loss of
    ``soft_corr_map`` where ``use_matching_loss``: its ground truth marks
    the pixels whose backward-warped second frame (sampled half a pixel
    off, the reference's align_corners=False normalisation) differs from
    the first by more than 20 in mean as occluded."""

    def __init__(self, gamma: float, max_flow: float,
                 use_matching_loss: bool):
        super().__init__(gamma, max_flow)
        self.use_matching_loss = use_matching_loss

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        loss = super().__call__(outputs, inputs)
        if not self.use_matching_loss:
            return loss
        image1, image2 = inputs["images"][:, 0], inputs["images"][:, 1]
        flow_gt = inputs["flows"][:, 0]
        b, _, h, w = image2.shape
        coords = coords_grid(b, h, w, dtype=flow_gt.dtype,
                             device=flow_gt.device) + flow_gt - 0.5
        back = bilinear_sampler(image2, coords)
        occ = ((image1 - back).mean(dim=1, keepdim=True).abs()
               > 20).to(flow_gt.dtype)
        conf_gt = compute_supervision_coarse(flow_gt, occ, 8)
        return loss + 0.01 * compute_coarse_loss(outputs["soft_corr_map"],
                                                 conf_gt)


def soft_correlation(corr_map: torch.Tensor) -> torch.Tensor:
    """(B, HW, H, W) volume -> (B, HW, HW) product of its softmaxes over
    the second frame's pixels and over the first's, float32."""
    b, hw = corr_map.shape[:2]
    corr = corr_map.reshape(b, hw, hw).float()
    return torch.softmax(corr, dim=2) * torch.softmax(corr, dim=1)


def mutual_match_coords(soft: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 2, H, W) coords of each pixel's best match where the match is
    mutual (its score equals the best score of the matched pixel exactly),
    else of the pixel itself."""
    b, hw, _ = soft.shape
    match12, idx12 = soft.max(dim=2)
    match21 = soft.max(dim=1).values
    matched = (match12 - torch.gather(match21, 1, idx12)) == 0
    base = torch.arange(hw, device=soft.device).expand(b, hw)
    index = torch.where(matched, idx12, base)
    coords = torch.stack([index % w, index // w], dim=1).to(torch.float32)
    return coords.reshape(b, 2, h, w)


class GMFlowNet(BaseModel):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflownet-things-9f061ac7.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflownet-kitti-712b4660.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32,
                 use_matching_loss: bool = False, use_mix_attn: bool = False,
                 **kwargs):
        super().__init__(
            output_stride=8,
            loss_fn=SequenceLoss(gamma, max_flow, use_matching_loss),
            **kwargs)
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.iters = iters
        self.hidden_dim = hdim = 128
        self.context_dim = cdim = 128
        encoder = BasicConvEncoder(output_dim=256, norm_fn="instance")
        if use_mix_attn:
            attn = MixAxialPOLAUpdate(embed_dim=256, depth=6, num_head=8,
                                      window_size=7)
        else:
            attn = POLAUpdate(embed_dim=256, depth=6, num_head=8,
                              window_size=7, neig_win_num=1)
        self.fnet = nn.Sequential(encoder, attn)
        self.cnet = BasicEncoder(output_dim=hdim + cdim, norm_fn="batch",
                                 dropout=dropout)
        self.update_block = BasicUpdateBlock(corr_levels, corr_radius,
                                             hidden_dim=hdim)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8,
        W/8); ``inputs["prev_preds"]["flow_small"]``, where given,
        warm-starts the coords by its forward projection in place of the
        matching.  Training: ``flow_preds`` (iters, B, 2, H, W),
        ``soft_corr_map`` (B, HW, HW) and ``flows``.  The coords are
        detached at the start of every iteration."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]
        fmap1, fmap2 = self.fnet(image1), self.fnet(image2)
        b, _, h, w = fmap1.shape
        corr_map = all_pairs_correlation(fmap1, fmap2)
        lookup = make_corr_lookup(
            pool_volume_pyramid(corr_map.reshape(b * h * w, h, w),
                                self.corr_levels), self.corr_radius)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        prev = inputs.get("prev_preds")
        warm = prev is not None and prev.get("flow_small") is not None
        soft = soft_correlation(corr_map) if training or not warm else None
        if warm:
            coords1 = coords0 + forward_interpolate(prev["flow_small"])
        else:
            coords1 = mutual_match_coords(soft, h, w)

        mask = torch.zeros((b, 64 * 9, h, w), dtype=fmap1.dtype,
                           device=fmap1.device)
        flows_lr, masks = [], []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            net, mask, delta = self.update_block(
                net, inp, lookup(coords1), (coords1 - coords0).to(net.dtype))
            coords1 = coords1 + delta
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)

        if training:
            flow_ups = convex_upsample(torch.cat(flows_lr), torch.cat(masks))
            flow_ups = self.postprocess_predictions(
                flow_ups.unflatten(0, (len(flows_lr), b)), resizer,
                is_flow=True)
            return {"flows": flow_ups[-1][:, None], "flow_preds": flow_ups,
                    "soft_corr_map": soft}
        flow_small = coords1 - coords0
        flow_up = self.postprocess_predictions(
            convex_upsample(flow_small, mask), resizer, is_flow=True)
        return {"flows": flow_up[:, None], "flow_small": flow_small}


class GMFlowNetMix(GMFlowNet):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflownet_mix-things-8396f0a1.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflownet_mix-sintel-33492618.ckpt",
    }

    def __init__(self, use_mix_attn: bool = True, **kwargs):
        super().__init__(use_mix_attn=use_mix_attn, **kwargs)


@register_model
@trainable
class gmflownet(GMFlowNet):
    pass


@register_model
@trainable
class gmflownet_mix(GMFlowNetMix):
    pass
