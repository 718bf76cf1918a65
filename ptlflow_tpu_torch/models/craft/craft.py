"""CRAFT (``ptlflow_tpu/models/craft/craft.py``), NCHW: RAFT whose cost
volume comes from cross attention.

The matching features of the second frame pass a self-attention transformer
(``f2_trans``); the volume is the inter-frame transformer's attention
scores, aggregated over its modes, normalised by their mean and population
variance over the whole (HW x HW) volume and average-pooled into RAFT's
4-level pyramid (``TransCorrBlock``).  The pyramid is built once a forward
and its lookup prepared once (``make_corr_lookup``): each GRU iteration is
one launch of ``csrc/corr_lookup.cu``, and in training one of its backward,
whose gradient flows into the attention.  The update block aggregates the
motion features by the context's intra-frame attention, taken once a
forward, through SETrans' ``ExpandedFeatTrans``.  Encoders, motion encoder,
SepConvGRU, flow head, convex upsampling, the warm start from
``prev_preds["flow_small"]`` and ``SequenceLoss`` are the port's RAFT.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import coords_grid, make_corr_lookup
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..raft.extractor import BasicEncoder
from ..raft.raft import SequenceLoss
from ..raft.update import BasicMotionEncoder, FlowHead, SepConvGRU
from .setrans import (CrossAttFeatTrans, ExpandedFeatTrans, SETransConfig,
                      SETransInputFeatEncoder, SelfAttVisPosTrans)


def pool_levels(corr: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """(Q, H, W) level 0 and its ``num_levels`` - 1 successive 2x2 average
    poolings; a side under 2 pools to 0, as the JAX package's pooling
    floors it."""
    pyramid = [corr]
    for _ in range(num_levels - 1):
        q, h, w = corr.shape
        if min(h, w) >= 2:
            corr = F.avg_pool2d(corr[:, None], 2, 2)[:, 0]
        else:  # F.avg_pool2d refuses an output side of 0
            corr = corr.new_zeros((q, h // 2, w // 2))
        pyramid.append(corr)
    return pyramid


class TransCorrBlock(nn.Module):
    """The correlation pyramid of the inter-frame cross attention's
    aggregated scores."""

    def __init__(self, config: SETransConfig, radius: int = 4,
                 num_levels: int = 4, do_corr_global_norm: bool = True):
        super().__init__()
        self.radius = radius
        self.num_levels = num_levels
        self.do_corr_global_norm = do_corr_global_norm
        self.setrans = CrossAttFeatTrans(config, "inter-frame corr")
        self.vispos_encoder = SETransInputFeatEncoder(config)

    def build_pyramid(self, fmap1: torch.Tensor,
                      fmap2: torch.Tensor) -> List[torch.Tensor]:
        """fmap1/2 (B, C, H, W) -> levels (B*H*W, H/2^l, W/2^l)."""
        b, _, h, w = fmap1.shape
        vispos1, pos_biases = self.vispos_encoder(fmap1,
                                                  return_pos_biases=True)
        vispos2 = self.vispos_encoder(fmap2)
        corr = self.setrans(vispos1, vispos2, pos_biases)  # (B, 1, U1, U2)
        if self.do_corr_global_norm:
            cf = corr.float()
            mean = cf.mean(dim=(2, 3), keepdim=True)
            var = cf.var(dim=(2, 3), keepdim=True, correction=0)
            corr = ((cf - mean) * torch.rsqrt(var + 1e-12)).to(corr.dtype)
        return pool_levels(corr.reshape(b * h * w, h, w), self.num_levels)


class GMAUpdateBlock(nn.Module):
    """RAFT's update block with SETrans' motion aggregator: the motion
    features mixed by the intra-frame attention feed the GRU beside
    them."""

    def __init__(self, corr_levels: int, corr_multiplier: int,
                 corr_radius: int, intra_trans_config: SETransConfig,
                 hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels * corr_multiplier,
                                          corr_radius)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=128 + hidden_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, 64 * 9, 1, padding=0))
        self.aggregator = ExpandedFeatTrans(intra_trans_config,
                                            "Motion Aggregator")

    def forward(self, net, inp, corr, flow, attention):
        motion_features = self.encoder(flow, corr)
        b, c, h, w = motion_features.shape
        motion_global = self.aggregator(
            motion_features.flatten(2).transpose(1, 2), attention)
        motion_global = motion_global.transpose(1, 2).reshape(b, c, h, w)
        net = self.gru(net, torch.cat([inp, motion_features, motion_global],
                                      dim=1))
        delta_flow = self.flow_head(net)
        # 0.25 scales the mask gradients, as in the reference
        mask = 0.25 * self.mask(net)
        return net, mask, delta_flow


class CRAFT(BaseModel):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/craft-things-5a41930c.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/craft-sintel-ff8e6563.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/craft-kitti-4d99b0c1.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32,
                 f2_attn_mask_radius: int = -1, f2_num_modes: int = 4,
                 f2_pos_code_weight: float = 0.5, inter_num_modes: int = 4,
                 inter_pos_code_weight: float = 0.5,
                 intra_pos_code_weight: float = 1.0,
                 intra_num_modes: int = 4, inter_qk_have_bias: bool = True,
                 pos_bias_radius: int = 7, **kwargs):
        super().__init__(output_stride=8,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.iters = iters
        self.hidden_dim = hdim = 128
        self.context_dim = cdim = 128

        # the inter-frame correlation transformer: aggregated scores only,
        # query and key tied
        inter_cfg = SETransConfig(
            in_feat_dim=256, feat_dim=256, num_modes=inter_num_modes,
            tie_qk_scheme="shared", qk_have_bias=inter_qk_have_bias,
            pos_code_weight=inter_pos_code_weight,
            pos_bias_radius=pos_bias_radius, out_attn_scores_only=True,
            has_FFN=False)
        self.corr_fn = TransCorrBlock(inter_cfg, radius=corr_radius,
                                      num_levels=corr_levels,
                                      do_corr_global_norm=True)
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                 dropout=dropout)
        self.cnet = BasicEncoder(output_dim=hdim + cdim, norm_fn="batch",
                                 dropout=dropout)
        # the second frame's features through self-attention
        f2_cfg = SETransConfig(
            in_feat_dim=256, feat_dim=256, num_modes=f2_num_modes,
            tie_qk_scheme=None, qk_have_bias=False,
            pos_code_weight=f2_pos_code_weight,
            pos_bias_radius=pos_bias_radius,
            attn_mask_radius=f2_attn_mask_radius,
            has_FFN=False, has_input_skip=True)
        self.f2_trans = SelfAttVisPosTrans(f2_cfg, "F2 transformer")
        # the context's intra-frame attention, for the motion aggregator
        intra_cfg = SETransConfig(
            in_feat_dim=128, feat_dim=128, num_modes=intra_num_modes,
            tie_qk_scheme=None, qk_have_bias=False,
            pos_code_weight=intra_pos_code_weight,
            pos_bias_radius=pos_bias_radius, out_attn_probs_only=True,
            has_FFN=False)
        self.att = SelfAttVisPosTrans(intra_cfg, "Intra-frame attention")
        agg_cfg = SETransConfig(
            in_feat_dim=128, feat_dim=128, num_modes=intra_num_modes,
            has_FFN=False, has_input_skip=True)
        self.update_block = GMAUpdateBlock(
            corr_levels=corr_levels, corr_multiplier=1,
            corr_radius=corr_radius, intra_trans_config=agg_cfg,
            hidden_dim=hdim)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8,
        W/8), warm-started from ``inputs["prev_preds"]["flow_small"]`` where
        given.  Training: ``flow_preds`` (iters, B, 2, H, W) and ``flows``,
        the last; the coords are detached at every iteration, as the JAX
        package stops their gradient."""
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]
        fmap1 = self.fnet(image1)
        fmap2 = self.f2_trans(self.fnet(image2))
        corr_lookup = make_corr_lookup(
            self.corr_fn.build_pyramid(fmap1, fmap2), self.corr_radius)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])
        attention = self.att(inp)

        b, _, h, w = fmap1.shape
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        coords1 = coords0
        prev = inputs.get("prev_preds")
        if prev is not None and prev.get("flow_small") is not None:
            coords1 = coords1 + forward_interpolate(prev["flow_small"])
        mask = torch.zeros((b, 64 * 9, h, w), dtype=fmap1.dtype,
                           device=fmap1.device)
        flows_lr, masks = [], []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_lookup(coords1)
            net, mask, delta_flow = self.update_block(
                net, inp, corr, coords1 - coords0, attention)
            coords1 = coords1 + delta_flow
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)

        if training:
            flow_ups = convex_upsample(torch.stack(flows_lr).flatten(0, 1),
                                       torch.stack(masks).flatten(0, 1))
            flow_ups = self.postprocess_predictions(
                flow_ups.unflatten(0, (len(flows_lr), b)), image_resizer,
                is_flow=True)
            return {"flows": flow_ups[-1][:, None], "flow_preds": flow_ups}
        flow_small = coords1 - coords0
        flow_up = self.postprocess_predictions(
            convex_upsample(flow_small, mask), image_resizer, is_flow=True)
        return {"flows": flow_up[:, None], "flow_small": flow_small}


@register_model
@trainable
class craft(CRAFT):
    pass
