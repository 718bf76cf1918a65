"""MatchFlow (``ptlflow_tpu/models/matchflow/matchflow.py``), NCHW: GMA (or
RAFT, ``matchflow_raft``) on the quadtree-attention matching features.

The input is resized bilinearly (align_corners) to a multiple of 32, both
frames go through the matching encoder in one batch (``quadtree.py``), and
their 4-level pyramid is looked up once an iteration by the lookup prepared
once a forward (``make_corr_lookup``: one launch of ``csrc/corr_lookup.cu``
on the card, and in training one of ``csrc/corr_lookup_backward.cu``).  The
warm start reads ``prev_preds["flow_small"]``.  With a ``train_size`` the
eval forward runs on tiles of that size blended by Gaussian weights, as
FlowFormer's does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ...ops.correlation import (build_corr_pyramid, coords_grid,
                                make_corr_lookup)
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..flowformer.flowformer import compute_grid_indices, compute_weight
from ..gma.gma import GMAUpdateBlock
from ..gma.gma_utils import Attention
from ..raft.extractor import BasicEncoder
from ..raft.raft import SequenceLoss
from ..raft.update import BasicUpdateBlock
from .quadtree import MatchingModel


class MatchFlow(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/matchflow_gma-chairs-02519b53.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/matchflow_gma-kitti-bc72ce81.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/matchflow_gma-sintel-683422f4.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/matchflow_gma-things-49295bd8.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32,
                 num_heads: int = 1, raft: bool = False,
                 use_tile_input: bool = True, tile_height: int = 416,
                 tile_sigma: float = 0.05, position_only: bool = False,
                 position_and_content: bool = False,
                 train_size: Optional[Tuple[int, int]] = None, **kwargs):
        super().__init__(output_stride=32,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.iters = iters
        self.raft = raft
        self.use_tile_input = use_tile_input
        self.tile_height = tile_height
        self.tile_sigma = tile_sigma
        self.train_size = train_size
        self.hidden_dim = hdim = 128
        self.context_dim = cdim = 128

        self.fnet = MatchingModel(train_size=train_size)
        self.cnet = BasicEncoder(output_dim=hdim + cdim, norm_fn="batch",
                                 dropout=dropout)
        if raft:
            self.update_block = BasicUpdateBlock(corr_levels, corr_radius,
                                                 hidden_dim=hdim)
        else:
            self.update_block = GMAUpdateBlock(corr_levels, corr_radius,
                                               num_heads, hidden_dim=hdim)
            self.att = Attention(dim=cdim, position_only=position_only,
                                 position_and_content=position_and_content,
                                 heads=num_heads, max_pos_size=160,
                                 dim_head=cdim)

    def _predict(self, image1: torch.Tensor, image2: torch.Tensor,
                 flow_prev: Optional[torch.Tensor] = None,
                 training: bool = False):
        """(flow_preds, flow_small): every iteration's upsampled flow
        (iters, B, 2, H, W) in training, else the last one (1, B, 2, H, W)
        and the 1/8 flow.  The coords are detached at the start of every
        iteration."""
        fmap1, fmap2 = self.fnet(image1, image2)
        lookup = make_corr_lookup(
            build_corr_pyramid(fmap1, fmap2, self.corr_levels),
            self.corr_radius)
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])
        extra = () if self.raft else (self.att(inp),)

        b, _, h, w = fmap1.shape
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        coords1 = coords0
        if flow_prev is not None:
            coords1 = coords1 + forward_interpolate(flow_prev)
        flows_lr, masks = [], []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            net, mask, delta = self.update_block(
                net, inp, lookup(coords1), coords1 - coords0, *extra)
            coords1 = coords1 + delta
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)
        if training:
            ups = convex_upsample(torch.cat(flows_lr), torch.cat(masks))
            return ups.unflatten(0, (len(flows_lr), b)), None
        flow_small = coords1 - coords0
        return convex_upsample(flow_small, mask)[None], flow_small

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        if self.use_tile_input and self.train_size is not None \
                and not training:
            return self.forward_tile(inputs)
        return self.forward_resize(inputs, training)

    def forward_resize(self, inputs: Dict[str, Any],
                       training: bool = False) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (the 1/8 flow
        of the resized frames), warm-started from
        ``inputs["prev_preds"]["flow_small"]`` where given.  Training:
        ``flow_preds`` (iters, B, 2, H, W) and ``flows``."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=True)
        prev = inputs.get("prev_preds")
        flow_prev = None if prev is None else prev.get("flow_small")
        flow_preds, flow_small = self._predict(images[:, 0], images[:, 1],
                                               flow_prev, training)
        flow_preds = self.postprocess_predictions(flow_preds, resizer,
                                                  is_flow=True)
        out = {"flows": flow_preds[-1][:, None]}
        if training:
            out["flow_preds"] = flow_preds
        else:
            out["flow_small"] = flow_small
        return out

    def forward_tile(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Tiles of ``train_size`` over the input resized to ``tile_height``
        rows at least, each predicted alone (tiles that overrun the edge
        cropped), blended by ``compute_weight``'s Gaussian weights."""
        th, tw = self.train_size
        input_size = inputs["images"].shape[-2:]
        image_size = (max(self.tile_height, input_size[-2]), input_size[-1])
        hws = compute_grid_indices(image_size, (th, tw))
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="interpolation", target_size=image_size,
            interpolation_mode="bilinear", interpolation_align_corners=True)
        image1, image2 = images[:, 0], images[:, 1]
        weights = torch.from_numpy(compute_weight(
            hws, image_size, (th, tw), self.tile_sigma)).to(image1)
        flows = image1.new_zeros((image1.shape[0], 2) + image_size)
        flow_count = image1.new_zeros((1, 1) + image_size)
        for idx, (h, w) in enumerate(hws):
            preds, _ = self._predict(image1[..., h:h + th, w:w + tw],
                                     image2[..., h:h + th, w:w + tw])
            eh = min(h + th, image_size[0])
            ew = min(w + tw, image_size[1])
            wt = weights[idx, h:eh, w:ew]
            flows[..., h:eh, w:ew] += preds[-1][..., :eh - h, :ew - w] * wt
            flow_count[..., h:eh, w:ew] += wt
        output_flow = self.postprocess_predictions(flows / flow_count,
                                                   resizer, is_flow=True)
        return {"flows": output_flow[:, None]}


class MatchFlowRAFT(MatchFlow):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/matchflow_raft-things-bf560032.ckpt"
    }

    def __init__(self, raft: bool = True, **kwargs):
        super().__init__(raft=raft, **kwargs)


@register_model
@trainable
class matchflow(MatchFlow):
    pass


@register_model
@trainable
class matchflow_raft(MatchFlowRAFT):
    pass
