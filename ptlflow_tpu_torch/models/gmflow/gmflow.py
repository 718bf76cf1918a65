"""GMFlow, global matching optical flow (``ptlflow_tpu/models/gmflow/
gmflow.py``), NCHW.  Both frames go through the CNN encoder in one batch;
at each scale (1/8 for ``gmflow``; 1/8 then 1/4 for ``gmflow_refine``)
the second frame's features are warped by the flow so far (detached),
both get the sine position embedding and the feature transformer, and the
flow is the softmax matching of frame 0 against frame 1: over the whole
map (``global_correlation_softmax``, float32 scores over H*W x H*W) or
over a (2r+1)^2 window (``local_correlation_softmax``); attention over
frame 0's features propagates it (globally, or in 3 x 3 windows), and
the last scale's flow is convex-upsampled.  No lookup kernel runs here.

The JAX package's ring-sharded global matching (``parallel/ring_corr.py``,
for ``validate --spatial_shards``) is not ported: the port's GMFlow
matches densely on one card.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ...nn import CastConv2d, at_least_float32
from ...ops.correlation import coords_grid, local_correlation
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample
from ...ops.warp import backward_warp
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from .backbone import CNNEncoder
from .transformer import (FeatureFlowAttention, FeatureTransformer,
                          feature_add_position)


class SequenceLoss:
    """The sum over the n predictions i of gamma^(n - i - 1) times the
    mean, over B, both channels, H and W, of valid * |pred_i - gt|; valid
    means ``valids >= 0.5`` and |gt| < ``max_flow``."""

    def __init__(self, gamma: float, max_flow: float):
        self.gamma = gamma
        self.max_flow = max_flow

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        flow_preds = outputs["flow_preds"]  # (n, B, 2, H, W)
        flow_gt = inputs["flows"][:, 0]
        valid = inputs["valids"][:, 0]
        mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1, keepdim=True))
        valid = ((valid >= 0.5) & (mag < self.max_flow)).to(flow_gt.dtype)
        n = flow_preds.shape[0]
        weights = self.gamma ** (n - torch.arange(
            n, dtype=torch.float32, device=flow_gt.device) - 1)
        per = torch.mean(valid[None] * (flow_preds - flow_gt[None]).abs(),
                         dim=(1, 2, 3, 4))
        return torch.sum(weights * per)


def global_correlation_softmax(feature0: torch.Tensor,
                               feature1: torch.Tensor):
    """The (B, 2, H, W) flow, in the features' dtype: each frame-0 pixel's
    expected displacement under the softmax (in at least float32) over all
    of frame 1's pixels of their scaled feature products."""
    b, c, h, w = feature0.shape
    f0 = at_least_float32(feature0.flatten(2).transpose(1, 2))
    f1 = at_least_float32(feature1.flatten(2))
    corr = torch.matmul(f0, f1) / (c ** 0.5)
    grid = coords_grid(b, h, w, dtype=corr.dtype, device=feature0.device)
    prob = torch.softmax(corr, dim=-1)
    correspondence = torch.matmul(prob, grid.flatten(2).transpose(1, 2))
    flow = correspondence.transpose(1, 2).reshape(b, 2, h, w) - grid
    return flow.to(feature0.dtype)


def local_correlation_softmax(feature0: torch.Tensor, feature1: torch.Tensor,
                              local_radius: int):
    """As :func:`global_correlation_softmax` over each pixel's (2r+1)^2
    window of frame 1 (taps dy slow, dx fast, as ``local_correlation``
    orders them), the taps outside the map at -1e9."""
    b, c, h, w = feature0.shape
    r = local_radius
    n = 2 * r + 1
    corr = at_least_float32(local_correlation(
        feature0, feature1, r, normalize=False)) / (c ** 0.5)
    dr = torch.arange(-r, r + 1, dtype=corr.dtype, device=corr.device)
    dy, dx = (t.reshape(n * n, 1, 1)
              for t in torch.meshgrid(dr, dr, indexing="ij"))
    xs = torch.arange(w, dtype=corr.dtype, device=corr.device) + dx
    ys = torch.arange(h, dtype=corr.dtype, device=corr.device)[:, None] + dy
    valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    corr = torch.where(valid, corr, torch.full_like(corr, -1e9))
    prob = torch.softmax(corr, dim=1)  # (B, n2, H, W)
    flow = torch.stack([(prob * dx).sum(1), (prob * dy).sum(1)], 1)
    return flow.to(feature0.dtype)


class GMFlow(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflow-chairs-4922131e.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflow-things-5a18a9e8.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflow-sintel-d6f83ccd.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflow-kitti-af50eb2e.ckpt",
    }

    def __init__(self, attention_type: str = "swin",
                 attn_splits_list: Sequence[int] = (2,),
                 corr_radius_list: Sequence[int] = (-1,),
                 feature_channels: int = 128, ffn_dim_expansion: int = 4,
                 gamma: float = 0.9, max_flow: float = 400.0,
                 num_head: int = 1, num_scales: int = 1,
                 num_transformer_layers: int = 6,
                 pred_bidir_flow: bool = False,
                 prop_radius_list: Sequence[int] = (-1,),
                 upsample_factor: int = 8, **kwargs):
        super().__init__(output_stride=32,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.attn_splits_list = attn_splits_list
        self.corr_radius_list = corr_radius_list
        self.feature_channels = feature_channels
        self.num_scales = num_scales
        self.prop_radius_list = prop_radius_list
        self.upsample_factor = upsample_factor
        self.backbone = CNNEncoder(output_dim=feature_channels,
                                   num_output_scales=num_scales)
        # single-head attention whatever ``num_head``, as in the JAX package
        self.transformer = FeatureTransformer(
            num_layers=num_transformer_layers, d_model=feature_channels,
            attention_type=attention_type,
            ffn_dim_expansion=ffn_dim_expansion)
        self.feature_flow_attn = FeatureFlowAttention(feature_channels)
        self.upsampler = nn.Sequential(
            CastConv2d(2 + feature_channels, 256, 3, 1, 1), nn.ReLU(),
            CastConv2d(256, upsample_factor ** 2 * 9, 1, 1, 0))

    def _upsample_flow(self, flow, feature, bilinear=False,
                       upsample_factor=8):
        if bilinear:
            h, w = flow.shape[-2:]
            return upsample_factor * interpolate(
                flow, (h * upsample_factor, w * upsample_factor),
                mode="bilinear", align_corners=True)
        mask = self.upsampler(torch.cat([flow, feature], 1))
        return convex_upsample(flow, mask, factor=self.upsample_factor)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds`` (n, B,
        2, H, W): each scale's matched flow (and, but at the last scale,
        its propagated flow) upsampled bilinearly, then the last scale's
        propagated flow convex-upsampled."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=(-0.406, -0.456, -0.485),
            bgr_mult=(1 / 0.225, 1 / 0.224, 1 / 0.229), bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        flow_preds = []
        flow, feature0, _ = self._match_scales(images, resizer, training,
                                               flow_preds)
        flow_up = self.postprocess_predictions(
            self._upsample_flow(flow, feature0), resizer, is_flow=True)
        outputs = {"flows": flow_up[:, None]}
        if training:
            outputs["flow_preds"] = torch.stack(flow_preds + [flow_up])
        return outputs

    def _match_scales(self, images: torch.Tensor, resizer, training: bool,
                      flow_preds: list):
        """The coarse-to-fine matching of the preprocessed ``images``:
        the last scale's propagated flow, its post-transformer frame-0
        features and its backbone features of both frames (taken before
        the warp, the position embedding and the transformer).  In
        training, appends to ``flow_preds`` each scale's matched flow and,
        but at the last scale, its propagated flow, upsampled bilinearly
        to the input's size."""
        b = images.shape[0]
        features = self.backbone(torch.cat([images[:, 0], images[:, 1]],
                                           0))[::-1]
        flow = None
        for scale_idx in range(self.num_scales):
            feature0, feature1 = features[scale_idx][:b], \
                features[scale_idx][b:]
            feature_ori = (feature0, feature1)
            upsample_factor = self.upsample_factor * (
                2 ** (self.num_scales - 1 - scale_idx))
            if flow is not None:
                h, w = flow.shape[-2:]
                flow = 2 * interpolate(flow, (h * 2, w * 2), mode="bilinear",
                                       align_corners=True)
                flow = flow.detach()
                feature1 = backward_warp(feature1, flow)
            attn_splits = self.attn_splits_list[scale_idx]
            corr_radius = self.corr_radius_list[scale_idx]
            prop_radius = self.prop_radius_list[scale_idx]
            feature0, feature1 = feature_add_position(
                feature0, feature1, attn_splits, self.feature_channels)
            feature0, feature1 = self.transformer(
                feature0, feature1, attn_num_splits=attn_splits)
            if corr_radius == -1:
                flow_pred = global_correlation_softmax(feature0, feature1)
            else:
                flow_pred = local_correlation_softmax(feature0, feature1,
                                                      corr_radius)
            flow = flow_pred if flow is None else flow + flow_pred
            if training:
                flow_preds.append(self.postprocess_predictions(
                    self._upsample_flow(flow, None, bilinear=True,
                                        upsample_factor=upsample_factor),
                    resizer, is_flow=True))
            flow = self.feature_flow_attn(
                feature0, flow.detach(), local_window_attn=prop_radius > 0,
                local_window_radius=prop_radius)
            if training and scale_idx < self.num_scales - 1:
                flow_preds.append(self.postprocess_predictions(
                    self._upsample_flow(flow, feature0, bilinear=True,
                                        upsample_factor=upsample_factor),
                    resizer, is_flow=True))
        return flow, feature0, feature_ori


class GMFlowWithRefinement(GMFlow):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflow_refine-chairs-88cdc009.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflow_refine-things-e40899f5.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflow_refine-sintel-ee46a2c4.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gmflow_refine-kitti-b7bf2fda.ckpt",
    }

    def __init__(self, attn_splits_list: Sequence[int] = (2, 8),
                 corr_radius_list: Sequence[int] = (-1, 4),
                 num_scales: int = 2,
                 prop_radius_list: Sequence[int] = (-1, 1),
                 upsample_factor: int = 4, **kwargs):
        super().__init__(attn_splits_list=attn_splits_list,
                         corr_radius_list=corr_radius_list,
                         num_scales=num_scales,
                         prop_radius_list=prop_radius_list,
                         upsample_factor=upsample_factor, **kwargs)


@register_model
@trainable
class gmflow(GMFlow):
    pass


@register_model
@trainable
class gmflow_refine(GMFlowWithRefinement):
    pass
