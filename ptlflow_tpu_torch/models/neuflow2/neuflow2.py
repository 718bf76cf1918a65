"""NeuFlow v2 (``ptlflow_tpu/models/neuflow2/neuflow2.py``), NCHW: global
matching at 1/16, then refinement at 1/16 and at 1/8.

The images stay BGR in [0, 1] and are resized bilinearly
(``align_corners=False``) to a multiple of 16; the flow is resized back.
The backbone gives features and context at 1/16 (with centred (y, x)
position channels) and 1/8; two cross-attention layers with a BatchNorm
post-norm mix the frames at 1/16, where the flow starts as the softmax
attention of frame 0 against frame 1 over the coords grid.  Each scale then
has a one-level correlation block (``CorrBlock``), prepared once, and a
convolutional refiner with an iteration context clipped to +-4:
``iters_s16`` + ``iters_s8`` lookup launches a forward (1 + 8).  The flow
is not detached between steps, as in the JAX package, whose lookup is
differentiable with respect to the coords: the blocks are prepared with
``coords_grad``.  The 1/8 flow is convex-upsampled by 8 with features of
frame 0 from ``conv_s8``, which training runs again at every 1/8 step, as
the JAX package does.  BatchNorms use batch statistics in training.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ...nn import BatchNorm2d, CastConv2d
from ...ops.correlation import CorrBlock, coords_grid
from ...ops.grid_sample import interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..neuflow.neuflow import (SequenceLoss, TransformerLayer, UpSample,
                               lrelu, sdpa)


class ConvBlock2(nn.Module):
    """Two convolutions, each followed by a BatchNorm and a leaky ReLU."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int,
                 stride: int, padding: int):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, out_planes, kernel_size,
                                stride=stride, padding=padding, bias=False)
        self.conv2 = CastConv2d(out_planes, out_planes, 3, stride=1,
                                padding=1, bias=False)
        self.norm1 = BatchNorm2d(out_planes)
        self.norm2 = BatchNorm2d(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = lrelu(self.norm1(self.conv1(x)))
        return lrelu(self.norm2(self.conv2(x)))


class CNNEncoder2(nn.Module):
    """Images -> (1/16 features with two centred (y, x) position channels
    appended, 1/8 features)."""

    def __init__(self, feature_dim_s16: int, context_dim_s16: int,
                 feature_dim_s8: int, context_dim_s8: int):
        super().__init__()
        self.block_8_1 = ConvBlock2(3, feature_dim_s8 * 2, 8, 4, 2)
        self.block_8_2 = ConvBlock2(3, feature_dim_s8, 6, 2, 2)
        self.block_cat_8 = ConvBlock2(feature_dim_s8 * 3,
                                      feature_dim_s8 + context_dim_s8, 3, 1,
                                      1)
        self.block_16_1 = ConvBlock2(3, feature_dim_s16, 6, 2, 2)
        self.block_8_16 = ConvBlock2(feature_dim_s8 + context_dim_s8,
                                     feature_dim_s16, 6, 2, 2)
        self.block_cat_16 = ConvBlock2(
            feature_dim_s16 * 2, feature_dim_s16 + context_dim_s16 - 2, 3, 1,
            1)

    def forward(self, img: torch.Tensor):
        img = nn.functional.avg_pool2d(img, 2, 2)
        x_8 = self.block_8_1(img)
        img = nn.functional.avg_pool2d(img, 2, 2)
        x_8 = self.block_cat_8(torch.cat([x_8, self.block_8_2(img)], dim=1))
        img = nn.functional.avg_pool2d(img, 2, 2)
        x_16 = self.block_cat_16(torch.cat(
            [self.block_16_1(img), self.block_8_16(x_8)], dim=1))
        b, _, h, w = x_16.shape
        ys = torch.arange(h, dtype=x_16.dtype, device=x_16.device) - h / 2
        xs = torch.arange(w, dtype=x_16.dtype, device=x_16.device) - w / 2
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        pos = torch.stack([yy, xx])[None].expand(b, 2, h, w)
        return torch.cat([x_16, pos], dim=1), x_8


class FeatureAttention2(nn.Module):
    """Cross-attention layers between the two frames, stacked in the batch
    (2B, C, H, W): each frame's tokens attend to the other's; a BatchNorm
    post-norm where asked."""

    def __init__(self, feature_dim: int, num_layers: int, ffn: bool = True,
                 ffn_dim_expansion: int = 1, post_norm: bool = False):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerLayer(feature_dim, ffn=ffn,
                             ffn_dim_expansion=ffn_dim_expansion)
            for _ in range(num_layers)])
        self.post_norm = post_norm
        if post_norm:
            self.norm = BatchNorm2d(feature_dim)

    def forward(self, concat_features: torch.Tensor) -> torch.Tensor:
        b2, c, h, w = concat_features.shape
        concat0 = concat_features.flatten(2).transpose(1, 2)
        for layer in self.layers:
            c0, c1 = concat0.chunk(2, dim=0)
            concat0 = layer(concat0, torch.cat([c1, c0], dim=0))
        out = concat0.transpose(1, 2).reshape(b2, c, h, w)
        if self.post_norm:
            out = self.norm(out)
        return out


class _RefineConv(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.conv = CastConv2d(in_planes, out_planes, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrelu(self.conv(x))


class Refine(nn.Module):
    """The lookup, context, iteration context, flow and a constant channel
    of the radius -> (iteration context clipped to +-4, flow step)."""

    def __init__(self, context_dim: int, iter_context_dim: int,
                 num_layers: int, levels: int, radius: int, inter_dim: int):
        super().__init__()
        self.radius = radius
        self.conv1 = _RefineConv(
            (radius * 2 + 1) ** 2 * levels + context_dim + iter_context_dim
            + 2 + 1, context_dim + iter_context_dim)
        self.conv2 = _RefineConv(context_dim + iter_context_dim, inter_dim)
        self.conv_layers = nn.ModuleList(
            [_RefineConv(inter_dim, inter_dim) for _ in range(num_layers)])
        self.conv3 = CastConv2d(inter_dim, iter_context_dim + 2, 3, 1, 1)

    def forward(self, corrs, context, iter_context, flow0):
        b, _, h, w = flow0.shape
        radius_emb = torch.full((b, 1, h, w), float(self.radius),
                                dtype=flow0.dtype, device=flow0.device)
        x = torch.cat([corrs, context, iter_context, flow0, radius_emb],
                      dim=1)
        x = self.conv2(self.conv1(x))
        for layer in self.conv_layers:
            x = layer(x)
        x = self.conv3(x)
        return torch.clamp(x[:, 2:], -4.0, 4.0), x[:, :2]


class NeuFlow2(BaseModel):
    pretrained_checkpoints = {
        "mixed": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/neuflow2-mixed-acac1a70.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/neuflow2-sintel-15c625f8.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/neuflow2-things-6ed47437.ckpt",
    }

    def __init__(self, gamma: float = 0.8, max_flow: float = 400,
                 feature_dim_s16: int = 128, context_dim_s16: int = 64,
                 iter_context_dim_s16: int = 64, feature_dim_s8: int = 128,
                 context_dim_s8: int = 64, iter_context_dim_s8: int = 64,
                 feature_dim_s1: int = 128, iters_s16: int = 1,
                 iters_s8: int = 8, **kwargs):
        super().__init__(output_stride=16,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.context_dim_s16 = context_dim_s16
        self.iter_context_dim_s16 = iter_context_dim_s16
        self.context_dim_s8 = context_dim_s8
        self.iter_context_dim_s8 = iter_context_dim_s8
        self.iters_s16 = iters_s16
        self.iters_s8 = iters_s8

        self.backbone = CNNEncoder2(feature_dim_s16, context_dim_s16,
                                    feature_dim_s8, context_dim_s8)
        self.cross_attn_s16 = FeatureAttention2(
            feature_dim_s16 + context_dim_s16, num_layers=2, ffn=True,
            ffn_dim_expansion=1, post_norm=True)
        self.merge_s8 = nn.Sequential(
            CastConv2d(feature_dim_s16 + feature_dim_s8, feature_dim_s8, 3,
                       1, 1, bias=False),
            nn.GELU(),
            CastConv2d(feature_dim_s8, feature_dim_s8, 3, 1, 1, bias=False),
            BatchNorm2d(feature_dim_s8))
        self.context_merge_s8 = nn.Sequential(
            CastConv2d(context_dim_s16 + context_dim_s8, context_dim_s8, 3,
                       1, 1, bias=False),
            nn.GELU(),
            CastConv2d(context_dim_s8, context_dim_s8, 3, 1, 1, bias=False),
            BatchNorm2d(context_dim_s8))
        self.refine_s16 = Refine(context_dim_s16, iter_context_dim_s16,
                                 num_layers=5, levels=1, radius=4,
                                 inter_dim=128)
        self.refine_s8 = Refine(context_dim_s8, iter_context_dim_s8,
                                num_layers=5, levels=1, radius=4,
                                inter_dim=96)
        self.conv_s8 = ConvBlock2(3, feature_dim_s1, 8, 8, 0)
        self.upsample_s8 = UpSample(feature_dim_s1, upsample_factor=8)

    @staticmethod
    def _split_features(features: torch.Tensor, context_dim: int):
        """[context, features] channels -> (features of both frames, the
        first frame's context through a ReLU)."""
        context = features[:, :context_dim].chunk(2, dim=0)[0]
        return features[:, context_dim:], torch.relu(context)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W).  Training: ``flow_preds``
        (iters_s16 + iters_s8, B, 2, H, W), each step's flow at input scale
        (the 1/16 ones bilinearly upsampled by 16), and ``flows``, the
        last."""
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=0.0, bgr_mult=1.0, bgr_to_rgb=False,
            resize_mode="interpolation", interpolation_align_corners=False)
        img0, img1 = images[:, 0], images[:, 1]
        b = img0.shape[0]

        features_s16, features_s8 = self.backbone(torch.cat([img0, img1]))
        features_s16 = self.cross_attn_s16(features_s16)
        features_s16, context_s16 = self._split_features(
            features_s16, self.context_dim_s16)
        features_s8, context_s8 = self._split_features(
            features_s8, self.context_dim_s8)
        f0_s16, f1_s16 = features_s16.chunk(2, dim=0)
        h16, w16 = f0_s16.shape[-2:]

        # global matching: attention of frame 0 over the coords grid
        grid16 = coords_grid(b, h16, w16, dtype=f0_s16.dtype,
                             device=f0_s16.device)
        corr_val = sdpa(f0_s16.flatten(2).transpose(1, 2),
                        f1_s16.flatten(2).transpose(1, 2),
                        grid16.flatten(2).transpose(1, 2))
        flow0 = corr_val.transpose(1, 2).reshape(b, 2, h16, w16) - grid16

        corr_fn_s16 = CorrBlock(f0_s16, f1_s16, num_levels=1, radius=4,
                                coords_grad=True)
        iter_context = img0.new_zeros((b, self.iter_context_dim_s16, h16,
                                       w16))
        flow_list = []
        for _ in range(self.iters_s16):
            iter_context, delta = self.refine_s16(
                corr_fn_s16(grid16 + flow0), context_s16, iter_context,
                flow0)
            flow0 = flow0 + delta
            if training:
                up = 16 * interpolate(flow0, (h16 * 16, w16 * 16),
                                      mode="bilinear")
                flow_list.append(self.postprocess_predictions(
                    up, image_resizer, is_flow=True))

        # to 1/8
        size8 = (h16 * 2, w16 * 2)
        flow0 = 2 * interpolate(flow0, size8, mode="nearest")
        features_s8 = self.merge_s8(torch.cat(
            [features_s8, interpolate(features_s16, size8, mode="nearest")],
            dim=1))
        f0_s8, f1_s8 = features_s8.chunk(2, dim=0)
        h8, w8 = f0_s8.shape[-2:]
        corr_fn_s8 = CorrBlock(f0_s8, f1_s8, num_levels=1, radius=4,
                               coords_grad=True)
        context_s8 = self.context_merge_s8(torch.cat(
            [context_s8, interpolate(context_s16, size8, mode="nearest")],
            dim=1))
        grid8 = coords_grid(b, h8, w8, dtype=img0.dtype, device=img0.device)
        iter_context = img0.new_zeros((b, self.iter_context_dim_s8, h8, w8))
        for _ in range(self.iters_s8):
            iter_context, delta = self.refine_s8(
                corr_fn_s8(grid8 + flow0), context_s8, iter_context, flow0)
            flow0 = flow0 + delta
            if training:
                up = self.upsample_s8(self.conv_s8(img0), flow0)
                flow_list.append(self.postprocess_predictions(
                    up, image_resizer, is_flow=True))

        if training:
            flow_preds = torch.stack(flow_list)
            return {"flows": flow_preds[-1][:, None],
                    "flow_preds": flow_preds}
        up_flow0 = self.upsample_s8(self.conv_s8(img0), flow0)
        up_flow0 = self.postprocess_predictions(up_flow0, image_resizer,
                                                is_flow=True)
        return {"flows": up_flow0[:, None]}


@register_model
@trainable
class neuflow2(NeuFlow2):
    pass
