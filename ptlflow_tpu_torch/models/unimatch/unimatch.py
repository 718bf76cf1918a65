"""UniMatch (GMFlow+) (``ptlflow_tpu/models/unimatch/unimatch.py``), NCHW:
GMFlow's coarse-to-fine matching (``models/gmflow/``: the backbone, the
transformer, the global and local matchings, the propagation), then either
GMFlow's convex upsampling or, with ``reg_refine``, a RAFT-style
regression refinement at the last scale.

The refinement steps a flow ``num_reg_refine`` times.  Each step reads
the (2r+1)^2 = 81 correlations of frame 0's backbone features with frame
1's sampled bilinearly in a window around coords + flow
(:func:`local_correlation_with_flow`, the reference's math), through
``BasicUpdateBlock``, whose hidden state is not carried: every step starts
from the same projection of frame 0's post-transformer features.  As in
the JAX package, the window is read from the all-pairs volume of the last
scale's backbone features, built once
(``ops/correlation.py::build_corr_pyramid``, one level) and looked up
each step by ``make_corr_lookup``: on the card one launch of
``csrc/corr_lookup.cu`` a step (in training its gradient launches
``csrc/corr_lookup_backward.cu`` once a step), on the CPU the plain
lookup.  The lookup orders the window x-major; the refinement reads it
y-major, so the two window axes are swapped.

Like the port's GMFlow, the attention is single-head whatever
``num_head``, and the global matching is dense on one card (the JAX
package's ring-sharded path is not ported).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
from torch import nn

from ...nn import CastConv2d, at_least_float32
from ...ops.correlation import (build_corr_pyramid, coords_grid,
                                make_corr_lookup)
from ...ops.grid_sample import bilinear_sampler
from ...ops.upsample import convex_upsample
from ...utils.registry import register_model, trainable
from ..gmflow.gmflow import GMFlow
from ..raft.update import FlowHead, SepConvGRU

# the refinement's window: (2 * 4 + 1)^2 = 81 correlations
REFINE_RADIUS = 4


def local_correlation_with_flow(feature0: torch.Tensor,
                                feature1: torch.Tensor, flow: torch.Tensor,
                                local_radius: int,
                                dilation: int = 1) -> torch.Tensor:
    """(B, (2r+1)^2, H, W), in feature0's dtype: each pixel's dot products,
    over sqrt(C) and in at least float32, of its frame-0 feature with frame
    1's sampled bilinearly (zero outside the map) at coords + flow + the
    window's offset times ``dilation``; the window y-major (dy slow, dx
    fast)."""
    b, c, h, w = feature0.shape
    n = 2 * local_radius + 1
    dtype = at_least_float32(flow).dtype
    dr = torch.arange(-local_radius, local_radius + 1, dtype=dtype,
                      device=flow.device) * dilation
    dy, dx = torch.meshgrid(dr, dr, indexing="ij")
    window = torch.stack([dx, dy]).reshape(1, 2, n * n, 1, 1)
    centre = coords_grid(b, h, w, dtype=dtype, device=flow.device) + flow
    coords = (centre[:, :, None] + window).reshape(b, 2, n * n * h, w)
    sampled = bilinear_sampler(feature1, coords).reshape(b, c, n * n, h, w)
    corr = (at_least_float32(feature0)[:, :, None]
            * at_least_float32(sampled)).sum(1) / math.sqrt(c)
    return corr.to(feature0.dtype)


class BasicMotionEncoder(nn.Module):
    """The correlation (``corr_channels``) and the flow (``flow_channels``)
    encoded apart, joined into 128 - ``flow_channels`` channels, the flow
    appended."""

    def __init__(self, corr_channels: int = 324, flow_channels: int = 2):
        super().__init__()
        self.convc1 = CastConv2d(corr_channels, 256, 1)
        self.convc2 = CastConv2d(256, 192, 3, padding=1)
        self.convf1 = CastConv2d(flow_channels, 128, 7, padding=3)
        self.convf2 = CastConv2d(128, 64, 3, padding=1)
        self.conv = CastConv2d(64 + 192, 128 - flow_channels, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    """The motion encoder, RAFT's separable GRU and flow head, and the
    convex-upsampling mask head (conv, ReLU, conv to 9 f^2 logits, not
    scaled)."""

    def __init__(self, corr_channels: int = 324, hidden_dim: int = 128,
                 context_dim: int = 128, downsample_factor: int = 8,
                 flow_dim: int = 2):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels, flow_dim)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=context_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            CastConv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, downsample_factor ** 2 * 9, 1))

    def forward(self, net: torch.Tensor, inp: torch.Tensor,
                corr: torch.Tensor, flow: torch.Tensor):
        """(the new hidden state, the mask logits, the flow's residual)."""
        motion_features = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion_features], dim=1))
        return net, self.mask(net), self.flow_head(net)


class UniMatch(GMFlow):
    pretrained_checkpoints = {
        "mix": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/unimatch-mixdata-9d7c1e4d.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/unimatch-things-2433864a.ckpt",
    }

    def __init__(self, gamma: float = 0.9, max_flow: float = 400.0,
                 feature_channels: int = 128, num_scales: int = 1,
                 upsample_factor: int = 8, reg_refine: bool = False,
                 num_transformer_layers: int = 6, num_head: int = 1,
                 ffn_dim_expansion: int = 4, num_reg_refine: int = 1,
                 attn_type: str = "swin",
                 attn_splits_list: Sequence[int] = (2,),
                 corr_radius_list: Sequence[int] = (-1,),
                 prop_radius_list: Sequence[int] = (-1,), **kwargs):
        super().__init__(
            attention_type=attn_type, attn_splits_list=attn_splits_list,
            corr_radius_list=corr_radius_list,
            feature_channels=feature_channels,
            ffn_dim_expansion=ffn_dim_expansion, gamma=gamma,
            max_flow=max_flow, num_head=num_head, num_scales=num_scales,
            num_transformer_layers=num_transformer_layers,
            prop_radius_list=prop_radius_list,
            upsample_factor=upsample_factor, **kwargs)
        self.reg_refine = reg_refine
        self.num_reg_refine = num_reg_refine
        if reg_refine:
            # the refinement's mask head upsamples in place of GMFlow's
            del self.upsampler
            self.refine_proj = CastConv2d(128, 256, 1)
            self.refine = BasicUpdateBlock(
                corr_channels=(2 * REFINE_RADIUS + 1) ** 2,
                downsample_factor=upsample_factor, flow_dim=2)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in eval also ``flow_small`` (B, 2,
        h, w), the last scale's flow (refined, with ``reg_refine``); in
        training ``flow_preds`` (n, B, 2, H, W): GMFlow's, then with
        ``reg_refine`` the last scale's propagated flow upsampled
        bilinearly and each refinement step's flow convex-upsampled."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=(-0.406, -0.456, -0.485),
            bgr_mult=(1 / 0.225, 1 / 0.224, 1 / 0.229), bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        flow_preds = []
        flow, feature0, (feature0_ori, feature1_ori) = self._match_scales(
            images, resizer, training, flow_preds)
        if not self.reg_refine:
            flow_preds.append(self.postprocess_predictions(
                self._upsample_flow(flow, feature0), resizer, is_flow=True))
        else:
            if training:
                flow_preds.append(self.postprocess_predictions(
                    self._upsample_flow(flow, None, bilinear=True,
                                        upsample_factor=self.upsample_factor),
                    resizer, is_flow=True))
            flow, refined = self._refine(flow, feature0, feature0_ori,
                                         feature1_ori)
            refined = [self.postprocess_predictions(f, resizer, is_flow=True)
                       for f in refined]
            flow_preds.extend(refined if training else refined[-1:])
        outputs = {"flows": flow_preds[-1][:, None]}
        if training:
            outputs["flow_preds"] = torch.stack(flow_preds)
        else:
            outputs["flow_small"] = flow
        return outputs

    def _refine(self, flow, feature0, feature0_ori, feature1_ori):
        """The regression refinement: (the last flow, each step's flow
        convex-upsampled).  The volume is float32 for float64 features, the
        lookup's widest type; the coords are float32."""
        proj = self.refine_proj(feature0)
        net0, inp = proj.chunk(2, dim=1)
        net0, inp = torch.tanh(net0), torch.relu(inp)
        vol_dtype = (torch.float32 if feature0_ori.dtype == torch.float64
                     else None)
        lookup = make_corr_lookup(build_corr_pyramid(
            feature0_ori, feature1_ori, num_levels=1, dtype=vol_dtype),
            REFINE_RADIUS)
        b, _, h, w = feature0_ori.shape
        n = 2 * REFINE_RADIUS + 1
        grid = coords_grid(b, h, w, device=flow.device)
        refined = []
        for _ in range(self.num_reg_refine):
            flow = flow.detach()
            corr = lookup((grid + flow).float())
            # the lookup's x-major window to the reference's y-major one
            corr = corr.view(b, n, n, h, w).transpose(1, 2).reshape(
                b, n * n, h, w).to(feature0_ori.dtype)
            _, up_mask, residual_flow = self.refine(net0, inp, corr, flow)
            flow = flow + residual_flow
            refined.append(convex_upsample(flow, up_mask,
                                           factor=self.upsample_factor))
        return flow, refined


class UniMatchScale2(UniMatch):
    pretrained_checkpoints = {
        "mix": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/unimatch_scale2-mixdata-b514dde2.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/unimatch_scale2-things-e75ae2f7.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/unimatch_scale2-sintel-f43b76ab.ckpt",
    }

    def __init__(self, num_scales: int = 2, upsample_factor: int = 4,
                 attn_splits_list: Sequence[int] = (2, 8),
                 corr_radius_list: Sequence[int] = (-1, 4),
                 prop_radius_list: Sequence[int] = (-1, 1), **kwargs):
        super().__init__(num_scales=num_scales,
                         upsample_factor=upsample_factor,
                         attn_splits_list=attn_splits_list,
                         corr_radius_list=corr_radius_list,
                         prop_radius_list=prop_radius_list, **kwargs)


class UniMatchScale2With6Refinements(UniMatch):
    pretrained_checkpoints = {
        "mix": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/unimatch_scale2_refine6-mixdata-398760b1.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/unimatch_scale2_refine6-things-54d7505b.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/unimatch_scale2_refine6-sintel-95ab1410.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/unimatch_scale2_refine6-kitti-0626279a.ckpt",
    }

    def __init__(self, num_scales: int = 2, upsample_factor: int = 4,
                 reg_refine: bool = True, num_reg_refine: int = 6,
                 attn_splits_list: Sequence[int] = (2, 8),
                 corr_radius_list: Sequence[int] = (-1, 4),
                 prop_radius_list: Sequence[int] = (-1, 1), **kwargs):
        super().__init__(num_scales=num_scales,
                         upsample_factor=upsample_factor,
                         reg_refine=reg_refine,
                         num_reg_refine=num_reg_refine,
                         attn_splits_list=attn_splits_list,
                         corr_radius_list=corr_radius_list,
                         prop_radius_list=prop_radius_list, **kwargs)


@register_model
@trainable
class unimatch(UniMatch):
    pass


@register_model
@trainable
class unimatch_sc2(UniMatchScale2):
    pass


@register_model
@trainable
class unimatch_sc2_ref6(UniMatchScale2With6Refinements):
    pass


@register_model
@trainable
class gmflow_p(UniMatch):
    pass


@register_model
@trainable
class gmflow_p_sc2(UniMatchScale2):
    pass


@register_model
@trainable
class gmflow_p_sc2_ref6(UniMatchScale2With6Refinements):
    pass
