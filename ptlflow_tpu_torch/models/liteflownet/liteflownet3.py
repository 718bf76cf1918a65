"""LiteFlowNet3 (``ptlflow_tpu/models/liteflownet/liteflownet3.py``), NCHW:
LiteFlowNet2's cascade with, from level 2 (from level 1 in the S
versions), the flow field deformed before matching (the upsampled flow
warped by a displacement predicted from the first frame's dilated
self-correlation and the upsampled confidence) and the 9x9 cost volume
modulated (a learned per-pixel scale and offset), and a confidence head on
the regularization.  The whole warped image enters the brightness error.
``confs`` is the last confidence, upsampled x4 bilinearly and resized back
to the input's size.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ...nn import CastConv2d, CastConvTranspose2d
from ...ops.grid_sample import interpolate
from ...utils.registry import register_model
from .liteflownet import (RegularizationBase, conv_stack, correlate,
                          lfn_warp, smooth_flow)
from .liteflownet2 import (LiteFlowNet2Base, SubPixel2, flow_net,
                           level_mults, up_flow2)


def conf_head(k: int) -> nn.Sequential:
    return nn.Sequential(CastConv2d(32, 1, k, 1, k // 2), nn.Sigmoid())


class FlowFieldDeformation(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.patch_size = [None, 5, 7, 9][level]
        k = [None, 3, 5, 5][level]
        self.up_conf = CastConvTranspose2d(1, 1, 4, 2, 1, bias=False)
        self.up_flow = up_flow2()
        self.feat_net = conv_stack((self.patch_size ** 2 + 1, 128, 3, 1, 1),
                                   (128, 64, 3, 1, 1), (64, 32, 3, 1, 1))
        self.disp_pred = CastConv2d(32, 2, k, 1, k // 2)
        self.conf_pred = conf_head(k)

    def forward(self, feats: torch.Tensor, flow: torch.Tensor,
                conf: torch.Tensor):
        conf = self.up_conf(conf)
        flow = self.up_flow(flow)
        # the first frame's features against themselves, 2 px apart
        self_corr = correlate(feats[:, 0], feats[:, 0], self.patch_size // 2,
                              dilation=2)
        x = self.feat_net(torch.cat([self_corr, conf], 1))
        # the flow field itself warped by the predicted displacement
        flow = lfn_warp(flow, self.disp_pred(x), 1.0)
        return flow, self.conf_pred(x)


class CostVolumeModulation(nn.Module):
    def __init__(self, level: int, num_levels: int = 4,
                 div_flow: float = 20.0):
        super().__init__()
        dims = [None, 210, 178, 146][level]
        self.mult = level_mults(num_levels, div_flow)[level]
        self.feat_net = conv_stack((dims, 128, 3, 1, 1), (128, 64, 3, 1, 1))
        self.mod_scalar_net = conv_stack((64, 32, 3, 1, 1),
                                         (32, 81, 1, 1, 0, False))
        self.mod_offset_net = conv_stack((64, 32, 3, 1, 1),
                                         (32, 81, 1, 1, 0, False))

    def forward(self, feats: torch.Tensor, flow: torch.Tensor,
                conf: torch.Tensor) -> torch.Tensor:
        warped = lfn_warp(feats[:, 1], flow, self.mult)
        corr = correlate(feats[:, 0], warped, 4)
        x = self.feat_net(torch.cat([feats[:, 0], corr, conf], 1))
        return self.mod_scalar_net(x) * corr + self.mod_offset_net(x)


class Matching3(nn.Module):
    def __init__(self, level: int, num_levels: int = 4,
                 div_flow: float = 20.0, use_s_version: bool = False):
        super().__init__()
        self.mult = level_mults(num_levels, div_flow)[level]
        self.up_flow = up_flow2() if (level == 1 and not use_s_version) \
            else None
        self.flow_net = flow_net(81, [3, 3, 5, 5][level])

    def forward(self, feats: torch.Tensor, flow: Optional[torch.Tensor],
                corr: Optional[torch.Tensor]) -> torch.Tensor:
        if self.up_flow is not None:
            flow = self.up_flow(flow)
        if corr is None:
            warped = feats[:, 1]
            if flow is not None:
                warped = lfn_warp(feats[:, 1], flow, self.mult)
            corr = correlate(feats[:, 0], warped, 4)
        new_flow = self.flow_net(corr)
        return new_flow if flow is None else flow + new_flow


class Regularization3(RegularizationBase):
    """Returns the smoothed flow, the confidence (None at level 3, and at
    level 0 outside the S versions) and the features."""

    def __init__(self, level: int, num_levels: int = 4,
                 div_flow: float = 20.0, use_s_version: bool = False):
        super().__init__(level, [195, 131, 99, 67][level],
                         [3, 3, 5, 5][level],
                         level_mults(num_levels, div_flow)[level], False)
        if (level == 0 and not use_s_version) or level == 3:
            self.conf_pred = None
        else:
            self.conf_pred = conf_head([3, 3, 5][level])

    def forward(self, images: torch.Tensor, feats: torch.Tensor,
                flow: torch.Tensor):
        x = self.features(images, feats, flow)
        flow = smooth_flow(flow, self.dist(x), self.k)
        conf = None if self.conf_pred is None else self.conf_pred(x)
        return flow, conf, x


class LiteFlowNet3(LiteFlowNet2Base):
    pretrained_checkpoints = {
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/liteflownet3-sintel-d985929f.ckpt",
    }

    def __init__(self, div_flow: float = 20.0,
                 use_pseudo_regularization: bool = False,
                 use_s_version: bool = False, **kwargs):
        super().__init__(div_flow, use_pseudo_regularization, **kwargs)
        self.use_s_version = use_s_version
        self.min_mod_level = 1 if use_s_version else 2
        levels = range(self.min_mod_level, self.num_levels)
        self.deformation_nets = nn.ModuleList(
            [FlowFieldDeformation(i) for i in levels])
        self.modulation_nets = nn.ModuleList(
            [CostVolumeModulation(i, self.num_levels, div_flow)
             for i in levels])
        self.matching_nets = nn.ModuleList(
            [Matching3(i, self.num_levels, div_flow, use_s_version)
             for i in range(self.num_levels)])
        self.subpixel_nets = nn.ModuleList(
            [SubPixel2(i, self.num_levels, div_flow)
             for i in range(self.num_levels)])
        self.regularization_nets = nn.ModuleList(
            [Regularization3(i, self.num_levels, div_flow, use_s_version)
             for i in range(self.num_levels)])
        self._add_head()

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W) and ``confs`` (B, 1, 1, H, W); in
        training also ``flow_preds`` (the four levels' flows in units of
        1/``div_flow``, 1/32 to 1/4) and ``conf_preds``."""
        feats_pyr, images_pyr, resizer = self._pyramids(inputs["images"])
        flow = conf = corr = None
        flow_preds, conf_preds = [], []
        for i in range(self.num_levels):
            feats = feats_pyr[i]
            if i >= self.min_mod_level:
                j = i - self.min_mod_level
                flow, conf = self.deformation_nets[j](feats, flow, conf)
                conf_preds.append(conf)
                corr = self.modulation_nets[j](feats, flow, conf)
            flow = self.matching_nets[i](feats, flow, corr)
            flow, sub_feat = self.subpixel_nets[i](feats, flow)
            flow, conf, reg_feat = self.regularization_nets[i](
                images_pyr[i], feats, flow)
            flow_preds.append(flow)
            if conf is not None:
                conf_preds.append(conf)
        flow = self._head(flow, sub_feat, reg_feat, resizer)
        cf = conf_preds[-1]
        h, w = cf.shape[-2:]
        cf = interpolate(cf, (4 * h, 4 * w), mode="bilinear",
                         align_corners=False)
        cf = self.postprocess_predictions(cf, resizer, is_flow=False)
        outputs = {"flows": flow[:, None], "confs": cf[:, None]}
        if training:
            outputs["flow_preds"] = flow_preds
            outputs["conf_preds"] = conf_preds
        return outputs


class LiteFlowNet3PseudoReg(LiteFlowNet3):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/liteflownet3-kitti-b5d32443.ckpt",
    }

    def __init__(self, div_flow: float = 20.0,
                 use_pseudo_regularization: bool = True,
                 use_s_version: bool = False, **kwargs):
        super().__init__(div_flow, use_pseudo_regularization, use_s_version,
                         **kwargs)


class LiteFlowNet3S(LiteFlowNet3):
    pretrained_checkpoints = {
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/liteflownet3s-sintel-89793e34.ckpt",
    }

    def __init__(self, div_flow: float = 20.0,
                 use_pseudo_regularization: bool = False,
                 use_s_version: bool = True, **kwargs):
        super().__init__(div_flow, use_pseudo_regularization, use_s_version,
                         **kwargs)


class LiteFlowNet3SPseudoReg(LiteFlowNet3):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/liteflownet3s-kitti-5dffb261.ckpt",
    }

    def __init__(self, div_flow: float = 20.0,
                 use_pseudo_regularization: bool = True,
                 use_s_version: bool = True, **kwargs):
        super().__init__(div_flow, use_pseudo_regularization, use_s_version,
                         **kwargs)


@register_model
class liteflownet3(LiteFlowNet3):
    pass


@register_model
class liteflownet3_pseudoreg(LiteFlowNet3PseudoReg):
    pass


@register_model
class liteflownet3s(LiteFlowNet3S):
    pass


@register_model
class liteflownet3s_pseudoreg(LiteFlowNet3SPseudoReg):
    pass
