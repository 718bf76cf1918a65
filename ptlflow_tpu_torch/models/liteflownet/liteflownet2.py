"""LiteFlowNet2 (``ptlflow_tpu/models/liteflownet/liteflownet2.py``), NCHW:
LiteFlowNet's matching, sub-pixel and regularization cascade on four
levels (1/32 to 1/4) with deeper flow networks, the brightness error still
of the warped green channel alone (the reference's quirk,
liteflownet2.py:236-238), a grouped transposed convolution up to the
input's size, and with ``use_pseudo_regularization``
(``liteflownet2_pseudoreg``) one more sub-pixel and regularization stage
at 1/2 before it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ...nn import CastConv2d, CastConvTranspose2d
from ...utils.registry import register_model
from ..base import BaseModel
from .liteflownet import (BGR_ADD, FeatureExtractor, RegularizationBase,
                          conv_stack, correlate, images_pyramid, lfn_warp,
                          smooth_flow)


def level_mults(num_levels: int, div_flow: float) -> List[float]:
    return [div_flow / 2 ** (num_levels - i + 1) for i in range(num_levels)]


def flow_net(cin: int, k: int) -> nn.Sequential:
    return conv_stack((cin, 128, 3, 1, 1), (128, 128, 3, 1, 1),
                      (128, 96, 3, 1, 1), (96, 64, 3, 1, 1),
                      (64, 32, 3, 1, 1), (32, 2, k, 1, k // 2, False))


def up_flow2(kernel: int = 4, stride: int = 2,
             padding: int = 1) -> CastConvTranspose2d:
    return CastConvTranspose2d(2, 2, kernel, stride, padding, bias=False,
                               groups=2)


class Matching2(nn.Module):
    def __init__(self, level: int, num_levels: int = 4,
                 div_flow: float = 20.0):
        super().__init__()
        self.corr_stride = [1, 1, 1, 2][level]
        self.mult = level_mults(num_levels, div_flow)[level]
        self.up_flow = None if level == 0 else up_flow2()
        self.up_corr = None if level < 3 else CastConvTranspose2d(
            49, 49, 4, 2, 1, bias=False, groups=49)
        self.flow_net = flow_net(49, [3, 3, 5, 5][level])

    def forward(self, feats: torch.Tensor,
                flow: Optional[torch.Tensor]) -> torch.Tensor:
        warped = feats[:, 1]
        if flow is not None:
            flow = self.up_flow(flow)
            warped = lfn_warp(feats[:, 1], flow, self.mult)
        corr = correlate(feats[:, 0], warped, 3, self.corr_stride,
                         self.corr_stride)
        if self.up_corr is not None:
            corr = self.up_corr(corr)
        new_flow = self.flow_net(corr)
        return new_flow if flow is None else flow + new_flow


class SubPixel2(nn.Module):
    """Also returns its last features, which the pseudo stage reads."""

    def __init__(self, level: int, num_levels: int = 4,
                 div_flow: float = 20.0):
        super().__init__()
        dims = [386, 258, 194, 130][level]
        k = [3, 3, 5, 5][level]
        self.mult = level_mults(num_levels, div_flow)[level]
        self.feat_net = conv_stack((dims, 128, 3, 1, 1), (128, 128, 3, 1, 1),
                                   (128, 96, 3, 1, 1), (96, 64, 3, 1, 1),
                                   (64, 32, 3, 1, 1))
        self.flow_net = CastConv2d(32, 2, k, 1, k // 2)

    def forward(self, feats: torch.Tensor, flow: torch.Tensor):
        warped = lfn_warp(feats[:, 1], flow, self.mult)
        x = self.feat_net(torch.cat([feats[:, 0], warped, flow], 1))
        return flow + self.flow_net(x), x


class Regularization2(RegularizationBase):
    """Also returns its features, which the pseudo stage reads."""

    def __init__(self, level: int, num_levels: int = 4,
                 div_flow: float = 20.0):
        super().__init__(level, [195, 131, 99, 67][level],
                         [3, 3, 5, 5][level],
                         level_mults(num_levels, div_flow)[level], True)

    def forward(self, images: torch.Tensor, feats: torch.Tensor,
                flow: torch.Tensor):
        x = self.features(images, feats, flow)
        return smooth_flow(flow, self.dist(x), self.k), x


class PseudoSubpixel(nn.Module):
    def __init__(self):
        super().__init__()
        self.up_flow = up_flow2()
        self.flow_net = nn.Sequential(
            CastConvTranspose2d(32, 32, 4, 2, 1), CastConv2d(32, 2, 7, 1, 3))

    def forward(self, sub_feat: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
        return self.up_flow(flow) + self.flow_net(sub_feat)


class PseudoRegularization(nn.Module):
    def __init__(self):
        super().__init__()
        self.feat_net = nn.Sequential(
            CastConvTranspose2d(32, 32, 4, 2, 1),
            CastConv2d(32, 49, (7, 1), 1, (3, 0)),
            CastConv2d(49, 49, (1, 7), 1, (0, 3)))

    def forward(self, reg_feat: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
        return smooth_flow(flow, self.feat_net(reg_feat), 7)


class LiteFlowNet2Base(BaseModel):
    """What LiteFlowNet2 and 3 share: four levels of the feature extractor
    (1/32 to 1/4), the optional pseudo stage and the last upsampling."""

    def __init__(self, div_flow: float = 20.0,
                 use_pseudo_regularization: bool = False, **kwargs):
        super().__init__(loss_fn=None, output_stride=32, **kwargs)
        self.div_flow = div_flow
        self.use_pseudo_regularization = use_pseudo_regularization
        self.num_levels = 4
        self.feature_net = FeatureExtractor(first=2)

    def _add_head(self) -> None:
        if self.use_pseudo_regularization:
            self.pseudo_subpixel = PseudoSubpixel()
            self.pseudo_regularization = PseudoRegularization()
            self.up_flow = up_flow2()
        else:
            self.up_flow = up_flow2(8, 4, 2)

    def _pyramids(self, raw: torch.Tensor):
        images, resizer = self.preprocess_images(
            raw, bgr_add=BGR_ADD, bgr_mult=1.0, bgr_to_rgb=True,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=False)
        feats_pyr = self.feature_net(images)
        return feats_pyr, images_pyramid(images, feats_pyr), resizer

    def _head(self, flow: torch.Tensor, sub_feat: torch.Tensor,
              reg_feat: torch.Tensor, resizer) -> torch.Tensor:
        """The pseudo stage where the model has one, the upsampling to the
        input's size, ``div_flow`` and the resize back."""
        if self.use_pseudo_regularization:
            flow = self.pseudo_subpixel(sub_feat, flow)
            flow = self.pseudo_regularization(reg_feat, flow)
        flow = self.up_flow(flow) * self.div_flow
        return self.postprocess_predictions(flow, resizer, is_flow=True)


class LiteFlowNet2(LiteFlowNet2Base):
    pretrained_checkpoints = {
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/liteflownet2-sintel-1e1eb282.ckpt",
    }

    def __init__(self, div_flow: float = 20.0,
                 use_pseudo_regularization: bool = False, **kwargs):
        super().__init__(div_flow, use_pseudo_regularization, **kwargs)
        self.matching_nets = nn.ModuleList(
            [Matching2(i, self.num_levels, div_flow)
             for i in range(self.num_levels)])
        self.subpixel_nets = nn.ModuleList(
            [SubPixel2(i, self.num_levels, div_flow)
             for i in range(self.num_levels)])
        self.regularization_nets = nn.ModuleList(
            [Regularization2(i, self.num_levels, div_flow)
             for i in range(self.num_levels)])
        self._add_head()

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds``, the
        four levels' flows in units of 1/``div_flow``, 1/32 to 1/4."""
        feats_pyr, images_pyr, resizer = self._pyramids(inputs["images"])
        flow = None
        flow_preds = []
        for i in range(self.num_levels):
            flow = self.matching_nets[i](feats_pyr[i], flow)
            flow, sub_feat = self.subpixel_nets[i](feats_pyr[i], flow)
            flow, reg_feat = self.regularization_nets[i](
                images_pyr[i], feats_pyr[i], flow)
            flow_preds.append(flow)
        outputs = {"flows": self._head(flow, sub_feat, reg_feat,
                                       resizer)[:, None]}
        if training:
            outputs["flow_preds"] = flow_preds
        return outputs


class LiteFlowNet2PseudoReg(LiteFlowNet2):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/liteflownet2-kitti-da069fca.ckpt",
    }

    def __init__(self, div_flow: float = 20.0,
                 use_pseudo_regularization: bool = True, **kwargs):
        super().__init__(div_flow, use_pseudo_regularization, **kwargs)


@register_model
class liteflownet2(LiteFlowNet2):
    pass


@register_model
class liteflownet2_pseudoreg(LiteFlowNet2PseudoReg):
    pass
