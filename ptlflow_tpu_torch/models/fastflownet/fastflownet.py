"""FastFlowNet (``ptlflow_tpu/models/fastflownet/fastflownet.py``), NCHW: a
shared three-level convolutional pyramid with three more levels
average-pooled from it, and at each level from 1/64 to 1/4 the second
frame's features warped by the upsampled flow, a center-dense subset (53
of 81 displacements) of the 9x9 local correlation, and a decoder whose
grouped convolutions shuffle their channels.

The mean is taken over both frames together, per channel; the input is
resized by interpolation to a multiple of 64.  The correlation is
``ops.local_correlation`` (radius 4) over C; no lookup kernel runs here.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, CastConvTranspose2d
from ...ops.correlation import coords_grid, local_correlation
from ...ops.grid_sample import bilinear_sampler, interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..pwcnet.pwcnet import MultiScaleLoss

# the center-dense dissipated index set (fastflownet.py:142-176)
CV_INDEX = (
    0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 21, 22, 23, 24, 26, 28, 29, 30,
    31, 32, 33, 34, 36, 38, 39, 40, 41, 42, 44, 46, 47, 48, 49, 50, 51, 52,
    54, 56, 57, 58, 59, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80)


def convrelu(cin, cout, k=3, stride=1, padding=1, groups=1):
    return nn.Sequential(
        CastConv2d(cin, cout, k, stride, padding, groups=groups, bias=True),
        nn.LeakyReLU(0.1))


def shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel shuffle: channel g * (C / groups) + i moves to i * groups +
    g."""
    b, c, h, w = x.shape
    return x.view(b, groups, c // groups, h, w).transpose(1, 2).reshape(
        b, c, h, w)


class Decoder(nn.Module):
    def __init__(self, in_channels: int, groups: int):
        super().__init__()
        self.groups = groups
        self.conv1 = convrelu(in_channels, 96, 3, 1)
        self.conv2 = convrelu(96, 96, 3, 1, groups=groups)
        self.conv3 = convrelu(96, 96, 3, 1, groups=groups)
        self.conv4 = convrelu(96, 96, 3, 1, groups=groups)
        self.conv5 = convrelu(96, 64, 3, 1)
        self.conv6 = convrelu(64, 32, 3, 1)
        self.conv7 = CastConv2d(32, 2, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        for conv in (self.conv2, self.conv3, self.conv4):
            out = shuffle(conv(out), self.groups)
        return self.conv7(self.conv6(self.conv5(out)))


class FastFlowNet(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/fastflownet-chairs-89e7a48e.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/fastflownet-kitti-6d3526a8.ckpt",
        "mix": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/fastflownet-mix-fd9b8c0d.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/fastflownet-sintel-6475ea96.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/fastflownet-things3d-fc093d29.ckpt",
    }

    def __init__(self, div_flow: float = 20.0, md: int = 4, groups: int = 3,
                 loss_start_scale: int = 4, loss_num_scales: int = 5,
                 loss_base_weight: float = 0.32, loss_norm: str = "L2",
                 **kwargs):
        super().__init__(
            loss_fn=MultiScaleLoss(loss_start_scale, loss_num_scales,
                                   loss_base_weight, loss_norm),
            output_stride=64, **kwargs)
        self.div_flow = div_flow
        self.md = md
        self.groups = groups
        self.pconv1_1 = convrelu(3, 16, 3, 2)
        self.pconv1_2 = convrelu(16, 16, 3, 1)
        self.pconv2_1 = convrelu(16, 32, 3, 2)
        self.pconv2_2 = convrelu(32, 32, 3, 1)
        self.pconv2_3 = convrelu(32, 32, 3, 1)
        self.pconv3_1 = convrelu(32, 64, 3, 2)
        self.pconv3_2 = convrelu(64, 64, 3, 1)
        self.pconv3_3 = convrelu(64, 64, 3, 1)
        self.rconv2 = convrelu(32, 32, 3, 1)
        for lvl in "3456":
            setattr(self, f"rconv{lvl}", convrelu(64, 32, 3, 1))
        for lvl in "3456":
            setattr(self, f"up{lvl}",
                    CastConvTranspose2d(2, 2, 4, 2, 1, bias=True))
        for lvl in "23456":
            setattr(self, f"decoder{lvl}", Decoder(87, groups))
        self.register_buffer("cv_index", torch.tensor(CV_INDEX),
                             persistent=False)

    def _pyramid(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        f1 = self.pconv1_2(self.pconv1_1(img))
        f2 = self.pconv2_3(self.pconv2_2(self.pconv2_1(f1)))
        f3 = self.pconv3_3(self.pconv3_2(self.pconv3_1(f2)))
        f4 = F.avg_pool2d(f3, 2, 2)
        f5 = F.avg_pool2d(f4, 2, 2)
        f6 = F.avg_pool2d(f5, 2, 2)
        return {"2": f2, "3": f3, "4": f4, "5": f5, "6": f6}

    def _corr(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        c = local_correlation(f1, f2, self.md, normalize=False) / f1.shape[1]
        return c.index_select(1, self.cv_index)

    @staticmethod
    def _warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        b, _, h, w = flow.shape
        coords = coords_grid(b, h, w, dtype=flow.dtype,
                             device=flow.device) + flow
        return bilinear_sampler(x, coords)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds``, the
        five levels' flows in units of 1/``div_flow``, 1/4 to 1/64."""
        raw = inputs["images"]
        mean = raw.mean(dim=(1, 3, 4), keepdim=True)
        images, resizer = self.preprocess_images(
            raw, bgr_add=-mean, bgr_mult=1.0, bgr_to_rgb=False,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=False)
        p1 = self._pyramid(images[:, 0])
        p2 = self._pyramid(images[:, 1])
        f6 = p1["6"]
        flow_up = f6.new_zeros((f6.shape[0], 2, *f6.shape[-2:]))
        scales = {"5": 0.625, "4": 1.25, "3": 2.5, "2": 5.0}
        flows = []
        flow = None
        for lvl in "65432":
            f2l = p2[lvl]
            if lvl != "6":
                # the flow of level lvl + 1, upsampled by that level's deconv
                flow_up = getattr(self, f"up{int(lvl) + 1}")(flow)
                f2l = self._warp(f2l, flow_up * scales[lvl])
            cat = torch.cat([self._corr(p1[lvl], f2l),
                             getattr(self, f"rconv{lvl}")(p1[lvl]), flow_up],
                            1)
            delta = getattr(self, f"decoder{lvl}")(cat)
            flow = delta if lvl == "6" else delta + flow_up
            flows.append(flow)
        h, w = images.shape[-2:]
        flow_full = self.div_flow * interpolate(flow, (h, w), mode="bilinear",
                                                align_corners=False)
        flow_full = self.postprocess_predictions(flow_full, resizer,
                                                 is_flow=True)
        outputs = {"flows": flow_full[:, None]}
        if training:
            outputs["flow_preds"] = flows[::-1]
        return outputs


@register_model
@trainable
class fastflownet(FastFlowNet):
    pass
