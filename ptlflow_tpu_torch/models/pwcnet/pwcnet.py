"""PWC-Net (``ptlflow_tpu/models/pwcnet/pwcnet.py``), NCHW: the feature
pyramid, the backward warp with PWC's validity mask, the local cost volume
and the DenseNet-style decoders, coarse to fine from 1/64 to 1/4, with
(``pwcnet``) or without (``pwcnet_nodc``) the dilated-context refinement;
its eval and training forwards and ``MultiScaleLoss``.

The input is resized by interpolation to a multiple of 64.  The cost
volume is ``ops.local_correlation`` (search radius 4) over C with a leaky
ReLU; no lookup kernel and no iteration loop run here.  The convolutions
cast their weights to their input's dtype, so ``validate --bf16``'s weight
cast computes in float32 on bfloat16-rounded weights, as in the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, CastConvTranspose2d
from ...ops.correlation import coords_grid, local_correlation
from ...ops.grid_sample import (bilinear_coverage, bilinear_sampler,
                                interpolate)
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..base import BaseModel


class MultiScaleLoss:
    """Multi-scale loss on the ground truth scaled by 0.05 and average
    pooled to each prediction's scale: the sum over predictions i (fine to
    coarse, the finest at 1/``start_scale``) of ``l_weight`` / 2^i times the
    mean of the per-pixel L2 norm (or of |.| where ``norm`` is "L1") of the
    difference."""

    def __init__(self, start_scale=4, num_scales=5, l_weight=0.32,
                 norm="L2"):
        self.start_scale = start_scale
        self.weights = [l_weight / (2 ** s) for s in range(num_scales)]
        self.norm = norm
        self.div_flow = 0.05

    def __call__(self, outputs: Dict[str, Any],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        target = inputs["flows"][:, 0] * self.div_flow
        loss = 0.0
        for i, pred in enumerate(outputs["flow_preds"]):
            k = self.start_scale * (2 ** i)
            t = F.avg_pool2d(target, k, k)
            if self.norm == "L1":
                loss = loss + self.weights[i] * (pred - t).abs().mean()
            else:
                loss = loss + self.weights[i] * torch.linalg.vector_norm(
                    pred - t, dim=1).mean()
        return loss


def conv(in_planes, out_planes, kernel_size=3, stride=1, padding=1,
         dilation=1):
    return nn.Sequential(
        CastConv2d(in_planes, out_planes, kernel_size, stride=stride,
                   padding=padding, dilation=dilation, bias=True),
        nn.LeakyReLU(0.1))


def predict_flow(in_planes):
    return CastConv2d(in_planes, 2, 3, stride=1, padding=1, bias=True)


def deconv(in_planes, out_planes, kernel_size=4, stride=2, padding=1):
    return CastConvTranspose2d(in_planes, out_planes, kernel_size, stride,
                               padding, bias=True)


def pwc_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``x`` (B, C, H, W) sampled at the grid plus ``flow`` (B, 2, H, W),
    zero where the sample of an all-ones map falls under 0.9999
    (``bilinear_coverage``)."""
    b, _, h, w = x.shape
    coords = coords_grid(b, h, w, dtype=flow.dtype, device=flow.device) + flow
    out = bilinear_sampler(x, coords)
    mask = bilinear_coverage(coords, (h, w), dtype=x.dtype)
    return out * (mask >= 0.9999).to(x.dtype)


class PWCNet(BaseModel):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/pwcnet-things-6a2e540b.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/pwcnet-sintel-533815e5.ckpt",
    }

    def __init__(self, div_flow: float = 20.0, md: int = 4,
                 loss_start_scale: int = 4, loss_num_scales: int = 5,
                 loss_base_weight: float = 0.32, loss_norm: str = "L2",
                 **kwargs):
        super().__init__(
            loss_fn=MultiScaleLoss(loss_start_scale, loss_num_scales,
                                   loss_base_weight, loss_norm),
            output_stride=64, **kwargs)
        self.div_flow = div_flow
        self.md = md
        dims = [(3, 16), (16, 32), (32, 64), (64, 96), (96, 128), (128, 196)]
        for lvl, (cin, cout) in zip("123456", dims):
            if lvl == "6":
                self.conv6aa = conv(cin, cout, stride=2)
                self.conv6a = conv(cout, cout)
                self.conv6b = conv(cout, cout)
            else:
                setattr(self, f"conv{lvl}a", conv(cin, cout, stride=2))
                setattr(self, f"conv{lvl}aa", conv(cout, cout))
                setattr(self, f"conv{lvl}b", conv(cout, cout))
        nd = (2 * md + 1) ** 2
        dd = [128, 256, 352, 416, 448]  # cumulative decoder widths
        for lvl, extra in zip("65432", [0, 128 + 4, 96 + 4, 64 + 4, 32 + 4]):
            od = nd + extra
            setattr(self, f"conv{lvl}_0", conv(od, 128))
            setattr(self, f"conv{lvl}_1", conv(od + dd[0], 128))
            setattr(self, f"conv{lvl}_2", conv(od + dd[1], 96))
            setattr(self, f"conv{lvl}_3", conv(od + dd[2], 64))
            setattr(self, f"conv{lvl}_4", conv(od + dd[3], 32))
            setattr(self, f"predict_flow{lvl}", predict_flow(od + dd[4]))
            if lvl != "2":
                setattr(self, f"deconv{lvl}", deconv(2, 2))
                setattr(self, f"upfeat{lvl}", deconv(od + dd[4], 2))

    def _pyramid(self, im: torch.Tensor) -> List[torch.Tensor]:
        feats, x = [], im
        for lvl in "123456":
            names = (("conv6aa", "conv6a", "conv6b") if lvl == "6" else
                     (f"conv{lvl}a", f"conv{lvl}aa", f"conv{lvl}b"))
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats  # levels 1..6

    def _decode(self, lvl: str, x: torch.Tensor):
        for i in range(5):
            x = torch.cat([getattr(self, f"conv{lvl}_{i}")(x), x], dim=1)
        return x, getattr(self, f"predict_flow{lvl}")(x)

    def _refine(self, x: torch.Tensor, flow2: torch.Tensor) -> torch.Tensor:
        return flow2

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds``, the
        five decoders' flows in units of 1/``div_flow``, 1/4 to 1/64."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=0.0, bgr_mult=1.0, bgr_to_rgb=False,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=False)
        c1 = self._pyramid(images[:, 0])
        c2 = self._pyramid(images[:, 1])

        def corr_act(f1, f2):
            return F.leaky_relu(local_correlation(f1, f2, self.md), 0.1)

        x, flow = self._decode("6", corr_act(c1[5], c2[5]))
        flows = [flow]
        up_flow, up_feat = self.deconv6(flow), self.upfeat6(x)
        for lvl, scale in zip("5432", (0.625, 1.25, 2.5, 5.0)):
            i = int(lvl) - 1
            warp = pwc_warp(c2[i], up_flow * scale)
            x = torch.cat([corr_act(c1[i], warp), c1[i], up_flow, up_feat],
                          dim=1)
            x, flow = self._decode(lvl, x)
            flows.append(flow)
            if lvl != "2":
                up_flow = getattr(self, f"deconv{lvl}")(flow)
                up_feat = getattr(self, f"upfeat{lvl}")(x)
        flows[-1] = self._refine(x, flows[-1])
        h, w = flows[-1].shape[-2:]
        flow_up = interpolate(flows[-1] * self.div_flow, (4 * h, 4 * w),
                              mode="bilinear", align_corners=True)
        flow_up = self.postprocess_predictions(flow_up, resizer, is_flow=True)
        outputs = {"flows": flow_up[:, None]}
        if training:
            outputs["flow_preds"] = flows[::-1]
        return outputs


class PWCDCNet(PWCNet):
    """PWC-Net with the dilated-context refinement of the last flow (the
    variant registered as ``pwcnet``)."""

    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/pwcdcnet-things-cc223701.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/pwcdcnet-sintel-c7d08a46.ckpt",
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        od = (2 * self.md + 1) ** 2 + 32 + 4 + 448
        self.dc_conv1 = conv(od, 128, 3, padding=1, dilation=1)
        self.dc_conv2 = conv(128, 128, 3, padding=2, dilation=2)
        self.dc_conv3 = conv(128, 128, 3, padding=4, dilation=4)
        self.dc_conv4 = conv(128, 96, 3, padding=8, dilation=8)
        self.dc_conv5 = conv(96, 64, 3, padding=16, dilation=16)
        self.dc_conv6 = conv(64, 32, 3, padding=1, dilation=1)
        self.dc_conv7 = predict_flow(32)

    def _refine(self, x: torch.Tensor, flow2: torch.Tensor) -> torch.Tensor:
        for i in range(1, 8):
            x = getattr(self, f"dc_conv{i}")(x)
        return flow2 + x


@register_model
@trainable
@ptlflow_trained
class pwcnet(PWCDCNet):
    pass


@register_model
@trainable
class pwcnet_nodc(PWCNet):
    pass
