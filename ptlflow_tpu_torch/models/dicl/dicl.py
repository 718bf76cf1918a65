"""DICL, displacement-invariant cost learning
(``ptlflow_tpu/models/dicl/dicl.py``), NCHW.  A GANet-style double U-Net
gives features from 1/4 to 1/64; at each level, coarse to fine, the 49
displacements of a 7x7 window each pair the first frame's features with
the second's moved by that displacement (the second frame warped by the
upsampled flow first), and one matching network shared by the
displacements scores every pair: the displacements are folded into the
batch.  A displacement-aware 1x1 projection mixes the 49 scores, a soft
argmax reads the flow, and a dilated context network refines it from the
flow, the scores' entropy, the features and the image.

The shifted pairs come from one zero pad of the second frame's features
and 49 slices of it (no strided views); pixels whose shifted features sum
to 0 (outside the map, or a warp's hole) are zeroed in both halves.  No
lookup kernel runs here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import (BatchNorm2d, CastConv2d, CastConvTranspose2d,
                   at_least_float32)
from ...ops.correlation import coords_grid
from ...ops.grid_sample import bilinear_coverage, bilinear_sampler, interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel


class BasicConv(nn.Module):
    """A convolution (transposed where ``deconv``) without bias, then
    optionally BatchNorm and ReLU."""

    def __init__(self, in_channels, out_channels, deconv=False, bn=True,
                 relu=True, **kwargs):
        super().__init__()
        self.use_relu = relu
        if bn:
            self.bn = BatchNorm2d(out_channels)
        else:
            self.bn = None
        cls = CastConvTranspose2d if deconv else CastConv2d
        self.conv = cls(in_channels, out_channels, bias=False, **kwargs)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.use_relu else x


class Conv2x(nn.Module):
    """A stride-2 convolution (or 4x4 transposed one), the skip ``rem``
    concatenated (or added), then a 3x3 ``BasicConv``."""

    def __init__(self, in_channels, out_channels, deconv=False, concat=True,
                 bn=True, relu=True):
        super().__init__()
        self.concat = concat
        kernel = 4 if deconv else 3
        self.conv1 = BasicConv(in_channels, out_channels, deconv, bn=False,
                               relu=True, kernel_size=kernel, stride=2,
                               padding=1)
        self.conv2 = BasicConv(out_channels * (2 if concat else 1),
                               out_channels, False, bn, relu, kernel_size=3,
                               stride=1, padding=1)

    def forward(self, x, rem):
        x = self.conv1(x)
        x = torch.cat([x, rem], 1) if self.concat else x + rem
        return self.conv2(x)


class FeatureGA(nn.Module):
    """GANet's double U-Net: (1/4, 1/8, 1/16, 1/32, 1/64) maps of 32
    channels."""

    def __init__(self):
        super().__init__()
        self.conv_start = nn.Sequential(
            BasicConv(3, 32, kernel_size=3, padding=1),
            BasicConv(32, 32, kernel_size=3, stride=2, padding=1),
            BasicConv(32, 32, kernel_size=3, padding=1))
        down = [(32, 48), (48, 64), (64, 96), (96, 128), (128, 160),
                (160, 192)]
        for i, (cin, cout) in enumerate(down, start=1):
            setattr(self, f"conv{i}a", BasicConv(cin, cout, kernel_size=3,
                                                 stride=2, padding=1))
        for i, (cout, cin) in reversed(list(enumerate(down, start=1))):
            setattr(self, f"deconv{i}a", Conv2x(cin, cout, deconv=True))
        for i, (cin, cout) in enumerate(down, start=1):
            setattr(self, f"conv{i}b", Conv2x(cin, cout))
        for i in range(6, 1, -1):
            cout, cin = down[i - 1]
            setattr(self, f"deconv{i}b", Conv2x(cin, cout, deconv=True))
            setattr(self, f"outconv_{i}", BasicConv(cout, 32, kernel_size=3,
                                                    padding=1))

    def forward(self, x):
        x = self.conv_start(x)
        rem = [x]
        for i in range(1, 7):
            x = getattr(self, f"conv{i}a")(x)
            rem.append(x)
        for i in range(6, 0, -1):
            x = getattr(self, f"deconv{i}a")(x, rem[i - 1])
            rem[i - 1] = x
        for i in range(1, 7):
            x = getattr(self, f"conv{i}b")(x, rem[i])
            rem[i] = x
        outs = []
        for i in range(6, 1, -1):
            x = getattr(self, f"deconv{i}b")(x, rem[i - 1])
            outs.append(getattr(self, f"outconv_{i}")(x))
        return outs[::-1]  # 1/4 to 1/64


class DICLMatch(nn.Module):
    """The matching network shared by a level's displacements: (N, 64, H,
    W) pairs to (N, 1, H, W) scores."""

    def __init__(self):
        super().__init__()
        self.match = nn.Sequential(
            BasicConv(64, 96, kernel_size=3, padding=1, dilation=1),
            BasicConv(96, 128, kernel_size=3, stride=2, padding=1),
            BasicConv(128, 128, kernel_size=3, padding=1, dilation=1),
            BasicConv(128, 64, kernel_size=3, padding=1, dilation=1),
            BasicConv(64, 32, kernel_size=4, padding=1, stride=2,
                      deconv=True),
            CastConv2d(32, 1, kernel_size=3, stride=1, padding=1, bias=True))

    def forward(self, x):
        return self.match(x)


def flow_entropy(cost: torch.Tensor) -> torch.Tensor:
    """(B, U, V, H, W) scores to the (B, 1, H, W) entropy of their softmax
    (in at least float32) over the U V displacements, over log(U V)."""
    b, u, v, h, w = cost.shape
    x = torch.softmax(at_least_float32(cost.reshape(b, u * v, h, w)), dim=1)
    ent = -(x * torch.log(x.clamp(1e-9, 1 - 1e-9))).sum(1, keepdim=True)
    return (ent / math.log(u * v)).to(cost.dtype)


def flow_regression(cost: torch.Tensor, max_u: int, max_v: int,
                    by_max: bool = True) -> torch.Tensor:
    """The soft argmax (in at least float32) of (B, U, V, H, W) scores
    over the displacements: (B, 2, H, W) flows, x from U and y from V."""
    b, su, sv, h, w = cost.shape
    x = at_least_float32(cost.reshape(b, su * sv, h, w))
    prob = torch.softmax(x if by_max else -x, dim=1)
    du = torch.arange(-max_u, max_u + 1, dtype=x.dtype,
                      device=cost.device).repeat_interleave(sv)
    dv = torch.arange(-max_v, max_v + 1, dtype=x.dtype,
                      device=cost.device).repeat(su)
    flow = torch.stack([torch.einsum("bkhw,k->bhw", prob, du),
                        torch.einsum("bkhw,k->bhw", prob, dv)], 1)
    return flow.to(cost.dtype)


class IdentityConv(CastConv2d):
    """DAP's 1x1 projection; its seeded init is the identity, as the
    reference's and the JAX package's."""

    def init_own_params(self, gen: torch.Generator) -> None:
        self.weight.copy_(torch.eye(self.out_channels)[:, :, None, None])


class DAP(nn.Module):
    """The displacement-aware projection: a 1x1 convolution over the U V
    scores (or, ``dap_by_temperature``, one temperature a pixel)."""

    def __init__(self, md=3, dap_by_temperature=False):
        super().__init__()
        self.dap_by_temperature = dap_by_temperature
        dim_c = (2 * md + 1) ** 2
        self.dap_layer = BasicConv(dim_c, 1 if dap_by_temperature else dim_c,
                                   bn=False, relu=False, kernel_size=1,
                                   padding=0, stride=1)
        if not dap_by_temperature:
            self.dap_layer.conv = IdentityConv(dim_c, dim_c, 1, bias=False)

    def forward(self, cost):
        b, u, v, h, w = cost.shape
        x = cost.reshape(b, u * v, h, w)
        if self.dap_by_temperature:
            x = x * (self.dap_layer(x) + 1e-6)
        else:
            x = self.dap_layer(x)
        return x.reshape(b, u, v, h, w)


def dicl_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``x`` sampled at the grid plus ``flow``, zero where the sampled
    ones would fall below 0.9999 (``bilinear_coverage``)."""
    b, _, h, w = x.shape
    coords = coords_grid(b, h, w, dtype=flow.dtype, device=flow.device) + flow
    out = bilinear_sampler(x, coords)
    mask = bilinear_coverage(coords, (h, w), dtype=x.dtype)
    return out * (mask >= 0.9999).to(x.dtype)


class MultiScaleUP:
    """The weighted mean over the levels of the mean L1 (or L2, or
    robust) distance of each flow, upsampled to the ground truth and
    scaled by the ratio of sizes, from the ground truth."""

    def __init__(self, loss_type="L1", weight=(1.0, 0.75, 0.50, 0.25, 0.25)):
        self.loss_type = loss_type
        self.weight = weight

    def __call__(self, outputs, inputs) -> torch.Tensor:
        target = inputs["flows"][:, 0]
        h, w = target.shape[-2:]
        total = 0.0
        preds = outputs["flow_preds"]
        for i, cur in enumerate(preds):
            ch, cw = cur.shape[-2:]
            real = interpolate(cur, (h, w), mode="bilinear",
                               align_corners=True)
            real = real * torch.tensor([w / cw, h / ch], dtype=real.dtype,
                                       device=real.device)[:, None, None]
            if self.loss_type == "L2":
                lv = torch.linalg.vector_norm(real - target, dim=1)
            elif self.loss_type == "robust":
                lv = ((real - target).abs().sum(1) + 1e-8) ** 0.4
            else:
                lv = (real - target).abs().sum(1)
            total = total + lv.mean() * self.weight[i]
        return total / len(preds)


class DICL(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dicl-chairs-fdc24e2f.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dicl-kitti-4813ccab.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dicl-sintel-fa9fc259.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dicl-things-20bc573d.ckpt",
    }

    def __init__(self, ctf_context: bool = True,
                 dap_by_temperature: bool = False, dap_layer: bool = True,
                 flow_reg_by_max: bool = True,
                 remove_warp_hole: bool = True,
                 scale_context: Sequence[float] = (0.03125, 0.0625, 0.125,
                                                   0.25, 0.5),
                 search_range: Sequence[int] = (3, 3, 3, 3, 3),
                 loss_type: str = "L1",
                 loss_weight: Sequence[float] = (1.0, 0.75, 0.50, 0.25,
                                                 0.25),
                 **kwargs):
        super().__init__(loss_fn=MultiScaleUP(loss_type, loss_weight),
                         output_stride=128, **kwargs)
        self.ctf_context = ctf_context
        self.flow_reg_by_max = flow_reg_by_max
        self.remove_warp_hole = remove_warp_hole
        self.scale_context = scale_context
        self.search_range = search_range
        self.use_dap = dap_layer
        self.feature = FeatureGA()
        if dap_layer:
            for lvl in range(2, 7):
                setattr(self, f"dap_layer{lvl}",
                        DAP(md=search_range[lvl - 2],
                            dap_by_temperature=dap_by_temperature))
        for lvl in range(2, 7):
            setattr(self, f"matching{lvl}", DICLMatch())

        def ctx_net(dims_dils):
            return nn.Sequential(
                *[BasicConv(i, o, kernel_size=3, padding=d, dilation=d)
                  for i, o, d in dims_dils],
                CastConv2d(32, 2, kernel_size=3, stride=1, padding=1,
                           bias=True))

        if ctf_context:
            full = [(38, 64, 1), (64, 128, 2), (128, 128, 4), (128, 96, 8),
                    (96, 64, 16), (64, 32, 1)]
            self.context_net2 = ctx_net(full)
            self.context_net3 = ctx_net(full)
            self.context_net4 = ctx_net([(38, 64, 1), (64, 128, 2),
                                         (128, 128, 4), (128, 64, 8),
                                         (64, 32, 1)])
            self.context_net5 = ctx_net([(38, 64, 1), (64, 128, 2),
                                         (128, 64, 4), (64, 32, 1)])
            self.context_net6 = ctx_net([(38, 64, 1), (64, 64, 2),
                                         (64, 32, 1)])

    def compute_cost(self, x: torch.Tensor, y: torch.Tensor, matchnet,
                     max_u: int, max_v: int) -> torch.Tensor:
        """The (B, U, V, H, W) scores of the U V = (2 max_u + 1)(2 max_v +
        1) pairs [x, y moved by (u, v)] (x displacement outer), both halves
        zero where y's moved features fall outside the map (and, with
        ``remove_warp_hole``, where they sum to 0), through ``matchnet``
        with the displacements folded into the batch."""
        b, c, h, w = x.shape
        su, sv = 2 * max_u + 1, 2 * max_v + 1
        yp = F.pad(y, (max_u, max_u, max_v, max_v))
        ys = torch.stack([yp[:, :, j:j + h, i:i + w]
                          for i in range(su) for j in range(sv)], 1)
        if self.remove_warp_hole:
            valid = ys.sum(2, keepdim=True) != 0
        else:
            ones = F.pad(x.new_ones(1, 1, h, w),
                         (max_u, max_u, max_v, max_v))
            valid = torch.stack([ones[:, :, j:j + h, i:i + w]
                                 for i in range(su) for j in range(sv)],
                                1) != 0
        valid = valid.to(x.dtype)
        cost = torch.cat([x[:, None] * valid, ys * valid], 2)
        cost = matchnet(cost.reshape(b * su * sv, 2 * c, h, w))
        return cost.reshape(b, su, sv, h, w)

    def _level(self, lvl: int, x_feat, y_feat, img_small, up_flow):
        sr = self.search_range[lvl - 2]
        if up_flow is not None:
            y_feat = dicl_warp(y_feat, up_flow)
        cost = self.compute_cost(x_feat, y_feat,
                                 getattr(self, f"matching{lvl}"), sr, sr)
        if self.use_dap:
            cost = getattr(self, f"dap_layer{lvl}")(cost)
        flow = flow_regression(cost, sr, sr, self.flow_reg_by_max)
        if up_flow is not None:
            flow = flow + up_flow
        if self.ctf_context:
            feat = torch.cat([flow.detach(), flow_entropy(cost).detach(),
                              x_feat, img_small], 1)
            ctx = getattr(self, f"context_net{lvl}")(feat)
            flow = flow + ctx * self.scale_context[6 - lvl]
        return flow

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds``, the
        levels' flows in pixels of their own grid, 1/4 to 1/64."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=False)
        x_img, y_img = images[:, 0], images[:, 1]
        h, w = x_img.shape[-2:]
        # one call a frame: in training the BatchNorms take each frame's
        # statistics and move twice, as the JAX package's do
        x_feats = self.feature(x_img)
        y_feats = self.feature(y_img)
        flows = {}
        up_flow = None
        for lvl in (6, 5, 4, 3, 2):
            img_small = interpolate(x_img, (h // 2 ** lvl, w // 2 ** lvl),
                                    mode="bilinear", align_corners=True)
            flow = self._level(lvl, x_feats[lvl - 2], y_feats[lvl - 2],
                               img_small, up_flow)
            flows[lvl] = flow
            if lvl > 2:
                up_flow = 2.0 * interpolate(
                    flow, x_feats[lvl - 3].shape[-2:], mode="bilinear",
                    align_corners=True).detach()
        flow2 = flows[2]
        fh, fw = flow2.shape[-2:]
        out = interpolate(flow2, (h, w), mode="bilinear", align_corners=True)
        out = out * torch.tensor([w / fw, h / fh], dtype=out.dtype,
                                 device=out.device)[:, None, None]
        outputs = {"flows": self.postprocess_predictions(
            out, resizer, is_flow=True)[:, None]}
        if training:
            outputs["flow_preds"] = [flows[i] for i in (2, 3, 4, 5, 6)]
        return outputs


@register_model
@trainable
class dicl(DICL):
    pass
