"""HD3 (``ptlflow_tpu/models/hd3/hd3.py``), NCHW: hierarchical discrete
distribution decomposition.  From 1/64 to 1/4, each level correlates the
first frame's features with the second's warped by the upsampled flow
(radius 4: 81 cells), decodes a match density over the (2c+1)^2 support
and reads a residual flow from it (``density2vector``: the softmax's
heaviest 2x2 cell and the expectation over its four corners); training
holds the densities to the ground truth's (``vector2density``) by KL
divergence.  ``hd3_ctxt`` decodes its finest level with a dilated context
head.  The encoder is DLA-34 with IDA upsampling, or the ``encoder="vgg"``
option's plain pyramid.  No lookup kernel runs here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm2d, CastConv2d, CastConvTranspose2d
from ...ops.correlation import coords_grid, local_correlation
from ...ops.grid_sample import grid_sample, interpolate
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..base import BaseModel
from .dla import DLAEncoder


def hd3_flow_warp(x: torch.Tensor, flo: torch.Tensor) -> torch.Tensor:
    """``x`` sampled at the grid plus ``flo`` with border padding
    (align_corners=True), zero where a corner of the sample lies outside
    the map (the reference's sampled ones below 0.9999, in closed form)."""
    b, _, h, w = x.shape
    coords = coords_grid(b, h, w, dtype=flo.dtype, device=flo.device) + flo
    grid = torch.stack([2.0 * coords[:, 0] / (w - 1) - 1.0,
                        2.0 * coords[:, 1] / (h - 1) - 1.0], dim=-1)
    out = grid_sample(x, grid, padding_mode="border", align_corners=True)
    mask = ((coords[:, 0] >= 0) & (coords[:, 0] <= w - 1)
            & (coords[:, 1] >= 0) & (coords[:, 1] <= h - 1))
    return out * mask[:, None].to(x.dtype)


def vector2density(vect: torch.Tensor, c: int) -> torch.Tensor:
    """(B, 2, H, W) flows clamped to [-c, c] and scattered bilinearly into
    the (2c+1)^2 support, row-major (y, x): (B, (2c+1)^2, H, W)."""
    d = 2 * c + 1
    flo = vect.clamp(-c, c)
    x, y = flo[:, 0], flo[:, 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1, y0 + 1
    wx0 = x1 - x
    wx1 = (x - x0) * (x1 <= c)
    wy0 = y1 - y
    wy1 = (y - y0) * (y1 <= c)

    def index(t):
        return t.clamp(-c, c).long() + c

    out = torch.zeros(vect.shape[0], d * d, *vect.shape[-2:],
                      dtype=vect.dtype, device=vect.device)
    for yi, xi, wgt in ((y0, x0, wx0 * wy0), (y0, x1, wx1 * wy0),
                        (y1, x0, wx0 * wy1), (y1, x1, wx1 * wy1)):
        out.scatter_add_(1, (index(yi) * d + index(xi))[:, None],
                         wgt[:, None])
    return out


def density2vector(prob: torch.Tensor, normalize: bool = True
                   ) -> torch.Tensor:
    """(B, d^2, H, W) match density logits (or, without ``normalize``,
    probabilities) to (B, 2, H, W) flows in support cells: the 2x2 cell
    of the heaviest sum (the first on a tie), then its right column's x
    less the left corners' share and its bottom row's y less the top
    corners' share."""
    b, ch, h, w = prob.shape
    d = int(math.sqrt(ch))
    if normalize:
        prob = torch.softmax(prob, dim=1)
    grid = prob.view(b, d, d, h, w)
    pooled = (grid[:, :-1, :-1] + grid[:, :-1, 1:] + grid[:, 1:, :-1]
              + grid[:, 1:, 1:])
    idx = torch.argmax(pooled.reshape(b, (d - 1) ** 2, h, w), dim=1,
                       keepdim=True)
    # the top-left corner's index in the d x d support
    idx = idx + idx // (d - 1)
    # the corners by a gather: the JAX package's one-hot masked sums stand
    # in for a per-pixel channel gather on the TPU, which the card does
    # directly
    p_lt, p_rt, p_lb, p_rb = (torch.gather(prob, 1, idx + off)
                              for off in (0, 1, d, d + 1))
    total = p_lt + p_rt + p_lb + p_rb
    p_lt, p_rt, p_lb = p_lt / total, p_rt / total, p_lb / total
    rt_x = ((idx + 1) % d - d // 2).to(prob.dtype)
    lb_y = ((idx + d) // d - d // 2).to(prob.dtype)
    return torch.cat([rt_x - p_lt - p_lb, lb_y - p_lt - p_rt], 1)


def downsample_flow_dense(flo: torch.Tensor, scale_factor: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flow resized by ``scale_factor`` (bilinear, align_corners=True,
    its values unscaled) and a mask of ones."""
    b, _, h, w = flo.shape
    nh, nw = int(h * scale_factor), int(w * scale_factor)
    out = interpolate(flo, (nh, nw), mode="bilinear", align_corners=True)
    return out, torch.ones(b, 1, nh, nw, dtype=flo.dtype, device=flo.device)


class HD3Loss:
    """The KL divergence (``batchmean``) of each level's density from the
    ground truth's residual over the upsampled coarser prediction, in
    support cells; the level's weight is 4^(levels below 1/64's)/(H W)."""

    def __call__(self, outputs, inputs) -> torch.Tensor:
        ds = outputs["downsample"]
        gt = inputs["flows"][:, 0]
        bsz, _, h, w = gt.shape
        kld = 0.0
        for level, prob in enumerate(outputs["ms_prob"]):
            scaled_gt, valid = downsample_flow_dense(gt, 1 / 2 ** (ds - level))
            if level > 0:
                prev = outputs["ms_pred"][level - 1]
                scaled_gt = scaled_gt - interpolate(
                    prev, (2 * prev.shape[-2], 2 * prev.shape[-1]),
                    mode="bilinear", align_corners=True)
            scaled_gt = scaled_gt / 2 ** (ds - level)
            gt_dist = (vector2density(scaled_gt,
                                      outputs["corr_range"][level])
                       * valid).detach()
            logp = F.log_softmax(prob, dim=1)
            tlogt = torch.where(gt_dist > 0, gt_dist * torch.log(
                gt_dist.clamp(min=1e-30)), torch.zeros_like(gt_dist))
            kl = (tlogt - gt_dist * logp).sum() / bsz
            kld = kld + 4.0 ** (ds - level) / (h * w) * kl
        return kld


class PreActBlock(nn.Module):
    def __init__(self, in_planes, planes, stride=1, normalize=True):
        super().__init__()
        self.normalize = normalize
        if normalize:
            self.bn1 = BatchNorm2d(in_planes)
        self.conv1 = CastConv2d(in_planes, planes, 3, stride=stride,
                                padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv2 = CastConv2d(planes, planes, 3, padding=1, bias=False)
        self.shortcut = (nn.Sequential(CastConv2d(in_planes, planes, 1,
                                                  stride=stride, bias=False))
                         if stride != 1 or in_planes != planes else None)

    def forward(self, x):
        out = F.relu(self.bn1(x)) if self.normalize else x
        shortcut = self.shortcut(out) if self.shortcut is not None else x
        out = self.conv2(F.relu(self.bn2(self.conv1(out))))
        return out + shortcut


class ResnetDecoder(nn.Module):
    def __init__(self, inplane, outplane):
        super().__init__()
        self.block1 = PreActBlock(inplane, outplane, normalize=False)
        self.block2 = PreActBlock(outplane, outplane, normalize=True)

    def forward(self, x):
        return self.block2(self.block1(x))


class HDADecoder(nn.Module):
    def __init__(self, inplane, outplane):
        super().__init__()
        self.block1 = PreActBlock(inplane, outplane, normalize=False)
        self.block2 = PreActBlock(outplane, outplane, normalize=True)
        self.root = nn.Sequential(
            BatchNorm2d(outplane * 2), nn.ReLU(),
            CastConv2d(outplane * 2, outplane, 1, bias=False))

    def forward(self, x):
        y1 = self.block1(x)
        return self.root(torch.cat([y1, self.block2(y1)], 1))


class HD3Decoder(nn.Module):
    """The level's mapping block, its density head ``cls`` and (but at
    the finest level) ``up``, the features for the next level."""

    def __init__(self, inplane, block, classes, up_classes):
        super().__init__()
        self.mapping = block(inplane, 128)
        self.cls = nn.Sequential(BatchNorm2d(128), nn.ReLU(),
                                 CastConv2d(128, classes, 1))
        self.up = (nn.Sequential(
            BatchNorm2d(128), nn.ReLU(),
            CastConvTranspose2d(128, up_classes, 4, stride=2, padding=1,
                                bias=False),
            BatchNorm2d(up_classes), nn.ReLU()) if up_classes > 0 else None)

    def forward(self, x):
        out = self.mapping(x)
        return self.cls(out), (self.up(out) if self.up is not None else None)


class HD3ContextHead(nn.Module):
    """``hd3_ctxt``'s finest level: seven dilated convolutions (1, 1, 2, 4,
    8, 16, 1) with BatchNorm, then the density head."""

    def __init__(self, inplane, classes):
        super().__init__()
        ch = [inplane] + [128] * 7
        dilations = [1, 1, 2, 4, 8, 16, 1]
        self.num_convs = 7
        for i in range(self.num_convs):
            setattr(self, f"dc_conv_{i}", nn.Sequential(
                CastConv2d(ch[i], ch[i + 1], 3, padding=dilations[i],
                           dilation=dilations[i], bias=False),
                BatchNorm2d(ch[i + 1]), nn.ReLU()))
        self.cls = CastConv2d(ch[-1], classes, 1)

    def forward(self, x):
        for i in range(self.num_convs):
            x = getattr(self, f"dc_conv_{i}")(x)
        return self.cls(x), None


class VGGBasicBlock(nn.Module):
    """Three 3x3 convolutions with BatchNorm and ReLU, the first of
    stride 2."""

    def __init__(self, in_planes, out_planes):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, out_planes, 3, stride=2,
                                padding=1, bias=False)
        self.bn1 = BatchNorm2d(out_planes)
        self.conv2 = CastConv2d(out_planes, out_planes, 3, padding=1,
                                bias=False)
        self.bn2 = BatchNorm2d(out_planes)
        self.conv3 = CastConv2d(out_planes, out_planes, 3, padding=1,
                                bias=False)
        self.bn3 = BatchNorm2d(out_planes)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return F.relu(self.bn3(self.conv3(x)))


class VGGEncoder(nn.Module):
    """The ``encoder="vgg"`` pyramid, fine to coarse as ``DLAEncoder``."""

    def __init__(self, planes):
        super().__init__()
        self.levels = len(planes)
        in_p = 3
        for i, p in enumerate(planes):
            setattr(self, f"block_{i}", VGGBasicBlock(in_p, p))
            in_p = p

    def forward(self, x):
        outs = []
        for i in range(self.levels):
            x = getattr(self, f"block_{i}")(x)
            outs.append(x)
        return outs


class HD3(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/hd3-chairs-0d46c9fd.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/hd3-things-afcd2eb4.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/hd3-sintel-10689995.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/hd3-kitti-6eb77dd3.ckpt",
    }

    def __init__(self, task: str = "flow", encoder: str = "dlaup",
                 decoder: str = "hda", downsample: int = 6,
                 corr_range: Sequence[int] = (4, 4, 4, 4, 4, 4),
                 context: bool = False, **kwargs):
        super().__init__(output_stride=int(2 ** downsample),
                         loss_fn=HD3Loss(), **kwargs)
        if task != "flow":
            raise ValueError("HD3 is ported for the flow task")
        self.downsample = downsample
        self.corr_range = list(corr_range)[:5]
        self.context = context
        self.levels = len(self.corr_range)
        self.classes = [(2 * d + 1) ** 2 for d in self.corr_range]

        if encoder == "vgg":
            pyr_channels = [16, 32, 64, 96, 128, 196]
            self.encoder = VGGEncoder(pyr_channels)
        else:
            pyr_channels = [16, 32, 64, 128, 256, 512, 512]
            self.encoder = DLAEncoder(pyr_channels)
        dec_block = HDADecoder if decoder == "hda" else ResnetDecoder
        feat_d_offset = pyr_channels[::-1]
        feat_d_offset[0] = 0
        up_d_offset = [0] + self.classes[1:]
        for level in range(self.levels):
            setattr(self, f"cost_bn_{level}", BatchNorm2d(self.classes[level]))
            input_d = (self.classes[level] + feat_d_offset[level]
                       + up_d_offset[level] + 2 * (level > 0))
            up_classes = (self.classes[level + 1]
                          if level < self.levels - 1 else -1)
            if self.context and level == self.levels - 1:
                dec = HD3ContextHead(input_d, self.classes[level])
            else:
                dec = HD3Decoder(input_d, dec_block, self.classes[level],
                                 up_classes=up_classes)
            setattr(self, f"Decoder_{level}", dec)

    def preprocess(self, images: torch.Tensor):
        """ImageNet-normalised BGR, resized by interpolation
        (align_corners=True) to a multiple of 64."""
        return self.preprocess_images(
            images, bgr_add=[-0.485, -0.456, -0.406],
            bgr_mult=[1 / 0.229, 1 / 0.224, 1 / 0.225], bgr_to_rgb=False,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=True)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, Any]:
        """``flows`` (B, 1, 2, H, W); in training also ``ms_prob`` (the
        levels' density logits), ``ms_pred`` (their flows in pixels of
        their own grid), ``corr_range`` and ``downsample``."""
        images, resizer = self.preprocess(inputs["images"])
        bs = images.shape[0]
        feats = self.encoder(torch.cat([images[:, 0], images[:, 1]]))[::-1]
        ms_prob, ms_vect = [], []
        up_vect = up_feat = None
        for level in range(self.levels):
            ref, tar = feats[level][:bs], feats[level][bs:]
            if level > 0:
                tar = hd3_flow_warp(tar, up_vect)
            cost = getattr(self, f"cost_bn_{level}")(
                local_correlation(ref, tar, 4))
            dec_in = (cost if level == 0
                      else torch.cat([cost, ref, up_feat, up_vect], 1))
            prob, up_feat = getattr(self, f"Decoder_{level}")(dec_in)
            vect = density2vector(prob)
            if level > 0:
                vect = vect + up_vect
            ms_prob.append(prob)
            ms_vect.append(vect * 2 ** (self.downsample - level))
            if level < self.levels - 1:
                up_vect = 2 * interpolate(
                    vect, (2 * vect.shape[-2], 2 * vect.shape[-1]),
                    mode="bilinear", align_corners=True)
        last = ms_vect[-1]
        flow = interpolate(last, (4 * last.shape[-2], 4 * last.shape[-1]),
                           mode="bilinear", align_corners=False)
        outputs = {"flows": self.postprocess_predictions(
            flow, resizer, is_flow=True)[:, None]}
        if training:
            outputs.update(ms_prob=ms_prob, ms_pred=ms_vect,
                           corr_range=self.corr_range,
                           downsample=self.downsample)
        return outputs


class HD3Context(HD3):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/hd3_ctxt-chairs-d7448468.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/hd3_ctxt-things-f1681f75.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/hd3_ctxt-sintel-22e655e9.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/hd3_ctxt-kitti-e7d69776.ckpt",
    }

    def __init__(self, context: bool = True, **kwargs):
        super().__init__(context=context, **kwargs)


@register_model
@trainable
@ptlflow_trained
class hd3(HD3):
    pass


@register_model
@trainable
@ptlflow_trained
class hd3_ctxt(HD3Context):
    pass
