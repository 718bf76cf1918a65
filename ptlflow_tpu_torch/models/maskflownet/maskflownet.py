"""MaskFlowNet (``ptlflow_tpu/models/maskflownet/maskflownet.py``), NCHW:
``maskflownet_s``, a PWC-style pyramid from 1/64 to 1/4 whose warp is a
deformable convolution of the second frame's features (the flow repeated
over the nine taps as the offsets), gated by a learned occlusion mask and
completed by features of the upsampled decoder; and ``maskflownet``, that
network followed by a second pyramid over [frame 1, 0] and [frame 2
warped, mask] that correlates both streams at each level.

Quirks that the reference's checkpoints depend on, kept: the flows inside
are (y, x) and flip at the output; the second stage reads image 1's
features at levels 2 and 3 where it means image 2's (``c2s``); the
correlations are the unnormalised local correlation over C, leaky ReLU
after; the mean the input is shifted by is taken over both frames and all
pixels, per channel; ``maskflownet``'s first stage is nested under
``MaskFlownet_S.`` in its ``state_dict``.  No lookup kernel runs here.
"""

from __future__ import annotations

from itertools import accumulate
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, CastConvTranspose2d
from ...ops.correlation import coords_grid, local_correlation
from ...ops.deform_conv import DeformConv2d
from ...ops.grid_sample import bilinear_coverage, bilinear_sampler, interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def conv(cin, cout, kernel_size=3, stride=1, padding=1, dilation=1,
         activation=True) -> nn.Sequential:
    layers = [CastConv2d(cin, cout, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=True)]
    if activation:
        layers.append(nn.LeakyReLU(0.1))
    return nn.Sequential(*layers)


def predict_flow(cin: int) -> nn.Module:
    return CastConv2d(cin, 2, 3, 1, 1, bias=True)


def predict_mask(cin: int) -> nn.Module:
    return CastConv2d(cin, 1, 3, 1, 1, bias=True)


def deconv(cin: int, cout: int) -> nn.Module:
    return CastConvTranspose2d(cin, cout, 4, 2, 1, bias=True)


def _upsample_kernel2d(w: int, like: torch.Tensor) -> torch.Tensor:
    """The (w, w) triangular kernel, built on ``like``'s device (no host
    copy a call)."""
    c = w // 2
    i = torch.arange(w, dtype=torch.float32, device=like.device)
    k = 1 - (c - i).abs() / (c + 1)
    return (k[:, None] * k[None, :]).to(like.dtype)


def _downsample_kernel2d(factor: int, like: torch.Tensor) -> torch.Tensor:
    # the JAX package builds this kernel twice and uses the second build,
    # the reference's ((w + 1) - |w - arange(2w + 1)|) / (2w + 1)
    w = factor // 2
    i = torch.arange(2 * w + 1, dtype=torch.float32, device=like.device)
    k = ((w + 1) - (w - i).abs()) / (2 * w + 1)
    return (k[:, None] * k[None, :]).to(like.dtype)


def mfn_upsample(img: torch.Tensor, factor: int) -> torch.Tensor:
    """The reference's triangular-kernel upsampling: an edge pad of one
    pixel on the bottom and right, a channel-wise transposed convolution
    of stride ``factor`` with the (2 factor - 1)^2 triangular kernel, and
    the last row and column cropped."""
    if factor == 1:
        return img
    c = img.shape[1]
    x = F.pad(img, (0, 1, 0, 1), mode="replicate")
    kernel = _upsample_kernel2d(2 * factor - 1, img)
    kernel = kernel.expand(c, 1, *kernel.shape)
    out = F.conv_transpose2d(x, kernel, stride=factor, padding=factor - 1,
                             groups=c)
    return out[..., :-1, :-1]


def mfn_downsample(img: torch.Tensor, factor: int) -> torch.Tensor:
    """The reference's normalised triangular-kernel downsampling: a
    channel-wise convolution of stride ``factor`` over the zero-padded
    map, divided by the kernel's weight inside the map."""
    if factor == 1:
        return img
    c = img.shape[1]
    k = _downsample_kernel2d(factor, img)
    pad = factor // 2
    num = F.conv2d(img, k.expand(c, 1, *k.shape), stride=factor,
                   padding=pad, groups=c)
    den = F.conv2d(torch.ones_like(img[:, :1]), k[None, None], stride=factor,
                   padding=pad)
    return num / den


def mfn_warp(x: torch.Tensor, flow_yx: torch.Tensor,
             clamp: bool = False) -> torch.Tensor:
    """``x`` sampled at the grid plus a (y, x) flow, with the normalised
    coordinates optionally clamped to [-1.1, 1.1]; zero where the sampled
    ones would fall below 0.9999 (``bilinear_coverage``, in closed
    form)."""
    b, _, h, w = flow_yx.shape
    coords = coords_grid(b, h, w, dtype=flow_yx.dtype,
                         device=flow_yx.device) + flow_yx.flip(1)
    if clamp:
        norm = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0],
                            dtype=coords.dtype,
                            device=coords.device)[:, None, None]
        coords = ((coords / norm - 1.0).clamp(-1.1, 1.1) + 1.0) * norm
    out = bilinear_sampler(x, coords)
    mask = bilinear_coverage(coords, (h, w), dtype=x.dtype)
    return out * (mask >= 0.9999).to(x.dtype)


class EpeLossWithMask:
    def __init__(self, eps: float = 1e-8, q: Optional[float] = None):
        self.eps = eps
        self.q = q

    def __call__(self, pred, label, mask) -> torch.Tensor:
        """(B,) masked mean EPE of (B, 2, H, W) flows, mask (B, 1, H, W)."""
        if self.q is not None:
            loss = ((pred - label).abs().sum(1) + self.eps) ** self.q
        else:
            loss = torch.sqrt(((pred - label) ** 2).sum(1) + self.eps)
        loss = loss * mask[:, 0]
        b = loss.shape[0]
        return loss.reshape(b, -1).sum(1) / torch.clamp(
            mask.reshape(b, -1).sum(1), min=1e-8)


class MultiscaleEpe:
    """The weighted sum over the five levels of ``EpeLossWithMask``, the
    prediction upsampled to the ground truth's size (or the ground truth
    and its mask downsampled to the prediction's), averaged over the
    batch."""

    def __init__(self, scales, weights, match, eps=1e-8, q=None):
        self.scales = scales
        self.weights = weights
        self.match = match
        self.epe = EpeLossWithMask(eps=eps, q=q)

    def __call__(self, outputs, inputs) -> torch.Tensor:
        flow = inputs["flows"][:, 0]
        mask = inputs["valids"][:, 0]
        losses = 0
        for p, w, s in zip(outputs["flow_preds"], self.weights, self.scales):
            if self.match == "upsampling":
                losses = losses + w * self.epe(mfn_upsample(p, s), flow, mask)
            elif self.match == "downsampling":
                losses = losses + w * self.epe(p, mfn_downsample(flow, s),
                                               mfn_downsample(mask, s))
            else:
                raise NotImplementedError(self.match)
        return losses.mean()


def _decoder(model: nn.Module, nd: int, extras: Dict[str, int],
             masks: bool) -> None:
    """The five dense decoders (``conv{lvl}_0..4``), their flow heads, and
    (but at level 2) their mask heads where ``masks`` and the transposed
    convolutions to the next level's features (``upfeat{lvl - 1}``)."""
    dd = list(accumulate([128, 128, 96, 64, 32]))
    for lvl, extra in extras.items():
        od = nd + extra
        setattr(model, f"conv{lvl}_0", conv(od, 128))
        setattr(model, f"conv{lvl}_1", conv(od + dd[0], 128))
        setattr(model, f"conv{lvl}_2", conv(od + dd[1], 96))
        setattr(model, f"conv{lvl}_3", conv(od + dd[2], 64))
        setattr(model, f"conv{lvl}_4", conv(od + dd[3], 32))
        setattr(model, f"pred_flow{lvl}", predict_flow(od + dd[4]))
        if lvl != "2":
            if masks:
                setattr(model, f"pred_mask{lvl}", predict_mask(od + dd[4]))
            setattr(model, f"upfeat{int(lvl) - 1}", deconv(od + dd[4], 16))


def _dilated_context(model: nn.Module, cin: int) -> None:
    model.dc_conv1 = conv(cin, 128, padding=1, dilation=1)
    model.dc_conv2 = conv(128, 128, padding=2, dilation=2)
    model.dc_conv3 = conv(128, 128, padding=4, dilation=4)
    model.dc_conv4 = conv(128, 96, padding=8, dilation=8)
    model.dc_conv5 = conv(96, 64, padding=16, dilation=16)
    model.dc_conv6 = conv(64, 32, padding=1, dilation=1)
    model.dc_conv7 = predict_flow(32)


class _Pyramid(BaseModel):
    """What both networks share: the six-stage feature extractor of each
    stream (``conv{i}{a,b,c}``, or ``{x,y,z}``), the dense decoders, the
    correlation and the dilated context network."""

    feature_names = ("a", "b", "c")

    def _features(self, images: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        x = images
        for i in range(1, 7):
            for s in self.feature_names:
                x = getattr(self, f"conv{i}{s}")(x)
            feats.append(x)
        return feats

    def _corr(self, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
        return lrelu(local_correlation(f1, f2, self.md))

    def _decode(self, lvl: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(5):
            x = torch.cat([getattr(self, f"conv{lvl}_{i}")(x), x], 1)
        return x

    def _context(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dc_conv4(self.dc_conv3(self.dc_conv2(self.dc_conv1(x))))
        return self.dc_conv7(self.dc_conv6(self.dc_conv5(y)))

    def preprocess(self, images: torch.Tensor):
        """Less the per-channel mean over the frames and pixels, RGB,
        resized by interpolation to a multiple of 64."""
        bgr_mean = images.mean(dim=(1, 3, 4), keepdim=True)
        return self.preprocess_images(
            images, bgr_add=-bgr_mean, bgr_mult=1.0, bgr_to_rgb=True,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=False)


class MaskFlownet_S(_Pyramid):
    pretrained_checkpoints = {
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/maskflownet_s-sintel-79196ff3.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/maskflownet_s-things-a8a8ed9e.ckpt",
    }

    def __init__(self, div_flow: float = 20.0, md: int = 4,
                 flow_multiplier: float = 1.0, deform_bias: bool = True,
                 strides: Sequence[int] = (64, 32, 16, 8, 4),
                 upfeat_ch: Sequence[int] = (16, 16, 16, 16),
                 loss_weights: Sequence[float] = (0.005, 0.01, 0.02, 0.08,
                                                  0.32),
                 loss_match: str = "upsampling", loss_eps: float = 1e-8,
                 loss_q: Optional[float] = None, **kwargs):
        super().__init__(
            loss_fn=MultiscaleEpe(strides, loss_weights, loss_match,
                                  loss_eps, loss_q),
            output_stride=64, **kwargs)
        self.div_flow = div_flow
        self.md = md
        self.strides = strides
        self.scale = div_flow * flow_multiplier

        dims = [(3, 16), (16, 32), (32, 64), (64, 96), (96, 128), (128, 196)]
        for i, (cin, cout) in enumerate(dims, start=1):
            setattr(self, f"conv{i}a", conv(cin, cout, stride=2))
            setattr(self, f"conv{i}b", conv(cout, cout))
            setattr(self, f"conv{i}c", conv(cout, cout))
        nd = (2 * md + 1) ** 2
        _decoder(self, nd, {"6": 0, "5": 128 + 18, "4": 96 + 18,
                            "3": 64 + 18, "2": 32 + 18}, masks=True)
        _dilated_context(self, nd + 32 + 18 + 448)
        for lvl, c in (("5", 128), ("4", 96), ("3", 64), ("2", 32)):
            setattr(self, f"deform{lvl}", DeformConv2d(c, c))
            setattr(self, f"conv{lvl}f", conv(16, c, activation=False))

    def stage(self, images: torch.Tensor) -> Dict[str, Any]:
        """The network on preprocessed (B, 2, 3, H, W) images: its five
        flows (in (y, x), units of 1/``scale``, 1/64 to 1/4), the level-2
        mask logits, and the second stage's inputs ``srcs``: image 1's and
        (with the ``c2s`` quirk) image 2's features, the flows, [image 1,
        0] and [image 2 warped, the mask less 0.5]."""
        b = images.shape[0]
        im1, im2 = images[:, 0], images[:, 1]
        feats = self._features(torch.cat([im1, im2]))
        c1 = [f[:b] for f in feats]
        c2 = [f[b:] for f in feats]

        x = self._decode("6", self._corr(c1[5], c2[5]))
        flow = self.pred_flow6(x)
        mask = self.pred_mask6(x)
        flows = [flow]
        for lvl, stride in zip(("5", "4", "3", "2"), self.strides[1:]):
            idx = int(lvl) - 1
            feat = lrelu(getattr(self, f"upfeat{lvl}")(x))
            flow = mfn_upsample(flow, 2)
            mask = mfn_upsample(mask, 2)
            off = (flow * (self.scale / stride)).repeat(1, 9, 1, 1)
            warp = getattr(self, f"deform{lvl}")(c2[idx], off)
            warp = lrelu(warp * torch.sigmoid(mask)
                         + getattr(self, f"conv{lvl}f")(feat))
            x = torch.cat([self._corr(c1[idx], warp), c1[idx], feat, flow], 1)
            x = self._decode(lvl, x)
            flow = flow + getattr(self, f"pred_flow{lvl}")(x)
            if lvl != "2":
                mask = getattr(self, f"pred_mask{lvl}")(x)
            flows.append(flow)
        flows[-1] = flows[-1] + self._context(x)

        # the level-2 mask was predicted at level 3 and upsampled
        mask0 = torch.sigmoid(mfn_upsample(mask, 4)) - 0.5
        c30 = torch.cat([im1, torch.zeros_like(mask0)], 1)
        warped_im2 = mfn_warp(im2, mfn_upsample(flows[-1], 4) * self.scale)
        c40 = torch.cat([warped_im2, mask0], 1)
        # the reference's quirk: image 1's features at levels 2 and 3
        c2s = [c2[0], c1[1], c1[2], c2[3], c2[4], c2[5]]
        return {"flows": flows, "mask": mask,
                "srcs": (c1, c2s, flows, c30, c40)}

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W) and ``occs`` (B, 1, 1, H, W); in
        training also ``flow_preds`` (the five levels' (x, y) flows in
        pixels of the input, 1/64 to 1/4) and ``occ_preds``."""
        images, resizer = self.preprocess(inputs["images"])
        res = self.stage(images)
        preds = [f.flip(1) * self.scale for f in res["flows"]]
        occ2 = 1 - torch.sigmoid(res["mask"])
        size = images.shape[-2:]
        flow_up = interpolate(preds[-1], size, mode="bilinear",
                              align_corners=True)
        occ_up = interpolate(occ2, size, mode="bilinear", align_corners=True)
        outputs = {
            "flows": self.postprocess_predictions(flow_up, resizer,
                                                  is_flow=True)[:, None],
            "occs": self.postprocess_predictions(occ_up, resizer,
                                                 is_flow=False)[:, None]}
        if training:
            outputs["flow_preds"] = preds
            outputs["occ_preds"] = [occ2]
        return outputs


class MaskFlownet(_Pyramid):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/maskflownet-kitti-d2ccb09b.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/maskflownet-sintel-c52423aa.ckpt",
    }
    feature_names = ("x", "y", "z")

    def __init__(self, div_flow: float = 20.0, md: int = 4, md2: int = 2,
                 flow_multiplier: float = 1.0, deform_bias: bool = True,
                 strides: Sequence[int] = (64, 32, 16, 8, 4),
                 upfeat_ch: Sequence[int] = (16, 16, 16, 16),
                 loss_weights: Sequence[float] = (0.005, 0.01, 0.02, 0.08,
                                                  0.32),
                 loss_match: str = "upsampling", loss_eps: float = 1e-8,
                 loss_q: Optional[float] = None, **kwargs):
        super().__init__(
            loss_fn=MultiscaleEpe(strides, loss_weights, loss_match,
                                  loss_eps, loss_q),
            output_stride=64, **kwargs)
        self.div_flow = div_flow
        self.md = md2
        self.strides = strides
        self.scale = div_flow * flow_multiplier
        self.MaskFlownet_S = MaskFlownet_S(
            div_flow=div_flow, md=md, flow_multiplier=flow_multiplier,
            strides=strides, upfeat_ch=upfeat_ch)

        dims = [(4, 16), (16, 32), (32, 64), (64, 96), (96, 128), (128, 196)]
        for i, (cin, cout) in enumerate(dims, start=1):
            setattr(self, f"conv{i}x", conv(cin, cout, stride=2))
            setattr(self, f"conv{i}y", conv(cout, cout))
            setattr(self, f"conv{i}z", conv(cout, cout))
        nd = (2 * md2 + 1) ** 2
        _decoder(self, nd, {"6": nd + 2, "5": nd + 128 + 20,
                            "4": nd + 96 + 20, "3": nd + 64 + 20,
                            "2": nd + 32 + 20}, masks=False)
        _dilated_context(self, 2 * nd + 32 + 20 + 448)
        for lvl, c in (("6", 196), ("5", 128), ("4", 96), ("3", 64),
                       ("2", 32)):
            setattr(self, f"deform{lvl}", DeformConv2d(c, c))

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds``, the
        second stage's five (x, y) flows in pixels of the input, 1/64 to
        1/4."""
        images, resizer = self.preprocess(inputs["images"])
        c1, c2, flows_s, c30, c40 = self.MaskFlownet_S.stage(images)["srcs"]
        b = images.shape[0]
        feats = self._features(torch.cat([c30, c40]))
        c3 = [f[:b] for f in feats]
        c4 = [f[b:] for f in feats]

        flow = flows_s[0]
        preds = []
        x = None
        for i, lvl in enumerate(("6", "5", "4", "3", "2")):
            idx = int(lvl) - 1
            if lvl != "6":
                feat = lrelu(getattr(self, f"upfeat{lvl}")(x))
                flow = mfn_upsample(flow, 2)
            off = (flow * (self.scale / self.strides[i])).repeat(1, 9, 1, 1)
            warp_u = lrelu(getattr(self, f"deform{lvl}")(c2[idx], off))
            corr_u = self._corr(c1[idx], warp_u)
            corr_v = self._corr(c3[idx], c4[idx])
            if lvl == "6":
                x = torch.cat([corr_u, corr_v, flow], 1)
            else:
                x = torch.cat([c1[idx], feat, corr_u, corr_v, flow,
                               flows_s[i]], 1)
            x = self._decode(lvl, x)
            flow = flow + getattr(self, f"pred_flow{lvl}")(x)
            preds.append(flow)
        preds[-1] = preds[-1] + self._context(x)

        preds = [f.flip(1) * self.scale for f in preds]
        flow_up = interpolate(preds[-1], images.shape[-2:], mode="bilinear",
                              align_corners=False)
        outputs = {"flows": self.postprocess_predictions(
            flow_up, resizer, is_flow=True)[:, None]}
        if training:
            outputs["flow_preds"] = preds
        return outputs


@register_model
@trainable
class maskflownet_s(MaskFlownet_S):
    pass


@register_model
@trainable
class maskflownet(MaskFlownet):
    pass
