"""FlowNet (``ptlflow_tpu/models/flownet/flownet.py``), NCHW: the
encoder-decoders S (stacked frames), C (two shared trunks and a dilated
21x21 correlation) and SD (small strides, intermediate convolutions), the
fusion network, and the stacks CS, CSS and FlowNet2, which chain them
through the backward warp of the second frame and its brightness error.

Each frame is mean-subtracted per channel and resized by interpolation
(``align_corners=True``) to a multiple of 64; the stacks preprocess once
and hand the resized frames to their sub-networks.  SD's output is divided
by ``div_flow`` where the others are multiplied by it, and FlowNet2 divides
SD's flow by ``div_flow`` once more, as the reference does.  The
correlation is ``ops.local_correlation`` (radius 10, dilation 2) over C;
no lookup kernel runs here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm2d, CastConv2d, CastConvTranspose2d
from ...ops.correlation import local_correlation
from ...ops.grid_sample import interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..pwcnet.pwcnet import MultiScaleLoss, pwc_warp


def conv(batch_norm, in_planes, out_planes, kernel_size=3, stride=1):
    pad = (kernel_size - 1) // 2
    layers = [CastConv2d(in_planes, out_planes, kernel_size, stride=stride,
                         padding=pad, bias=not batch_norm)]
    if batch_norm:
        layers.append(BatchNorm2d(out_planes))
    return nn.Sequential(*layers, nn.LeakyReLU(0.1))


def i_conv(batch_norm, in_planes, out_planes, kernel_size=3, stride=1,
           bias=True):
    pad = (kernel_size - 1) // 2
    layers = [CastConv2d(in_planes, out_planes, kernel_size, stride=stride,
                         padding=pad, bias=bias)]
    if batch_norm:
        layers.append(BatchNorm2d(out_planes))
    return nn.Sequential(*layers)


def predict_flow(in_planes):
    return CastConv2d(in_planes, 2, 3, stride=1, padding=1, bias=True)


def deconv(in_planes, out_planes):
    return nn.Sequential(
        CastConvTranspose2d(in_planes, out_planes, 4, 2, 1, bias=True),
        nn.LeakyReLU(0.1))


def upsample_flow(bias=True):
    return CastConvTranspose2d(2, 2, 4, 2, 1, bias=bias)


def stack_frames(images: torch.Tensor) -> torch.Tensor:
    """(B, N, C, H, W) -> (B, N * C, H, W), frame-major channels."""
    b, n, c, h, w = images.shape
    return images.reshape(b, n * c, h, w)


class FlowNetBase(BaseModel):
    def __init__(self, div_flow: float = 20.0, input_channels: int = 6,
                 batch_norm: bool = False, loss_start_scale: int = 4,
                 loss_num_scales: int = 5, loss_base_weight: float = 0.32,
                 loss_norm: str = "L2", **kwargs):
        super().__init__(
            loss_fn=MultiScaleLoss(loss_start_scale, loss_num_scales,
                                   loss_base_weight, loss_norm),
            output_stride=64, **kwargs)
        self.div_flow = div_flow
        self.input_channels = input_channels
        self.batch_norm = batch_norm

    def _preprocess(self, images: torch.Tensor):
        """Per-frame, per-channel BGR mean subtracted, RGB, resized by
        interpolation to a multiple of 64 (flownets.py:93-103)."""
        mean = images.mean(dim=(-2, -1), keepdim=True)
        return self.preprocess_images(
            images, bgr_add=-mean, bgr_mult=1.0, bgr_to_rgb=True,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=True)

    def _encode(self, x: torch.Tensor, names: Sequence[str]) -> torch.Tensor:
        for name in names:
            x = getattr(self, name)(x)
        return x

    def _decode(self, skips: Sequence[torch.Tensor],
                top: int) -> List[torch.Tensor]:
        """The refinement from the coarsest map ``skips[-1]`` (level
        ``top``) to the finest: at each level the deconvolved features, the
        skip and the upsampled flow concatenated, through ``inter_conv``
        where the network has one, to ``predict_flow``.  Returns the flows
        fine to coarse."""
        x = skips[-1]
        flow = getattr(self, f"predict_flow{top}")(x)
        flows = [flow]
        for lvl, skip in zip(range(top - 1, -1, -1), skips[-2::-1]):
            up = getattr(self, f"upsampled_flow{lvl + 1}_to_{lvl}")(flow)
            x = torch.cat([skip, getattr(self, f"deconv{lvl}")(x), up], 1)
            inter = getattr(self, f"inter_conv{lvl}", None)
            flow = getattr(self, f"predict_flow{lvl}")(
                x if inter is None else inter(x))
            flows.append(flow)
        return flows[::-1]

    def _finish(self, flow: torch.Tensor, resizer, flow_preds,
                training: bool) -> Dict[str, torch.Tensor]:
        flow = self.postprocess_predictions(flow, resizer, is_flow=True)
        outputs = {"flows": flow[:, None]}
        if training:
            outputs["flow_preds"] = flow_preds
        return outputs

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds``, the
        decoder's flows in units of 1/``div_flow``, fine to coarse."""
        images, resizer = self._preprocess(inputs["images"])
        flow, preds = self._predict(images)
        return self._finish(flow, resizer, preds, training)


def _up4(flow: torch.Tensor) -> torch.Tensor:
    h, w = flow.shape[-2:]
    return interpolate(flow, (4 * h, 4 * w), mode="bilinear",
                       align_corners=False)


class FlowNetS(FlowNetBase):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flownets-things-98cde14d.ckpt"
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        bn = self.batch_norm
        self.conv1 = conv(bn, self.input_channels, 64, 7, 2)
        self.conv2 = conv(bn, 64, 128, 5, 2)
        self.conv3 = conv(bn, 128, 256, 5, 2)
        self.conv3_1 = conv(bn, 256, 256)
        self.conv4 = conv(bn, 256, 512, stride=2)
        self.conv4_1 = conv(bn, 512, 512)
        self.conv5 = conv(bn, 512, 512, stride=2)
        self.conv5_1 = conv(bn, 512, 512)
        self.conv6 = conv(bn, 512, 1024, stride=2)
        self.conv6_1 = conv(bn, 1024, 1024)
        self.deconv5 = deconv(1024, 512)
        self.deconv4 = deconv(1026, 256)
        self.deconv3 = deconv(770, 128)
        self.deconv2 = deconv(386, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(1026)
        self.predict_flow4 = predict_flow(770)
        self.predict_flow3 = predict_flow(386)
        self.predict_flow2 = predict_flow(194)
        self.upsampled_flow6_to_5 = upsample_flow(bias=False)
        self.upsampled_flow5_to_4 = upsample_flow(bias=False)
        self.upsampled_flow4_to_3 = upsample_flow(bias=False)
        self.upsampled_flow3_to_2 = upsample_flow(bias=False)

    def _predict_stacked(self, x: torch.Tensor):
        """The flow at the input's size and the decoder's flows, from the
        frames and any extra maps stacked along the channels."""
        c2 = self._encode(x, ("conv1", "conv2"))
        c3 = self._encode(c2, ("conv3", "conv3_1"))
        c4 = self._encode(c3, ("conv4", "conv4_1"))
        c5 = self._encode(c4, ("conv5", "conv5_1"))
        c6 = self._encode(c5, ("conv6", "conv6_1"))
        flows = self._decode([c2, c3, c4, c5, c6], 6)
        return self.div_flow * _up4(flows[0]), flows

    def _predict(self, images: torch.Tensor):
        return self._predict_stacked(stack_frames(images))


class FlowNetC(FlowNetBase):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flownetc-things-cc8ac7fd.ckpt"
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        bn = self.batch_norm
        self.conv1 = conv(bn, 3, 64, 7, 2)
        self.conv2 = conv(bn, 64, 128, 5, 2)
        self.conv3 = conv(bn, 128, 256, 5, 2)
        self.conv_redir = conv(bn, 256, 32, 1, 1)
        self.conv3_1 = conv(bn, 473, 256)
        self.conv4 = conv(bn, 256, 512, stride=2)
        self.conv4_1 = conv(bn, 512, 512)
        self.conv5 = conv(bn, 512, 512, stride=2)
        self.conv5_1 = conv(bn, 512, 512)
        self.conv6 = conv(bn, 512, 1024, stride=2)
        self.conv6_1 = conv(bn, 1024, 1024)
        self.deconv5 = deconv(1024, 512)
        self.deconv4 = deconv(1026, 256)
        self.deconv3 = deconv(770, 128)
        self.deconv2 = deconv(386, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(1026)
        self.predict_flow4 = predict_flow(770)
        self.predict_flow3 = predict_flow(386)
        self.predict_flow2 = predict_flow(194)
        self.upsampled_flow6_to_5 = upsample_flow()
        self.upsampled_flow5_to_4 = upsample_flow()
        self.upsampled_flow4_to_3 = upsample_flow()
        self.upsampled_flow3_to_2 = upsample_flow()

    def _predict(self, images: torch.Tensor):
        """The two frames' shared trunks to 1/8, their correlation over 21x21
        displacements 2 px apart divided by C, and the decoder."""
        c2a = self._encode(images[:, 0], ("conv1", "conv2"))
        c3a = self.conv3(c2a)
        c3b = self._encode(images[:, 1], ("conv1", "conv2", "conv3"))
        corr = local_correlation(c3a, c3b, 10, normalize=False,
                                 dilation=2) / c3a.shape[1]
        corr = F.leaky_relu(corr, 0.1)
        c3 = self.conv3_1(torch.cat([self.conv_redir(c3a), corr], 1))
        c4 = self._encode(c3, ("conv4", "conv4_1"))
        c5 = self._encode(c4, ("conv5", "conv5_1"))
        c6 = self._encode(c5, ("conv6", "conv6_1"))
        flows = self._decode([c2a, c3, c4, c5, c6], 6)
        return self.div_flow * _up4(flows[0]), flows


class FlowNetSD(FlowNetBase):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flownetsd-things-f87246fa.ckpt"
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        bn = self.batch_norm
        self.conv0 = conv(bn, 6, 64)
        self.conv1 = conv(bn, 64, 64, stride=2)
        self.conv1_1 = conv(bn, 64, 128)
        self.conv2 = conv(bn, 128, 128, stride=2)
        self.conv2_1 = conv(bn, 128, 128)
        self.conv3 = conv(bn, 128, 256, stride=2)
        self.conv3_1 = conv(bn, 256, 256)
        self.conv4 = conv(bn, 256, 512, stride=2)
        self.conv4_1 = conv(bn, 512, 512)
        self.conv5 = conv(bn, 512, 512, stride=2)
        self.conv5_1 = conv(bn, 512, 512)
        self.conv6 = conv(bn, 512, 1024, stride=2)
        self.conv6_1 = conv(bn, 1024, 1024)
        self.deconv5 = deconv(1024, 512)
        self.deconv4 = deconv(1026, 256)
        self.deconv3 = deconv(770, 128)
        self.deconv2 = deconv(386, 64)
        self.inter_conv5 = i_conv(bn, 1026, 512)
        self.inter_conv4 = i_conv(bn, 770, 256)
        self.inter_conv3 = i_conv(bn, 386, 128)
        self.inter_conv2 = i_conv(bn, 194, 64)
        self.predict_flow6 = predict_flow(1024)
        self.predict_flow5 = predict_flow(512)
        self.predict_flow4 = predict_flow(256)
        self.predict_flow3 = predict_flow(128)
        self.predict_flow2 = predict_flow(64)
        self.upsampled_flow6_to_5 = upsample_flow()
        self.upsampled_flow5_to_4 = upsample_flow()
        self.upsampled_flow4_to_3 = upsample_flow()
        self.upsampled_flow3_to_2 = upsample_flow()

    def _predict(self, images: torch.Tensor):
        """The stacked frames at stride 1 first, then 1/2 to 1/64; the flow
        divided by ``div_flow`` (the reference's quirk,
        flownetsd.py:147-150)."""
        c0 = self.conv0(stack_frames(images))
        c2 = self._encode(c0, ("conv1", "conv1_1", "conv2", "conv2_1"))
        c3 = self._encode(c2, ("conv3", "conv3_1"))
        c4 = self._encode(c3, ("conv4", "conv4_1"))
        c5 = self._encode(c4, ("conv5", "conv5_1"))
        c6 = self._encode(c5, ("conv6", "conv6_1"))
        flows = self._decode([c2, c3, c4, c5, c6], 6)
        return _up4(flows[0]) / self.div_flow, flows


class FlowNetFusion(FlowNetBase):
    """The fusion network of FlowNet2: 11 input channels at full size, two
    strides down and back, flows at 1, 1/2 and 1/4."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        bn = self.batch_norm
        self.conv0 = conv(bn, 11, 64)
        self.conv1 = conv(bn, 64, 64, stride=2)
        self.conv1_1 = conv(bn, 64, 128)
        self.conv2 = conv(bn, 128, 128, stride=2)
        self.conv2_1 = conv(bn, 128, 128)
        self.deconv1 = deconv(128, 32)
        self.deconv0 = deconv(162, 16)
        self.inter_conv1 = i_conv(bn, 162, 32)
        self.inter_conv0 = i_conv(bn, 82, 16)
        self.predict_flow2 = predict_flow(128)
        self.predict_flow1 = predict_flow(32)
        self.predict_flow0 = predict_flow(16)
        self.upsampled_flow2_to_1 = upsample_flow()
        self.upsampled_flow1_to_0 = upsample_flow()

    def _predict_stacked(self, x: torch.Tensor):
        c0 = self.conv0(x)
        c1 = self._encode(c0, ("conv1", "conv1_1"))
        c2 = self._encode(c1, ("conv2", "conv2_1"))
        flows = self._decode([c0, c1, c2], 2)
        return flows[0], flows

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``inputs["images"]``: the 11 stacked maps (B, 11, H, W)."""
        flow, preds = self._predict_stacked(inputs["images"])
        return self._finish(flow, None, preds, training)


def _brightness_error(img0: torch.Tensor,
                      warped: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(img0 - warped, dim=1, keepdim=True)


class FlowNetCS(FlowNetBase):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flownetcs-things-4bdecffa.ckpt"
    }

    def __init__(self, input_channels: int = 12, **kwargs):
        super().__init__(input_channels=input_channels, **kwargs)
        self.flownetc = FlowNetC(div_flow=self.div_flow,
                                 batch_norm=self.batch_norm)
        self.flownets_1 = FlowNetS(div_flow=self.div_flow,
                                   input_channels=input_channels,
                                   batch_norm=self.batch_norm)

    def _stage_input(self, images: torch.Tensor,
                     flow: torch.Tensor) -> torch.Tensor:
        """The next S network's 12 channels: both frames, the second warped
        by ``flow``, the flow over ``div_flow`` and the brightness error."""
        img0, img1 = images[:, 0], images[:, 1]
        warped = pwc_warp(img1, flow)
        return torch.cat([img0, img1, warped, flow / self.div_flow,
                          _brightness_error(img0, warped)], 1)

    def _predict(self, images: torch.Tensor):
        """C, then each S network on the flow before it; the last flow and
        the last decoder's flows."""
        flow, preds = self.flownetc._predict(images)
        for name in ("flownets_1", "flownets_2"):
            if hasattr(self, name):
                flow, preds = getattr(self, name)._predict_stacked(
                    self._stage_input(images, flow))
        return flow, preds


class FlowNetCSS(FlowNetCS):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flownetcss-things-dd05a3b9.ckpt"
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.flownets_2 = FlowNetS(div_flow=self.div_flow,
                                   input_channels=self.input_channels,
                                   batch_norm=self.batch_norm)


class FlowNet2(FlowNetCSS):
    """CSS and SD fused.  Its ``flow_preds`` are the fusion network's (full
    size, 1/2, 1/4), so its loss needs ``loss_start_scale=1``: the default 4
    pools the ground truth to 1/4, 1/8 and 1/16 and fails on the shapes, in
    the JAX package as here (ROADMAP.md, section 3)."""

    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flownet2-things-2a58d37d.ckpt"
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.flownets_d = FlowNetSD(div_flow=self.div_flow,
                                    batch_norm=self.batch_norm)
        self.flownetfusion = FlowNetFusion(div_flow=self.div_flow,
                                           batch_norm=self.batch_norm)

    def _predict(self, images: torch.Tensor):
        img0, img1 = images[:, 0], images[:, 1]
        css_flow, _ = super()._predict(images)
        sd_flow, _ = self.flownets_d._predict(images)
        sd_flow = sd_flow / self.div_flow ** 2
        x = torch.cat([
            img0, sd_flow, css_flow,
            torch.linalg.vector_norm(sd_flow, dim=1, keepdim=True),
            torch.linalg.vector_norm(css_flow, dim=1, keepdim=True),
            _brightness_error(img0, pwc_warp(img1, sd_flow)),
            _brightness_error(img0, pwc_warp(img1, css_flow))], 1)
        return self.flownetfusion._predict_stacked(x)


@register_model
@trainable
class flownets(FlowNetS):
    pass


@register_model
@trainable
class flownetc(FlowNetC):
    pass


@register_model
@trainable
class flownetsd(FlowNetSD):
    pass


@register_model
@trainable
class flownetcs(FlowNetCS):
    pass


@register_model
@trainable
class flownetcss(FlowNetCSS):
    pass


@register_model
@trainable
class flownet2(FlowNet2):
    pass
