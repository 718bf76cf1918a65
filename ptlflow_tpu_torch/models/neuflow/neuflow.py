"""NeuFlow (``ptlflow_tpu/models/neuflow/neuflow.py``), NCHW: global
matching at 1/16, then one local refinement at 1/8 and a convex
upsampling by 8.

Each frame goes through a backbone of strided convolution blocks with
affine-free BatchNorms (the image at 1/1, 1/2, 1/4 and 1/8 into 1/8
features, then 1/16), with normalised (y, x) position channels appended.
Two bidirectional cross-attention layers and a LayerNorm mix the frames at
1/16, where the flow starts as the softmax attention of frame 0 over frame
1 with the coords grid as values (``sdpa``), then propagates by a
self-attention with the flow as values.  At 1/8 the 1/16 features are
merged in (nearest upsampling), a 7 x 7 local correlation of frame 0 with
frame 1 warped by the flow feeds a convolutional refiner, and features of
frame 0 from ``conv_s8`` give the upsampling mask.  No lookup kernel runs
here.

NeuFlow v2 (``models/neuflow2``) reuses ``lrelu``, ``sdpa``,
``TransformerLayer``, ``UpSample`` and ``SequenceLoss``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import (BatchNorm2d, CastConv2d, CastLinear, LayerNorm,
                   at_least_float32)
from ...ops.correlation import coords_grid, local_correlation
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample
from ...ops.warp import backward_warp
from ...utils.registry import register_model, trainable
from ..base import BaseModel


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention of (B, L, C) queries against (B, M, C) keys over (B, M, D)
    values -> (B, L, D) in v's dtype: scores in at least float32 scaled by
    1/sqrt(C), their softmax, then the product with the values, as plain
    matrix products (the JAX package computes it outside any Pallas
    kernel)."""
    q, k = at_least_float32(q), at_least_float32(k)
    scale = torch.rsqrt(torch.tensor(float(q.shape[-1]), dtype=q.dtype))
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(at_least_float32(attn),
                        at_least_float32(v)).to(v.dtype)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def untokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W)."""
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


class SequenceLoss:
    """The sum over predictions i of w_i times the mean, over B, both
    channels, H and W, of valid * |pred_i - gt|, with the fixed weights
    w = (0.2, 1, 1, ...); valid means ``valids >= 0.5`` and |gt| <
    ``max_flow``.  ``gamma`` is accepted and unused, as in the JAX
    package."""

    def __init__(self, gamma: float, max_flow: float):
        self.max_flow = max_flow

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        flow_preds = outputs["flow_preds"]  # n of (B, 2, H, W)
        flow_gt = inputs["flows"][:, 0]
        valid = inputs["valids"][:, 0]
        mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1, keepdim=True))
        valid = ((valid >= 0.5) & (mag < self.max_flow)).to(flow_gt.dtype)
        total = 0.0
        for i, pred in enumerate(flow_preds):
            w = 0.2 if i == 0 else 1.0
            total = total + w * torch.mean(valid * (pred - flow_gt).abs())
        return total


class TransformerLayer(nn.Module):
    """``source`` attends to ``target``; the message, normalised, and with
    ``ffn`` passed with the source through an MLP and normalised again, is
    added to the source.  Tokens (B, N, C)."""

    def __init__(self, feature_dim: int, ffn: bool = True,
                 ffn_dim_expansion: int = 1):
        super().__init__()
        self.q_proj = CastLinear(feature_dim, feature_dim)
        self.k_proj = CastLinear(feature_dim, feature_dim)
        self.v_proj = CastLinear(feature_dim, feature_dim)
        self.merge = CastLinear(feature_dim, feature_dim)
        self.norm1 = LayerNorm(feature_dim)
        self.use_ffn = ffn
        if ffn:
            in_ch = feature_dim * 2
            self.mlp = nn.Sequential(
                CastLinear(in_ch, in_ch * ffn_dim_expansion, bias=False),
                nn.GELU(),
                CastLinear(in_ch * ffn_dim_expansion, feature_dim,
                           bias=False))
            self.norm2 = LayerNorm(feature_dim)

    def forward(self, source: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
        message = self.merge(sdpa(self.q_proj(source), self.k_proj(target),
                                  self.v_proj(target)))
        message = self.norm1(message)
        if self.use_ffn:
            message = self.norm2(self.mlp(torch.cat([source, message],
                                                    dim=-1)))
        return source + message


class UpSample(nn.Module):
    """Convex upsampling of the flow by ``upsample_factor`` with a mask
    from the flow and ``feature``."""

    def __init__(self, feature_dim: int, upsample_factor: int):
        super().__init__()
        self.upsample_factor = upsample_factor
        self.conv1 = CastConv2d(2 + feature_dim, 256, 3, 1, 1)
        self.conv2 = CastConv2d(256, 512, 3, 1, 1)
        self.conv3 = CastConv2d(512, upsample_factor ** 2 * 9, 1, 1, 0)

    def forward(self, feature: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1(torch.cat([flow, feature], dim=1)))
        mask = self.conv3(torch.relu(self.conv2(x)))
        return convex_upsample(flow, mask, self.upsample_factor)


class ConvBlock(nn.Module):
    """Two convolutions (leaky ReLU after each), their sum, then an
    affine-free BatchNorm (eps 1e-6)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int,
                 stride: int, padding: int):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, out_planes, kernel_size,
                                stride=stride, padding=padding, bias=False)
        self.conv2 = CastConv2d(out_planes, out_planes, 3, stride=1,
                                padding=1, bias=False)
        self.norm = BatchNorm2d(out_planes, eps=1e-6, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = lrelu(self.conv1(x))
        return self.norm(x1 + lrelu(self.conv2(x1)))


class DownDimBlock(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.conv_block = ConvBlock(in_planes, out_planes, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block(lrelu(x))


def with_position(x: torch.Tensor) -> torch.Tensor:
    """``x`` with the (y, x) pixel positions, each over its side minus 1,
    appended as two channels."""
    b, _, h, w = x.shape
    ys = torch.arange(h, dtype=x.dtype, device=x.device) / (h - 1)
    xs = torch.arange(w, dtype=x.dtype, device=x.device) / (w - 1)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.cat([x, torch.stack([yy, xx])[None].expand(b, 2, h, w)], 1)


class CNNEncoder(nn.Module):
    """An image -> (1/8 features, 1/16 features), each with position
    channels."""

    def __init__(self, feature_dim: int):
        super().__init__()
        self.block1_1 = ConvBlock(3, feature_dim, 8, 8, 0)
        self.block1_2 = ConvBlock(3, feature_dim, 8, 4, 2)
        self.block1_3 = ConvBlock(3, feature_dim, 8, 2, 3)
        self.block1_4 = ConvBlock(3, feature_dim, 7, 1, 3)
        self.block1_dd = DownDimBlock(feature_dim * 4, feature_dim)
        self.block1_ds = ConvBlock(feature_dim, feature_dim, 2, 2, 0)
        self.block2 = ConvBlock(3, feature_dim, 7, 1, 3)
        self.block2_dd = DownDimBlock(feature_dim * 2, feature_dim)

    def forward(self, img: torch.Tensor):
        scales = []
        for block in (self.block1_1, self.block1_2, self.block1_3,
                      self.block1_4):
            scales.append(block(img))
            img = F.avg_pool2d(img, 2, 2)
        x1 = self.block1_dd(torch.cat(scales, 1))
        x2 = self.block2_dd(torch.cat([self.block1_ds(x1), self.block2(img)],
                                      1))
        return with_position(x1), with_position(x2)


class FeatureAttention(nn.Module):
    """Cross-attention layers (with the MLP) between two frames' (B, C, H,
    W) features: each frame's tokens attend to the other's, both frames in
    one batch; then a LayerNorm (eps 1e-6)."""

    def __init__(self, feature_dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList([TransformerLayer(feature_dim)
                                     for _ in range(num_layers)])
        self.norm = LayerNorm(feature_dim, eps=1e-6)

    def forward(self, feature0: torch.Tensor, feature1: torch.Tensor):
        h, w = feature0.shape[-2:]
        concat0 = torch.cat([tokens(feature0), tokens(feature1)], 0)
        for layer in self.layers:
            c0, c1 = concat0.chunk(2, dim=0)
            concat0 = layer(concat0, torch.cat([c1, c0], 0))
        f0, f1 = self.norm(concat0).chunk(2, dim=0)
        return untokens(f0, h, w), untokens(f1, h, w)


class FlowAttention(nn.Module):
    """The flow propagated by self-attention of the features, the flow as
    the values."""

    def __init__(self, feature_dim: int):
        super().__init__()
        self.q_proj = CastLinear(feature_dim, feature_dim)
        self.k_proj = CastLinear(feature_dim, feature_dim)

    def forward(self, feature: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
        h, w = feature.shape[-2:]
        f = tokens(feature)
        return untokens(sdpa(self.q_proj(f), self.k_proj(f), tokens(flow)),
                        h, w)


class RefineConvBlock(nn.Module):
    def __init__(self, in_planes, out_planes, kernel_size, stride, padding):
        super().__init__()
        self.conv = CastConv2d(in_planes, out_planes, kernel_size,
                               stride=stride, padding=padding, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lrelu(self.conv(x))


class Refine(nn.Module):
    """The flow step from the (patch_size)^2 local correlation of frame 0
    with the warped frame 1, frame 0's features and the flow."""

    def __init__(self, feature_dim: int, patch_size: int, num_layers: int):
        super().__init__()
        self.patch_size = patch_size
        self.conv1 = RefineConvBlock(patch_size ** 2 + feature_dim + 2, 96,
                                     3, 1, 1)
        self.conv_layers = nn.ModuleList([
            RefineConvBlock(96, 96, 3, 1, 1) for _ in range(num_layers)])
        self.conv2 = RefineConvBlock(96, 64, 3, 1, 1)
        self.conv3 = RefineConvBlock(64, 32, 3, 1, 1)
        self.conv4 = CastConv2d(32, 2, 3, 1, 1, bias=True)

    def forward(self, feature0, feature1, flow0):
        attn = local_correlation(feature0, feature1, self.patch_size // 2,
                                 normalize=False)
        x = self.conv1(torch.cat([attn, feature0, flow0], 1))
        for layer in self.conv_layers:
            x = layer(x)
        return self.conv4(self.conv3(self.conv2(x)))


class NeuFlow(BaseModel):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/neuflow-things-c402aa7a.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/neuflow-sintel-0d969ea2.ckpt",
    }

    def __init__(self, gamma: float = 0.8, max_flow: float = 400.0,
                 feature_dim: int = 90, **kwargs):
        super().__init__(output_stride=16,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.feature_dim = feature_dim
        self.backbone = CNNEncoder(feature_dim)
        self.cross_attn_s16 = FeatureAttention(feature_dim + 2, num_layers=2)
        self.flow_attn_s16 = FlowAttention(feature_dim + 2)
        self.merge_s8 = nn.Sequential(
            CastConv2d((feature_dim + 2) * 2, feature_dim * 2, 3, 1, 1,
                       bias=False),
            nn.GELU(),
            CastConv2d(feature_dim * 2, feature_dim, 3, 1, 1, bias=False))
        self.refine_s8 = Refine(feature_dim, patch_size=7, num_layers=6)
        self.conv_s8 = ConvBlock(3, feature_dim, 8, 8, 0)
        self.upsample_s1 = UpSample(feature_dim, upsample_factor=8)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W); in training also ``flow_preds``, two
        (B, 2, H, W): the refined 1/8 flow upsampled bilinearly, then the
        convex-upsampled one."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=(-0.406, -0.456, -0.485),
            bgr_mult=(1 / 0.225, 1 / 0.224, 1 / 0.229), bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        img0, img1 = images[:, 0], images[:, 1]
        # one call a frame: in training the BatchNorms take each frame's
        # statistics and move twice, as the JAX package's do
        f0_s8, f0_s16 = self.backbone(img0)
        f1_s8, f1_s16 = self.backbone(img1)
        f0_s16, f1_s16 = self.cross_attn_s16(f0_s16, f1_s16)

        # global matching: attention of frame 0 over the coords grid
        b, _, h16, w16 = f0_s16.shape
        grid = coords_grid(b, h16, w16, dtype=f0_s16.dtype,
                           device=f0_s16.device)
        corresp = sdpa(tokens(f0_s16), tokens(f1_s16), tokens(grid))
        flow0 = self.flow_attn_s16(f0_s16, untokens(corresp, h16, w16)
                                   - grid)

        size8 = (h16 * 2, w16 * 2)
        f0_s8 = self.merge_s8(torch.cat(
            [f0_s8, interpolate(f0_s16, size8, mode="nearest")], 1))
        f1_s8 = self.merge_s8(torch.cat(
            [f1_s8, interpolate(f1_s16, size8, mode="nearest")], 1))
        flow0 = 2 * interpolate(flow0, size8, mode="nearest")
        flow0 = flow0 + self.refine_s8(f0_s8, backward_warp(f1_s8, flow0),
                                       flow0)

        flow_full = self.postprocess_predictions(
            self.upsample_s1(self.conv_s8(img0), flow0), resizer,
            is_flow=True)
        outputs = {"flows": flow_full[:, None]}
        if training:
            up0 = 8 * interpolate(flow0, (size8[0] * 8, size8[1] * 8),
                                  mode="bilinear", align_corners=True)
            outputs["flow_preds"] = [
                self.postprocess_predictions(up0, resizer, is_flow=True),
                flow_full]
        return outputs


@register_model
@trainable
class neuflow(NeuFlow):
    pass
