"""SEA-RAFT (``ptlflow_tpu/models/sea_raft/sea_raft.py``), NCHW: the eval
forward, the training forward with its Laplace-mixture NLL terms and
``SequenceLoss``.

ResNet-FPN context and feature encoders; the context encoder reads both
frames concatenated on channels (6 in), the feature encoder runs once per
frame (its train-mode BatchNorm statistics depend on it).  Iteration 0
regresses the flow and the 4-channel info map from the context alone; each
later one looks up the correlation pyramid at the current flow and refines
the hidden state by ConvNeXt blocks (no GRU).  The lookup is prepared once
per forward (``make_corr_lookup``) and launched once per iteration.  The
flow state is float32 even under ``mixed_precision``.  Flow and info share
one convex upsampling (``ops.convex_upsample_data``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ...nn import CastConv2d, cast_params
from ...ops.correlation import (build_corr_pyramid, coords_grid,
                                make_corr_lookup)
from ...ops.upsample import convex_upsample, convex_upsample_data
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..raft.raft import _DTYPES
from .layer import ConvNextBlock, ResNetFPN, conv3x3


class SequenceLoss:
    """gamma-weighted sum over the iterations of the mean Laplace-mixture
    NLL (``nf_preds``), over the pixels that are valid (``valids >= 0.5``
    and |gt| < ``max_flow``) and where the NLL is finite."""

    def __init__(self, gamma: float, max_flow: float):
        self.gamma = gamma
        self.max_flow = max_flow

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        flow_gt = inputs["flows"][:, 0]  # (B, 2, H, W)
        valid = inputs["valids"][:, 0]  # (B, 1, H, W)
        mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1, keepdim=True))
        valid = (valid >= 0.5) & (mag < self.max_flow)
        nf_preds = outputs["nf_preds"]  # (n, B, 2, H, W)
        n = nf_preds.shape[0]
        loss = 0.0
        for i in range(n):
            nll = nf_preds[i]
            mask = torch.isfinite(nll.detach()) & valid
            m = mask.to(nll.dtype)
            nll = torch.where(mask, nll, 0.0)
            loss = loss + (self.gamma ** (n - i - 1) * torch.sum(m * nll)
                           / torch.clamp(torch.sum(m), min=1))
        return loss


def laplace_mixture_nll(flow_pred: torch.Tensor, info_pred: torch.Tensor,
                        flow_gt: torch.Tensor, var_min: float,
                        var_max: float) -> torch.Tensor:
    """Laplace-mixture NLL per pixel and flow channel: flows (..., 2, H,
    W), info (..., 4, H, W) -> (..., 2, H, W).  Info channels 0-1 are the
    mixture's logits, 2-3 its log scales, clamped to [0, var_max] and
    [var_min, 0] (SEA-RAFT's and DPFlow's)."""
    raw_b = info_pred[..., 2:, :, :]
    log_b = torch.stack([raw_b[..., 0, :, :].clamp(0, var_max),
                         raw_b[..., 1, :, :].clamp(var_min, 0)], dim=-3)
    weight = info_pred[..., :2, :, :]
    err = (flow_gt - flow_pred).abs()
    # (..., flow channel c, mixture m, H, W): |gt - pred|_c / b_m
    term2 = err.unsqueeze(-3) * torch.exp(-log_b).unsqueeze(-4)
    term1 = weight - math.log(2) - log_b
    lse = torch.logsumexp(term1.unsqueeze(-4) - term2, dim=-3)
    return torch.logsumexp(weight, dim=-3, keepdim=True) - lse


class BasicMotionEncoder(nn.Module):
    """SEA-RAFT's motion encoder.  Its convolutions run in their input's
    dtype (``CastConv2d``), as in the JAX package: the correlation ones in
    the correlation's."""

    def __init__(self, corr_channel: int, dim: int = 128):
        super().__init__()
        self.convc1 = CastConv2d(corr_channel, dim * 2, 1, padding=0)
        self.convc2 = CastConv2d(dim * 2, dim + dim // 2, 3, padding=1)
        self.convf1 = CastConv2d(2, dim, 7, padding=3)
        self.convf2 = CastConv2d(dim, dim // 2, 3, padding=1)
        self.conv = CastConv2d(dim * 2, dim - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    """The motion encoder and a stack of ConvNeXt refinement blocks."""

    def __init__(self, corr_channel: int, num_blocks: int, hdim: int = 128,
                 cdim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channel=corr_channel, dim=cdim)
        self.refine = nn.ModuleList(
            [ConvNextBlock(2 * cdim + hdim, hdim) for _ in range(num_blocks)])

    def forward(self, net: torch.Tensor, inp: torch.Tensor,
                corr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        inp = torch.cat([inp, self.encoder(flow, corr)], dim=1)
        for blk in self.refine:
            net = blk(torch.cat([net, inp], dim=1))
        return net


class SEARAFT(BaseModel):
    pretrained_checkpoints: Dict[str, str] = {}

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dim: int = 128, initial_dim: int = 64, num_blocks: int = 2,
                 block_dims: Sequence[int] = (64, 128, 256),
                 pretrain: str = "resnet18", gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 4,
                 alternate_corr: bool = False, use_var: bool = True,
                 var_min: float = 0, var_max: float = 10,
                 corr_dtype: Optional[str] = None,
                 mixed_precision: bool = False, **kwargs):
        super().__init__(output_stride=8,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        if corr_dtype not in _DTYPES:
            raise ValueError(f"corr_dtype must be one of {list(_DTYPES)}")
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.dim = dim
        self.iters = iters
        self.use_var = use_var
        self.var_min = var_min
        self.var_max = var_max
        # "bfloat16" stores the pyramid in bf16; the lookup accumulates fp32
        self.corr_dtype = corr_dtype
        # bf16 weights and activations, as the JAX package's inference mixed
        # precision; implies a bf16 pyramid; the flow state stays fp32
        self.mixed_precision = mixed_precision
        corr_channel = corr_levels * (corr_radius * 2 + 1) ** 2

        self.cnet = ResNetFPN(block_dims, initial_dim, pretrain=pretrain,
                              input_dim=6, output_dim=2 * dim)
        self.init_conv = conv3x3(2 * dim, 2 * dim)
        self.upsample_weight = nn.Sequential(
            nn.Conv2d(dim, dim * 2, 3, padding=1), nn.ReLU(),
            nn.Conv2d(dim * 2, 64 * 9, 1, padding=0))
        self.flow_head = nn.Sequential(
            nn.Conv2d(dim, 2 * dim, 3, padding=1), nn.ReLU(),
            nn.Conv2d(2 * dim, 6, 3, padding=1))
        if iters > 0:
            self.fnet = ResNetFPN(block_dims, initial_dim, pretrain=pretrain,
                                  input_dim=3, output_dim=2 * dim)
            self.update_block = BasicUpdateBlock(
                corr_channel=corr_channel, num_blocks=num_blocks, hdim=dim,
                cdim=dim)
        if mixed_precision:
            # weights are stored in bf16, the norms' running statistics
            # stay fp32: the cast the JAX package applies on every forward
            cast_params(self, torch.bfloat16)

    def _nf_loss(self, flow_pred: torch.Tensor, info_pred: torch.Tensor,
                 flow_gt: torch.Tensor) -> torch.Tensor:
        var_max = self.var_max if self.use_var else 0
        var_min = self.var_min if self.use_var else 0
        return laplace_mixture_nll(flow_pred, info_pred, flow_gt, var_min,
                                   var_max)

    def _heads(self, net: torch.Tensor, flow_8x: Optional[torch.Tensor]):
        """The flow head's step added to ``flow_8x`` (fp32), the info map
        and the upsampling mask logits."""
        update = self.flow_head(net)
        step = update[:, :2].float()
        flow_8x = step if flow_8x is None else flow_8x + step
        return flow_8x, update[:, 2:], 0.25 * self.upsample_weight(net)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8,
        W/8).

        Training (``training=True``): ``flow_preds`` (iters+1, B, 2, H, W)
        and ``info_preds`` (iters+1, B, 4, H, W), iteration 0's and every
        refinement's upsampled outputs; ``nf_preds`` (iters+1, B, 2, H, W),
        their NLL against ``inputs["flows"]`` (zeros where absent); and
        ``flows``, the last flow.  The flow is detached at the start of
        every iteration, as the JAX package stops its gradient.
        ``BaseModel.forward`` sets the modes."""
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]

        corr_dtype = _DTYPES[self.corr_dtype]
        if self.mixed_precision:
            corr_dtype = torch.bfloat16
            image1 = image1.to(torch.bfloat16)
            image2 = image2.to(torch.bfloat16)

        cnet = self.init_conv(self.cnet(torch.cat([image1, image2], dim=1)))
        net, context = cnet[:, :self.dim], cnet[:, self.dim:]
        flow_8x, info_8x, mask = self._heads(net, None)
        outs = [(flow_8x, info_8x, mask)]

        if self.iters > 0:
            fmap1 = self.fnet(image1)
            fmap2 = self.fnet(image2)
            pyramid = build_corr_pyramid(fmap1, fmap2, self.corr_levels,
                                         dtype=corr_dtype)
            corr_lookup = make_corr_lookup(pyramid, self.corr_radius)
            b, _, h, w = fmap1.shape
            grid = coords_grid(b, h, w, dtype=torch.float32,
                               device=fmap1.device)
            for _ in range(self.iters):
                flow_8x = flow_8x.detach()
                corr = corr_lookup(grid + flow_8x)
                net = self.update_block(net, context, corr,
                                        flow_8x.to(net.dtype))
                flow_8x, info_8x, mask = self._heads(net, flow_8x)
                if training:
                    outs.append((flow_8x, info_8x, mask))

        if not training:
            flow_up = self.postprocess_predictions(
                convex_upsample(flow_8x, mask), image_resizer, is_flow=True)
            return {"flows": flow_up[:, None], "flow_small": flow_8x}

        # every iteration upsampled in one batched call, ((iters+1)*B, ...)
        flows, infos, masks = (torch.cat(t) for t in zip(*outs))
        flow_ups, info_ups = convex_upsample_data(flows, infos, masks)
        n, b = len(outs), images.shape[0]
        flow_ups = self.postprocess_predictions(
            flow_ups.unflatten(0, (n, b)), image_resizer, is_flow=True)
        info_ups = self.postprocess_predictions(
            info_ups.unflatten(0, (n, b)), image_resizer, is_flow=False)
        flow_gt = (inputs["flows"][:, 0] if "flows" in inputs
                   else torch.zeros_like(flow_ups[-1]))
        return {"flows": flow_ups[-1][:, None], "flow_preds": flow_ups,
                "info_preds": info_ups,
                "nf_preds": self._nf_loss(flow_ups, info_ups, flow_gt)}


_URL = "https://github.com/hmorimitsu/ptlflow/releases/download/weights1"


class SEARAFT_S(SEARAFT):
    pretrained_checkpoints = {
        k: f"{_URL}/sea_raft_s-{v}.ckpt" for k, v in {
            "tartan": "tartan-f7e26f21", "chairs": "chairs-6980249f",
            "things": "things-a15c1713", "sintel": "sintel-bb63371a",
            "kitti": "kitti-3a96c1cc", "spring": "spring-4d13c106"}.items()}


class SEARAFT_M(SEARAFT):
    pretrained_checkpoints = {
        k: f"{_URL}/sea_raft_m-{v}.ckpt" for k, v in {
            "tartan": "tartan-e684ed5f", "chairs": "chairs-1cb7b11e",
            "things": "things-ac45dd7f", "sintel": "sintel-f8bb7e3f",
            "kitti": "kitti-e51f7603", "spring": "spring-de7c13e2"}.items()}

    def __init__(self, pretrain: str = "resnet34", **kwargs):
        super().__init__(pretrain=pretrain, **kwargs)


class SEARAFT_L(SEARAFT_M):
    def __init__(self, iters: int = 12, **kwargs):
        super().__init__(iters=iters, **kwargs)


@register_model
@trainable
class sea_raft(SEARAFT):
    pass


@register_model
@trainable
class sea_raft_s(SEARAFT_S):
    pass


@register_model
@trainable
class sea_raft_m(SEARAFT_M):
    pass


@register_model
@trainable
class sea_raft_l(SEARAFT_L):
    pass
