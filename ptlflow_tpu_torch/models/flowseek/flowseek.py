"""FlowSeek (``ptlflow_tpu/models/flowseek/flowseek.py``), NCHW: SEA-RAFT
iterations seeded with depth-foundation features and ego-motion basis
fields; its eval forward and its training forward.

A frozen DepthAnything V2 reads both frames resized to 518x518 and gives
its first fused path and a depth map; the depth spawns 8 normalised basis
flow fields (``create_bases``, float32 on every path) that a second
ResNet-FPN (``bnet``) encodes beside the context net; ``merge_head``'s
three stride-2 convolutions bring the depth features onto the padded 1/8
grid, where they widen both frames' features.  Iteration 0 regresses the
flow from the context; each later one looks up the 4-level correlation
pyramid, prepared once per forward (``make_corr_lookup``: one launch of
``csrc/corr_lookup.cu`` an iteration on the card), and refines the hidden
state by SEA-RAFT's ConvNeXt update block.  The JAX model reads no previous
prediction, so neither does this one; it returns ``flow_small`` all the
same.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import (build_corr_pyramid, coords_grid,
                                make_corr_lookup)
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample, convex_upsample_data
from ...utils.registry import ptlflow_trained, register_model
from ..base import BaseModel
from ..sea_raft.layer import ResNetFPN, conv3x3
from ..sea_raft.sea_raft import BasicUpdateBlock, laplace_mixture_nll
from ..waft.backbones import VIT_CONFIGS
from ..waft.dinov2 import DinoVisionTransformer
from ..waft.dpt import DPTHeadA1
from ..waft.waft import WAFTSequenceLoss


class FlowSeekDAV2(nn.Module):
    """DINOv2 and the DPT depth head: (path_1, relu(depth))."""

    def __init__(self, encoder: str = "vits"):
        super().__init__()
        cfg = VIT_CONFIGS[encoder]
        self.idx = cfg["idx"]
        self.features = cfg["features"]
        self.pretrained = DinoVisionTransformer(encoder)
        self.depth_head = DPTHeadA1(self.pretrained.embed_dim,
                                    cfg["features"], cfg["out_channels"],
                                    patch_size=14)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h, w = x.shape[-2:]
        feats = self.pretrained.get_intermediate_layers(x, self.idx)
        out, p1, _, _, _ = self.depth_head(feats, h // 14, w // 14)
        return p1, torch.relu(self.depth_head.scratch.output_conv2(out))


def create_bases(disp: torch.Tensor) -> torch.Tensor:
    """8 instantaneous-motion basis flow fields of a disparity map, each
    normalised over the whole image: (B, 1, H, W) -> (B, 16, H, W) float32,
    channel pairs [Tx, Ty, Tz, R1x, R2x, R1y, R2y, Rz]."""
    disp = disp.float()
    b, _, h, w = disp.shape
    ys = torch.linspace(0.5 / h, 1.0 - 0.5 / h, h, device=disp.device) - 0.5
    xs = torch.linspace(0.5 / w, 1.0 - 0.5 / w, w, device=disp.device) - 0.5
    u = xs.view(1, 1, 1, w).expand(b, 1, h, w)
    v = ys.view(1, 1, h, 1).expand(b, 1, h, w)
    aspect = w / h
    ones = torch.ones_like(disp)
    zeros = torch.zeros_like(disp)

    def norm(a, c):
        f = torch.cat([a, c], dim=1)
        return f / torch.sqrt(torch.sum(f ** 2, dim=(1, 2, 3), keepdim=True))

    return torch.cat([
        2 * disp * norm(-ones, zeros), 2 * disp * norm(zeros, -ones),
        2 * disp * norm(u, v), norm(zeros, ones), norm(u * v, v * v),
        norm(-ones, zeros), norm(-u * u, -u * v),
        norm(-v / aspect, u * aspect)], dim=1)


class FlowSeek(BaseModel):
    frozen_prefixes = ("dav2",)

    def __init__(self, corr_levels: int = 4, radius: int = 4,
                 pretrain: str = "resnet18", da_size: str = "vits",
                 dim: int = 128, initial_dim: int = 64, num_blocks: int = 2,
                 block_dims: Sequence[int] = (64, 128, 256),
                 gamma: float = 0.8, max_flow: float = 400, iters: int = 4,
                 use_var: bool = True, var_min: float = 0,
                 var_max: float = 10, **kwargs):
        super().__init__(output_stride=8,
                         loss_fn=WAFTSequenceLoss(gamma, max_flow), **kwargs)
        self.dim = dim
        self.iters = iters
        self.use_var = use_var
        self.var_min = var_min
        self.var_max = var_max
        self.corr_levels = corr_levels
        self.corr_radius = radius
        corr_channel = corr_levels * (radius * 2 + 1) ** 2

        self.cnet = ResNetFPN(block_dims, initial_dim, pretrain=pretrain,
                              input_dim=6, output_dim=2 * dim)
        self.dav2 = FlowSeekDAV2(da_size)
        feats = VIT_CONFIGS[da_size]["features"]
        self.merge_head = nn.Sequential(
            CastConv2d(feats, feats // 2 * 3, 3, stride=2, padding=1),
            nn.ReLU(),
            CastConv2d(feats // 2 * 3, feats * 2, 3, stride=2, padding=1),
            nn.ReLU(),
            CastConv2d(feats * 2, feats * 2, 3, stride=2, padding=1))
        self.bnet = ResNetFPN(block_dims, initial_dim, pretrain=pretrain,
                              input_dim=16, output_dim=2 * dim)
        self.init_conv = conv3x3(2 * dim, 2 * dim)
        self.upsample_weight = nn.Sequential(
            CastConv2d(dim * 2, dim * 2, 3, padding=1), nn.ReLU(),
            CastConv2d(dim * 2, 64 * 9, 1, padding=0))
        self.flow_head = nn.Sequential(
            CastConv2d(dim * 2, 2 * dim, 3, padding=1), nn.ReLU(),
            CastConv2d(2 * dim, 6, 3, padding=1))
        if iters > 0:
            self.fnet = ResNetFPN(block_dims, initial_dim, pretrain=pretrain,
                                  input_dim=3, output_dim=2 * dim)
            self.update_block = BasicUpdateBlock(
                corr_channel=corr_channel, num_blocks=num_blocks,
                hdim=dim * 2, cdim=dim * 2)

    def _heads(self, net: torch.Tensor):
        update = self.flow_head(net)
        return update[:, :2], update[:, 2:], 0.25 * self.upsample_weight(net)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, Any]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8,
        W/8).  Training: also ``flow_preds`` and ``info_preds`` (iters+1,
        B, 2 or 4, H, W), iteration 0's and every refinement's, and
        ``nf_preds``, their Laplace-mixture NLL against ``inputs["flows"]``
        (zeros where absent).  The flow is detached at the start of every
        iteration."""
        images = inputs["images"]
        h, w = images.shape[-2:]
        images_res, _ = self.preprocess_images(
            images, bgr_add=[-0.406, -0.456, -0.485],
            bgr_mult=[1 / 0.225, 1 / 0.224, 1 / 0.229], bgr_to_rgb=True,
            target_size=(518, 518), resize_mode="interpolation",
            interpolation_align_corners=False)
        b = images.shape[0]
        # the frozen depth branch: both frames in one batch (no batch
        # statistics in it), no gradient
        with torch.no_grad():
            p1, depth = self.dav2(images_res[:, :2].flatten(0, 1))
        p1 = interpolate(p1, (h, w)).unflatten(0, (b, 2))
        bases1 = create_bases(interpolate(depth.unflatten(0, (b, 2))[:, 0],
                                          (h, w)))
        mono1, mono2 = (self.merge_head(p1[:, k]) for k in range(2))

        images, resizer = self.preprocess_images(
            images, bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="constant", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]
        cnet = self.init_conv(self.cnet(torch.cat([image1, image2], dim=1)))
        bnet = self.init_conv(self.bnet(resizer.pad(bases1)))
        d = self.dim
        net = torch.cat([cnet[:, :d], bnet[:, :d]], dim=1)
        context = torch.cat([cnet[:, d:], bnet[:, d:]], dim=1)

        flow_8x, info_8x, mask = self._heads(net)
        outs = [(flow_8x, info_8x, mask)]
        if self.iters > 0:
            fmap1 = torch.cat([self.fnet(image1), mono1], dim=1)
            fmap2 = torch.cat([self.fnet(image2), mono2], dim=1)
            lookup = make_corr_lookup(
                build_corr_pyramid(fmap1, fmap2, self.corr_levels),
                self.corr_radius)
            _, _, hf, wf = fmap1.shape
            grid = coords_grid(b, hf, wf, dtype=torch.float32,
                               device=fmap1.device)
            for _ in range(self.iters):
                flow_8x = flow_8x.detach()
                corr = lookup(grid + flow_8x)
                net = self.update_block(net, context, corr, flow_8x)
                step, info_8x, mask = self._heads(net)
                flow_8x = flow_8x + step
                if training:
                    outs.append((flow_8x, info_8x, mask))

        if not training:
            flow_up = convex_upsample(flow_8x, mask)
            return {"flows": self.postprocess_predictions(
                flow_up, resizer, is_flow=True)[:, None],
                "flow_small": flow_8x}

        flows, infos, masks = (torch.cat(t) for t in zip(*outs))
        flow_ups, info_ups = convex_upsample_data(flows, infos, masks)
        n = len(outs)
        flow_ups = self.postprocess_predictions(
            flow_ups.unflatten(0, (n, b)), resizer, is_flow=True)
        info_ups = self.postprocess_predictions(
            info_ups.unflatten(0, (n, b)), resizer, is_flow=False)
        gt = (inputs["flows"][:, 0] if inputs.get("flows") is not None
              else torch.zeros_like(flow_ups[-1]))
        var_max = self.var_max if self.use_var else 0
        var_min = self.var_min if self.use_var else 0
        return {"flows": flow_ups[-1][:, None], "flow_preds": flow_ups,
                "info_preds": info_ups,
                "nf_preds": laplace_mixture_nll(flow_ups, info_ups, gt,
                                                var_min, var_max)}


class FlowSeekT(FlowSeek):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowseek_t-things-16757c61.ckpt",
        "tar-c-t": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowseek_t-tar-c-t-6be37a8c.ckpt",
    }

    def __init__(self, pretrain: str = "resnet18", da_size: str = "vits",
                 **kwargs):
        super().__init__(pretrain=pretrain, da_size=da_size, **kwargs)


class FlowSeekM(FlowSeek):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowseek_m-things-503e3693.ckpt",
        "tar-c-t": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowseek_m-tar-c-t-261fd770.ckpt",
    }

    def __init__(self, pretrain: str = "resnet34", da_size: str = "vitb",
                 **kwargs):
        super().__init__(pretrain=pretrain, da_size=da_size, **kwargs)


@register_model
@ptlflow_trained
class flowseek_t(FlowSeekT):
    pass


@register_model
@ptlflow_trained
class flowseek_m(FlowSeekM):
    pass
