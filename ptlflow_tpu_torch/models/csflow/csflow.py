"""CSFlow (``ptlflow_tpu/models/csflow/csflow.py``), NCHW: RAFT with a
cross-strip correlation as a second channel of its volume, its eval
forward with the warm start and its training forward (RAFT's
``SequenceLoss`` over the strip initialisation and every iteration).

The strip volume (``StripCrossCorrMap_v2``) correlates each pixel of the
first frame with the second frame's columns and rows, averaged into strip
descriptors, and adds the two.  The JAX package stacks it with the
all-pairs volume as two channels of one pyramid; here each is its own
one-channel pyramid (``ops/correlation.py::pool_volume_pyramid``) with its
own prepared lookup, two launches an iteration, and their outputs are
interleaved level by level into the JAX lookup's channel-major order (a
level's 81 product channels, then its 81 strip channels).  The strip
correlations also give the initial flow: the reference's softmax runs over
a singleton axis, so that flow is the plain sum over each strip, kept as
the checkpoints were trained.  Every layer casts its weights to its
input's dtype, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ... import nn as pnn
from ...nn import CastConv2d
from ...ops.correlation import (all_pairs_correlation, coords_grid,
                                make_corr_lookup, pool_volume_pyramid)
from ...ops.upsample import convex_upsample, upflow
from ...ops.warp import forward_interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..raft.extractor import BasicEncoder
from ..raft.raft import SequenceLoss
from ..raft.update import FlowHead, SepConvGRU


class ConvBNReLU(nn.Module):
    def __init__(self, in_chan: int, out_chan: int, ks: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = CastConv2d(in_chan, out_chan, ks, stride=stride,
                               padding=padding, bias=False)
        self.bn = pnn.BatchNorm2d(out_chan)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class StripCrossCorrMap_v2(nn.Module):
    """The strip volume of two (B, C, H, W) feature maps: strip[b, y1, x1,
    0, y2, x2] = corr_w[b, y1, x1, 0, x2] + corr_h[b, y1, x1, y2, 0], where
    corr_w correlates the first frame's pixel with the second frame's
    columns averaged over H and corr_h with its rows averaged over W (each
    through its own 1x1 conv-BatchNorm-ReLU), accumulated in float32.
    Returns (strip, corr_w, corr_h) in the features' dtype."""

    def __init__(self, in_chan: int = 256, out_chan: int = 256):
        super().__init__()
        self.conv1_1 = ConvBNReLU(in_chan, out_chan, ks=1, padding=0)
        self.conv1_2 = ConvBNReLU(in_chan, out_chan, ks=1, padding=0)
        self.conv2_1 = ConvBNReLU(in_chan, out_chan, ks=1, padding=0)
        self.conv2_2 = ConvBNReLU(in_chan, out_chan, ks=1, padding=0)

    def forward(self, fmap1: torch.Tensor, fmap2: torch.Tensor):
        b, _, h, w = fmap1.shape
        f1w = self.conv1_1(fmap1).float()
        f1h = self.conv1_2(fmap1).float()
        f2w = self.conv2_1(fmap2).mean(dim=2).float()  # columns (B, C, W2)
        f2h = self.conv2_2(fmap2).mean(dim=3).float()  # rows (B, C, H2)
        corr_w = torch.einsum("bcw,bchx->bhxw", f2w, f1w)[:, :, :, None]
        corr_h = torch.einsum("bcy,bchx->bhxy", f2h, f1h)[..., None]
        strip = (corr_w + corr_h).reshape(b, h, w, 1, h, w)
        dt = fmap1.dtype
        return strip.to(dt), corr_w.to(dt), corr_h.to(dt)


class BasicMotionEncoder_v2(nn.Module):
    """RAFT's motion encoder over both lookups' channels."""

    def __init__(self, corr_levels: int, corr_radius: int):
        super().__init__()
        cor_planes = 2 * (corr_levels * (2 * corr_radius + 1) ** 2)
        self.convc1 = CastConv2d(cor_planes, 256, 1, padding=0)
        self.convc2 = CastConv2d(256, 192, 3, padding=1)
        self.convf1 = CastConv2d(2, 128, 7, padding=3)
        self.convf2 = CastConv2d(128, 64, 3, padding=1)
        self.conv = CastConv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_levels: int, corr_radius: int,
                 hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder_v2(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, 64 * 9, 1, padding=0))

    def forward(self, net, inp, corr, flow):
        motion_features = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion_features], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class CSFlowCorrBlock:
    """The product volume and the strip volume, each average-pooled into
    ``num_levels`` levels with its lookup prepared once here; a call looks
    both up and interleaves them level by level: (B, L * 2 * (2r+1)^2, H1,
    W1), within a level the product's channels then the strip's.  Both
    pyramids are float32 (the JAX package's two-channel volume promotes
    the strip to the product's float32)."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 strip: torch.Tensor, num_levels: int = 4, radius: int = 4):
        b, _, h, w = fmap1.shape
        corr = all_pairs_correlation(fmap1, fmap2).reshape(b * h * w, h, w)
        strip = strip.reshape(b * h * w, h, w).to(corr.dtype)
        self.num_levels = num_levels
        self.pyramids = [pool_volume_pyramid(v, num_levels)
                         for v in (corr, strip)]
        self.lookups = [make_corr_lookup(p, radius) for p in self.pyramids]

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        outs = [lookup(coords) for lookup in self.lookups]
        b, c, h, w = outs[0].shape
        n2 = c // self.num_levels
        return torch.stack([o.view(b, self.num_levels, n2, h, w)
                            for o in outs], dim=2).reshape(b, 2 * c, h, w)


class CSFlow(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/csflow-chairs-458a9436.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/csflow-things-ebdd403b.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/csflow-kitti-dc66357a.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32, **kwargs):
        super().__init__(output_stride=8,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.iters = iters
        self.hidden_dim = hdim = 128
        self.context_dim = cdim = 128
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                 dropout=dropout)
        self.cnet = BasicEncoder(output_dim=hdim + cdim, norm_fn="batch",
                                 dropout=dropout)
        self.strip_corr_block_v2 = StripCrossCorrMap_v2(in_chan=256,
                                                        out_chan=256)
        self.update_block = BasicUpdateBlock(corr_levels, corr_radius,
                                             hidden_dim=hdim)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8,
        W/8); ``inputs["prev_preds"]["flow_small"]``, where given,
        warm-starts the coords by its forward projection before the strip
        initialisation is added.  Training: ``flow_preds`` (iters + 1, B,
        2, H, W), the upsampled strip initialisation then every
        iteration's flow, and ``flows``; the coords are detached at the
        start of every iteration."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]

        fmap1 = self.fnet(image1)
        fmap2 = self.fnet(image2)
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])

        strip, corr_w, corr_h = self.strip_corr_block_v2(fmap1, fmap2)
        corr_fn = CSFlowCorrBlock(fmap1, fmap2, strip, self.corr_levels,
                                  self.corr_radius)

        b, _, h, w = fmap1.shape
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        coords1 = coords0
        prev = inputs.get("prev_preds")
        if prev is not None and prev.get("flow_small") is not None:
            coords1 = coords1 + forward_interpolate(prev["flow_small"])
        # the strip initialisation: the sums over each strip (u from the
        # rows, v from the columns), differentiable into the strip block
        corr_init = torch.stack([corr_h.sum(dim=(3, 4)),
                                 corr_w.sum(dim=(3, 4))], dim=1)
        coords1 = coords1.detach() + corr_init.to(fmap1.dtype)
        init_up = self.postprocess_predictions(
            upflow(coords1 - coords0, 8), resizer, is_flow=True)

        mask = torch.zeros((b, 64 * 9, h, w), dtype=fmap1.dtype,
                           device=fmap1.device)
        flows_lr, masks = [], []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            net, mask, delta = self.update_block(
                net, inp, corr, (coords1 - coords0).to(net.dtype))
            coords1 = coords1 + delta
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)

        if training:
            flow_ups = convex_upsample(torch.stack(flows_lr).flatten(0, 1),
                                       torch.stack(masks).flatten(0, 1))
            flow_ups = self.postprocess_predictions(
                flow_ups.unflatten(0, (len(flows_lr), b)), resizer,
                is_flow=True)
            return {"flows": flow_ups[-1][:, None],
                    "flow_preds": torch.cat([init_up[None], flow_ups])}
        flow_small = coords1 - coords0
        flow_up = self.postprocess_predictions(
            convex_upsample(flow_small, mask), resizer, is_flow=True)
        return {"flows": flow_up[:, None], "flow_small": flow_small}


@register_model
@trainable
class csflow(CSFlow):
    pass
