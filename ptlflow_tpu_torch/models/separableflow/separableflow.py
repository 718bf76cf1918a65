"""SeparableFlow (``ptlflow_tpu/models/separableflow/separableflow.py``),
NCHW: the all-pairs volume filtered by GANet's non-local filter, its 4-D
pyramid and two 1-D volumes separated from it and aggregated by 3-D U-Nets
with semi-global aggregation, which also give the initial flow; then
RAFT-style GRU iterations on the three volumes.  Its eval forward and its
training forward.

The reverse volume f2 f1^T / sqrt(C) is accumulated in float32 and
filtered in float32 (``nlf_volume``), its pyramid cast to the features'
dtype.  The lookup is prepared once a forward (``make_corr_lookup``) and
launched once an iteration: 32 launches of ``csrc/corr_lookup.cu`` a
forward on the card, and in training 32 of its backward.  The 1-D windows
are gathered (``lookup_1d``), where the JAX package contracts one-hot
weights.  The input is padded on both sides to a multiple of 64, so that
the U-Nets' three halvings of the 1/8 maps are exact.  SeparableFlow reads
no previous prediction: every pair starts cold, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from ... import nn as pnn
from ...nn import CastConv2d
from ...ops.correlation import (coords_grid, make_corr_lookup,
                                pool_volume_pyramid)
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..raft.extractor import BasicEncoder
from ..raft.raft import SequenceLoss
from ..raft.update import FlowHead, SepConvGRU
from .cost_agg import CostAggregation, linear_resize_axis
from .ganet import _l1_normalize, nlf_iter


def _conv_in_relu(cin: int, cout: int, stride: int = 1) -> List[nn.Module]:
    return [CastConv2d(cin, cout, 3, stride=stride, padding=1),
            pnn.InstanceNorm2d(cout), nn.ReLU()]


class Guidance(nn.Module):
    """The guidance heads on the first frame and its features: the NLF's
    (B, 20, H, W) weights, and each SGA block's 20 weights of the u and of
    the v aggregation at 1/8 (``sg1``-``sg3``) and 1/16 (``sg11``,
    ``sg12``)."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.wsize = 20
        self.bn_relu = nn.Sequential(pnn.InstanceNorm2d(channels), nn.ReLU())
        self.conv0 = nn.Sequential(
            *_conv_in_relu(3, 16), *_conv_in_relu(16, channels // 4, 2),
            *_conv_in_relu(channels // 4, channels // 2, 2),
            *_conv_in_relu(channels // 2, channels, 2))
        inner = channels // 4
        self.conv1 = nn.Sequential(*_conv_in_relu(channels * 2, inner))
        self.conv2 = nn.Sequential(*_conv_in_relu(inner, inner),
                                   *_conv_in_relu(inner, inner))
        self.conv3 = nn.Sequential(*_conv_in_relu(inner, inner),
                                   *_conv_in_relu(inner, inner))
        self.conv11 = nn.Sequential(*_conv_in_relu(inner, inner * 2, 2))
        self.conv12 = nn.Sequential(*_conv_in_relu(inner * 2, inner * 2),
                                    *_conv_in_relu(inner * 2, inner * 2))
        self.weights = nn.Sequential(
            *_conv_in_relu(inner, inner),
            CastConv2d(inner, self.wsize, 3, stride=1, padding=1))
        for name, cin in (("weight_sg1", inner), ("weight_sg2", inner),
                          ("weight_sg3", inner), ("weight_sg11", inner * 2),
                          ("weight_sg12", inner * 2)):
            setattr(self, name, nn.Sequential(
                *_conv_in_relu(cin, cin),
                CastConv2d(cin, self.wsize * 2, 3, stride=1, padding=1)))

    def forward(self, fea: torch.Tensor, img: torch.Tensor):
        x = torch.cat([self.bn_relu(fea), self.conv0(img)], dim=1)
        x = self.conv1(x)
        x = self.conv2(x) + x
        guid = self.weights(x)
        x = self.conv3(x) + x
        sgs = {n: getattr(self, f"weight_{n}")(x) for n in ("sg1", "sg2",
                                                             "sg3")}
        x = self.conv11(x)
        x = self.conv12(x) + x
        sgs.update({n: getattr(self, f"weight_{n}")(x)
                    for n in ("sg11", "sg12")})
        guid_u = {k: v[:, :self.wsize] for k, v in sgs.items()}
        guid_v = {k: v[:, self.wsize:] for k, v in sgs.items()}
        return guid, guid_u, guid_v


def reverse_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) features -> the (B, H2*W2, H1, W1) volume f2 f1^T /
    sqrt(C), accumulated in float32: channels the second frame's pixels,
    the NLF's layout."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.reshape(b, c, h * w).float()
    f2 = fmap2.reshape(b, c, h * w).float()
    corr = torch.matmul(f2.transpose(1, 2), f1) / math.sqrt(c)
    return corr.view(b, h * w, h, w)


def nlf_volume(corr: torch.Tensor, guid: torch.Tensor) -> torch.Tensor:
    """The guided non-local filter of a (B, H2*W2, H1, W1) volume under
    the (B, 20, H1, W1) guidance, L1-normalised by 5 channels a
    direction."""
    gs = [_l1_normalize(k) for k in torch.split(guid, 5, dim=1)]
    return nlf_iter(corr, *gs)


class BasicMotionEncoder(nn.Module):
    """The motion encoder on the 4-D lookup and the two 1-D windows."""

    def __init__(self, corr_levels: int, corr_radius: int):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        cor1_planes = corr_levels * (2 * corr_radius + 1)
        self.convc1 = CastConv2d(cor_planes, 256, 1, padding=0)
        self.convc11 = CastConv2d(cor1_planes, 64, 1, padding=0)
        self.convc12 = CastConv2d(cor1_planes, 64, 1, padding=0)
        self.convc2 = CastConv2d(256, 192, 3, padding=1)
        self.convc21 = CastConv2d(64, 64, 3, padding=1)
        self.convc22 = CastConv2d(64, 64, 3, padding=1)
        self.convf1 = CastConv2d(2, 128, 7, padding=3)
        self.convf2 = CastConv2d(128, 64, 3, padding=1)
        self.conv = CastConv2d(64 + 192 + 64 * 2, 128 - 2, 3, padding=1)

    def forward(self, flow, corr, corr1, corr2):
        relu = torch.relu
        cor = relu(self.convc2(relu(self.convc1(corr))))
        c1 = relu(self.convc21(relu(self.convc11(corr1))))
        c2 = relu(self.convc22(relu(self.convc12(corr2))))
        flo = relu(self.convf2(relu(self.convf1(flow))))
        out = relu(self.conv(torch.cat([cor, c1, c2, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_levels: int, corr_radius: int,
                 hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, 64 * 9, 1, padding=0))

    def forward(self, net, inp, corr, corr1, corr2, flow):
        motion = self.encoder(flow, corr, corr1, corr2)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        # 0.25 scales the mask gradients, as in the reference
        return net, 0.25 * self.mask(net), self.flow_head(net)


def separate_volume(pyramid: List[torch.Tensor],
                    shape: Tuple[int, int, int, int, int]):
    """The max and the mean profile of each (B*H1*W1, H2_l, W2_l) level
    along x (over H2) and along y (over W2), each linearly resized (aligned
    corners) to W2 or H2: sep_u (B, 2L, W2, H1, W1) and sep_v (B, 2L, H2,
    H1, W1), channels (max, mean) a level."""
    b, h1, w1, h2, w2 = shape
    sep_u, sep_v = [], []
    for cl in pyramid:
        for dim, size, out in ((1, w2, sep_u), (2, h2, sep_v)):
            sep = torch.stack([cl.amax(dim), cl.mean(dim)], dim=1)
            sep = sep.view(b, h1, w1, 2, -1).permute(0, 3, 4, 1, 2)
            out.append(linear_resize_axis(sep, 2, size))
    return torch.cat(sep_u, dim=1), torch.cat(sep_v, dim=1)


def lookup_1d(corr1d: torch.Tensor, coords: torch.Tensor, radius: int,
              num_levels: int = 4, clamp_coords: bool = False
              ) -> torch.Tensor:
    """The 1-D pyramid lookup of ``corr1d`` (B, H1, W1, D) at ``coords``
    (B, H1, W1): level i the 2x average pool of level i - 1 along D (a
    trailing odd element dropped), read by linear interpolation at coords
    / 2^i + a - r for a in [0, 2r], zero outside; with ``clamp_coords`` the
    positions are first clamped to [-1, 1], the reference's quirk for u.
    Returns (B, L(2r+1), H1, W1), level-major, in the volume's dtype,
    computed in float32 at least; the two taps of every position are
    gathered."""
    b, h1, w1, _ = corr1d.shape
    vol = corr1d.reshape(b * h1 * w1, -1)
    dtype = torch.promote_types(vol.dtype, torch.float32)
    base = coords.reshape(-1, 1).to(dtype)
    dx = torch.arange(-radius, radius + 1, dtype=dtype, device=vol.device)
    out = []
    for i in range(num_levels):
        length = vol.shape[-1]
        if length == 0:  # a level pooled away reads zeros
            out.append(base.new_zeros((base.shape[0], dx.shape[0])))
            continue
        pos = base / 2 ** i + dx
        if clamp_coords:
            pos = pos.clamp(-1.0, 1.0)
        p0 = torch.floor(pos)
        frac = pos - p0
        table = vol.to(dtype)

        def tap(p):
            inside = (p >= 0) & (p <= length - 1)
            idx = p.clamp(0, length - 1).long()
            return torch.where(inside, torch.gather(table, 1, idx), 0.0)

        out.append(tap(p0) * (1 - frac) + tap(p0 + 1) * frac)
        even = length - length % 2
        vol = 0.5 * (vol[:, 0:even:2] + vol[:, 1:even:2])
    out = torch.cat(out, dim=1).to(corr1d.dtype)
    return out.view(b, h1, w1, -1).permute(0, 3, 1, 2)


class SeparableFlow(BaseModel):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/separableflow-things-31fe3b2d.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/separableflow-sintel-4c9a8c03.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/separableflow-kitti-c9395318.ckpt",
        "universal": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/separableflow-universal-87350d91.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32,
                 hidden_dim: int = 128, context_dim: int = 128, **kwargs):
        super().__init__(output_stride=64,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.iters = iters
        self.hidden_dim = hidden_dim
        self.context_dim = context_dim
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                 dropout=dropout)
        self.cnet = BasicEncoder(output_dim=hidden_dim + context_dim,
                                 norm_fn="batch", dropout=dropout)
        self.update_block = BasicUpdateBlock(corr_levels, corr_radius,
                                             hidden_dim=hidden_dim)
        self.guidance = Guidance(channels=256)
        self.cost_agg1 = CostAggregation(in_channel=8)
        self.cost_agg2 = CostAggregation(in_channel=8)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8,
        W/8) of the padded frames.  Training: ``flow_preds`` (3 + iters, B,
        2, H, W), the two earlier initial flows of the U-Nets, the initial
        flow, then every iteration's upsampled flow; and ``flows``.  The
        coords are detached at the start of every iteration."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]
        fmap1, fmap2 = self.fnet(image1), self.fnet(image2)
        guid, guid_u, guid_v = self.guidance(fmap1.detach(), image1)

        b, _, h, w = fmap1.shape
        corr = nlf_volume(reverse_volume(fmap1, fmap2), guid)
        # (B, H2*W2, H1, W1) -> levels of (B*H1*W1, H2, W2)
        level0 = corr.permute(0, 2, 3, 1).reshape(b * h * w, h, w)
        pyramid = pool_volume_pyramid(level0.to(fmap1.dtype),
                                      self.corr_levels)
        corr_lookup = make_corr_lookup(pyramid, self.corr_radius)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])

        sep_u, sep_v = separate_volume(pyramid, (b, h, w, h, w))
        u_out = self.cost_agg1(sep_u, guid_u, max_shift=384, is_ux=True,
                               training=training)
        v_out = self.cost_agg2(sep_v, guid_v, max_shift=384, is_ux=False,
                               training=training)
        flow_init = torch.cat([u_out[-2], v_out[-2]], dim=1)
        inits = ([torch.cat([u, v], dim=1) for u, v in zip(u_out[:2],
                                                             v_out[:2])]
                 if training else [])

        fi = interpolate(flow_init.detach() / 8.0, (h, w), mode="bilinear",
                         align_corners=True)
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        coords1 = coords0 + fi.float()
        corr1d_u = u_out[-1][:, 0].permute(0, 2, 3, 1)  # (B, H1, W1, W2)
        corr1d_v = v_out[-1][:, 0].permute(0, 2, 3, 1)  # (B, H1, W1, H2)

        r, levels = self.corr_radius, self.corr_levels
        mask = torch.zeros((b, 64 * 9, h, w), dtype=fmap1.dtype,
                           device=fmap1.device)
        flows_lr, masks = [], []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_lookup(coords1)
            c1 = lookup_1d(corr1d_u, coords1[:, 0], r, levels,
                           clamp_coords=True)
            c2 = lookup_1d(corr1d_v, coords1[:, 1], r, levels)
            flow = (coords1 - coords0).to(net.dtype)
            net, mask, delta = self.update_block(net, inp, corr, c1, c2,
                                                 flow)
            coords1 = coords1 + delta
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)

        if training:
            flow_ups = convex_upsample(torch.cat(flows_lr), torch.cat(masks))
            flow_ups = self.postprocess_predictions(
                flow_ups.unflatten(0, (len(flows_lr), b)), resizer,
                is_flow=True)
            init_preds = [self.postprocess_predictions(f, resizer,
                                                       is_flow=True)
                          for f in inits + [flow_init]]
            preds = torch.cat([torch.stack(init_preds), flow_ups])
            return {"flows": flow_ups[-1][:, None], "flow_preds": preds}
        flow_small = coords1 - coords0
        flow_up = self.postprocess_predictions(
            convex_upsample(flow_small, mask), resizer, is_flow=True)
        return {"flows": flow_up[:, None], "flow_small": flow_small}


@register_model
@trainable
class separableflow(SeparableFlow):
    pass
