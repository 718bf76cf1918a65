"""CCMR and CCMR+ (``ptlflow_tpu/models/ccmr/ccmr.py``), NCHW: MS-RAFT+'s
coarse-to-fine loop (3 scales from 1/16 to 1/4, or 4 to 1/2 for CCMR+)
with XCiT cross-covariance attention for global context.

Each scale's context features go through an XCiT block (channels attend
over channels, q and k L2-normalised along the tokens, a temperature a
head) and every iteration's update block aggregates the motion features by
that context (``XCASeparate``: q and k from the context, v from the
motion).  The correlation is MS-RAFT+'s: ``AltCorrBlock`` by default,
``CorrBlock`` (the lookup kernel on the card) with
``alternate_corr=False``.  Unlike MS-RAFT+, CCMR upsamples the *flow* to
the next scale and re-anchors it on the finer grid.  ``flow_small`` is
MS-RAFT+'s (the padded frames' 1/16 flow).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ... import nn as pnn
from ...nn import CastConv2d, CastLinear
from ...ops.correlation import coords_grid
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample, upflow
from ...ops.warp import forward_interpolate
from ...utils.registry import ptlflow_trained, register_model
from ..base import BaseModel
from ..ms_raft_plus.ms_raft_plus import MSRAFTPlus, downflow, ms_layer
from ..raft.extractor import make_norm
from ..raft.raft import SequenceLoss
from ..raft.update import BasicMotionEncoder, FlowHead, SepConvGRU


def fourier_pos_encoding(h: int, w: int, hidden_dim: int = 32,
                         temperature: float = 10000, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(1, 2*hidden_dim, H, W): sin/cos features of the positions 1..H
    (the first ``hidden_dim`` channels) and 1..W, each scaled to (0, 2 pi],
    interleaved sin, cos."""
    eps = 1e-6
    y = torch.arange(1, h + 1, dtype=dtype, device=device)
    x = torch.arange(1, w + 1, dtype=dtype, device=device)
    y = y / (y[-1] + eps) * (2 * math.pi)
    x = x / (x[-1] + eps) * (2 * math.pi)
    dim_t = torch.arange(hidden_dim, dtype=dtype, device=device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / hidden_dim)

    def interleave(p):
        return torch.stack([torch.sin(p[:, 0::2]), torch.cos(p[:, 1::2])],
                           dim=-1).reshape(p.shape[0], -1)

    pos_y = interleave(y[:, None] / dim_t)  # (H, hidden)
    pos_x = interleave(x[:, None] / dim_t)  # (W, hidden)
    pos = torch.cat([pos_y.t()[:, :, None].expand(-1, h, w),
                     pos_x.t()[:, None, :].expand(-1, h, w)], dim=0)
    return pos[None]


class PositionalEncodingFourier(nn.Module):
    def __init__(self, hidden_dim: int = 32, dim: int = 128):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.token_projection = CastConv2d(hidden_dim * 2, dim, 1)

    def forward(self, h: int, w: int, like: torch.Tensor) -> torch.Tensor:
        pos = fourier_pos_encoding(h, w, self.hidden_dim, dtype=like.dtype,
                                   device=like.device)
        return self.token_projection(pos)


class LPI(nn.Module):
    """Depthwise 3x3 -> GELU -> GroupNorm(8) -> depthwise 3x3."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = CastConv2d(dim, dim, 3, padding=1, groups=dim)
        self.bn = nn.GroupNorm(num_groups=8, num_channels=dim)
        self.conv2 = CastConv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.bn(F.gelu(self.conv1(x))))


def xca_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               temperature: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Cross-covariance attention: (B, N, C) q, k, v -> (B, N, C).  Within
    a head the channels attend over the channels; q and k are
    L2-normalised along the tokens (norms floored at 1e-12)."""
    b, n, c = q.shape

    def split(t):  # (B, heads, C/heads, N)
        return t.reshape(b, n, num_heads, c // num_heads).permute(0, 2, 3, 1)

    q = F.normalize(split(q), dim=-1, eps=1e-12)
    k = F.normalize(split(k), dim=-1, eps=1e-12)
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = torch.softmax(attn * temperature.float(), dim=-1).to(v.dtype)
    out = torch.matmul(attn, split(v))  # (B, heads, C/heads, N)
    return out.permute(0, 3, 1, 2).reshape(b, n, c)


class XCA(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = CastLinear(dim, dim * 3, bias=qkv_bias)
        self.proj = CastLinear(dim, dim)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.temperature.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(xca_attend(q, k, v, self.temperature,
                                    self.num_heads))


class XCASeparate(nn.Module):
    """q and k from ``x_qk``, v from ``x_v``."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.to_qk = CastLinear(dim, dim * 2, bias=qkv_bias)
        self.to_v = CastLinear(dim, dim, bias=qkv_bias)
        self.proj = CastLinear(dim, dim)
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.temperature.fill_(1.0)

    def forward(self, x_qk: torch.Tensor, x_v: torch.Tensor) -> torch.Tensor:
        q, k = self.to_qk(x_qk).chunk(2, dim=-1)
        return self.proj(xca_attend(q, k, self.to_v(x_v), self.temperature,
                                    self.num_heads))


class XCAMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = CastLinear(dim, hidden)
        self.fc2 = CastLinear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class XCABlock(nn.Module):
    """Attention, local patch interaction (LPI) and MLP, each scaled by its
    layer scale (``gamma1``, ``gamma3``, ``gamma2``); in the separate
    variant ``norm1`` normalises both inputs."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 1,
                 separate: bool = False):
        super().__init__()
        self.separate = separate
        self.norm1 = pnn.LayerNorm(dim, eps=1e-6)
        self.attn = (XCASeparate if separate else XCA)(dim, num_heads)
        self.norm2 = pnn.LayerNorm(dim, eps=1e-6)
        self.mlp = XCAMlp(dim, int(dim * mlp_ratio))
        self.norm3 = pnn.LayerNorm(dim, eps=1e-6)
        self.local_mp = LPI(dim)
        for g in ("gamma1", "gamma2", "gamma3"):
            setattr(self, g, nn.Parameter(torch.ones(dim)))

    def init_own_params(self, gen: torch.Generator) -> None:
        for g in (self.gamma1, self.gamma2, self.gamma3):
            g.fill_(1.0)

    def forward(self, x: torch.Tensor, h: int, w: int,
                x_v: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        if self.separate:
            a = self.attn(self.norm1(x), self.norm1(x_v))
        else:
            a = self.attn(self.norm1(x))
        x = x + self.gamma1.to(x.dtype) * a
        lp = self.local_mp(self.norm3(x).transpose(1, 2).reshape(b, c, h, w))
        x = x + self.gamma3.to(x.dtype) * lp.flatten(2).transpose(1, 2)
        return x + self.gamma2.to(x.dtype) * self.mlp(self.norm2(x))


class XCiT(nn.Module):
    """Fourier positions added to the map, then XCA blocks over its tokens
    (one in the separate variant, whose values ``x_v`` get no
    positions)."""

    def __init__(self, embed_dim: int = 128, depth: int = 1,
                 num_heads: int = 8, mlp_ratio: float = 1,
                 separate: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList([
            XCABlock(embed_dim, num_heads, mlp_ratio, separate=separate)
            for _ in range(1 if separate else depth)])
        self.pos_embeder = PositionalEncodingFourier(dim=embed_dim)

    def forward(self, x: torch.Tensor,
                x_v: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, C, H, W) -> (B, C, H, W)."""
        b, c, h, w = x.shape
        tokens = (x + self.pos_embeder(h, w, x)).flatten(2).transpose(1, 2)
        tokens_v = None if x_v is None else x_v.flatten(2).transpose(1, 2)
        for blk in self.blocks:
            tokens = blk(tokens, h, w, x_v=tokens_v)
        return tokens.transpose(1, 2).reshape(b, c, h, w)


class CCMREncoder(nn.Module):
    """MS-RAFT+'s encoder with a 1x1 convolution after each up layer: 3 or
    4 scales from 1/16; ``context_mode`` gives every scale output_dim
    channels."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "group",
                 num_scales: int = 3, context_mode: bool = False):
        super().__init__()
        self.num_scales = num_scales
        self.norm1 = make_norm(norm_fn, 64)
        self.conv1 = CastConv2d(3, 64, 7, stride=2, padding=3)
        self.layer1 = ms_layer(64, 64, norm_fn, 1)
        self.layer2 = ms_layer(64, 96, norm_fn, 2)
        self.layer3 = ms_layer(96, 128, norm_fn, 2)
        self.layer4 = ms_layer(128, 160, norm_fn, 2)
        if context_mode:
            top = output_dim
            outs = (output_dim, output_dim, output_dim)
        else:
            top = 160
            outs = (128, 96, 64)
        self.conv2 = CastConv2d(160, top, 1)
        self.up_layer2 = ms_layer(top + 128, 128, norm_fn, 1)
        self.after_up_layer2_conv = CastConv2d(128, outs[0], 1)
        self.up_layer1 = ms_layer(outs[0] + 96, 96, norm_fn, 1)
        self.after_up_layer1_conv = CastConv2d(96, outs[1], 1)
        if num_scales == 4:
            self.up_layer0 = ms_layer(outs[1] + 64, 64, norm_fn, 1)
            self.after_up_layer0_conv = CastConv2d(64, outs[2], 1)

    def forward(self, x: torch.Tensor):
        x = torch.relu(self.norm1(self.conv1(x)))
        e1 = self.layer1(x)
        e2 = self.layer2(e1)
        e3 = self.layer3(e2)
        outs = [self.conv2(self.layer4(e3))]
        ups = [(self.up_layer2, self.after_up_layer2_conv, e3),
               (self.up_layer1, self.after_up_layer1_conv, e2)]
        if self.num_scales == 4:
            ups.append((self.up_layer0, self.after_up_layer0_conv, e1))
        for layer, after, skip in ups:
            up = interpolate(outs[-1], tuple(skip.shape[-2:]))
            outs.append(after(layer(torch.cat([up, skip], dim=1))))
        return outs


class CCMRUpdateBlock(nn.Module):
    """RAFT's motion encoder on 2 levels of radius 4, one XCiT aggregator a
    scale, a SepConvGRU on [context, motion, aggregated motion] and a
    2x2x9 mask."""

    def __init__(self, hidden_dim: int = 128, scale: int = 2,
                 num_heads: int = 8, depth: int = 1, mlp_ratio: float = 1,
                 num_scales: int = 3):
        super().__init__()
        self.encoder = BasicMotionEncoder(2, 4)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=256 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, scale * scale * 9, 1, padding=0))
        self.aggregator = nn.ModuleList([
            XCiT(embed_dim=128, depth=depth, num_heads=num_heads,
                 mlp_ratio=mlp_ratio, separate=True)
            for _ in range(num_scales)])

    def forward(self, net, inp, corr, flow, global_context,
                level_index: int = 0):
        motion = self.encoder(flow, corr)
        motion_global = self.aggregator[level_index](global_context,
                                                     x_v=motion)
        net = self.gru(net, torch.cat([inp, motion, motion_global], dim=1))
        delta_flow = self.flow_head(net)
        mask = 0.25 * self.mask(net)
        return net, mask, delta_flow


class CCMR(BaseModel):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/ccmr-kitti-612444b9.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/ccmr-sintel-e1760f37.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 iters: Sequence[int] = (8, 10, 15),
                 lookup_pyramid_levels: int = 2, lookup_radius: int = 4,
                 model_type: str = "CCMR", cnet_norm: str = "group",
                 fnet_norm: str = "group", num_scales: int = 3,
                 gamma: float = 0.8, max_flow: float = 400,
                 alternate_corr: bool = True, **kwargs):
        if (2 * lookup_radius + 1) ** 2 * lookup_pyramid_levels != 2 * 81:
            raise ValueError("CCMR's motion encoder takes 2 levels of "
                             "radius 4")
        super().__init__(output_stride=32,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.alternate_corr = alternate_corr
        self.iters = tuple(iters)
        self.lookup_pyramid_levels = lookup_pyramid_levels
        self.lookup_radius = lookup_radius
        self.num_scales = num_scales
        self.fnet = CCMREncoder(output_dim=256, norm_fn=fnet_norm,
                                num_scales=num_scales)
        self.cnet = CCMREncoder(output_dim=256, norm_fn=cnet_norm,
                                num_scales=num_scales, context_mode=True)
        self.update_block = CCMRUpdateBlock(hidden_dim=128, scale=2,
                                            num_heads=8, depth=1,
                                            mlp_ratio=1,
                                            num_scales=num_scales)
        self.xcit = nn.ModuleList([
            XCiT(embed_dim=128, depth=1, num_heads=8, mlp_ratio=1,
                 separate=False) for _ in range(num_scales)])

    _corr_block = MSRAFTPlus._corr_block

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Replicate-padded to /32 on both sides.  Eval: ``flows`` (B, 1, 2,
        H, W) and ``flow_small``, warm-started from
        ``inputs["prev_preds"]["flow_small"]`` where given.  Training (the
        JAX package marks neither name trainable, but its forward has a
        training mode): ``flow_preds`` of every iteration of every scale
        and ``flows``."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]
        b = image1.shape[0]
        fnet_pyr = self.fnet(torch.cat([image1, image2]))
        cnet_pyr = self.cnet(image1)

        h16, w16 = fnet_pyr[0].shape[-2:]
        coords0 = coords_grid(b, h16, w16, device=image1.device)
        coords1 = coords0
        prev = inputs.get("prev_preds")
        if prev is not None and prev.get("flow_small") is not None:
            coords1 = coords1 + forward_interpolate(prev["flow_small"])

        # the number of x2 steps from the first scale's convex upsampling
        # to the input size
        ups_offset = (self.num_scales - 1 if self.num_scales == 4
                      else self.num_scales)
        flow_preds, up_mask = [], None
        n_levels = len(fnet_pyr)
        for index in range(n_levels):
            fmap1, fmap2 = fnet_pyr[index].chunk(2)
            corr_fn = self._corr_block(fmap1, fmap2)
            cnet = cnet_pyr[index]
            net = torch.tanh(cnet[:, :128])
            inp = torch.relu(cnet[:, 128:])
            global_context = self.xcit[index](inp)
            if index >= 1:
                # the flow, upsampled and re-anchored on the finer grid
                flow = convex_upsample(coords1 - coords0, up_mask, 2)
                coords0 = coords_grid(b, *fmap1.shape[-2:],
                                      device=image1.device)
                coords1 = coords0 + flow
            flows_lr, masks = [], []
            for _ in range(self.iters[index]):
                coords1 = coords1.detach()
                net, up_mask, delta = self.update_block(
                    net, inp, corr_fn(coords1), coords1 - coords0,
                    global_context, level_index=index)
                coords1 = coords1 + delta
                if training:
                    flows_lr.append(coords1 - coords0)
                    masks.append(up_mask)
            if training:
                ups = convex_upsample(torch.cat(flows_lr), torch.cat(masks),
                                      2)
                for _ in range(ups_offset - index):
                    ups = upflow(ups, 2)
                flow_preds.append(self.postprocess_predictions(
                    ups.unflatten(0, (len(flows_lr), b)), resizer,
                    is_flow=True))

        flow_up = convex_upsample(coords1 - coords0, up_mask, 2)
        for _ in range(ups_offset - (n_levels - 1)):
            flow_up = upflow(flow_up, 2)
        if training:
            preds = torch.cat(flow_preds)
            return {"flows": preds[-1][:, None], "flow_preds": preds}
        return {"flows": self.postprocess_predictions(
                    flow_up, resizer, is_flow=True)[:, None],
                "flow_small": downflow(flow_up, 0.0625)}


class CCMRPlus(CCMR):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/ccmr+-kitti-c289d5e6.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/ccmr+-sintel-055b44ec.ckpt",
    }

    def __init__(self, iters: Sequence[int] = (8, 10, 10, 10),
                 model_type: str = "CCMR+", num_scales: int = 4, **kwargs):
        super().__init__(iters=iters, model_type=model_type,
                         num_scales=num_scales, **kwargs)


@register_model
@ptlflow_trained
class ccmr(CCMR):
    pass


@register_model
@ptlflow_trained
class ccmr_p(CCMRPlus):
    pass
