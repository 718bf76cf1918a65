"""StreamFlow (``ptlflow_tpu/models/streamflow/streamflow.py``), NCHW: the
flows of T - 1 consecutive frame pairs from T frames (4), in one batch.

The feature and context encoders are Twins-SVT (``Twins_CSC``) run once
over the frames stacked vertically, (T*H, W): at 1/4 a frame is H/4 rows,
which need not be a multiple of the 7-row windows, so windows straddle
frame boundaries, as in the JAX package.  One 4-level pyramid holds the 3
pairs (Q = 3 x H/8 x W/8) and its lookup is prepared once: one launch a
step, 15 a forward.  The update block (``SKUpdateBlock_TAM_v3``) adds to
SKFlow's motion features (``models/skflow/skflow.py``) GMA's aggregation
by a content-only attention and a transformer over each pixel's 3 pairs,
whose parameters start at zero (so that the block starts as the
identity); its flow head reads the pairs' channels concatenated and gives
every pair's step.  The mask is scaled by 0.25.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, CastLinear, LayerNorm
from ...ops.correlation import build_corr_pyramid, coords_grid, \
    make_corr_lookup
from ...ops.upsample import convex_upsample
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..flowformer.twins import TwinsSVT
from ..gma.gma_utils import Aggregate
from ..skflow.skflow import (PCBlock4_Deep_nopool_res,
                             SKMotionEncoder6_Deep_nopool_res)


class SequenceLoss:
    """RAFT's ``SequenceLoss`` summed over the frame pairs: for pair i, the
    sum over iterations k of gamma^(n-k-1) times the mean of valid *
    |pred - gt| against ``flows[:, i]`` and ``valids[:, i]``."""

    def __init__(self, gamma: float, max_flow: float):
        self.gamma = gamma
        self.max_flow = max_flow

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        preds = outputs["flow_preds"]  # (iters, B, T', 2, H, W)
        n = preds.shape[0]
        exponents = torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                 device=preds.device)
        weights = self.gamma ** exponents
        total = 0.0
        for i in range(preds.shape[2]):
            flow_gt = inputs["flows"][:, i]
            mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1, keepdim=True))
            valid = ((inputs["valids"][:, i] >= 0.5)
                     & (mag < self.max_flow)).to(flow_gt.dtype)
            i_loss = (preds[:, :, i] - flow_gt[None]).abs()
            per_iter = (valid[None] * i_loss).mean(dim=(1, 2, 3, 4))
            total = total + torch.sum(weights * per_iter)
        return total


class Twins_CSC(nn.Module):
    """Twins-SVT over the frames stacked vertically: (B, T, 3, H, W) ->
    (B, T, 256, H/8, W/8)."""

    def __init__(self):
        super().__init__()
        self.svt = TwinsSVT()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c, h, w = x.shape
        tall = x.transpose(1, 2).reshape(b, c, t * h, w)
        out = self.svt(tall)
        ho, wo = out.shape[2] // t, out.shape[3]
        return out.reshape(b, -1, t, ho, wo).transpose(1, 2)


class ContentAttention(nn.Module):
    """GMA's attention by content alone (the reference comments out its
    positional term): (B, C, H, W) -> (B, heads, HW, HW)."""

    def __init__(self, dim: int, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.to_qk = CastConv2d(dim, heads * dim_head * 2, 1, bias=False)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        b, _, h, w = fmap.shape
        q, k = self.to_qk(fmap).chunk(2, dim=1)
        q = self.scale * q.reshape(b, self.heads, self.dim_head,
                                   h * w).transpose(-1, -2)
        k = k.reshape(b, self.heads, self.dim_head, h * w)
        sim = torch.matmul(q.float(), k.float())
        return torch.softmax(sim, dim=-1).to(fmap.dtype)


class TimmAttention(nn.Module):
    """timm's ViT attention with a fused ``qkv``, on tokens (B, N, C)."""

    def __init__(self, dim: int, num_heads: int = 1, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = CastLinear(dim, dim * 3, bias=qkv_bias)
        self.proj = CastLinear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul((q * self.scale).float(),
                            k.float().transpose(-1, -2))
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn.float(), v.float()).to(x.dtype)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class TimmMlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = CastLinear(in_features, hidden_features)
        self.fc2 = CastLinear(hidden_features, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-norm attention and MLP over tokens (B, N, C).  Every parameter
    starts at zero, as in the reference (``zero_module``): see
    ``StreamFlow.init_params``."""

    def __init__(self, dim: int, num_heads: int = 1, mlp_ratio: int = 2):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.attn = TimmAttention(dim, num_heads=num_heads, qkv_bias=False)
        self.mlp = TimmMlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TemporalLayer2(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.transformer_block = TransformerBlock(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B*H*W, T', C) -> the same."""
        return self.transformer_block(x)


class SKUpdateBlock_TAM_v3(nn.Module):
    def __init__(self, decoder_dim: int, num_heads: int, use_gma: bool,
                 pcupdater_conv: Sequence[int], corr_levels: int,
                 corr_radius: int, T: int, k_conv: Sequence[int]):
        super().__init__()
        embed_dim = decoder_dim // 2
        self.encoder = SKMotionEncoder6_Deep_nopool_res(
            corr_levels, corr_radius, k_conv, out_dim=embed_dim)
        self.gma = use_gma
        if use_gma:
            self.aggregator = Aggregate(dim=embed_dim, dim_head=embed_dim,
                                        heads=num_heads)
        self.gru = PCBlock4_Deep_nopool_res(embed_dim * 5, embed_dim,
                                            pcupdater_conv)
        self.mask = nn.Sequential(
            CastConv2d(embed_dim, embed_dim * 2, 3, padding=1), nn.ReLU(),
            CastConv2d(embed_dim * 2, 8 * 8 * 9, 1, padding=0))
        self.transformer_block = TemporalLayer2(dim=embed_dim)
        self.flow_head = PCBlock4_Deep_nopool_res(embed_dim * (T - 1),
                                                  2 * (T - 1), k_conv)

    def forward(self, nets, inps, corrs, flows, attentions, t_pairs: int):
        """nets, inps, corrs, flows: (B*T', C, H, W), pair-major within a
        batch element -> (nets, masks (B, T', 576, H, W), steps (B, T', 2,
        H, W))."""
        bt, _, h, w = nets.shape
        b = bt // t_pairs
        motion = self.encoder(flows, corrs)
        c = motion.shape[1]
        # each pixel's T' pairs as a token sequence
        tokens = motion.reshape(b, t_pairs, c, h * w).permute(0, 3, 1, 2)
        mft = self.transformer_block(tokens.reshape(b * h * w, t_pairs, c))
        mft = mft.reshape(b, h * w, t_pairs, c).permute(0, 2, 3, 1).reshape(
            bt, c, h, w)
        if self.gma:
            mfg = self.aggregator(attentions, motion)
            inp_cats = torch.cat([inps, motion, mfg, mft], dim=1)
        else:
            inp_cats = torch.cat([inps, motion, mft], dim=1)
        nets = self.gru(torch.cat([nets, inp_cats], dim=1))
        # the flow head over the pairs' channels, pair-major
        delta = self.flow_head(nets.reshape(b, -1, h, w))
        masks = 0.25 * self.mask(nets)
        return (nets, masks.reshape(b, t_pairs, -1, h, w),
                delta.reshape(b, t_pairs, 2, h, w))


class StreamFlow(BaseModel):
    required_images = 4  # T frames -> T - 1 flows
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/streamflow-kitti-eaafa6ed.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/streamflow-sintel-af557e5e.ckpt",
        "spring": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/streamflow-spring-092f8a17.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/streamflow-things-c640255a.ckpt",
    }

    def __init__(self, decoder_dim: int = 256, corr_levels: int = 4,
                 corr_radius: int = 4, num_heads: int = 1,
                 pcupdater_conv=(1, 7), T: int = 4, k_conv=(1, 15),
                 use_gma: bool = True, iters: int = 15,
                 gamma: float = 0.8, max_flow: float = 400, **kwargs):
        super().__init__(output_stride=8,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.iters = iters
        self.hidden_dim = decoder_dim // 2
        self.context_dim = cdim = decoder_dim // 2
        self.fnet = Twins_CSC()
        self.cnet = Twins_CSC()
        self.update_block = SKUpdateBlock_TAM_v3(
            decoder_dim=decoder_dim, num_heads=num_heads, use_gma=use_gma,
            pcupdater_conv=list(pcupdater_conv), corr_levels=corr_levels,
            corr_radius=corr_radius, T=T, k_conv=list(k_conv))
        self.att = (ContentAttention(dim=cdim, heads=num_heads, dim_head=cdim)
                    if use_gma else None)

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "StreamFlow":
        """``BaseModel.init_params``, then the temporal transformer's
        parameters at zero, as the JAX package and the reference start
        them."""
        super().init_params(seed)
        for p in self.update_block.transformer_block.parameters():
            p.zero_()
        return self

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` and ``flow_small`` (B, T-1, 2, H(/8), W(/8)),
        pair i the flow from frame i to frame i + 1.  Training:
        ``flow_preds`` (iters, B, T-1, 2, H, W) and ``flows``, the last;
        the coords are detached at every iteration."""
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        b, t = images.shape[:2]
        tp = t - 1  # frame pairs
        fmaps = self.fnet(images)
        cnets = self.cnet(images[:, :-1])
        bt = b * tp
        h, w = fmaps.shape[-2:]
        corr_lookup = make_corr_lookup(
            build_corr_pyramid(fmaps[:, :-1].flatten(0, 1),
                               fmaps[:, 1:].flatten(0, 1), self.corr_levels),
            self.corr_radius)
        cn = cnets.flatten(0, 1)
        nets = torch.tanh(cn[:, :self.hidden_dim])
        inps = torch.relu(cn[:, self.hidden_dim:])
        attentions = self.att(inps) if self.att is not None else None

        coords0 = coords_grid(bt, h, w, dtype=torch.float32,
                              device=images.device)
        coords1 = coords0
        mask = images.new_zeros((bt, 64 * 9, h, w))
        flows_lr, masks = [], []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corrs = corr_lookup(coords1)
            nets, pair_masks, delta = self.update_block(
                nets, inps, corrs, coords1 - coords0, attentions,
                t_pairs=tp)
            coords1 = coords1 + delta.flatten(0, 1)
            mask = pair_masks.flatten(0, 1)
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)

        if training:
            flow_ups = convex_upsample(torch.stack(flows_lr).flatten(0, 1),
                                       torch.stack(masks).flatten(0, 1))
            flow_ups = self.postprocess_predictions(
                flow_ups.unflatten(0, (len(flows_lr), b, tp)), image_resizer,
                is_flow=True)
            return {"flows": flow_ups[-1], "flow_preds": flow_ups}
        flow_small = coords1 - coords0
        flow_up = self.postprocess_predictions(
            convex_upsample(flow_small, mask), image_resizer, is_flow=True)
        return {"flows": flow_up.unflatten(0, (b, tp)),
                "flow_small": flow_small.unflatten(0, (b, tp))}


@register_model
@trainable
class streamflow(StreamFlow):
    pass
