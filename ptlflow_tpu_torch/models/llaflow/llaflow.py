"""LLA-Flow (``ptlflow_tpu/models/llaflow/llaflow.py``), NCHW: RAFT or GMA
with local similarity aggregation, its eval forward with the warm start and
its training forward (RAFT's ``SequenceLoss``).

Two 5x5 local-similarity attentions over the context features
(``LocalSimilar``, edge-padded windows): one enhances the second frame's
features (``LSA``), the other weighs each pixel's window of the first
frame's features in ``ShiftLSA``, whose volume is one (HW x 25C) by
(25C x HW) product: the JAX package's 25 window-shifted products summed in
one, the same terms in another order.  The all-pairs volume plus the
learned ``gamma`` times that volume is average-pooled into the pyramid
(``LLACorrBlock``), whose lookup is prepared once and launched once per
iteration.  ``gma=True`` (``llaflow``) updates with GMA's block and a
global attention without the position term, ``gma=False``
(``llaflow_raft``) with RAFT's.  Every layer casts its weights to its
input's dtype, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import (all_pairs_correlation, coords_grid,
                                make_corr_lookup, pool_volume_pyramid)
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..gma.gma import GMAUpdateBlock
from ..raft.extractor import BasicEncoder
from ..raft.raft import SequenceLoss
from ..raft.update import BasicUpdateBlock


def patch_extra(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size^2, H, W): each pixel's size x size
    window, edge-padded, window positions row-major (dy, then dx)."""
    b, c, h, w = x.shape
    p = size // 2
    xp = F.pad(x, (p, p, p, p), mode="replicate")
    return F.unfold(xp, size).reshape(b, c, size * size, h, w)


class GlobalAttention(nn.Module):
    """GMA's attention without the position term: the softmax over the
    keys of scaled query-key products, in float32, cast to ``fmap``'s
    dtype; (B, heads, HW, HW)."""

    def __init__(self, dim: int = 128, heads: int = 1, dim_head: int = 128):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head ** -0.5
        self.to_qk = CastConv2d(dim, heads * dim_head * 2, 1, bias=False)

    def scale_queries(self, q: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return q * self.scale

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        b, _, h, w = fmap.shape
        q, k = self.to_qk(fmap).chunk(2, dim=1)
        q, k = (t.reshape(b, self.heads, self.dim_head, h * w).transpose(
            -1, -2) for t in (q, k))
        q = self.scale_queries(q, h, w)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        return torch.softmax(sim, dim=-1).to(fmap.dtype)


class LocalSimilar(nn.Module):
    """Softmax similarity of each pixel's query with the keys of its 5x5
    window: (B, size^2, H, W)."""

    def __init__(self, dim: int = 128, heads: int = 1, size: int = 5):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.size = size
        self.to_qk = CastConv2d(dim, dim * 2, 1, bias=False)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        q, k = self.to_qk(fmap).chunk(2, dim=1)
        kn = patch_extra(k, self.size)
        sim = torch.einsum("bchw,bclhw->blhw", (q * self.scale).float(),
                           kn.float())
        return torch.softmax(sim, dim=1).to(fmap.dtype)


class LSA(nn.Module):
    """``fmap + gamma * (attention-weighted 5x5 window of to_v(fmap))``,
    ``gamma`` zero at init."""

    def __init__(self, dim: int = 128, heads: int = 1, size: int = 5):
        super().__init__()
        self.size = size
        self.to_v = CastConv2d(dim, dim, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.gamma.zero_()

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        vn = patch_extra(self.to_v(fmap), self.size)
        out = torch.einsum("blhw,bclhw->bchw", attn.float(), vn.float())
        return fmap + self.gamma.to(fmap.dtype) * out.to(fmap.dtype)


class ShiftLSA(nn.Module):
    """The shift-aggregated volume (B, HW, H, W): for each pair (n, m) the
    sum over the 5x5 window positions l of the attention-weighted
    ``to_f1`` features at l of n's window with ``to_f2`` of the second
    frame at m shifted by l, over sqrt(dim / heads).  One float32 product
    of (HW x 25C) by (25C x HW)."""

    def __init__(self, dim: int = 256, heads: int = 1, size: int = 5):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.size = size
        self.to_f1 = CastConv2d(dim, dim, 1, bias=False)
        self.to_f2 = CastConv2d(dim, dim, 1, bias=False)

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor,
                fmap2: torch.Tensor) -> torch.Tensor:
        b, c, h, w = fmap.shape
        n = self.size * self.size
        f1s = attn[:, None] * patch_extra(self.to_f1(fmap), self.size)
        f2n = patch_extra(self.to_f2(fmap2), self.size)
        corr = torch.matmul(
            f1s.reshape(b, c * n, h * w).transpose(1, 2).float(),
            f2n.reshape(b, c * n, h * w).float())
        corr = corr / math.sqrt(self.dim // self.heads)
        return corr.reshape(b, h * w, h, w)


class LLACorrBlock:
    """The all-pairs volume of ``fmap1`` and ``fmap2`` plus ``gamma`` times
    ``corr2`` (ShiftLSA's), average-pooled into ``num_levels`` levels, and
    its lookup at ``radius``, prepared once here."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 gamma: torch.Tensor, corr2: torch.Tensor,
                 num_levels: int = 4, radius: int = 4):
        b, _, h, w = fmap1.shape
        corr = all_pairs_correlation(fmap1, fmap2)
        corr = corr + gamma.to(corr.dtype) * corr2
        self.pyramid = pool_volume_pyramid(corr.reshape(b * h * w, h, w),
                                           num_levels)
        self.lookup = make_corr_lookup(self.pyramid, radius)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        return self.lookup(coords)


class LLAFlow(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/llaflow_gma-chairs-c4225e37.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/llaflow_gma-things-1cfce7fe.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/llaflow_gma-sintel-4ca6e4a9.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/llaflow_gma-kitti-ac312150.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32, gma: bool = True,
                 **kwargs):
        super().__init__(output_stride=8,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.iters = iters
        self.use_gma = gma
        self.hidden_dim = 128
        self.context_dim = 128
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                 dropout=dropout)
        self.cnet = BasicEncoder(output_dim=256, norm_fn="batch",
                                 dropout=dropout)
        self.ls1 = LocalSimilar(dim=128, heads=1, size=5)
        self.ls2 = LocalSimilar(dim=128, heads=1, size=5)
        self.s_lsa = ShiftLSA(dim=256, heads=1, size=5)
        self.lsa = LSA(dim=256, heads=1, size=5)
        if gma:
            self.update_block = GMAUpdateBlock(corr_levels, corr_radius,
                                               num_heads=1, hidden_dim=128)
            self.att = GlobalAttention(dim=128, heads=1, dim_head=128)
        else:
            self.update_block = BasicUpdateBlock(corr_levels, corr_radius,
                                                 hidden_dim=128)
            self.att = None
        # the blend of the ShiftLSA volume, zero at init
        self.gamma = nn.Parameter(torch.zeros(1))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.gamma.zero_()

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8,
        W/8); ``inputs["prev_preds"]["flow_small"]``, where given,
        warm-starts the coords by its forward projection.  Training:
        ``flow_preds`` (iters, B, 2, H, W) and ``flows``; the coords are
        detached at the start of every iteration."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])
        ls1, ls2 = self.ls1(inp), self.ls2(inp)
        extra = () if self.att is None else (self.att(inp),)

        fmap1, fmap2 = self.fnet(torch.cat([image1, image2])).chunk(2)
        fmap2 = self.lsa(ls2, fmap2)
        corr2 = self.s_lsa(ls1, fmap1, fmap2)
        corr_fn = LLACorrBlock(fmap1, fmap2, self.gamma, corr2,
                               self.corr_levels, self.corr_radius)

        b, _, h, w = fmap1.shape
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        coords1 = coords0
        prev = inputs.get("prev_preds")
        if prev is not None and prev.get("flow_small") is not None:
            coords1 = coords1 + forward_interpolate(prev["flow_small"])

        flows_lr, masks = [], []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            net, mask, delta = self.update_block(
                net, inp, corr, (coords1 - coords0).to(net.dtype), *extra)
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
            return {"flows": flow_ups[-1][:, None], "flow_preds": flow_ups}
        flow_small = coords1 - coords0
        flow_up = self.postprocess_predictions(
            convex_upsample(flow_small, mask), resizer, is_flow=True)
        return {"flows": flow_up[:, None], "flow_small": flow_small}


class LLAFlowRAFT(LLAFlow):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/llaflow_raft-chairs-a720c578.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/llaflow_raft-things-b6cb5f0e.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/llaflow_raft-sintel-69c82cea.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/llaflow_raft-kitti-b8b43046.ckpt",
    }

    def __init__(self, gma: bool = False, **kwargs):
        super().__init__(gma=gma, **kwargs)


@register_model
@trainable
class llaflow(LLAFlow):
    pass


@register_model
@trainable
class llaflow_raft(LLAFlowRAFT):
    pass
