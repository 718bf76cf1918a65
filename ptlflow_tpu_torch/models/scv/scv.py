"""SCV, the sparse cost volume flow (``ptlflow_tpu/models/scv/scv.py``),
NCHW: ``scv4`` at 1/4, ``scv8`` at 1/8.

Each pixel keeps its exact top-k matches of the (N x N) product of the two
frames' features (``compute_sparse_corr``: ``torch.topk`` over chunks of
rows, so the whole product is never live), and every iteration splats them,
displaced by the flow's updates, into 9x9 windows at 5 scales
(``sparse_windows``: a product of the separable bilinear weights, no
atomics).  Plain PyTorch on either device: the JAX package computes both in
XLA, the reference with faiss and torch.sparse.  Equal scores at the k-th
place may be picked in another order than the JAX package's ``lax.top_k``
picks them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from ...ops.correlation import coords_grid
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..raft.raft import SequenceLoss
from ..raft.update import BasicUpdateBlock
from .extractor import BasicEncoder, BasicEncoderQuarter

# the (rows x N) score chunk of compute_sparse_corr, in float32 elements
MAX_SCORE_ELEMS = 1 << 26


def compute_sparse_corr(fmap1: torch.Tensor, fmap2: torch.Tensor,
                        k: int = 32) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Each pixel's top-``k`` matches: fmap1, fmap2 (B, C, H, W) ->
    corr (B, N, k), the scores (float32 dot products) over sqrt(C),
    largest first; coords0 (N, 2), each pixel's (y, x); coords1 (B, N, k,
    2), the matches' (y, x) displacements.  Differentiable with respect to
    the features through the selected scores."""
    b, c, h, w = fmap1.shape
    n = h * w
    f1 = fmap1.flatten(2).transpose(1, 2).float()  # (B, N, C)
    f2 = fmap2.flatten(2).float()  # (B, C, N)
    rows = max(1, MAX_SCORE_ELEMS // max(n, 1))
    vals, idx = [], []
    for s in range(0, n, rows):
        v, i = torch.topk(torch.bmm(f1[:, s:s + rows], f2), k, dim=-1)
        vals.append(v)
        idx.append(i)
    corr = torch.cat(vals, dim=1) / math.sqrt(c)
    idx = torch.cat(idx, dim=1)
    gy, gx = torch.meshgrid(torch.arange(h, device=fmap1.device),
                            torch.arange(w, device=fmap1.device),
                            indexing="ij")
    coords0 = torch.stack([gy.reshape(-1), gx.reshape(-1)], -1).float()
    coords1 = (torch.stack([idx // w, idx % w], -1).float()
               - coords0[None, :, None, :])
    return corr.to(fmap1.dtype), coords0, coords1


def sparse_windows(corr: torch.Tensor, coords1: torch.Tensor, h: int,
                   w: int, num_scales: int = 5,
                   search_range: int = 4) -> torch.Tensor:
    """The matches splatted into dense windows: corr (B, N, k) at the
    fractional (y, x) displacements coords1 (B, N, k, 2), scaled by 0.5^i
    at scale i, each bilinearly into a (2r+1)^2 window around the pixel;
    corners outside [-r, r] are dropped.  Returns (B, scales*(2r+1)^2, H,
    W), scale-major, each window y-major.  The coords get no gradient."""
    b, n, k = corr.shape
    r = search_range
    ws = 2 * r + 1
    slots = torch.arange(ws, dtype=torch.float32, device=corr.device)
    cf = corr.float().reshape(b * n, k, 1)
    outs = []
    for i in range(num_scales):
        c = coords1.detach().float().reshape(b * n, k, 2) * (0.5 ** i)
        c0 = torch.floor(c)
        frac = (c - c0)[..., None]  # (BN, k, 2, 1)
        slot = c0[..., None] + r  # the floor corner's slot
        # separable weights (BN, k, 2, ws): a corner outside the window
        # matches no slot
        wgt = ((slots == slot) * (1 - frac) + (slots == slot + 1) * frac)
        ry, rx = wgt[:, :, 0], wgt[:, :, 1]
        out = torch.bmm((cf * ry).transpose(1, 2), rx)  # (BN, ws_y, ws_x)
        outs.append(out.reshape(b, h, w, ws * ws))
    return torch.cat(outs, dim=-1).permute(0, 3, 1, 2).to(corr.dtype)


class SCVBase(BaseModel):
    def __init__(self, num_k: int = 32, gamma: float = 0.8,
                 max_flow: float = 400.0, iters: int = 32,
                 stride: int = 8, **kwargs):
        super().__init__(loss_fn=SequenceLoss(gamma, max_flow),
                         output_stride=8, **kwargs)
        self.num_k = num_k
        self.iters = iters
        self.stride = stride

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Replicate-padded to /8 on both sides.  Eval: ``flows`` (B, 1, 2,
        H, W) and ``flow_small`` (B, 2, H/s, W/s), warm-started from
        ``inputs["prev_preds"]["flow_small"]`` where given.  Training:
        ``flow_preds`` (iters, B, 2, H, W) and ``flows``.  Each iteration
        moves the stored matches by minus the last iteration's update (x, y
        flipped to (y, x)) before the splat; the coords are detached at the
        start of every iteration."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]
        fmap1, fmap2 = self.fnet(image1), self.fnet(image2)
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :128])
        inp = torch.relu(cnet[:, 128:])

        b, _, h, w = fmap1.shape
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        coords1 = coords0
        prev = inputs.get("prev_preds")
        if prev is not None and prev.get("flow_small") is not None:
            coords1 = coords1 + forward_interpolate(prev["flow_small"])
        corr_val, _, coords1_cv = compute_sparse_corr(fmap1, fmap2,
                                                      k=self.num_k)
        delta = torch.zeros_like(coords0)
        flows_lr, masks = [], []
        for _ in range(self.iters):
            d_yx = delta.detach().flip(1).flatten(2).transpose(1, 2)
            coords1_cv = coords1_cv - d_yx[:, :, None, :]
            corr = sparse_windows(corr_val, coords1_cv, h, w)
            coords1 = coords1.detach()
            net, mask, delta = self.update_block(net, inp, corr,
                                                 coords1 - coords0)
            coords1 = coords1 + delta
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)

        f = self.stride
        if training:
            ups = convex_upsample(torch.cat(flows_lr), torch.cat(masks), f)
            ups = self.postprocess_predictions(
                ups.unflatten(0, (len(flows_lr), b)), resizer, is_flow=True)
            return {"flows": ups[-1][:, None], "flow_preds": ups}
        flow_small = coords1 - coords0
        flow_up = self.postprocess_predictions(
            convex_upsample(flow_small, mask, f), resizer, is_flow=True)
        return {"flows": flow_up[:, None], "flow_small": flow_small}


class SCVQuarter(SCVBase):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scv-quarter-chairs-4726627e.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scv-quarter-kitti-e86c7953.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scv-quarter-sintel-2d9b4a05.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scv-quarter-things-0dac9b66.ckpt",
    }

    def __init__(self, num_k: int = 32, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32, **kwargs):
        super().__init__(num_k=num_k, gamma=gamma, max_flow=max_flow,
                         iters=iters, stride=4, **kwargs)
        self.fnet = BasicEncoderQuarter(output_dim=256, norm_fn="instance")
        self.cnet = BasicEncoderQuarter(output_dim=256, norm_fn="batch")
        self.update_block = BasicUpdateBlock(None, None, hidden_dim=128,
                                             cor_planes=405,
                                             mask_channels=16 * 9)


class SCVEighth(SCVBase):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scv-eighth-chairs-8ba57294.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scv-eighth-things-9c893323.ckpt",
    }

    def __init__(self, num_k: int = 32, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32, **kwargs):
        super().__init__(num_k=num_k, gamma=gamma, max_flow=max_flow,
                         iters=iters, stride=8, **kwargs)
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="batch")
        self.update_block = BasicUpdateBlock(None, None, hidden_dim=128,
                                             cor_planes=405)


@register_model
@trainable
class scv4(SCVQuarter):
    pass


@register_model
@trainable
class scv8(SCVEighth):
    pass
