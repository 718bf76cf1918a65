"""Flow1D (``ptlflow_tpu/models/flow1d/flow1d.py``), NCHW: decomposed 1-D
correlations with cross attention; its eval forward with the warm start,
and its training forward.

The second frame's features are attended along x to correlate with the
first frame's along y (``rows_y``, (B, H1, W, H2)), and along y to correlate
along x (``rows_x``, (B, H, W1, W2)).  Each RAFT-style GRU iteration reads a
(2r+1)-wide bilinear window of each row at the current coords
(``lookup_1d``), zero outside the row: 2(2r+1) correlation channels.  The
JAX package reads the windows by a one-hot product, a TPU workaround; here
they are gathered.  The encoders and the update block are RAFT's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import coords_grid
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..gmflow.transformer import position_embedding_sine
from ..raft.extractor import BasicEncoder
from ..raft.raft import SequenceLoss
from ..raft.update import BasicUpdateBlock


class Attention1D(nn.Module):
    """Cross attention of ``feature1`` over ``feature2`` along x (each row)
    or y (each column), after self attention of ``feature1`` along the
    other axis where ``double_cross_attn``; the position embedding is added
    to the queries' and keys' inputs.  Logits and softmax in float32.
    Returns (output, attention)."""

    def __init__(self, in_channels: int, y_attention: bool = False,
                 double_cross_attn: bool = False):
        super().__init__()
        self.y_attention = y_attention
        self.double_cross_attn = double_cross_attn
        if double_cross_attn:
            self.self_attn = Attention1D(in_channels,
                                         y_attention=not y_attention)
        self.query_conv = CastConv2d(in_channels, in_channels, 1)
        self.key_conv = CastConv2d(in_channels, in_channels, 1)

    def forward(self, feature1: torch.Tensor, feature2: torch.Tensor,
                position: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = feature1.shape[1]
        if self.double_cross_attn:
            feature1 = self.self_attn(feature1, feature1, position)[0]
        query = feature1 if position is None else feature1 + position
        key = feature2 if position is None else feature2 + position
        query, key = self.query_conv(query), self.key_conv(key)
        # rows (b, h, w, c) for x; columns (b, w, h, c) for y
        perm, back = (((0, 3, 2, 1), (0, 3, 2, 1)) if self.y_attention
                      else ((0, 2, 3, 1), (0, 3, 1, 2)))
        q, k, v = (t.permute(*perm).float() for t in (query, key, feature2))
        scores = torch.matmul(q, k.transpose(-1, -2)) / c ** 0.5
        attn = torch.softmax(scores, dim=-1).to(feature2.dtype)
        out = torch.matmul(attn.float(), v).permute(*back)
        return out.to(feature1.dtype), attn


def corr_1d_x(feature1: torch.Tensor, feature2: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) x 2 -> rows (B, H, W1, W2) / sqrt(C), float32."""
    c = feature1.shape[1]
    f1 = feature1.permute(0, 2, 3, 1).float()
    f2 = feature2.permute(0, 2, 1, 3).float()
    return torch.matmul(f1, f2) / c ** 0.5


def corr_1d_y(feature1: torch.Tensor, feature2: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) x 2 -> columns (B, H1, W, H2) / sqrt(C), float32."""
    c = feature1.shape[1]
    f1 = feature1.permute(0, 3, 2, 1).float()  # (b, w, h1, c)
    f2 = feature2.permute(0, 3, 1, 2).float()  # (b, w, c, h2)
    return (torch.matmul(f1, f2) / c ** 0.5).transpose(1, 2)


def lookup_1d(rows: torch.Tensor, coords: torch.Tensor,
              radius: int) -> torch.Tensor:
    """The (2r+1)-wide bilinear window of each pixel's row: ``rows`` (B, H,
    W, L), ``coords`` (B, H, W) positions along L -> (B, 2r+1, H, W), tap
    ``a`` at coords + a - r, zero outside [0, L - 1]; gathered and
    weighted in float32, returned in the rows' dtype."""
    b, h, w, length = rows.shape
    table = rows.reshape(b * h * w, length).float()
    q = coords.reshape(b * h * w, 1).float()
    p0 = torch.floor(q)
    frac = q - p0
    pos = p0 + torch.arange(-radius, radius + 1, dtype=q.dtype,
                            device=q.device)

    def tap(p):
        inside = (p >= 0) & (p <= length - 1)
        idx = p.clamp(0, length - 1).long()
        return torch.where(inside, torch.gather(table, 1, idx), 0.0)

    out = tap(pos) * (1 - frac) + tap(pos + 1) * frac
    return out.reshape(b, h, w, 2 * radius + 1).permute(0, 3, 1, 2).to(
        rows.dtype)


class Flow1D(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flow1d-chairs-75cd85a1.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flow1d-things-bcd92815.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flow1d-sintel-28a093d3.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flow1d-kitti-803a0181.ckpt",
        "highres": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flow1d-highres-7ab476dc.ckpt",
    }

    def __init__(self, downsample_factor: int = 8,
                 feature_channels: int = 256, hidden_dim: int = 128,
                 context_dim: int = 128, corr_radius: int = 32,
                 iters: int = 32, gamma: float = 0.8, max_flow: float = 400,
                 **kwargs):
        super().__init__(output_stride=8,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.downsample_factor = downsample_factor
        self.feature_channels = feature_channels
        self.hidden_dim = hidden_dim
        self.context_dim = context_dim
        self.corr_radius = corr_radius
        self.iters = iters
        self.fnet = BasicEncoder(output_dim=feature_channels,
                                 norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=hidden_dim + context_dim,
                                 norm_fn="batch")
        self.attn_x = Attention1D(feature_channels, y_attention=False,
                                  double_cross_attn=True)
        self.attn_y = Attention1D(feature_channels, y_attention=True,
                                  double_cross_attn=True)
        if downsample_factor != 8 or context_dim != 128:
            raise ValueError("Flow1D's update block works at 1/8 on 128 "
                             "context channels, as every registered "
                             "configuration does")
        # RAFT's update block on the 2 x (2r+1) channels of 1-D windows
        self.update_block = BasicUpdateBlock(
            None, None, hidden_dim=hidden_dim,
            cor_planes=(2 * corr_radius + 1) * 2)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8,
        W/8); ``inputs["prev_preds"]["flow_small"]``, where given,
        warm-starts the coords by its forward projection.  Training:
        ``flow_preds`` (iters, B, 2, H, W) and ``flows``.  The coords are
        detached at the start of every iteration."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]
        feature1, feature2 = self.fnet(image1), self.fnet(image2)
        b, _, h, w = feature1.shape
        position = position_embedding_sine(
            h, w, self.feature_channels // 2, dtype=feature1.dtype,
            device=feature1.device)
        feature2_x, _ = self.attn_x(feature1, feature2, position)
        rows_y = corr_1d_y(feature1, feature2_x).to(feature1.dtype)
        feature2_y, _ = self.attn_y(feature1, feature2, position)
        rows_x = corr_1d_x(feature1, feature2_y).to(feature1.dtype)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])

        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=feature1.device)
        coords1 = coords0
        prev = inputs.get("prev_preds")
        if prev is not None and prev.get("flow_small") is not None:
            coords1 = coords1 + forward_interpolate(prev["flow_small"])
        df = self.downsample_factor
        mask = torch.zeros((b, df * df * 9, h, w), dtype=feature1.dtype,
                           device=feature1.device)
        r = self.corr_radius
        flows_lr, masks = [], []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = torch.cat([lookup_1d(rows_x, coords1[:, 0], r),
                              lookup_1d(rows_y, coords1[:, 1], r)], dim=1)
            net, mask, delta = self.update_block(
                net, inp, corr, (coords1 - coords0).to(net.dtype))
            coords1 = coords1 + delta
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)

        if training:
            flow_ups = convex_upsample(torch.cat(flows_lr), torch.cat(masks),
                                       factor=df)
            flow_ups = self.postprocess_predictions(
                flow_ups.unflatten(0, (len(flows_lr), b)), resizer,
                is_flow=True)
            return {"flows": flow_ups[-1][:, None], "flow_preds": flow_ups}
        flow_small = coords1 - coords0
        flow_up = self.postprocess_predictions(
            convex_upsample(flow_small, mask, factor=df), resizer,
            is_flow=True)
        return {"flows": flow_up[:, None], "flow_small": flow_small}


@register_model
@trainable
class flow1d(Flow1D):
    pass
