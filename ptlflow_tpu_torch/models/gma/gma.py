"""GMA (``ptlflow_tpu/models/gma/gma.py``), NCHW: RAFT with a global
motion aggregation.

The attention over the context features is computed once per forward,
outside the GRU loop; every iteration's update block aggregates the motion
features by it and feeds both to a wider SepConvGRU.  Everything else is
the port's RAFT (``models/raft/raft.py``): encoders, pyramid, the lookup
prepared once and launched once per iteration, convex upsampling, the warm
start from ``prev_preds["flow_small"]``, the training forward and
``SequenceLoss``.  It computes in fp32 only, as the JAX package's GMA does:
RAFT's ``mixed_precision`` and ``corr_dtype`` are refused.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...nn import CastConv2d
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..raft.extractor import BasicEncoder
from ..raft.raft import RAFT
from ..raft.update import BasicMotionEncoder, FlowHead, SepConvGRU
from .gma_utils import Aggregate, Attention


class GMAUpdateBlock(nn.Module):
    def __init__(self, corr_levels: int, corr_radius: int, num_heads: int,
                 hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=128 + hidden_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, 64 * 9, 1, padding=0))
        self.aggregator = Aggregate(dim=128, dim_head=128, heads=num_heads)

    def forward(self, net, inp, corr, flow, attention):
        motion_features = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion_features)
        net = self.gru(net, torch.cat([inp, motion_features, motion_global],
                                      dim=1))
        delta_flow = self.flow_head(net)
        # 0.25 scales the mask gradients, as in the reference
        mask = 0.25 * self.mask(net)
        return net, mask, delta_flow


class GMA(RAFT):
    fp32_only = True
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gma-chairs-d4ec321d.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gma-things-90aafb63.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gma-sintel-98d6f3d0.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/gma-kitti-8ca3ec80.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32, num_heads: int = 1,
                 position_only: bool = False,
                 position_and_content: bool = False,
                 alternate_corr: bool = False,
                 corr_dtype: Optional[str] = None,
                 mixed_precision: bool = False, **kwargs):
        # plain attributes, set before RAFT.__init__ calls _build
        self.num_heads = num_heads
        self.position_only = position_only
        self.position_and_content = position_and_content
        super().__init__(corr_levels=corr_levels, corr_radius=corr_radius,
                         dropout=dropout, gamma=gamma, max_flow=max_flow,
                         iters=iters, alternate_corr=alternate_corr,
                         corr_dtype=corr_dtype,
                         mixed_precision=mixed_precision, **kwargs)

    def _build(self):
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                 dropout=self.dropout)
        self.cnet = BasicEncoder(output_dim=self.hidden_dim + self.context_dim,
                                 norm_fn="batch", dropout=self.dropout)
        self.update_block = GMAUpdateBlock(self.corr_levels, self.corr_radius,
                                           self.num_heads,
                                           hidden_dim=self.hidden_dim)
        self.att = Attention(dim=self.context_dim,
                             position_only=self.position_only,
                             position_and_content=self.position_and_content,
                             heads=self.num_heads, max_pos_size=160,
                             dim_head=self.context_dim)

    def _update_extras(self, inp: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return (self.att(inp),)


@register_model
@trainable
@ptlflow_trained
class gma(GMA):
    pass
