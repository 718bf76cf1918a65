"""SKFlow (``ptlflow_tpu/models/skflow/skflow.py``), NCHW: GMA with
super-kernel update blocks.

``PCBlock4_Deep_nopool_res`` is a residual stack of 1x1 feed-forward
convolutions and large depthwise convolutions (one square k x k
convolution per entry of ``k_conv``, ``groups`` = channels: 1x1 and 15x15
in the motion encoder and flow head, 1x1 and 7x7 in the GRU), with exact
(erf) GELU, which is ``F.gelu``'s default and the JAX package's ``gelu``.
The update block feeds the motion features and GMA's aggregation of them
(``models/gma/gma_utils.py``) through such a block in place of the GRU.

Everything else is the port's GMA and RAFT: the encoders (one fnet pass a
frame), the pyramid, the attention taken once a forward, the lookup
prepared once and launched once an iteration, the upsampling mask carried
from the last iteration, the warm start from ``prev_preds["flow_small"]``,
the training forward and ``SequenceLoss``.  It computes in fp32 only, as
the JAX package's SKFlow: it has no mixed-precision mode, and RAFT's
``mixed_precision`` and ``corr_dtype`` are refused.  Every convolution
casts its weights to its input's dtype (``CastConv2d``), as the JAX
package's do.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d
from ...utils.registry import register_model, trainable
from ..gma.gma import GMA
from ..gma.gma_utils import Aggregate, Attention
from ..raft.extractor import BasicEncoder


class PCBlock4_Deep_nopool_res(nn.Module):
    """gelu(x + ffn1(x)); then gelu(x + conv(x)) for each depthwise conv of
    ``k_conv``; gelu(x + pw(x)); ffn2(x) to ``c_out`` channels."""

    def __init__(self, c_in: int, c_out: int, k_conv: Sequence[int]):
        super().__init__()
        self.conv_list = nn.ModuleList([
            CastConv2d(c_in, c_in, k, stride=1, padding=k // 2, groups=c_in)
            for k in k_conv])
        hidden = int(1.5 * c_in)
        self.ffn1 = nn.Sequential(
            CastConv2d(c_in, hidden, 1, padding=0), nn.GELU(),
            CastConv2d(hidden, c_in, 1, padding=0))
        self.pw = CastConv2d(c_in, c_in, 1, padding=0)
        self.ffn2 = nn.Sequential(
            CastConv2d(c_in, hidden, 1, padding=0), nn.GELU(),
            CastConv2d(hidden, c_out, 1, padding=0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(x + self.ffn1(x))
        for conv in self.conv_list:
            x = F.gelu(x + conv(x))
        x = F.gelu(x + self.pw(x))
        return self.ffn2(x)


class SKMotionEncoder6_Deep_nopool_res(nn.Module):
    """The lookup's L*(2r+1)^2 channels (324 at L = 4, r = 4) and the flow
    -> ``out_dim`` - 2 motion channels (126), with the flow appended last.
    StreamFlow's encoder is this one with ``out_dim`` half its decoder
    width."""

    def __init__(self, corr_levels: int, corr_radius: int,
                 k_conv: Sequence[int], out_dim: int = 128):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = PCBlock4_Deep_nopool_res(cor_planes, 256, k_conv)
        self.convc2 = PCBlock4_Deep_nopool_res(256, 192, k_conv)
        self.convf1 = CastConv2d(2, 128, 1, 1, 0)
        self.convf2 = PCBlock4_Deep_nopool_res(128, 64, k_conv)
        self.conv = PCBlock4_Deep_nopool_res(64 + 192, out_dim - 2, k_conv)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = self.convc2(F.gelu(self.convc1(corr)))
        flo = self.convf2(self.convf1(flow))
        out = self.conv(torch.cat([cor, flo], dim=1))
        return torch.cat([out, flow], dim=1)


class SKUpdateBlock6_Deep_nopoolres_AllDecoder(nn.Module):
    def __init__(self, corr_levels: int, corr_radius: int,
                 k_conv: Sequence[int], PCUpdater_conv: Sequence[int],
                 num_heads: int, hidden_dim: int):
        super().__init__()
        self.encoder = SKMotionEncoder6_Deep_nopool_res(
            corr_levels, corr_radius, k_conv)
        self.gru = PCBlock4_Deep_nopool_res(
            128 + hidden_dim + hidden_dim + 128, 128, PCUpdater_conv)
        self.flow_head = PCBlock4_Deep_nopool_res(128, 2, k_conv)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, 64 * 9, 1, padding=0))
        self.aggregator = Aggregate(dim=128, dim_head=128, heads=num_heads)

    def forward(self, net, inp, corr, flow, attention):
        motion_features = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion_features)
        inp_cat = torch.cat([inp, motion_features, motion_global], dim=1)
        net = self.gru(torch.cat([net, inp_cat], dim=1))
        delta_flow = self.flow_head(net)
        # 0.25 scales the mask gradients, as in the reference
        mask = 0.25 * self.mask(net)
        return net, mask, delta_flow


class SKFlow(GMA):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/skflow-kitti-4e1f8b63.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/skflow-sintel-98fb67cf.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/skflow-things-f84e6538.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32,
                 k_conv: Sequence[int] = (1, 15),
                 PCUpdater_conv: Sequence[int] = (1, 7),
                 num_heads: int = 1, position_only: bool = False,
                 position_and_content: bool = False,
                 alternate_corr: bool = False, **kwargs):
        # plain attributes, set before RAFT.__init__ calls _build
        self.k_conv = tuple(k_conv)
        self.pc_updater_conv = tuple(PCUpdater_conv)
        super().__init__(corr_levels=corr_levels, corr_radius=corr_radius,
                         dropout=dropout, gamma=gamma, max_flow=max_flow,
                         iters=iters, num_heads=num_heads,
                         position_only=position_only,
                         position_and_content=position_and_content,
                         alternate_corr=alternate_corr, **kwargs)

    def _build(self):
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                 dropout=self.dropout)
        self.cnet = BasicEncoder(output_dim=self.hidden_dim + self.context_dim,
                                 norm_fn="batch", dropout=self.dropout)
        self.update_block = SKUpdateBlock6_Deep_nopoolres_AllDecoder(
            corr_levels=self.corr_levels, corr_radius=self.corr_radius,
            k_conv=self.k_conv, PCUpdater_conv=self.pc_updater_conv,
            num_heads=self.num_heads, hidden_dim=self.hidden_dim)
        self.att = Attention(dim=self.context_dim,
                             position_only=self.position_only,
                             position_and_content=self.position_and_content,
                             heads=self.num_heads, max_pos_size=160,
                             dim_head=self.context_dim)


@register_model
@trainable
class skflow(SKFlow):
    pass
