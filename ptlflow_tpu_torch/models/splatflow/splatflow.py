"""SplatFlow (``ptlflow_tpu/models/splatflow/splatflow.py``), NCHW: a
three-frame RAFT whose second pair reads the first pair's motion features
forward-splatted to its first frame; eval only, as in the JAX package (no
loss).

Each pair is RAFT's encoders and pyramid (``ops/correlation.py::CorrBlock``,
its lookup prepared once and launched once per iteration), a global
attention over the context features that aggregates the motion features,
and one of two GRU branches: the plain one for the first pair (or a lone
pair), the one that also reads the splatted features
(``ops/warp.py::softsplat_average`` by the first pair's 1/8 flow) for the
second.  Every layer casts its weights to its input's dtype, as in the JAX
package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import CorrBlock, coords_grid
from ...ops.upsample import convex_upsample
from ...ops.warp import softsplat_average
from ...utils.registry import register_model
from ..base import BaseModel
from ..llaflow.llaflow import GlobalAttention
from ..memfof.memfof import MemfofAggregate
from ..raft.extractor import BasicEncoder
from ..raft.update import BasicMotionEncoder, FlowHead, SepConvGRU


def _mask_head() -> nn.Sequential:
    return nn.Sequential(CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
                         CastConv2d(256, 64 * 9, 1, padding=0))


class SplatUpdate(nn.Module):
    """The motion encoder and its global aggregation, then one of two GRU,
    flow-head and mask branches: ``*_sp`` where the splatted motion
    features ``mf_t`` are given, the plain one otherwise.  Returns (net,
    mask, delta, motion features)."""

    def __init__(self, hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(4, 4)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=128 + hidden_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = _mask_head()
        self.aggregator = MemfofAggregate(dim=128, heads=1, dim_head=128)
        self.gru_sp = SepConvGRU(hidden_dim=hidden_dim,
                                 input_dim=128 + hidden_dim + hidden_dim * 2)
        self.flow_head_sp = FlowHead(hidden_dim, hidden_dim=256)
        self.mask_sp = _mask_head()

    def forward(self, net, inp, corr, flow, atte_s,
                mf_t: Optional[torch.Tensor] = None):
        mf = self.encoder(flow, corr)
        mf_s = self.aggregator(atte_s, mf)
        if mf_t is not None:
            gru, head, mask = self.gru_sp, self.flow_head_sp, self.mask_sp
            inp_cat = torch.cat([inp, mf, mf_s, mf_t], dim=1)
        else:
            gru, head, mask = self.gru, self.flow_head, self.mask
            inp_cat = torch.cat([inp, mf, mf_s], dim=1)
        net = gru(net, inp_cat)
        return net, 0.25 * mask(net), head(net), mf


class SplatFlow(BaseModel):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/splatflow-kitti-2aa8e145.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32, **kwargs):
        super().__init__(output_stride=8, loss_fn=None, **kwargs)
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.iters = iters
        self.hdim = self.cdim = 128
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                 dropout=dropout)
        self.cnet = BasicEncoder(output_dim=256, norm_fn="batch",
                                 dropout=dropout)
        self.att = GlobalAttention(dim=self.cdim, heads=1,
                                   dim_head=self.cdim)
        self.update = SplatUpdate(hidden_dim=self.hdim)

    def _forward_one_pair(self, image1: torch.Tensor, image2: torch.Tensor,
                          mf_t: Optional[torch.Tensor] = None):
        """The 8x flow of one pair, its last motion features and its 1/8
        flow."""
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2])).chunk(2)
        corr_fn = CorrBlock(fmap1, fmap2, self.corr_levels, self.corr_radius)
        b, _, h, w = fmap1.shape
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        coords1 = coords0
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hdim])
        inp = torch.relu(cnet[:, self.hdim:])
        atte_s = self.att(inp)
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_fn(coords1)
            net, mask, delta, mf = self.update(
                net, inp, corr, (coords1 - coords0).to(net.dtype), atte_s,
                mf_t)
            coords1 = coords1 + delta
        low = coords1 - coords0
        return convex_upsample(low, mask), mf, low

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8, W/8) of
        the last pair: frames 1 -> 2 of three, after 0 -> 1 whose motion
        features it splats; of the one pair of two frames."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        flow, mf, low = self._forward_one_pair(images[:, 0], images[:, 1])
        if images.shape[1] > 2:
            flow, _, low = self._forward_one_pair(
                images[:, 1], images[:, 2], mf_t=softsplat_average(mf, low))
        flow = self.postprocess_predictions(flow, resizer, is_flow=True)
        return {"flows": flow[:, None], "flow_small": low}


@register_model
class splatflow(SplatFlow):
    pass
