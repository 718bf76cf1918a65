"""VideoFlow (``ptlflow_tpu/models/videoflow/videoflow.py``), NCHW: flow
forward and backward from the middle of 3 frames (BOF) or of each inner
frame of N (MOF).

Both run the Twins-SVT backbone (``models/flowformer/twins.py``) on every
frame and on the middle frames for the context, GMA's attention taken once
a forward (``models/gma/gma_utils.py``), and SKFlow's super-kernel blocks
(``models/skflow/skflow.py``), whose depthwise 15x15 convolutions run on
PyTorch's own kernels.  The forward and the backward correlation blocks are
each a 4-level pyramid prepared once (``CorrBlock``): two lookup launches a
decoder step.  Two frames are padded to three by repeating the first.

BOF's motion encoder reads the two lookups concatenated, the 1->2 pair's
first, and runs ``convc1`` on each half with one set of weights; its flow
head gives both steps in that order, while its mask, scaled by 0.25, holds
the 1->0 pair's first.  MOF carries a 48-channel motion state per
inner frame, started from ``init_hidden_state`` ((1, 1, 48, 1, 1), the
reference's layout), whose neighbours' states are shifted in with zero
ends and warped by ``bilinear_sampler`` at the flows; its mask is scaled
by 100 and its output is the middle inner frame.  Both are eval models, as
in the JAX package: no loss and not trainable, though ``training=True``
gives every step's flows in ``flow_preds``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import CorrBlock, coords_grid
from ...ops.grid_sample import bilinear_sampler
from ...ops.upsample import convex_upsample
from ...utils.registry import register_model
from ..base import BaseModel
from ..flowformer.twins import twins_svt_large
from ..gma.gma_utils import Aggregate, Attention
from ..skflow.skflow import PCBlock4_Deep_nopool_res

K_CONV = (1, 15)
PC_UPDATER_CONV = (1, 7)


def pad_to_three(images: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3, H, W) -> (B, 3, 3, H, W), the first frame repeated."""
    if images.shape[1] == 2:
        images = torch.cat([images[:, :1], images], dim=1)
    return images


class SKMotionEncoderBOF(nn.Module):
    def __init__(self, corr_radius: int, corr_levels: int,
                 cost_heads_num: int, k_conv=K_CONV):
        super().__init__()
        self.cor_planes = ((corr_radius * 2 + 1) ** 2 * cost_heads_num
                           * corr_levels)
        self.convc1 = PCBlock4_Deep_nopool_res(self.cor_planes, 128, k_conv)
        self.convc2 = PCBlock4_Deep_nopool_res(256, 192, k_conv)
        self.convf1_ = CastConv2d(4, 128, 1, 1, 0)
        self.convf2 = PCBlock4_Deep_nopool_res(128, 64, k_conv)
        self.conv = PCBlock4_Deep_nopool_res(64 + 192, 128 - 4, k_conv)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        corr1, corr2 = corr.split(self.cor_planes, dim=1)
        cor = F.gelu(torch.cat([self.convc1(corr1), self.convc1(corr2)],
                               dim=1))
        cor = self.convc2(cor)
        flo = self.convf2(self.convf1_(flow))
        out = self.conv(torch.cat([cor, flo], dim=1))
        return torch.cat([out, flow], dim=1)


class SKUpdateBlockBOF(nn.Module):
    def __init__(self, corr_radius: int, corr_levels: int,
                 cost_heads_num: int, hidden_dim: int):
        super().__init__()
        self.encoder = SKMotionEncoderBOF(corr_radius, corr_levels,
                                          cost_heads_num)
        self.gru = PCBlock4_Deep_nopool_res(
            128 + hidden_dim + hidden_dim + 128, 128, PC_UPDATER_CONV)
        self.flow_head = PCBlock4_Deep_nopool_res(128, 4, K_CONV)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, 64 * 9 * 2, 1, padding=0))
        self.aggregator = Aggregate(dim=128, dim_head=128, heads=1)

    def forward(self, net, inp, corr, flow, attention, get_mask=True):
        motion_features = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion_features)
        inp_cat = torch.cat([inp, motion_features, motion_global], dim=1)
        net = self.gru(torch.cat([net, inp_cat], dim=1))
        delta_flow = self.flow_head(net)
        mask = 0.25 * self.mask(net) if get_mask else None
        return net, mask, delta_flow


def upsample_pair(model: BaseModel, flow: torch.Tensor, mask: torch.Tensor,
                  resizer, factor: int = 8) -> torch.Tensor:
    return model.postprocess_predictions(convex_upsample(flow, mask, factor),
                                         resizer, is_flow=True)


class VideoFlowBOF(BaseModel):
    pretrained_checkpoints = {
        "things_288960": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/videoflow_bof-things_288960noise-d581490a.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/videoflow_bof-sintel-c2010097.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/videoflow_bof-kitti-fa9af79c.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 gma: str = "GMA-SK2", decoder_depth: int = 32,
                 cost_heads_num: int = 1, **kwargs):
        super().__init__(loss_fn=None, output_stride=8, **kwargs)
        assert gma == "GMA-SK2", "only the published GMA-SK2 configuration"
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.decoder_depth = decoder_depth
        self.hidden_dim = 128
        self.context_dim = 128
        self.cnet = twins_svt_large()
        self.fnet = twins_svt_large()
        self.update_block = SKUpdateBlockBOF(
            corr_radius=corr_radius, corr_levels=corr_levels,
            cost_heads_num=cost_heads_num, hidden_dim=128)
        self.att = Attention(dim=128, heads=1, max_pos_size=160,
                             dim_head=128)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """3 frames (or 2, padded): eval gives ``flows`` 1->2 and
        ``flows_bw`` 1->0 (B, 1, 2, H, W), and ``flow_small`` and
        ``flow_bw_small`` (B, 2, H/8, W/8); ``training`` gives
        ``flow_preds`` (depth, B, 2, 2, H, W), the pairs (1->2, 1->0) of
        every step, and ``flows``/``flows_bw`` of the last."""
        images = pad_to_three(inputs["images"])
        if images.shape[1] != 3:
            raise ValueError("videoflow_bof takes 3 frames")
        images, image_resizer = self.preprocess_images(
            images, bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        b, n, _, h, w = images.shape
        fmaps = self.fnet(images.flatten(0, 1))
        fmaps = fmaps.unflatten(0, (b, n))
        hf, wf = fmaps.shape[-2:]
        corr_fn_21 = CorrBlock(fmaps[:, 1], fmaps[:, 0], self.corr_levels,
                               self.corr_radius)
        corr_fn_23 = CorrBlock(fmaps[:, 1], fmaps[:, 2], self.corr_levels,
                               self.corr_radius)

        cnet = self.cnet(images[:, 1])
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])
        attention = self.att(inp)

        coords0 = coords_grid(b, hf, wf, dtype=images.dtype,
                              device=images.device)
        flow21 = images.new_zeros((b, 2, hf, wf))
        flow23 = images.new_zeros((b, 2, hf, wf))
        preds = []
        for _ in range(self.decoder_depth):
            flow23, flow21 = flow23.detach(), flow21.detach()
            corr = torch.cat([corr_fn_23(coords0 + flow23),
                              corr_fn_21(coords0 + flow21)], dim=1)
            net, up_mask, delta = self.update_block(
                net, inp, corr, torch.cat([flow23, flow21], dim=1),
                attention, get_mask=training)
            flow23 = flow23 + delta[:, 0:2]
            flow21 = flow21 + delta[:, 2:4]
            if training:
                mask21, mask23 = up_mask.split(64 * 9, dim=1)
                preds.append(torch.stack(
                    [upsample_pair(self, flow23, mask23, image_resizer),
                     upsample_pair(self, flow21, mask21, image_resizer)],
                    dim=1))

        if training:
            flow_preds = torch.stack(preds)
            return {"flows": flow_preds[-1][:, :1],
                    "flows_bw": flow_preds[-1][:, 1:],
                    "flow_preds": flow_preds}
        mask21, mask23 = (0.25 * self.update_block.mask(net)).split(64 * 9,
                                                                    dim=1)
        return {"flows": upsample_pair(self, flow23, mask23,
                                       image_resizer)[:, None],
                "flows_bw": upsample_pair(self, flow21, mask21,
                                          image_resizer)[:, None],
                "flow_small": flow23, "flow_bw_small": flow21}


# --------------------------------------------------------------------- MOF

class VelocityUpdateBlock(nn.Module):
    """Unused by the forward, as in the reference, and kept so that its
    checkpoints load strictly."""

    def __init__(self, c_in: int = 43 + 128 + 43, c_out: int = 43,
                 c_hidden: int = 64):
        super().__init__()
        self.mlp = nn.Sequential(
            CastConv2d(c_in, c_hidden, 3, padding=1), nn.GELU(),
            CastConv2d(c_hidden, c_hidden, 3, padding=1), nn.GELU(),
            CastConv2d(c_hidden, c_out, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class SKMotionEncoderMOF(nn.Module):
    """The motion encoder with a 48-channel state per inner frame."""

    def __init__(self, corr_radius: int, corr_levels: int,
                 cost_heads_num: int, k_conv=K_CONV):
        super().__init__()
        self.cor_planes = ((corr_radius * 2 + 1) ** 2 * cost_heads_num
                           * corr_levels)
        self.convc1 = PCBlock4_Deep_nopool_res(self.cor_planes, 128, k_conv)
        self.convc2 = PCBlock4_Deep_nopool_res(256, 192, k_conv)
        self.convf1_ = CastConv2d(4, 128, 1, 1, 0)
        self.convf2 = PCBlock4_Deep_nopool_res(128, 64, k_conv)
        self.conv = PCBlock4_Deep_nopool_res(64 + 192 + 48 * 3, 128 - 4 + 48,
                                             k_conv)
        self.velocity_update_block = VelocityUpdateBlock()
        self.init_hidden_state = nn.Parameter(torch.zeros(1, 1, 48, 1, 1))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.init_hidden_state.copy_(
            torch.randn(self.init_hidden_state.shape, generator=gen))

    def initial_state(self, b: int, n: int, h: int, w: int) -> torch.Tensor:
        """``init_hidden_state`` tiled over ``b`` x ``n`` inner frames:
        (b*n, 48, h, w)."""
        return self.init_hidden_state.expand(b, n, 48, h, w).reshape(
            b * n, 48, h, w)

    def forward(self, motion_hidden_state: Optional[torch.Tensor],
                forward_flow, backward_flow, coords0, forward_corr,
                backward_corr, bs: int):
        bn, _, h, w = forward_flow.shape
        n = bn // bs
        if motion_hidden_state is None:
            motion_hidden_state = self.initial_state(bs, n, h, w)
        mhs = motion_hidden_state.reshape(bs, n, 48, h, w)
        zeros = mhs.new_zeros((bs, 1, 48, h, w))
        # each frame's state from its later and its earlier neighbour,
        # warped along the flow to that neighbour
        fwd_mhs = bilinear_sampler(
            torch.cat([mhs[:, 1:], zeros], dim=1).reshape(bn, 48, h, w),
            forward_flow + coords0)
        bwd_mhs = bilinear_sampler(
            torch.cat([zeros, mhs[:, :n - 1]], dim=1).reshape(bn, 48, h, w),
            backward_flow + coords0)
        cor = F.gelu(torch.cat([self.convc1(forward_corr),
                                self.convc1(backward_corr)], dim=1))
        cor = self.convc2(cor)
        flow = torch.cat([forward_flow, backward_flow], dim=1)
        flo = self.convf2(self.convf1_(flow))
        out = self.conv(torch.cat(
            [cor, flo, fwd_mhs, bwd_mhs, mhs.reshape(bn, 48, h, w)], dim=1))
        out, motion_hidden_state = out[:, :124], out[:, 124:]
        return torch.cat([out, flow], dim=1), motion_hidden_state


class SKUpdateBlockMOF(nn.Module):
    def __init__(self, feat_dim: int, down_ratio: int, corr_radius: int,
                 corr_levels: int, cost_heads_num: int, hidden_dim: int):
        super().__init__()
        ratio = 256 // feat_dim
        self.encoder = SKMotionEncoderMOF(corr_radius, corr_levels,
                                          cost_heads_num)
        self.gru = PCBlock4_Deep_nopool_res(
            128 + hidden_dim + hidden_dim + 128, 128 // ratio,
            PC_UPDATER_CONV)
        self.flow_head = PCBlock4_Deep_nopool_res(128 // ratio, 4, K_CONV)
        self.mask = nn.Sequential(
            CastConv2d(128 // ratio, 256 // ratio, 3, padding=1), nn.ReLU(),
            CastConv2d(256 // ratio, down_ratio ** 2 * 9 * 2, 1, padding=0))
        self.aggregator = Aggregate(dim=128, dim_head=128, heads=1)

    def forward(self, net, motion_hidden_state, inp, forward_corr,
                backward_corr, forward_flow, backward_flow, coords0,
                attention, bs: int, get_mask: bool = True):
        motion_features, motion_hidden_state = self.encoder(
            motion_hidden_state, forward_flow, backward_flow, coords0,
            forward_corr, backward_corr, bs=bs)
        motion_global = self.aggregator(attention, motion_features)
        inp_cat = torch.cat([inp, motion_features, motion_global], dim=1)
        net = self.gru(torch.cat([net, inp_cat], dim=1))
        delta_flow = self.flow_head(net)
        mask = 100.0 * self.mask(net) if get_mask else None
        return net, motion_hidden_state, mask, delta_flow


class VideoFlowMOF(BaseModel):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/videoflow_mof-kitti-293b4f59.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/videoflow_mof-sintel-739e4d3a.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/videoflow_mof-things-e24551af.ckpt",
        "things_288960": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/videoflow_mof-things_288960noise-0615a42e.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 gma: str = "GMA-SK2", decoder_depth: int = 32,
                 feat_dim: int = 256, Tfusion: str = "stack",
                 down_ratio: int = 8, cost_heads_num: int = 1, **kwargs):
        super().__init__(loss_fn=None, output_stride=8, **kwargs)
        assert Tfusion == "stack" and down_ratio == 8, \
            "only the published stack/8x configuration"
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.decoder_depth = decoder_depth
        self.down_ratio = down_ratio
        self.hidden_dim = feat_dim // 2
        self.context_dim = feat_dim // 2
        ratio = 256 // feat_dim
        self.cnet = twins_svt_large()
        self.fnet = twins_svt_large()
        self.update_block = SKUpdateBlockMOF(
            feat_dim=feat_dim, down_ratio=down_ratio,
            corr_radius=corr_radius, corr_levels=corr_levels,
            cost_heads_num=cost_heads_num, hidden_dim=128 // ratio)
        self.att = Attention(dim=128 // ratio, heads=1, max_pos_size=160,
                             dim_head=128 // ratio)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """N frames (2 padded to 3): eval gives the middle inner frame's
        ``flows`` (forward) and ``flows_bw`` (B, 1, 2, H, W), and every
        inner frame's ``flow_small`` and ``flow_bw_small`` (B*(N-2), 2,
        H/8, W/8); ``training`` gives ``flow_preds`` (depth, B, 2, 2, H,
        W), the middle frame's (forward, backward) pair of every step."""
        images = pad_to_three(inputs["images"])
        images, image_resizer = self.preprocess_images(
            images, bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        b, n, _, h, w = images.shape
        dr = self.down_ratio
        fmaps = self.fnet(images.flatten(0, 1)).unflatten(0, (b, n))
        hf, wf = fmaps.shape[-2:]
        center = fmaps[:, 1:n - 1].flatten(0, 1)
        forward_corr_fn = CorrBlock(center, fmaps[:, 2:n].flatten(0, 1),
                                    self.corr_levels, self.corr_radius)
        backward_corr_fn = CorrBlock(center, fmaps[:, 0:n - 2].flatten(0, 1),
                                     self.corr_levels, self.corr_radius)

        cnet = self.cnet(images[:, 1:n - 1].flatten(0, 1))
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])
        attention = self.att(inp)

        bn = b * (n - 2)
        coords0 = coords_grid(bn, hf, wf, dtype=images.dtype,
                              device=images.device)
        fwd_flow = images.new_zeros((bn, 2, hf, wf))
        bwd_flow = images.new_zeros((bn, 2, hf, wf))
        mhs = self.update_block.encoder.initial_state(b, n - 2, hf, wf)
        mid = (n - 2) // 2

        def pick(x):  # the middle inner frame of each batch element
            return x.unflatten(0, (b, n - 2))[:, mid]

        preds = []
        for _ in range(self.decoder_depth):
            fwd_flow, bwd_flow = fwd_flow.detach(), bwd_flow.detach()
            net, mhs, up_mask, delta = self.update_block(
                net, mhs, inp, forward_corr_fn(coords0 + fwd_flow),
                backward_corr_fn(coords0 + bwd_flow), fwd_flow, bwd_flow,
                coords0, attention, bs=b, get_mask=training)
            fwd_flow = fwd_flow + delta[:, 0:2]
            bwd_flow = bwd_flow + delta[:, 2:4]
            if training:
                fm, bm = up_mask.split(dr ** 2 * 9, dim=1)
                preds.append(torch.stack(
                    [pick(upsample_pair(self, fwd_flow, fm, image_resizer,
                                        dr)),
                     pick(upsample_pair(self, bwd_flow, bm, image_resizer,
                                        dr))], dim=1))

        if training:
            flow_preds = torch.stack(preds)
            return {"flows": flow_preds[-1][:, :1],
                    "flows_bw": flow_preds[-1][:, 1:],
                    "flow_preds": flow_preds}
        fm, bm = (100.0 * self.update_block.mask(net)).split(dr ** 2 * 9,
                                                             dim=1)
        return {"flows": pick(upsample_pair(self, fwd_flow, fm,
                                            image_resizer, dr))[:, None],
                "flows_bw": pick(upsample_pair(self, bwd_flow, bm,
                                               image_resizer, dr))[:, None],
                "flow_small": fwd_flow, "flow_bw_small": bwd_flow}


@register_model
class videoflow_bof(VideoFlowBOF):
    pass


@register_model
class videoflow_mof(VideoFlowMOF):
    pass
