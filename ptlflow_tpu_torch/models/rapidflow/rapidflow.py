"""RAPIDFlow (``ptlflow_tpu/models/rapidflow/rapidflow.py``), NCHW: a
coarse-to-fine recurrent pyramid on one shared NeXt1D stage.

Both frames go through ``fnet`` in one batch and the first through
``cnet``; each is a :class:`Next1dEncoder`, whose levels come coarsest
first.  From the coarsest level of ``pyramid_ranges`` down to the finest,
each level builds its own one-level correlation block (:class:`CorrBlock`:
the pyramid and its lookup prepared once a level) and runs
``ceil(iters / levels)`` update steps, each one lookup: one launch of
``csrc/corr_lookup.cu`` on the card.  The flow is carried in the level's
own pixel units (``rescale_flow``) and the hidden state is resampled and
gated into the next level's context (``upnet_layer``).  The eval forward
upsamples the last flow once with the convex mask of
``min(8, min(pyramid_ranges))``; the training forward returns every step's
flow at input size (``flow_preds``), RAFT's ``SequenceLoss`` reads them.

The warm start reads the previous pair's full-size ``prev_preds["flows"]``
(or ``prev_flows``), never ``flow_small``: this model gives none.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import CorrBlock, coords_grid
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..base import BaseModel
from ..raft.raft import SequenceLoss
from .next1d import Next1dEncoder, Next1dStage


def rescale_flow(flow: torch.Tensor, width_im: int, height_im: int,
                 to_local: bool = True) -> torch.Tensor:
    """A (B, 2, H, W) flow from image pixels into the (W, H) map's own
    pixels (``to_local``), or back: x scaled by W / width_im and y by
    H / height_im, or their inverses."""
    h, w = flow.shape[-2:]
    if to_local:
        sx, sy = w / width_im, h / height_im
    else:
        sx, sy = width_im / w, height_im / h
    scale = torch.tensor([sx, sy], dtype=flow.dtype, device=flow.device)
    return flow * scale.view(2, 1, 1)


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = CastConv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = CastConv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class MotionEncoder(nn.Module):
    """The lookup's L*(2r+1)^2 channels and the flow -> ``dec_motion_chs``
    motion channels, the flow last."""

    def __init__(self, corr_levels: int, corr_range: int,
                 dec_motion_chs: int):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_range + 1) ** 2
        self.convc1 = CastConv2d(cor_planes, 256, 1)
        self.convc2 = CastConv2d(256, 192, 3, padding=1)
        self.convf1 = CastConv2d(2, 128, 7, padding=3)
        self.convf2 = CastConv2d(128, 64, 3, padding=1)
        self.conv = CastConv2d(64 + 192, dec_motion_chs - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class Next1dDecoder(nn.Module):
    """The GRU's replacement: tanh of a NeXt1D stage over the hidden state
    and the input."""

    def __init__(self, hidden_dim: int, input_dim: int, ksize: int = 7,
                 depth: int = 1, mlp_ratio: float = 4.0,
                 fuse_next1d_weights: bool = False):
        super().__init__()
        self.conv = Next1dStage(
            hidden_dim + input_dim, hidden_dim, kernel_size=ksize, stride=1,
            depth=depth, mlp_ratio=mlp_ratio,
            fuse_next1d_weights=fuse_next1d_weights)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.conv(torch.cat([h, x], dim=1)))


class UpdateBlock(nn.Module):
    """Motion encoder, NeXt1D decoder, flow head and (``mask``) the convex
    upsampling logits of ``pred_stride``."""

    def __init__(self, pyramid_ranges: Sequence[int], corr_levels: int,
                 corr_range: int, dec_net_chs: int, dec_inp_chs: int,
                 dec_motion_chs: int, dec_depth: int, dec_mlp_ratio: float,
                 fuse_next1d_weights: bool, use_upsample_mask: bool):
        super().__init__()
        self.use_upsample_mask = use_upsample_mask
        self.encoder = MotionEncoder(corr_levels, corr_range, dec_motion_chs)
        self.decoder = Next1dDecoder(
            dec_net_chs, dec_motion_chs + dec_inp_chs, ksize=7,
            depth=dec_depth, mlp_ratio=dec_mlp_ratio,
            fuse_next1d_weights=fuse_next1d_weights)
        self.flow_head = FlowHead(dec_net_chs, hidden_dim=256)
        pred_stride = min(8, min(pyramid_ranges)) if use_upsample_mask else 8
        self.mask = nn.Sequential(
            CastConv2d(dec_net_chs, dec_net_chs * 2, 3, padding=1),
            nn.ReLU(),
            CastConv2d(dec_net_chs * 2, pred_stride ** 2 * 9, 1))

    def forward(self, net: torch.Tensor, inp: torch.Tensor,
                corr: torch.Tensor, flow: torch.Tensor,
                get_mask: bool = False):
        """(delta_flow, net, mask or None)."""
        motion_features = self.encoder(flow, corr)
        net = self.decoder(net, torch.cat([inp, motion_features], dim=1))
        delta_flow = self.flow_head(net)
        mask = (self.mask(net) if self.use_upsample_mask and get_mask
                else None)
        return delta_flow, net, mask


class RAPIDFlow(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/rapidflow-chairs-9c8c182a.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/rapidflow-things-0377c8fa.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/rapidflow-sintel-89a21262.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/rapidflow-kitti-2561329f.ckpt",
    }

    def __init__(self, pyramid_ranges: Tuple[int, int] = (32, 8),
                 iters: int = 12, corr_levels: int = 1, corr_range: int = 4,
                 enc_hidden_chs: int = 64, enc_out_chs: int = 128,
                 enc_stem_stride: int = 4, enc_mlp_ratio: float = 4.0,
                 enc_depth: int = 4, dec_net_chs: int = 64,
                 dec_inp_chs: int = 64, dec_motion_chs: int = 128,
                 dec_depth: int = 2, dec_mlp_ratio: float = 4.0,
                 use_upsample_mask: bool = True,
                 fuse_next1d_weights: bool = False, gamma: float = 0.8,
                 max_flow: float = 400.0, **kwargs):
        num_recurrent_layers = int(math.log2(max(pyramid_ranges))) - 1
        super().__init__(output_stride=int(2 ** (num_recurrent_layers + 1)),
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.pyramid_ranges = tuple(pyramid_ranges)
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_range = corr_range
        self.dec_net_chs = dec_net_chs
        self.dec_inp_chs = dec_inp_chs
        self.use_upsample_mask = use_upsample_mask
        # level index (coarsest first) of each end of the range
        self.pyramid_levels = [
            num_recurrent_layers + 1 - int(math.log2(v))
            for v in pyramid_ranges]
        self.pred_stride = min(8, min(pyramid_ranges))

        enc_kw = dict(max_pyr_range=(min(pyramid_ranges),
                                     max(pyramid_ranges)),
                      stem_stride=enc_stem_stride,
                      num_recurrent_layers=num_recurrent_layers,
                      hidden_chs=enc_hidden_chs, out_chs=enc_out_chs,
                      mlp_ratio=enc_mlp_ratio, depth=enc_depth,
                      fuse_next1d_weights=fuse_next1d_weights)
        self.fnet = Next1dEncoder(**enc_kw)
        self.cnet = Next1dEncoder(**enc_kw)
        self.update_block = UpdateBlock(
            pyramid_ranges=pyramid_ranges, corr_levels=corr_levels,
            corr_range=corr_range, dec_net_chs=dec_net_chs,
            dec_inp_chs=dec_inp_chs, dec_motion_chs=dec_motion_chs,
            dec_depth=dec_depth, dec_mlp_ratio=dec_mlp_ratio,
            fuse_next1d_weights=fuse_next1d_weights,
            use_upsample_mask=use_upsample_mask)
        self.upnet_layer = nn.Sequential(
            CastConv2d(2 * dec_net_chs, dec_net_chs, 1),
            nn.ReLU(),
            Next1dStage(dec_net_chs, dec_net_chs, stride=1, depth=2,
                        mlp_ratio=dec_mlp_ratio,
                        fuse_next1d_weights=fuse_next1d_weights))

    def _upsample_flow(self, flow: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        # the flow is in image pixels already; convex_upsample scales by
        # its factor, so divide first (exact: a power of 2)
        f = self.pred_stride
        return convex_upsample(flow / f, mask, f)

    def _warm_start(self, inputs: Dict[str, Any], b: int, h0: int, w0: int,
                    width_im: int, height_im: int,
                    like: torch.Tensor) -> torch.Tensor:
        """The coarsest level's starting flow: the previous pair's
        full-size ``flows`` resampled to (h0, w0), in that level's pixels,
        forward-projected; zeros without one."""
        prev = inputs.get("prev_preds")
        prev_flows = (prev.get("flows") if prev is not None
                      else inputs.get("prev_flows"))
        if prev_flows is None:
            return like.new_zeros((b, 2, h0, w0))
        pf = prev_flows[:, 0] if prev_flows.dim() == 5 else prev_flows
        flow = interpolate(pf, (h0, w0), align_corners=True)
        flow = rescale_flow(flow, width_im, height_im, to_local=True)
        return forward_interpolate(flow)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W).  Training (``training=True``):
        also ``flow_preds`` (levels * ceil(iters / levels), B, 2, H, W),
        every step's flow at input size, the last level's through the
        convex mask.  The flow is detached at the start of every step, as
        the JAX package stops its gradient."""
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=False,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        x1_raw, x2_raw = images[:, 0], images[:, 1]
        b, _, height_im, width_im = x1_raw.shape

        x_pyr = self.fnet(torch.cat([x1_raw, x2_raw], dim=0))
        cnet_pyr = self.cnet(x1_raw)

        start_level, output_level = self.pyramid_levels
        levels = slice(start_level, output_level + 1)
        pyr1 = [x[:b] for x in x_pyr][levels]
        pyr2 = [x[b:] for x in x_pyr][levels]
        pyr_cnet = cnet_pyr[levels]
        num_levels = output_level - start_level + 1
        iters_per_level = int(math.ceil(self.iters / num_levels))

        h0, w0 = pyr1[0].shape[-2:]
        flow = self._warm_start(inputs, b, h0, w0, width_im, height_im,
                                pyr1[0])

        flow_preds = []
        net: Optional[torch.Tensor] = None
        for lvl, (x1, x2, cnet_feat) in enumerate(zip(pyr1, pyr2, pyr_cnet)):
            h, w = x1.shape[-2:]
            coords0 = coords_grid(b, h, w, dtype=torch.float32,
                                  device=x1.device)
            corr_fn = CorrBlock(x1, x2, num_levels=self.corr_levels,
                                radius=self.corr_range)
            net_tmp = torch.tanh(cnet_feat[:, :self.dec_net_chs])
            inp = torch.relu(cnet_feat[:, self.dec_net_chs:
                                       self.dec_net_chs + self.dec_inp_chs])
            if net is None:
                net = net_tmp
            else:
                net = interpolate(net, (h, w), align_corners=True)
                gate = torch.sigmoid(self.upnet_layer(
                    torch.cat([net, net_tmp], dim=1)))
                net = gate * net + (1.0 - gate) * net_tmp
            if lvl > 0:
                flow = rescale_flow(flow, w, h, to_local=False)
                flow = interpolate(flow, (h, w), align_corners=True)

            # the mask is only read at the last level's training outputs
            get_mask = training and lvl == num_levels - 1
            for _ in range(iters_per_level):
                flow = flow.detach()
                corr = corr_fn(coords0 + flow)
                delta, net, mask = self.update_block(net, inp, corr, flow,
                                                     get_mask=get_mask)
                flow = flow + delta
                if training:
                    out_flow = rescale_flow(flow, width_im, height_im,
                                            to_local=False)
                    if mask is not None:
                        out_flow = self._upsample_flow(out_flow, mask)
                    flow_preds.append(interpolate(
                        out_flow, (height_im, width_im), align_corners=True))

        if training:
            preds = self.postprocess_predictions(
                torch.stack(flow_preds), image_resizer, is_flow=True)
            return {"flows": preds[-1][:, None], "flow_preds": preds}

        out_flow = rescale_flow(flow, width_im, height_im, to_local=False)
        if self.use_upsample_mask:
            out_flow = self._upsample_flow(out_flow,
                                           self.update_block.mask(net))
        out_flow = interpolate(out_flow, (height_im, width_im),
                               align_corners=True)
        final = self.postprocess_predictions(out_flow, image_resizer,
                                             is_flow=True)
        return {"flows": final[:, None]}


class RAPIDFlow_it1(RAPIDFlow):
    def __init__(self, pyramid_ranges=(32, 32), iters=1, **kwargs):
        super().__init__(pyramid_ranges, iters, **kwargs)


class RAPIDFlow_it2(RAPIDFlow):
    def __init__(self, pyramid_ranges=(32, 16), iters=2, **kwargs):
        super().__init__(pyramid_ranges, iters, **kwargs)


class RAPIDFlow_it3(RAPIDFlow):
    def __init__(self, pyramid_ranges=(32, 8), iters=3, **kwargs):
        super().__init__(pyramid_ranges, iters, **kwargs)


class RAPIDFlow_it6(RAPIDFlow):
    def __init__(self, pyramid_ranges=(32, 8), iters=6, **kwargs):
        super().__init__(pyramid_ranges, iters, **kwargs)


@register_model
@trainable
@ptlflow_trained
class rapidflow(RAPIDFlow):
    pass


@register_model
@trainable
@ptlflow_trained
class rapidflow_it1(RAPIDFlow_it1):
    pass


@register_model
@trainable
@ptlflow_trained
class rapidflow_it2(RAPIDFlow_it2):
    pass


@register_model
@trainable
@ptlflow_trained
class rapidflow_it3(RAPIDFlow_it3):
    pass


@register_model
@trainable
@ptlflow_trained
class rapidflow_it6(RAPIDFlow_it6):
    pass
