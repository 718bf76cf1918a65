"""RPKNet (``ptlflow_tpu/models/rpknet/rpknet.py``), NCHW: the recurrent
partial-kernel pyramid network.

One encoder (:class:`PKConvSLKEncoder`) runs on each frame: a stem, then
one shared SLK stage applied again and again with a partial-kernel ConvGRU
carrying a hidden state down the pyramid, every convolution sliced to the
widths of its call (``PKConv2d``).  Each level's features split into the
matching features and the context (input and hidden state of both
frames).  From the coarsest level of ``pyramid_ranges`` to the finest,
each level builds its one-level :class:`CorrBlock` (prepared once a level)
and runs ``ceil(iters / levels)`` update steps, one lookup each; the
hidden state is resampled and gated into the next level
(``upnet_gate_layer``).  The last flow is convex-upsampled by
``min(pyramid_ranges)``.  ``flow_small`` is the last flow in the coarsest
level's pixels and size, and a following pair warm-starts from it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops.correlation import CorrBlock, coords_grid
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..base import BaseModel
from ..raft.raft import SequenceLoss
from ..rapidflow.rapidflow import rescale_flow
from .pkconv_slk import (LayerNorm2dNoAffine, PKConv2d, PKConvSLK,
                         make_norm)


def _gru(convz, convr, convq, h: torch.Tensor, x: torch.Tensor,
         out_ch: int) -> torch.Tensor:
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(convz(hx, out_ch=out_ch))
    r = torch.sigmoid(convr(hx, out_ch=out_ch))
    q = torch.tanh(convq(torch.cat([r * h, x], dim=1), out_ch=out_ch))
    return (1 - z) * h + z * q


class ConvPartialGRU(nn.Module):
    """A ConvGRU of 3x3 partial convolutions."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.convz = PKConv2d(hidden_dim + input_dim, hidden_dim, 3,
                              padding=1)
        self.convr = PKConv2d(hidden_dim + input_dim, hidden_dim, 3,
                              padding=1)
        self.convq = PKConv2d(hidden_dim + input_dim, hidden_dim, 3,
                              padding=1)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                out_ch: int) -> torch.Tensor:
        return _gru(self.convz, self.convr, self.convq, h, x, out_ch)


class PKConvSLKGRU(nn.Module):
    """A GRU whose gates are SLK stages (channel LayerNorm)."""

    def __init__(self, hidden_dim: int, input_dim: int, depth: int = 2,
                 mlp_ratio: float = 4):
        super().__init__()
        kw = dict(mlp_ratio=mlp_ratio, norm=LayerNorm2dNoAffine(), stride=1,
                  depth=depth)
        self.convz = PKConvSLK(hidden_dim + input_dim, hidden_dim, **kw)
        self.convr = PKConvSLK(hidden_dim + input_dim, hidden_dim, **kw)
        self.convq = PKConvSLK(hidden_dim + input_dim, hidden_dim, **kw)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                out_ch: int) -> torch.Tensor:
        return _gru(self.convz, self.convr, self.convq, h, x, out_ch)


class FlowHeadPartial(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = PKConv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = PKConv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class ConvexMask(nn.Module):
    def __init__(self, net_chs: int, pred_stride: int):
        super().__init__()
        self.conv1 = PKConv2d(net_chs, net_chs * 2, 3, padding=1)
        self.conv2 = PKConv2d(net_chs * 2, pred_stride ** 2 * 9, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1(x, out_ch=2 * x.shape[1]))
        return self.conv2(x)


class MotionEncoderPartial(nn.Module):
    def __init__(self, corr_levels: int, corr_range: int,
                 dec_motion_chs: int):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_range + 1) ** 2
        self.convc1 = PKConv2d(cor_planes, 256, 1)
        self.convc2 = PKConv2d(256, 192, 3, padding=1)
        self.convf1 = PKConv2d(2, 128, 7, padding=3)
        self.convf2 = PKConv2d(128, 64, 3, padding=1)
        self.conv = PKConv2d(64 + 192, dec_motion_chs - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class UpdatePartialBlock(nn.Module):
    """The motion encoder, ``dec_gru_iters`` SLK GRUs in a row, the flow
    head and (``mask``) the convex upsampling logits."""

    def __init__(self, pyramid_ranges: Sequence[int], corr_levels: int,
                 corr_range: int, net_chs_fixed: int, inp_chs_fixed: int,
                 dec_motion_chs: int, dec_gru_depth: int, dec_gru_iters: int,
                 dec_gru_mlp_ratio: float, use_upsample_mask: bool,
                 upmask_gradient_scale: float):
        super().__init__()
        self.use_upsample_mask = use_upsample_mask
        self.upmask_gradient_scale = upmask_gradient_scale
        self.encoder = MotionEncoderPartial(corr_levels, corr_range,
                                            dec_motion_chs)
        self.gru_list = nn.ModuleList([
            PKConvSLKGRU(net_chs_fixed, dec_motion_chs + inp_chs_fixed,
                         depth=dec_gru_depth, mlp_ratio=dec_gru_mlp_ratio)
            for _ in range(dec_gru_iters)])
        self.flow_head = FlowHeadPartial(net_chs_fixed, hidden_dim=256)
        if use_upsample_mask:
            self.mask = ConvexMask(net_chs_fixed, min(pyramid_ranges))

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        return self.upmask_gradient_scale * self.mask(net)

    def forward(self, net: torch.Tensor, inp: torch.Tensor,
                corr: torch.Tensor, flow: torch.Tensor,
                get_mask: bool = True):
        """(delta_flow, net, mask or None)."""
        inp = torch.cat([inp, self.encoder(flow, corr)], dim=1)
        for gru in self.gru_list:
            net = gru(net, inp, net.shape[1])
        delta_flow = self.flow_head(net)
        mask = (self.upsample_mask(net)
                if self.use_upsample_mask and get_mask else None)
        return delta_flow, net, mask


class PKConvSLKEncoder(nn.Module):
    """The recurrent pyramid encoder: a stride-``stem_stride`` stem, then
    one shared SLK stage (``rec_stage``) applied again and again on the
    state of a partial ConvGRU (``forward_gru``, ``down_gru``), the widths
    growing along ``hidden_chs``; a partial 1x1 output head.  Returns the
    levels of ``pyr_range`` coarsest first."""

    def __init__(self, pyr_range: Sequence[int], hidden_chs: Sequence[int],
                 out_1x1_abs_chs: int, out_1x1_factor: Optional[float],
                 stem_stride: int = 2, norm: Optional[nn.Module] = None,
                 mlp_ratio: float = 4, depth: int = 2):
        super().__init__()
        self.pyr_level_range = [int(math.log2(v)) for v in pyr_range]
        self.hidden_chs = list(hidden_chs)
        self.out_1x1_abs_chs = out_1x1_abs_chs
        self.out_1x1_factor = out_1x1_factor
        self.stem_stride = stem_stride
        norm = make_norm("group") if norm is None else norm
        hc = hidden_chs[-1]
        self.forward_gru = ConvPartialGRU(hc, hc)
        self.down_gru = PKConv2d(hc, hc, 3, stride=2, padding=1, bias=True)
        self.stem = nn.Sequential(
            PKConv2d(3, hidden_chs[0], 7, stride=stem_stride, padding=3),
            norm)
        self.rec_stage = PKConvSLK(hc, hc, mlp_ratio=mlp_ratio, norm=norm,
                                   stride=2, depth=depth)
        if out_1x1_abs_chs > 0:
            self.out_1x1 = PKConv2d(hc, out_1x1_abs_chs, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        pyramid = []
        if self.pyr_level_range[0] == 0:
            pyramid.append(x)
        pyr_iters = self.pyr_level_range[1]
        offset = 1
        if self.stem_stride > 2:
            extra = int(math.log2(self.stem_stride)) - 1
            pyr_iters -= extra
            offset += extra
        last = len(self.hidden_chs) - 1
        for i in range(pyr_iters):
            if i == 0:
                x = self.stem(x)
                h = torch.zeros_like(x)
            else:
                in_ch = self.hidden_chs[min(i - 1, last)]
                out_ch = self.hidden_chs[min(i, last)]
                h = self.forward_gru(h, x, in_ch)
                x = self.rec_stage(h, out_ch=out_ch)
                if i < pyr_iters - 1:
                    h = torch.tanh(self.down_gru(h, out_ch=out_ch))
            if i >= self.pyr_level_range[0] - offset:
                pyramid.append(x)
        out = []
        for x in pyramid:
            if self.out_1x1_abs_chs > 0:
                out_ch = (None if self.out_1x1_factor is None
                          else int(self.out_1x1_factor * x.shape[1]))
                x = self.out_1x1(x, out_ch=out_ch)
            out.append(x)
        return out[::-1]


class ResidualPartialBlock(nn.Module):
    """x + norm(conv2(relu(norm(conv1(x))))), ReLUs on the branch and the
    sum with ``use_out_activation`` (stride 1 only)."""

    def __init__(self, in_planes: int, planes: int,
                 norm: Optional[nn.Module] = None,
                 use_out_activation: bool = True):
        super().__init__()
        self.use_out_activation = use_out_activation
        self.conv1 = PKConv2d(in_planes, planes, 3, padding=1)
        self.conv2 = PKConv2d(planes, planes, 3, padding=1)
        self.norm_fn = make_norm("group") if norm is None else norm

    def forward(self, x: torch.Tensor, out_ch: int) -> torch.Tensor:
        y = torch.relu(self.norm_fn(self.conv1(x, out_ch)))
        y = self.norm_fn(self.conv2(y, out_ch))
        if self.use_out_activation:
            y = torch.relu(y)
        out = x + y
        return torch.relu(out) if self.use_out_activation else out


class UpNetPartial(nn.Module):
    """The gate that fuses a coarser level's hidden state into the next."""

    def __init__(self, net_chs_fixed: int, norm: Optional[nn.Module] = None):
        super().__init__()
        self.conv = PKConv2d(2 * net_chs_fixed, net_chs_fixed, 1)
        self.res = ResidualPartialBlock(net_chs_fixed, net_chs_fixed,
                                        norm=norm, use_out_activation=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv(x, out_ch=x.shape[1] // 2))
        return self.res(x, x.shape[1])


def split_features(x1f: torch.Tensor, x2f: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """A level's features of both frames -> (matching features of frame 1
    and 2, the input context, the hidden-state context): the last third of
    each frame's channels is its context, half input, half hidden state,
    concatenated over the two frames."""
    xh = x1f.shape[1]
    ch = xh // 3
    halfch = ch // 2
    x1, cn1 = x1f[:, :xh - ch], x1f[:, xh - ch:]
    x2, cn2 = x2f[:, :xh - ch], x2f[:, xh - ch:]
    inp = torch.cat([cn1[:, :ch - halfch], cn2[:, :ch - halfch]], dim=1)
    net = torch.cat([cn1[:, ch - halfch:], cn2[:, ch - halfch:]], dim=1)
    return x1, x2, inp, net


class RPKNet(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/rpknet-chairs-a705b345.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/rpknet-kitti-39504eb4.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/rpknet-sintel-e7cc969e.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/rpknet-things-f79b0d81.ckpt",
    }

    def __init__(self, pyramid_ranges: Tuple[int, ...] = (32, 8),
                 iters: int = 12, input_pad_one_side: bool = False,
                 input_bgr_to_rgb: bool = False,
                 upgate_norm_type: str = "group",
                 group_norm_num_groups: int = 8, corr_levels: int = 1,
                 corr_range: int = 4, enc_norm_type: str = "group",
                 enc_stem_stride: int = 2, enc_depth: int = 2,
                 enc_mlp_ratio: float = 4.0,
                 enc_hidden_chs: Sequence[int] = (32, 64, 96),
                 enc_out_1x1_chs: str = "2.0", dec_gru_iters: int = 2,
                 dec_gru_depth: int = 2, dec_gru_mlp_ratio: float = 4.0,
                 dec_net_chs: Optional[int] = None,
                 dec_inp_chs: Optional[int] = None,
                 dec_motion_chs: int = 128, use_upsample_mask: bool = True,
                 upmask_gradient_scale: float = 1.0, gamma: float = 0.8,
                 max_flow: float = 400, **kwargs):
        num_recurrent_layers = int(math.log2(max(pyramid_ranges))) - 1
        super().__init__(output_stride=int(2 ** (num_recurrent_layers + 1)),
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.pyramid_ranges = tuple(pyramid_ranges)
        self.iters = iters
        self.input_pad_one_side = input_pad_one_side
        self.input_bgr_to_rgb = input_bgr_to_rgb
        self.corr_levels = corr_levels
        self.corr_range = corr_range

        if isinstance(enc_out_1x1_chs, str):
            enc_out_1x1_chs = (float(enc_out_1x1_chs)
                               if "." in enc_out_1x1_chs
                               else int(enc_out_1x1_chs))
        if isinstance(enc_out_1x1_chs, float):
            self.out_1x1_factor = enc_out_1x1_chs
            self.out_1x1_abs_chs = int(enc_out_1x1_chs * enc_hidden_chs[-1])
        else:
            self.out_1x1_factor = None
            self.out_1x1_abs_chs = enc_out_1x1_chs

        net_chs, inp_chs = dec_net_chs, dec_inp_chs
        if net_chs is None or inp_chs is None:
            base_chs = self.out_1x1_abs_chs
            if base_chs < 1:
                base_chs = enc_hidden_chs[-1]
            base_chs = base_chs // 3 * 2
            if net_chs is None and inp_chs is None:
                net_chs = inp_chs = base_chs // 2
            elif net_chs is None:
                net_chs = base_chs - inp_chs
            else:
                inp_chs = base_chs - net_chs
        self.net_chs_fixed = net_chs
        self.inp_chs_fixed = inp_chs
        self.pyramid_levels = [
            num_recurrent_layers + 1 - int(math.log2(v))
            for v in pyramid_ranges]

        self.fnet = PKConvSLKEncoder(
            pyr_range=[min(pyramid_ranges), max(pyramid_ranges)],
            hidden_chs=enc_hidden_chs, out_1x1_abs_chs=self.out_1x1_abs_chs,
            out_1x1_factor=self.out_1x1_factor, stem_stride=enc_stem_stride,
            norm=make_norm(enc_norm_type, group_norm_num_groups),
            mlp_ratio=enc_mlp_ratio, depth=enc_depth)
        self.update_block = UpdatePartialBlock(
            pyramid_ranges=pyramid_ranges, corr_levels=corr_levels,
            corr_range=corr_range, net_chs_fixed=net_chs,
            inp_chs_fixed=inp_chs, dec_motion_chs=dec_motion_chs,
            dec_gru_depth=dec_gru_depth, dec_gru_iters=dec_gru_iters,
            dec_gru_mlp_ratio=dec_gru_mlp_ratio,
            use_upsample_mask=use_upsample_mask,
            upmask_gradient_scale=upmask_gradient_scale)
        self.use_upsample_mask = use_upsample_mask
        # the JAX package's gate takes the encoder's norm, whatever
        # upgate_norm_type says
        self.upnet_gate_layer = UpNetPartial(
            net_chs_fixed=net_chs,
            norm=make_norm(enc_norm_type, group_norm_num_groups))

    def _upsample_flow(self, flow: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        f = min(self.pyramid_ranges)
        return convex_upsample(flow / f, mask, f)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, h0,
        w0), the last flow in the coarsest level's pixels, from which
        ``inputs["prev_preds"]["flow_small"]`` warm-starts the next pair
        (forward-projected).  Training (``training=True``): also
        ``flow_preds``, every step's flow at input size.  The flow is
        detached at the start of every step, as the JAX package stops its
        gradient."""
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0,
            bgr_to_rgb=self.input_bgr_to_rgb, resize_mode="pad",
            pad_mode="replicate", pad_two_side=not self.input_pad_one_side)
        x1_raw, x2_raw = images[:, 0], images[:, 1]
        b, _, height_im, width_im = x1_raw.shape

        x1_pyramid = self.fnet(x1_raw)
        x2_pyramid = self.fnet(x2_raw)
        # the published configs give one range pair; the JAX package uses
        # the first pair (the reference alternates them in training)
        start_level, output_level = self.pyramid_levels[:2]
        pyr1 = x1_pyramid[start_level:output_level + 1]
        pyr2 = x2_pyramid[start_level:output_level + 1]
        num_levels = output_level - start_level + 1
        iters_per_level = int(math.ceil(self.iters / num_levels))

        h0, w0 = pyr1[0].shape[-2:]
        prev = inputs.get("prev_preds")
        flow_init = prev.get("flow_small") if prev is not None else None
        if flow_init is not None:
            flow = forward_interpolate(flow_init)
        else:
            flow = x1_raw.new_zeros((b, 2, h0, w0))

        flow_preds = []
        net = None
        for lvl, (x1f, x2f) in enumerate(zip(pyr1, pyr2)):
            x1, x2, inp, net_tmp = split_features(x1f, x2f)
            inp = torch.relu(inp)
            h, w = x1.shape[-2:]
            coords0 = coords_grid(b, h, w, dtype=torch.float32,
                                  device=x1.device)
            corr_fn = CorrBlock(x1, x2, num_levels=self.corr_levels,
                                radius=self.corr_range)
            if net is None:
                net = torch.tanh(net_tmp)
            else:
                net = torch.tanh(interpolate(net, (h, w), align_corners=True))
                net_skip = torch.tanh(net_tmp)
                gate = torch.sigmoid(self.upnet_gate_layer(
                    torch.cat([net, net_skip], dim=1)))
                net = gate * net + (1.0 - gate) * net_skip
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

        # the warm start of the next pair: the last flow at the coarsest
        # level's size, in its pixels
        small = interpolate(rescale_flow(flow, w0, h0, to_local=False),
                            (h0, w0), align_corners=True)
        if training:
            preds = self.postprocess_predictions(
                torch.stack(flow_preds), image_resizer, is_flow=True)
            return {"flows": preds[-1][:, None], "flow_preds": preds,
                    "flow_small": small}

        out_flow = rescale_flow(flow, width_im, height_im, to_local=False)
        if self.use_upsample_mask:
            out_flow = self._upsample_flow(
                out_flow, self.update_block.upsample_mask(net))
        else:
            out_flow = interpolate(out_flow, (height_im, width_im),
                                   align_corners=True)
        final = self.postprocess_predictions(out_flow, image_resizer,
                                             is_flow=True)
        return {"flows": final[:, None], "flow_small": small}


@register_model
@trainable
@ptlflow_trained
class rpknet(RPKNet):
    pass
