"""DPFlow (``ptlflow_tpu/models/dpflow/dpflow.py``), NCHW: the dual-pyramid
bidirectional CGU network.

The input size decides the pyramid's depth (:func:`compute_pyramid_levels`:
3 levels at ~1K, one more per octave above) and with it the padding stride
2^(levels + 2).  One encoder (:class:`CGUBidirDualEncoder`) runs on both
frames together: a stride-4 residual stem, then one shared cross-gated
stage applied again and again down the pyramid on a ConvGRU's state, a
second GRU carried back up, and a low-resolution stem of the image resized
to each level.  From the coarsest level to the finest, each level builds
its one-level :class:`CorrBlock` (prepared once a level) and runs
``iters_per_level`` update steps, one lookup each; every step predicts the
flow's change and, with the Laplace loss, 4 info channels (a two-component
Laplace mixture).  The eval forward upsamples the last flow by 8 with the
convex mask; the training forward returns every step's flow and info at
input size and their mixture NLL (``nf_preds``).  ``flow_small`` is the
last flow, at the finest level, in its pixels; the next pair warm-starts
from it, rescaled to the coarsest level.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...nn import CastConv2d, CastConvTranspose2d
from ...ops.correlation import CorrBlock, coords_grid
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..base import BaseModel
from ..raft.raft import SequenceLoss as L1SequenceLoss
from ..rapidflow.rapidflow import rescale_flow
from ..rpknet.pkconv_slk import GroupNorm, LayerNorm2dNoAffine
from ..rpknet.rpknet import split_features
from ..sea_raft.sea_raft import SequenceLoss as LaplaceSequenceLoss
from ..sea_raft.sea_raft import laplace_mixture_nll
from .cgu import CGUStage


def compute_pyramid_levels(images_shape: Sequence[int]) -> int:
    """3 levels up to a ~1100 px diagonal, one more per octave above, from
    the (..., H, W) input shape (before padding)."""
    img_diag = math.sqrt(images_shape[-2] ** 2 + images_shape[-1] ** 2)
    input_factor = max(1.0, img_diag / 1100)
    return int(round(math.log2(input_factor))) + 3


class ResidualBlock(nn.Module):
    """Two 3x3 conv-norm-ReLUs and a residual, through a 1x1 convolution
    and the norm where the stride or width changes."""

    def __init__(self, in_planes: int, planes: int, norm: nn.Module,
                 stride: int = 1):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, planes, 3, padding=1,
                                stride=stride)
        self.conv2 = CastConv2d(planes, planes, 3, padding=1)
        self.norm_fn = norm
        self.downsample = None
        if stride != 1 or in_planes != planes:
            # the reference's Sequential also holds the (parameter-free)
            # norm: the checkpoint's names are downsample.0.*
            self.downsample = nn.Sequential(
                CastConv2d(in_planes, planes, 1, stride=stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm_fn(self.conv1(x)))
        y = torch.relu(self.norm_fn(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm_fn(self.downsample(x))
        return torch.relu(x + y)


class ResStem(nn.Module):
    """The stride-4 residual stem."""

    def __init__(self, hidden_chs: Sequence[int], norm: nn.Module):
        super().__init__()
        self.norm_fn = norm
        self.conv1 = CastConv2d(3, hidden_chs[0], 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(
            ResidualBlock(hidden_chs[0], hidden_chs[0], norm, stride=1),
            ResidualBlock(hidden_chs[0], hidden_chs[0], norm, stride=1))
        self.layer2 = nn.Sequential(
            ResidualBlock(hidden_chs[0], hidden_chs[1], norm, stride=2),
            ResidualBlock(hidden_chs[1], hidden_chs[1], norm, stride=1))
        self.conv2 = CastConv2d(hidden_chs[1], hidden_chs[2], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm_fn(self.conv1(x)))
        return self.conv2(self.layer2(self.layer1(x)))


def _gru(convz, convr, convq, h: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    hx = torch.cat([h, x], dim=1)
    z = torch.sigmoid(convz(hx))
    r = torch.sigmoid(convr(hx))
    q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
    return (1 - z) * h + z * q


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.convz = CastConv2d(hidden_dim + input_dim, hidden_dim, 3,
                                padding=1)
        self.convr = CastConv2d(hidden_dim + input_dim, hidden_dim, 3,
                                padding=1)
        self.convq = CastConv2d(hidden_dim + input_dim, hidden_dim, 3,
                                padding=1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return _gru(self.convz, self.convr, self.convq, h, x)


class CGUGRU(nn.Module):
    """A GRU whose gates are CGU stages."""

    def __init__(self, hidden_dim: int, input_dim: int,
                 norm: Optional[nn.Module] = None, depth: int = 4,
                 mlp_ratio: float = 2, mlp_use_dw_conv: bool = True,
                 mlp_dw_kernel_size: int = 7, mlp_in_kernel_size: int = 1,
                 mlp_out_kernel_size: int = 1,
                 layer_scale_init_value: float = 1e-2):
        super().__init__()
        kw = dict(stride=1,
                  norm=LayerNorm2dNoAffine() if norm is None else norm,
                  depth=depth, use_cross=False, mlp_ratio=mlp_ratio,
                  mlp_use_dw_conv=mlp_use_dw_conv,
                  mlp_dw_kernel_size=mlp_dw_kernel_size,
                  mlp_in_kernel_size=mlp_in_kernel_size,
                  mlp_out_kernel_size=mlp_out_kernel_size,
                  layer_scale_init_value=layer_scale_init_value)
        self.convz = CGUStage(hidden_dim + input_dim, hidden_dim, **kw)
        self.convr = CGUStage(hidden_dim + input_dim, hidden_dim, **kw)
        self.convq = CGUStage(hidden_dim + input_dim, hidden_dim, **kw)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return _gru(self.convz, self.convr, self.convq, h, x)


class FlowHead(nn.Module):
    """The flow's change, and with ``info_pred`` 4 info channels after
    it."""

    def __init__(self, input_dim: int, hidden_dim: int = 256,
                 info_pred: bool = False):
        super().__init__()
        self.conv1 = CastConv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = CastConv2d(hidden_dim, 6 if info_pred else 2, 3,
                                padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class ConvexMask(nn.Module):
    def __init__(self, net_chs: int, pred_stride: int):
        super().__init__()
        self.conv1 = CastConv2d(net_chs, net_chs * 2, 3, padding=1)
        self.conv2 = CastConv2d(net_chs * 2, pred_stride ** 2 * 9, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class MotionEncoder(nn.Module):
    def __init__(self, corr_levels: int, corr_range: int,
                 dec_motion_chs: int, corr_hidden: int = 256,
                 corr_out: int = 192, flow_hidden: int = 128,
                 flow_out: int = 64, flow_kernel_size: int = 7):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_range + 1) ** 2
        self.convc1 = CastConv2d(cor_planes, corr_hidden, 1)
        self.convc2 = CastConv2d(corr_hidden, corr_out, 3, padding=1)
        self.convf1 = CastConv2d(2, flow_hidden, flow_kernel_size,
                                 padding=flow_kernel_size // 2)
        self.convf2 = CastConv2d(flow_hidden, flow_out, 3, padding=1)
        self.conv = CastConv2d(flow_out + corr_out, dec_motion_chs - 2, 3,
                               padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class UpdateBlock(nn.Module):
    """The motion encoder, ``dec_gru_iters`` CGU GRUs in a row, the flow
    head and (``mask``) the 8x convex upsampling logits."""

    def __init__(self, corr_levels: int, corr_range: int, net_chs_fixed: int,
                 inp_chs_fixed: int, dec_motion_chs: int = 128,
                 dec_flow_kernel_size: int = 7, dec_flow_head_chs: int = 256,
                 dec_gru_norm: Optional[nn.Module] = None,
                 dec_gru_depth: int = 4, dec_gru_iters: int = 1,
                 dec_gru_mlp_ratio: float = 2.0, mlp_use_dw_conv: bool = True,
                 mlp_dw_kernel_size: int = 7, mlp_in_kernel_size: int = 1,
                 mlp_out_kernel_size: int = 1,
                 layer_scale_init_value: float = 1e-2, loss: str = "laplace",
                 use_upsample_mask: bool = True,
                 upmask_gradient_scale: float = 1.0):
        super().__init__()
        self.use_upsample_mask = use_upsample_mask
        self.upmask_gradient_scale = upmask_gradient_scale
        self.encoder = MotionEncoder(corr_levels, corr_range, dec_motion_chs,
                                     flow_kernel_size=dec_flow_kernel_size)
        self.gru_list = nn.ModuleList([
            CGUGRU(net_chs_fixed, dec_motion_chs + inp_chs_fixed,
                   norm=dec_gru_norm, depth=dec_gru_depth,
                   mlp_ratio=dec_gru_mlp_ratio,
                   mlp_use_dw_conv=mlp_use_dw_conv,
                   mlp_dw_kernel_size=mlp_dw_kernel_size,
                   mlp_in_kernel_size=mlp_in_kernel_size,
                   mlp_out_kernel_size=mlp_out_kernel_size,
                   layer_scale_init_value=layer_scale_init_value)
            for _ in range(dec_gru_iters)])
        self.flow_head = FlowHead(net_chs_fixed, hidden_dim=dec_flow_head_chs,
                                  info_pred=loss == "laplace")
        if use_upsample_mask:
            self.mask = ConvexMask(net_chs_fixed, 8)

    def upsample_mask(self, net: torch.Tensor) -> torch.Tensor:
        return self.upmask_gradient_scale * self.mask(net)

    def forward(self, net: torch.Tensor, inp: torch.Tensor,
                corr: torch.Tensor, flow: torch.Tensor,
                get_mask: bool = True):
        """(delta, net, mask or None); delta holds the info channels after
        the flow's two where the flow head predicts them."""
        inp = torch.cat([inp, self.encoder(flow, corr)], dim=1)
        for gru in self.gru_list:
            net = gru(net, inp)
        delta = self.flow_head(net)
        mask = (self.upsample_mask(net)
                if self.use_upsample_mask and get_mask else None)
        return delta, net, mask


class CGUBidirDualEncoder(nn.Module):
    """The bidirectional dual-image recurrent CGU pyramid encoder: a
    forward GRU carried down the pyramid with the shared cross-image stage
    ``rec_stage``, a backward GRU carried up with ``back_stage``, a
    low-resolution stem of each frame resized to each level, and the
    output stages.  Returns both frames' levels, coarsest first."""

    def __init__(self, hidden_chs: Sequence[int], out_1x1_abs_chs: int,
                 out_1x1_factor: Optional[float], num_out_stages: int = 1,
                 norm: Optional[nn.Module] = None, depth: int = 4,
                 mlp_ratio: float = 2.0, mlp_use_dw_conv: bool = True,
                 mlp_dw_kernel_size: int = 7, mlp_in_kernel_size: int = 1,
                 mlp_out_kernel_size: int = 1,
                 layer_scale_init_value: float = 1e-2):
        super().__init__()
        norm = GroupNorm() if norm is None else norm
        self.hidden_chs = list(hidden_chs)
        self.out_1x1_abs_chs = out_1x1_abs_chs
        self.out_1x1_factor = out_1x1_factor
        self.num_out_stages = num_out_stages
        hc = hidden_chs[-1]
        self.forward_gru = ConvGRU(hc, hc)
        self.down_gru = CastConv2d(hc, hc, 3, stride=2, padding=1)
        self.backward_gru = ConvGRU(hc, hc)
        self.up_gru = CastConvTranspose2d(hc, hc, 4, stride=2, padding=1)
        self.stem = ResStem([hidden_chs[0], hidden_chs[1], 2 * hc], norm)
        self.lowres_stem = ResStem(list(hidden_chs), norm)
        if out_1x1_abs_chs > 0:
            self.out_1x1 = CastConv2d(hc, out_1x1_abs_chs, 1)
        stage_kw = dict(stride=2, norm=norm, depth=depth, use_cross=True,
                        mlp_ratio=mlp_ratio, mlp_use_dw_conv=mlp_use_dw_conv,
                        mlp_dw_kernel_size=mlp_dw_kernel_size,
                        mlp_in_kernel_size=mlp_in_kernel_size,
                        mlp_out_kernel_size=mlp_out_kernel_size,
                        layer_scale_init_value=layer_scale_init_value)
        self.rec_stage = CGUStage(hc, hc, **stage_kw)
        self.back_stage = CGUStage(hc, hc, **{**stage_kw, "stride": 1})
        if num_out_stages > 0:
            self.out_merge_conv = CastConv2d(3 * hc, hc, 1)
            self.out_stages = CGUStage(
                hc, hc, **{**stage_kw, "stride": 1,
                           "depth": num_out_stages * depth})

    def forward(self, x: torch.Tensor, y: torch.Tensor, pyr_levels: int
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        input_x, input_y = x, y
        x_pyr, y_pyr = [], []
        for i in range(pyr_levels + 1):
            if i == 0:
                x = self.stem(x)
                y = self.stem(y)
                half = x.shape[1] // 2
                x, hx = x[:, :half], torch.tanh(x[:, half:])
                y, hy = y[:, :half], torch.tanh(y[:, half:])
                continue
            hx = self.forward_gru(hx, x)
            hy = self.forward_gru(hy, y)
            x, y = self.rec_stage(hx, hy)
            if i < pyr_levels:
                hx = torch.tanh(self.down_gru(hx))
                hy = torch.tanh(self.down_gru(hy))
            x_pyr.append(x)
            y_pyr.append(y)

        hx = torch.zeros_like(x_pyr[-1])
        hy = torch.zeros_like(y_pyr[-1])
        for i in range(len(x_pyr) - 1, -1, -1):
            x, y = x_pyr[i], y_pyr[i]
            hx = self.backward_gru(hx, x)
            hy = self.backward_gru(hy, y)
            x2, y2 = self.back_stage(hx, hy)
            size = (x.shape[2] * 4, x.shape[3] * 4)
            x_low = self.lowres_stem(
                interpolate(input_x, size, align_corners=True))
            y_low = self.lowres_stem(
                interpolate(input_y, size, align_corners=True))
            x_pyr[i] = torch.cat([x, x2, x_low], dim=1)
            y_pyr[i] = torch.cat([y, y2, y_low], dim=1)
            if i > 0:
                hx = torch.tanh(self.up_gru(hx))
                hy = torch.tanh(self.up_gru(hy))

        outs_x, outs_y = [], []
        for x, y in zip(x_pyr, y_pyr):
            if self.num_out_stages > 0:
                x = self.out_merge_conv(torch.relu(x))
                y = self.out_merge_conv(torch.relu(y))
                x, y = self.out_stages(x, y)
            if self.out_1x1_abs_chs > 0:
                x = self.out_1x1(x)
                y = self.out_1x1(y)
            outs_x.append(x)
            outs_y.append(y)
        return outs_x[::-1], outs_y[::-1]


class DPFlowSequenceLoss:
    """The Laplace-mixture sequence loss of ``nf_preds`` (SEA-RAFT's) where
    the model predicts them, else RAFT's gamma-weighted L1 of
    ``flow_preds``."""

    def __init__(self, loss: str, max_flow: float, gamma: float):
        self.loss = loss
        self.laplace = LaplaceSequenceLoss(gamma, max_flow)
        self.l1 = L1SequenceLoss(gamma, max_flow)

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        if self.loss == "laplace" and outputs.get("nf_preds") is not None:
            return self.laplace(outputs, inputs)
        return self.l1(outputs, inputs)


class DPFlow(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dpflow-chairs-f94e717a.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dpflow-kitti-4e97eac6.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dpflow-sintel-b44b072c.ckpt",
        "spring": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dpflow-spring-69bac7fa.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dpflow-things-2012b5d6.ckpt",
    }

    def __init__(self, pyramid_levels: Optional[int] = None,
                 iters_per_level: int = 4, corr_levels: int = 1,
                 corr_range: int = 4, enc_depth: int = 4,
                 enc_mlp_ratio: float = 2.0,
                 enc_hidden_chs: Sequence[int] = (64, 96, 128),
                 enc_num_out_stages: int = 1, enc_out_1x1_chs: str = "384",
                 dec_gru_iters: int = 1, dec_gru_depth: int = 4,
                 dec_gru_mlp_ratio: float = 2.0, dec_net_chs: int = 128,
                 dec_inp_chs: int = 128, dec_motion_chs: int = 128,
                 dec_flow_kernel_size: int = 7,
                 dec_flow_head_chs: int = 256,
                 use_upsample_mask: bool = True,
                 upmask_gradient_scale: float = 1.0,
                 cgu_mlp_dw_kernel_size: int = 7,
                 cgu_layer_scale_init_value: float = 0.01,
                 loss: str = "laplace", gamma: float = 0.8,
                 max_flow: float = 400.0, use_var: bool = True,
                 var_min: float = 0.0, var_max: float = 10.0, **kwargs):
        output_stride = (int(2 ** (pyramid_levels + 2))
                         if pyramid_levels is not None else 32)
        super().__init__(output_stride=output_stride,
                         loss_fn=DPFlowSequenceLoss(loss, max_flow, gamma),
                         **kwargs)
        self.pyramid_levels = pyramid_levels
        self.iters_per_level = iters_per_level
        self.corr_levels = corr_levels
        self.corr_range = corr_range
        self.loss = loss
        self.use_var = use_var
        self.var_min = var_min
        self.var_max = var_max
        self.use_upsample_mask = use_upsample_mask

        if isinstance(enc_out_1x1_chs, str):
            enc_out_1x1_chs = (float(enc_out_1x1_chs)
                               if "." in enc_out_1x1_chs
                               else int(enc_out_1x1_chs))
        if isinstance(enc_out_1x1_chs, float):
            out_1x1_factor = enc_out_1x1_chs
            out_1x1_abs_chs = int(enc_out_1x1_chs * enc_hidden_chs[-1])
        else:
            out_1x1_factor = None
            out_1x1_abs_chs = enc_out_1x1_chs

        self.fnet = CGUBidirDualEncoder(
            hidden_chs=enc_hidden_chs, out_1x1_abs_chs=out_1x1_abs_chs,
            out_1x1_factor=out_1x1_factor,
            num_out_stages=enc_num_out_stages, norm=GroupNorm(),
            depth=enc_depth, mlp_ratio=enc_mlp_ratio,
            mlp_dw_kernel_size=cgu_mlp_dw_kernel_size,
            layer_scale_init_value=cgu_layer_scale_init_value)
        self.update_block = UpdateBlock(
            corr_levels=corr_levels, corr_range=corr_range,
            net_chs_fixed=dec_net_chs, inp_chs_fixed=dec_inp_chs,
            dec_motion_chs=dec_motion_chs,
            dec_flow_kernel_size=dec_flow_kernel_size,
            dec_flow_head_chs=dec_flow_head_chs,
            dec_gru_norm=LayerNorm2dNoAffine(), dec_gru_depth=dec_gru_depth,
            dec_gru_iters=dec_gru_iters, dec_gru_mlp_ratio=dec_gru_mlp_ratio,
            mlp_dw_kernel_size=cgu_mlp_dw_kernel_size,
            layer_scale_init_value=cgu_layer_scale_init_value, loss=loss,
            use_upsample_mask=use_upsample_mask,
            upmask_gradient_scale=upmask_gradient_scale)

    @staticmethod
    def _upsample(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        # the values are not rescaled: convex_upsample scales by its
        # factor, so divide first (exact: a power of 2)
        return convex_upsample(x / 8, mask, 8)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small``.  Training
        (``training=True``): also ``flow_preds`` (levels * iters_per_level,
        B, 2, H, W) and, with the Laplace loss, ``info_preds`` (..., 4, H,
        W) and ``nf_preds`` (..., 2, H, W), their NLL against
        ``inputs["flows"]`` (zeros where absent).  The flow is detached at
        the start of every step, as the JAX package stops its gradient."""
        if self.pyramid_levels is None:
            pyr_levels = compute_pyramid_levels(inputs["images"].shape)
            output_stride = 2 ** (pyr_levels + 2)
        else:
            pyr_levels = self.pyramid_levels
            output_stride = self.output_stride

        images, image_resizer = self.preprocess_images(
            inputs["images"], stride=output_stride, bgr_add=-0.5,
            bgr_mult=2.0, bgr_to_rgb=True, resize_mode="pad",
            pad_mode="replicate", pad_two_side=True)
        x1_raw, x2_raw = images[:, 0], images[:, 1]
        b, _, height_im, width_im = x1_raw.shape

        x1_pyramid, x2_pyramid = self.fnet(x1_raw, x2_raw,
                                           pyr_levels=pyr_levels)

        h0, w0 = x1_pyramid[0].shape[-2:]
        prev = inputs.get("prev_preds")
        flow_init = prev.get("flow_small") if prev is not None else None
        if flow_init is not None:
            flow = rescale_flow(flow_init, w0, h0, to_local=False)
            flow = forward_interpolate(
                interpolate(flow, (h0, w0), align_corners=True))
        else:
            flow = x1_raw.new_zeros((b, 2, h0, w0))

        laplace = self.loss == "laplace"
        flow_preds, info_preds = [], []
        for lvl, (x1f, x2f) in enumerate(zip(x1_pyramid, x2_pyramid)):
            x1, x2, inp, net = split_features(x1f, x2f)
            inp = torch.relu(inp)
            net = torch.tanh(net)
            h, w = x1.shape[-2:]
            coords0 = coords_grid(b, h, w, dtype=torch.float32,
                                  device=x1.device)
            corr_fn = CorrBlock(x1, x2, num_levels=self.corr_levels,
                                radius=self.corr_range)
            if lvl > 0:
                flow = rescale_flow(flow, w, h, to_local=False)
                flow = interpolate(flow, (h, w), align_corners=True)

            for _ in range(self.iters_per_level):
                flow = flow.detach()
                corr = corr_fn(coords0 + flow)
                delta, net, mask = self.update_block(
                    net, inp, corr, flow,
                    get_mask=training and self.use_upsample_mask)
                info = delta[:, 2:] if laplace else None
                flow = flow + delta[:, :2]
                if training:
                    out_flow = rescale_flow(flow, width_im, height_im,
                                            to_local=False)
                    if mask is not None:
                        out_flow = self._upsample(out_flow, mask)
                        if info is not None:
                            info = self._upsample(info, mask)
                    flow_preds.append(interpolate(
                        out_flow, (height_im, width_im), align_corners=True))
                    if info is not None:
                        info_preds.append(interpolate(
                            info, (height_im, width_im), align_corners=True))

        if not training:
            out_flow = rescale_flow(flow, width_im, height_im,
                                    to_local=False)
            if self.use_upsample_mask:
                out_flow = self._upsample(out_flow,
                                          self.update_block.upsample_mask(net))
            out_flow = interpolate(out_flow, (height_im, width_im),
                                   align_corners=True)
            final = self.postprocess_predictions(out_flow, image_resizer,
                                                 is_flow=True)
            return {"flows": final[:, None], "flow_small": flow}

        preds = self.postprocess_predictions(torch.stack(flow_preds),
                                             image_resizer, is_flow=True)
        outputs = {"flows": preds[-1][:, None], "flow_preds": preds,
                   "flow_small": flow}
        if laplace:
            infos = self.postprocess_predictions(torch.stack(info_preds),
                                                 image_resizer, is_flow=False)
            flow_gt = (inputs["flows"][:, 0] if "flows" in inputs
                       else torch.zeros_like(preds[-1]))
            var_max = self.var_max if self.use_var else 0.0
            var_min = self.var_min if self.use_var else 0.0
            outputs["info_preds"] = infos
            outputs["nf_preds"] = laplace_mixture_nll(
                preds, infos, flow_gt, var_min, var_max)
        return outputs


@register_model
@trainable
@ptlflow_trained
class dpflow(DPFlow):
    pass
