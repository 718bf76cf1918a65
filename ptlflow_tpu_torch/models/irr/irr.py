"""IRR, the iterative residual refinement PWC models
(``ptlflow_tpu/models/irr/irr.py``), NCHW: ``irr_pwcnet`` (an estimator a
level), ``irr_pwcnet_irr`` (one estimator shared by the levels, on the
residual), and ``irr_pwc`` and ``scopeflow`` (both directions with
occlusion, the bilateral refinements and the occlusion upsampler); their
eval and training forwards and losses.

Every model resizes its input by interpolation to a multiple of 64 and
runs coarse to fine from 1/64 to 1/4 on ``local_correlation`` cost volumes
(search radius 4); no lookup kernel and no iteration loop.  ScopeFlow is
IRR-PWC with the JAX package's ``_cont_extra_rescale`` quirk: its
``flow_preds`` hold the context flows rescaled to global units twice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import register_model, trainable
from ..base import BaseModel
from .pwc_modules import (ContextNetwork, FeatureExtractor,
                          FlowEstimatorDense, OccContextNetwork,
                          OccEstimatorDense, OccUpsampleNetwork, RefineFlow,
                          RefineOcc, compute_cost_volume, conv, irr_warp,
                          lrelu, rescale_flow, upsample2d_as)


def _downsample_as(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Average pooling to ``hw`` by whole ratios."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    return F.avg_pool2d(x, (h // hw[0], w // hw[1]))


def _epe_sum(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(pred - target, dim=1).sum()


class MultiScaleEPE_PWC:
    """The sum over predictions i of weight i times the summed EPE against
    the ground truth times ``div_flow`` pooled to its scale, over the batch
    size."""

    def __init__(self, div_flow: float,
                 train_batch_size: Optional[int] = None):
        self.div_flow = div_flow
        self.batch_size = train_batch_size
        self.weights = [0.32, 0.08, 0.02, 0.01, 0.005]

    def __call__(self, outputs, inputs) -> torch.Tensor:
        target = self.div_flow * inputs["flows"][:, 0]
        bs = self.batch_size or target.shape[0]
        total = 0.0
        for i, out in enumerate(outputs["flow_preds"]):
            t = _downsample_as(target, out.shape[-2:])
            total = total + self.weights[i] * _epe_sum(out, t)
        return total / bs


def f1_score_bal_loss(y_pred: torch.Tensor,
                      y_true: torch.Tensor) -> torch.Tensor:
    """The balanced F1 occlusion loss of IRR-PWC."""
    eps = 1e-8
    dims = (1, 2, 3)
    tp = -(y_true * torch.log(y_pred + eps)).sum(dims)
    fn = -((1 - y_true) * torch.log(1 - y_pred + eps)).sum(dims)
    denom_tp = y_true.sum(dims) + y_pred.sum(dims) + eps
    denom_fn = (1 - y_true).sum(dims) + (1 - y_pred).sum(dims) + eps
    return ((tp / denom_tp).sum() + (fn / denom_fn).sum()) \
        * y_pred.shape[2] * y_pred.shape[3] * 0.5


class MultiScaleEPE_PWC_Bi_Occ_upsample:
    """IRR-PWC's loss: the summed EPE of both directions' flows and the F1
    loss of both occlusions, each over its scales, the smaller of the two
    weighted up to the larger by a ratio that carries no gradient; over
    the batch size."""

    def __init__(self, div_flow: float,
                 train_batch_size: Optional[int] = None):
        self.div_flow = div_flow
        self.batch_size = train_batch_size
        self.weights = [0.32, 0.08, 0.02, 0.01, 0.005, 0.00125, 0.0003125]

    def __call__(self, outputs, inputs) -> torch.Tensor:
        tf_f = self.div_flow * inputs["flows"][:, 0]
        tf_b = self.div_flow * inputs.get("flows_b", inputs["flows"])[:, 0]
        occs = inputs.get("occs")
        to_f = (occs[:, 0] if occs is not None
                else tf_f.new_zeros((tf_f.shape[0], 1) + tf_f.shape[2:]))
        occs_b = inputs.get("occs_b")
        to_b = occs_b[:, 0] if occs_b is not None else to_f
        bs = self.batch_size or tf_f.shape[0]

        flow_loss = 0.0
        for i, out_i in enumerate(outputs["flow_preds"]):
            loss_i = 0.0
            for j in range(len(out_i) // 2):
                for pred, t in ((out_i[2 * j], tf_f),
                                (out_i[2 * j + 1], tf_b)):
                    loss_i = loss_i + _epe_sum(
                        pred, _downsample_as(t, pred.shape[-2:]))
            flow_loss = flow_loss + self.weights[i] * loss_i / len(out_i)

        occ_loss = 0.0
        for i, out_i in enumerate(outputs["occ_preds"]):
            loss_i = 0.0
            for j in range(len(out_i) // 2):
                for pred, t in ((out_i[2 * j], to_f),
                                (out_i[2 * j + 1], to_b)):
                    o = torch.sigmoid(pred)
                    loss_i = loss_i + f1_score_bal_loss(
                        o, _downsample_as(t, o.shape[-2:]))
            occ_loss = occ_loss + self.weights[i] * loss_i / len(out_i)

        f_l, o_l = flow_loss.detach(), occ_loss.detach()
        f_w = torch.where(f_l > o_l, torch.ones_like(f_l), o_l / f_l)
        o_w = torch.where(f_l > o_l, f_l / o_l, torch.ones_like(o_l))
        return (flow_loss * f_w + occ_loss * o_w) / bs


class _IRRBase(BaseModel):
    def __init__(self, loss_fn, div_flow: float, search_range: int,
                 output_level: int, num_chs: Sequence[int], **kwargs):
        super().__init__(output_stride=64, loss_fn=loss_fn, **kwargs)
        self.div_flow = div_flow
        self.search_range = search_range
        self.output_level = output_level
        self.feature_pyramid_extractor = FeatureExtractor(num_chs)

    def _pyramids(self, inputs):
        """(resizer, x1_raw, x2_raw, pyramid 1, pyramid 2): each pyramid
        coarse to fine, the raw frame last."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=0.0, bgr_mult=1.0, bgr_to_rgb=True,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=False)
        x1, x2 = images[:, 0], images[:, 1]
        return (resizer, x1, x2,
                self.feature_pyramid_extractor(x1) + [x1],
                self.feature_pyramid_extractor(x2) + [x2])

    def _flow_out(self, flow, hw, resizer):
        up = upsample2d_as(flow, hw) / self.div_flow
        return self.postprocess_predictions(up, resizer, is_flow=True)


class IRRPWCNet(_IRRBase):
    """PWC-Net with a dense flow estimator a level."""

    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/irr_pwcnet-things-3f7fb8ca.ckpt",
    }

    def __init__(self, div_flow: float = 0.05, search_range: int = 4,
                 output_level: int = 4,
                 num_chs: Sequence[int] = (3, 16, 32, 64, 96, 128, 196),
                 train_batch_size: Optional[int] = None, **kwargs):
        super().__init__(MultiScaleEPE_PWC(div_flow, train_batch_size),
                         div_flow, search_range, output_level, num_chs,
                         **kwargs)
        dim_corr = (search_range * 2 + 1) ** 2
        self.flow_estimators = nn.ModuleList([
            FlowEstimatorDense(dim_corr if lvl == 0 else dim_corr + ch + 2)
            for lvl, ch in enumerate(num_chs[::-1][:output_level + 1])])
        self.context_networks = ContextNetwork(dim_corr + 32 + 2 + 448 + 2)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        resizer, x1_raw, _, x1_pyr, x2_pyr = self._pyramids(inputs)
        hw = x1_raw.shape[-2:]
        flows = []
        flow = x1_raw.new_zeros((x1_raw.shape[0], 2) + x1_pyr[0].shape[-2:])
        for lvl, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            if lvl == 0:
                x2_warp = x2
            else:
                flow = upsample2d_as(flow, x1.shape[-2:])
                x2_warp = irr_warp(x2, flow, hw[0], hw[1], self.div_flow)
            corr = lrelu(compute_cost_volume(x1, x2_warp, self.search_range))
            est_in = corr if lvl == 0 else torch.cat([corr, x1, flow], dim=1)
            x_intm, flow = self.flow_estimators[lvl](est_in)
            if lvl == self.output_level:
                flow = flow + self.context_networks(
                    torch.cat([x_intm, flow], dim=1))
                flows.append(flow)
                break
            flows.append(flow)
        outputs = {"flows": self._flow_out(flow, hw, resizer)[:, None]}
        if training:
            outputs["flow_preds"] = flows
        return outputs


class IRRPWCNetIRR(_IRRBase):
    """One flow estimator and context network shared by the levels, on the
    flow's residual in local units."""

    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/irr_pwcnet_irr-things-41a07190.ckpt",
    }

    def __init__(self, div_flow: float = 0.05, search_range: int = 4,
                 output_level: int = 4,
                 num_chs: Sequence[int] = (3, 16, 32, 64, 96, 128, 196),
                 train_batch_size: Optional[int] = None, **kwargs):
        super().__init__(MultiScaleEPE_PWC(div_flow, train_batch_size),
                         div_flow, search_range, output_level, num_chs,
                         **kwargs)
        num_ch_in = (search_range * 2 + 1) ** 2 + 32 + 2
        self.flow_estimators = FlowEstimatorDense(num_ch_in)
        self.context_networks = ContextNetwork(num_ch_in + 448 + 2)
        self.conv_1x1 = nn.ModuleList([
            conv(c, 32, kernel_size=1) for c in (196, 128, 96, 64, 32)])

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        resizer, x1_raw, _, x1_pyr, x2_pyr = self._pyramids(inputs)
        hw = x1_raw.shape[-2:]
        dv = self.div_flow
        flows = []
        flow = x1_raw.new_zeros((x1_raw.shape[0], 2) + x1_pyr[0].shape[-2:])
        for lvl, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            if lvl == 0:
                x2_warp = x2
            else:
                flow = upsample2d_as(flow, x1.shape[-2:])
                x2_warp = irr_warp(x2, flow, hw[0], hw[1], dv)
            corr = lrelu(compute_cost_volume(x1, x2_warp, self.search_range))
            flow = rescale_flow(flow, dv, hw[1], hw[0], to_local=True)
            x_intm, flow_res = self.flow_estimators(
                torch.cat([corr, self.conv_1x1[lvl](x1), flow], dim=1))
            flow = flow + flow_res
            flow = flow + self.context_networks(
                torch.cat([x_intm, flow], dim=1))
            flow = rescale_flow(flow, dv, hw[1], hw[0], to_local=False)
            flows.append(flow)
            if lvl == self.output_level:
                break
        outputs = {"flows": self._flow_out(flow, hw, resizer)[:, None]}
        if training:
            outputs["flow_preds"] = flows
        return outputs


class IRRPWC(_IRRBase):
    """Both directions' flows and occlusions, refined bilaterally a level,
    then the occlusions upsampled to the input scale."""

    _cont_extra_rescale = False

    pretrained_checkpoints = {
        "chairs_occ": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/irr_pwc-chairs_occ-02066cc4.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/irr_pwc-things-c143e848.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/irr_pwc-sintel-6ad65777.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/irr_pwc-kitti-74d8868f.ckpt",
    }

    def __init__(self, div_flow: float = 0.05, search_range: int = 4,
                 output_level: int = 4, num_levels: int = 7,
                 num_chs: Sequence[int] = (3, 16, 32, 64, 96, 128, 196),
                 train_batch_size: Optional[int] = None, **kwargs):
        super().__init__(
            MultiScaleEPE_PWC_Bi_Occ_upsample(div_flow, train_batch_size),
            div_flow, search_range, output_level, num_chs, **kwargs)
        self.num_levels = num_levels
        dim_corr = (search_range * 2 + 1) ** 2
        self.num_ch_in_flo = dim_corr + 32 + 2
        self.num_ch_in_occ = dim_corr + 32 + 1
        self.flow_estimators = FlowEstimatorDense(self.num_ch_in_flo)
        self.context_networks = ContextNetwork(self.num_ch_in_flo + 448 + 2)
        self.occ_estimators = OccEstimatorDense(self.num_ch_in_occ)
        self.occ_context_networks = OccContextNetwork(
            self.num_ch_in_occ + 448 + 1)
        self.occ_shuffle_upsample = OccUpsampleNetwork(11, 1)
        self.conv_1x1 = nn.ModuleList([
            conv(c, 32, kernel_size=1) for c in (196, 128, 96, 64)])
        self.conv_1x1_1 = conv(16, 3, kernel_size=1)
        self.refine_flow = RefineFlow(2 + 1 + 32)
        self.refine_occ = RefineOcc(1 + 32 + 32)

    def _level(self, lvl, x1, x2, x1_raw, x2_raw, flow_f, flow_b, occ_f,
               occ_b, hw):
        """One estimation level (up to ``output_level``): the flows and
        occlusions refined, and what ``flow_preds``/``occ_preds`` get."""
        dv, (h_im, w_im) = self.div_flow, hw
        if lvl > 0:
            flow_f, flow_b, occ_f, occ_b = (
                upsample2d_as(t, x.shape[-2:]) for t, x in
                ((flow_f, x1), (flow_b, x2), (occ_f, x1), (occ_b, x2)))
            x2_warp = irr_warp(x2, flow_f, h_im, w_im, dv)
            x1_warp = irr_warp(x1, flow_b, h_im, w_im, dv)
        else:
            x2_warp, x1_warp = x2, x1
        corr_f = lrelu(compute_cost_volume(x1, x2_warp, self.search_range))
        corr_b = lrelu(compute_cost_volume(x2, x1_warp, self.search_range))
        if lvl != self.output_level:
            x1_1by1 = self.conv_1x1[lvl](x1)
            x2_1by1 = self.conv_1x1[lvl](x2)
        else:
            x1_1by1, x2_1by1 = x1, x2
        flow_f = rescale_flow(flow_f, dv, w_im, h_im, True)
        flow_b = rescale_flow(flow_b, dv, w_im, h_im, True)

        def estimate(corr, feat, flow, occ):
            xi, res = self.flow_estimators(torch.cat([corr, feat, flow], 1))
            flow_est = flow + res
            flow_cont = flow_est + self.context_networks(
                torch.cat([xi, flow_est], 1))
            xo, ores = self.occ_estimators(torch.cat([corr, feat, occ], 1))
            occ_est = occ + ores
            occ_cont = occ_est + self.occ_context_networks(
                torch.cat([xo, occ_est], 1))
            return (rescale_flow(flow_cont, dv, w_im, h_im, False), occ_cont)

        flow_cont_f, occ_cont_f = estimate(corr_f, x1_1by1, flow_f, occ_f)
        flow_cont_b, occ_cont_b = estimate(corr_b, x2_1by1, flow_b, occ_b)

        img1_resize = upsample2d_as(x1_raw, flow_f.shape[-2:])
        img2_resize = upsample2d_as(x2_raw, flow_b.shape[-2:])
        img2_warp = irr_warp(img2_resize, flow_cont_f, h_im, w_im, dv)
        img1_warp = irr_warp(img1_resize, flow_cont_b, h_im, w_im, dv)
        flow_f = rescale_flow(self.refine_flow(
            flow_cont_f.detach(), img1_resize - img2_warp, x1_1by1),
            dv, w_im, h_im, False)
        flow_b = rescale_flow(self.refine_flow(
            flow_cont_b.detach(), img2_resize - img1_warp, x2_1by1),
            dv, w_im, h_im, False)

        x2_1by1_warp = irr_warp(x2_1by1, flow_f, h_im, w_im, dv)
        x1_1by1_warp = irr_warp(x1_1by1, flow_b, h_im, w_im, dv)
        occ_f = self.refine_occ(occ_cont_f.detach(), x1_1by1,
                                x1_1by1 - x2_1by1_warp)
        occ_b = self.refine_occ(occ_cont_b.detach(), x2_1by1,
                                x2_1by1 - x1_1by1_warp)
        if self._cont_extra_rescale:
            flow_cont_f = rescale_flow(flow_cont_f, dv, w_im, h_im, False)
            flow_cont_b = rescale_flow(flow_cont_b, dv, w_im, h_im, False)
        return (flow_f, flow_b, occ_f, occ_b,
                [flow_cont_f, flow_cont_b, flow_f, flow_b],
                [occ_cont_f, occ_cont_b, occ_f, occ_b])

    def _upsample_level(self, lvl, x1, x2, flow_f, flow_b, occ_f, occ_b, hw):
        """A level past ``output_level``: the flows upsampled, the
        occlusions by the upsampling network."""
        dv, (h_im, w_im) = self.div_flow, hw
        flow_f = upsample2d_as(flow_f, x1.shape[-2:])
        flow_b = upsample2d_as(flow_b, x2.shape[-2:])
        x2_warp = irr_warp(x2, flow_f, h_im, w_im, dv)
        x1_warp = irr_warp(x1, flow_b, h_im, w_im, dv)
        flow_b_warp = irr_warp(flow_b, flow_f, h_im, w_im, dv)
        flow_f_warp = irr_warp(flow_f, flow_b, h_im, w_im, dv)
        if lvl != self.num_levels - 1:
            x1_in, x2_in, x1_w_in, x2_w_in = (
                self.conv_1x1_1(t) for t in (x1, x2, x1_warp, x2_warp))
        else:
            x1_in, x2_in, x1_w_in, x2_w_in = x1, x2, x1_warp, x2_warp
        occ_f = self.occ_shuffle_upsample(
            occ_f, torch.cat([x1_in, x2_w_in, flow_f, flow_b_warp], 1))
        occ_b = self.occ_shuffle_upsample(
            occ_b, torch.cat([x2_in, x1_w_in, flow_b, flow_f_warp], 1))
        return flow_f, flow_b, occ_f, occ_b

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """``flows``, ``flows_b`` (B, 1, 2, H, W), ``occs``, ``occs_b`` (B,
        1, 1, H, W) in [0, 1] and ``occ_preds``; in training also
        ``flow_preds``: a list a level of [context f, context b, refined f,
        refined b] (the upsampling levels: [f, b])."""
        resizer, x1_raw, x2_raw, x1_pyr, x2_pyr = self._pyramids(inputs)
        hw = tuple(x1_raw.shape[-2:])
        flows, occs = [], []
        sh = (x1_raw.shape[0],) + tuple(x1_pyr[0].shape[-2:])
        flow_f = x1_raw.new_zeros((sh[0], 2) + sh[1:])
        flow_b = x1_raw.new_zeros((sh[0], 2) + sh[1:])
        occ_f = x1_raw.new_zeros((sh[0], 1) + sh[1:])
        occ_b = x1_raw.new_zeros((sh[0], 1) + sh[1:])
        for lvl, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            if lvl <= self.output_level:
                (flow_f, flow_b, occ_f, occ_b, fl, oc) = self._level(
                    lvl, x1, x2, x1_raw, x2_raw, flow_f, flow_b, occ_f,
                    occ_b, hw)
                flows.append(fl)
                occs.append(oc)
            else:
                flow_f, flow_b, occ_f, occ_b = self._upsample_level(
                    lvl, x1, x2, flow_f, flow_b, occ_f, occ_b, hw)
                flows.append([flow_f, flow_b])
                occs.append([occ_f, occ_b])

        def occ_out(occ):
            up = upsample2d_as(torch.sigmoid(occ), hw)
            return self.postprocess_predictions(up, resizer, is_flow=False)

        outputs = {
            "flows": self._flow_out(flow_f, hw, resizer)[:, None],
            "occs": occ_out(occ_f)[:, None],
            "flows_b": self._flow_out(flow_b, hw, resizer)[:, None],
            "occs_b": occ_out(occ_b)[:, None],
            "occ_preds": occs,
        }
        if training:
            outputs["flow_preds"] = flows
        return outputs


class ScopeFlow(IRRPWC):
    """IRR-PWC's architecture and parameters; its ``flow_preds`` keep the
    context flows rescaled to global units twice, as the JAX package's
    do."""

    _cont_extra_rescale = True

    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scopeflow-chairs-ebfaa62d.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scopeflow-things-70e22d63.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scopeflow-kitti-a20c434d.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/scopeflow-sintel-21a91683.ckpt",
    }


@register_model
@trainable
class irr_pwc(IRRPWC):
    pass


@register_model
@trainable
class scopeflow(ScopeFlow):
    pass


@register_model
@trainable
class irr_pwcnet(IRRPWCNet):
    pass


@register_model
@trainable
class irr_pwcnet_irr(IRRPWCNetIRR):
    pass
