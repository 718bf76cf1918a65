"""STaRFlow (``ptlflow_tpu/models/starflow/starflow.py``), NCHW: IRR-PWC
over a sequence of N >= 2 frames, in both directions, with a temporal
memory.  Each consecutive pair runs the IRR pyramid from 1/64 to 1/4 with
one joint flow-and-occlusion estimator and context network shared by the
levels, the bilateral refinements of flow and occlusion, and the
occlusion upsampler to full size; each level's estimator also reads the
features the previous pair left at that level (``conv_1x1_time`` of its
estimator's features), warped by that pair's backward flow.

The two directions run as one batch of 2B (forward first), which
computes per sample what the JAX package computes direction by
direction.  Returns ``flows``, ``occs``, ``flows_b`` and ``occs_b``, each
(B, N - 1, C, H, W).  Inference only, as in the JAX package and the
reference; no lookup kernel runs here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from ...utils.registry import register_model
from ..base import BaseModel
from ..irr.pwc_modules import (FeatureExtractor, FlowEstimatorDense,
                               OccUpsampleNetwork, RefineFlow, RefineOcc,
                               compute_cost_volume, conv, irr_warp, lrelu,
                               rescale_flow, upsample2d_as)


class FlowAndOccEstimatorDense(FlowEstimatorDense):
    """The dense estimator with three outputs: (features, flow, occlusion)."""

    def __init__(self, ch_in: int):
        super().__init__(ch_in, ch_out=3)

    def forward(self, x: torch.Tensor):
        x, out = super().forward(x)
        return x, out[:, :2], out[:, 2:3]


class FlowAndOccContextNetwork(nn.Module):
    def __init__(self, ch_in: int):
        super().__init__()
        self.convs = nn.Sequential(
            conv(ch_in, 128, 3, 1, 1), conv(128, 128, 3, 1, 2),
            conv(128, 128, 3, 1, 4), conv(128, 96, 3, 1, 8),
            conv(96, 64, 3, 1, 16), conv(64, 32, 3, 1, 1),
            conv(32, 3, isReLU=False))

    def forward(self, x: torch.Tensor):
        out = self.convs(x)
        return out[:, :2], out[:, 2:3]


def _swap(t: torch.Tensor) -> torch.Tensor:
    """The other direction's tensor for each half of a 2B batch."""
    return t.roll(t.shape[0] // 2, 0)


class StarFlow(BaseModel):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/starflow-things-d3966a93.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/starflow-sintel-3c06b844.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/starflow-kitti-34b9a3ed.ckpt",
    }

    def __init__(self, div_flow: float = 0.05, search_range: int = 4,
                 output_level: int = 4, num_levels: int = 7,
                 num_chs: Sequence[int] = (3, 16, 32, 64, 96, 128, 196),
                 train_batch_size: Optional[int] = None, **kwargs):
        super().__init__(output_stride=64, loss_fn=None, **kwargs)
        self.div_flow = div_flow
        self.search_range = search_range
        self.output_level = output_level
        self.num_levels = num_levels
        self.feature_pyramid_extractor = FeatureExtractor(num_chs)
        self.num_ch_in = (search_range * 2 + 1) ** 2 + 32 + 2 + 1
        self.flow_and_occ_estimators = FlowAndOccEstimatorDense(
            2 * self.num_ch_in)
        self.context_networks = FlowAndOccContextNetwork(
            2 * self.num_ch_in + 448 + 2 + 1)
        self.occ_shuffle_upsample = OccUpsampleNetwork(11, 1)
        self.conv_1x1 = nn.ModuleList([
            conv(c, 32, kernel_size=1) for c in (196, 128, 96, 64)])
        self.conv_1x1_1 = conv(16, 3, kernel_size=1)
        self.conv_1x1_time = conv(2 * self.num_ch_in + 448, self.num_ch_in,
                                  kernel_size=1)
        self.refine_flow = RefineFlow(2 + 1 + 32)
        self.refine_occ = RefineOcc(1 + 32 + 32)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        if training:
            raise NotImplementedError(
                "training is not implemented for StarFlow (as in the JAX "
                "package and the reference)")
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=0.0, bgr_mult=1.0, bgr_to_rgb=True,
            resize_mode="interpolation", interpolation_mode="bilinear",
            interpolation_align_corners=False)
        b, n_frames = images.shape[:2]
        hw = images.shape[-2:]
        height_im, width_im = hw
        dv = self.div_flow
        frames = images.transpose(0, 1).flatten(0, 1)  # frame-major
        pyramid = self.feature_pyramid_extractor(frames) + [frames]
        # level l of frame i: pyramid[l][i * b:(i + 1) * b]
        outs = {"flows": [], "occs": [], "flows_b": [], "occs_b": []}
        prev_feats = [None] * (self.output_level + 1)
        prev_flow_b = [None] * (self.output_level + 1)

        def warp(x, flow):
            return irr_warp(x, flow, height_im, width_im, dv)

        def rescale(flow, to_local):
            return rescale_flow(flow, dv, width_im, height_im, to_local)

        for i in range(n_frames - 1):
            # the pair's two directions as one batch: (frame i, frame i + 1)
            # then (frame i + 1, frame i)
            pair = [torch.cat([f[(i + 1) * b:(i + 2) * b],
                               f[i * b:(i + 1) * b]]) for f in pyramid]
            flow = occ = None
            for l, tgt in enumerate(pair):
                src = _swap(tgt)
                h, w = src.shape[-2:]
                if flow is None:
                    flow = src.new_zeros(2 * b, 2, h, w)
                    occ = src.new_zeros(2 * b, 1, h, w)
                else:
                    flow = upsample2d_as(flow, (h, w))
                if l > self.output_level:
                    tgt_warp = warp(tgt, flow)
                    if l != self.num_levels - 1:
                        src_in = self.conv_1x1_1(src)
                        tgt_w_in = self.conv_1x1_1(tgt_warp)
                    else:
                        src_in, tgt_w_in = src, tgt_warp
                    occ = self.occ_shuffle_upsample(occ, torch.cat(
                        [src_in, tgt_w_in, flow, warp(_swap(flow), flow)], 1))
                    continue
                if l > 0:
                    occ = upsample2d_as(occ, (h, w))
                    tgt_warp = warp(tgt, flow)
                else:
                    tgt_warp = tgt
                corr = lrelu(compute_cost_volume(src, tgt_warp,
                                                 self.search_range))
                src_1by1 = (self.conv_1x1[l](src)
                            if l != self.output_level else src)
                if prev_feats[l] is None:
                    prev_feats[l] = src.new_zeros(b, self.num_ch_in, h, w)
                elif i > 0:
                    # the previous pair's features, moved by its backward
                    # flow at this level
                    prev_feats[l] = warp(prev_feats[l], prev_flow_b[l])
                flow = rescale(flow, True)
                memory = torch.cat([prev_feats[l],
                                    torch.zeros_like(prev_feats[l])])
                xi, fres, ores = self.flow_and_occ_estimators(
                    torch.cat([memory, corr, src_1by1, flow, occ], 1))
                flow_est = flow + fres
                occ_est = occ + ores
                fcres, ocres = self.context_networks(
                    torch.cat([xi, flow_est, occ_est], 1))
                flow_cont = rescale(flow_est + fcres, False)
                occ_cont = occ_est + ocres

                img_tgt = upsample2d_as(pair[-1], (h, w))
                img_src = _swap(img_tgt)
                flow = self.refine_flow(
                    flow_cont, img_src - warp(img_tgt, flow_cont), src_1by1)
                flow = rescale(flow, False)
                tgt_1by1_warp = warp(_swap(src_1by1), flow)
                occ = self.refine_occ(occ_cont, src_1by1,
                                      src_1by1 - tgt_1by1_warp)
                prev_feats[l] = self.conv_1x1_time(xi[:b])
                prev_flow_b[l] = flow[b:]
            outs["flows"].append(flow[:b])
            outs["flows_b"].append(flow[b:])
            outs["occs"].append(occ[:b])
            outs["occs_b"].append(occ[b:])

        res = {}
        for key, preds in outs.items():
            if key.startswith("flows"):
                preds = [upsample2d_as(f, hw) / dv for f in preds]
            else:
                preds = [upsample2d_as(torch.sigmoid(o), hw) for o in preds]
            res[key] = self.postprocess_predictions(
                torch.stack(preds, 1), resizer, is_flow=key.startswith("flow"))
        return res


@register_model
class starflow(StarFlow):
    pass
