"""WAFT (``ptlflow_tpu/models/waft/waft.py``), NCHW: warping-alone field
transforms at half resolution, its eval forward, its training forward with
the Laplace-mixture NLL maps and the sequence loss.

Frozen foundation features (DepthAnything V2 or Twins) and a trainable
ResNet18-style net give both frames' maps at 1/2; each of the ``iters``
refinements warps the second map by the current flow
(``bilinear_sampler``, zero padding), runs the patch-8 ViT refine network
over [map 1, warped map 2, hidden state, flow], updates the hidden state
and regresses a flow step, the 4-channel info map and the convex
upsampling weights; flow and info share one 2x convex upsampling.  There
is no cost volume and no lookup.  ``WAFTa1`` stops the gradient of its
DepthAnything features; both variants name their frozen modules in
``frozen_prefixes``, which the trainer leaves out.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ...nn import CastConv2d
from ...ops.correlation import coords_grid
from ...ops.grid_sample import bilinear_sampler, interpolate
from ...ops.upsample import convex_upsample_data
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..base import BaseModel
from ..sea_raft.sea_raft import SequenceLoss, laplace_mixture_nll
from .backbones import (VIT_CONFIGS, DepthAnythingFeatureA1,
                        DepthAnythingFeatureA2, RefineViT, ResNet18DeconvA1,
                        ResNet18DeconvA2, TwinsFeatureEncoder)

# The gamma-weighted mean NLL over the valid pixels where it is finite:
# SEA-RAFT's loss, term for term.
WAFTSequenceLoss = SequenceLoss

_BGR_ADD = [-0.406, -0.456, -0.485]
_BGR_MULT = [1 / 0.225, 1 / 0.224, 1 / 0.229]


class WAFTBase(BaseModel):
    def _heads(self, dim: int) -> None:
        self.warp_linear = CastConv2d(3 * dim + 2, dim, 1)
        self.refine_transform = CastConv2d(dim // 2 * 3, dim, 1)
        self.upsample_weight = torch.nn.Sequential(
            CastConv2d(dim, 2 * dim, 3, padding=1), torch.nn.ReLU(),
            CastConv2d(2 * dim, 4 * 9, 1))
        self.flow_head = torch.nn.Sequential(
            CastConv2d(dim, 2 * dim, 3, padding=1), torch.nn.ReLU(),
            CastConv2d(2 * dim, 6, 1))

    def _preprocess(self, inputs: Dict[str, Any]):
        return self.preprocess_images(
            inputs["images"], bgr_add=_BGR_ADD, bgr_mult=_BGR_MULT,
            bgr_to_rgb=True, resize_mode="pad", pad_mode="constant",
            pad_two_side=True)

    def _iterate(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 net: torch.Tensor, resizer, training: bool):
        """The refinements at 1/2: the upsampled, unpadded (flows, infos)
        of every refinement in training, of the last one in eval."""
        b, _, h, w = fmap1.shape
        flow = torch.zeros((b, 2, h, w), dtype=fmap1.dtype,
                           device=fmap1.device)
        grid = coords_grid(b, h, w, dtype=fmap1.dtype, device=fmap1.device)
        flows: List[torch.Tensor] = []
        infos: List[torch.Tensor] = []
        for it in range(self.iters):
            flow = flow.detach()
            warped = bilinear_sampler(fmap2, grid + flow)
            refine_inp = self.warp_linear(
                torch.cat([fmap1, warped, net, flow], dim=1))
            out = self.refine_net(refine_inp)["out"]
            net = self.refine_transform(torch.cat([out, net], dim=1))
            update = self.flow_head(net)
            flow = flow + update[:, :2]
            if training or it == self.iters - 1:
                flow_up, info_up = convex_upsample_data(
                    flow, update[:, 2:], 0.25 * self.upsample_weight(net), 2)
                flows.append(self.postprocess_predictions(flow_up, resizer,
                                                          is_flow=True))
                infos.append(self.postprocess_predictions(info_up, resizer,
                                                          is_flow=False))
        return flows, infos

    def _outputs(self, flows, infos, inputs, training: bool):
        """Eval: ``flows`` (B, 1, 2, H, W).  Training: also ``flow_preds``
        and ``info_preds`` (iters, B, 2 or 4, H, W) and ``nf_preds``, their
        Laplace-mixture NLL (iters, B, 2, H, W) against
        ``inputs["flows"]`` (zeros where absent)."""
        if not training:
            return {"flows": flows[-1][:, None]}
        flow_preds, info_preds = torch.stack(flows), torch.stack(infos)
        gt = (inputs["flows"][:, 0] if inputs.get("flows") is not None
              else torch.zeros_like(flows[-1]))
        return {"flows": flows[-1][:, None], "flow_preds": flow_preds,
                "info_preds": info_preds,
                "nf_preds": laplace_mixture_nll(flow_preds, info_preds, gt,
                                                self.var_min, self.var_max)}


class WAFTa1(WAFTBase):
    """Frozen DepthAnything V2 features (their gradient stopped), a
    ResNet18-deconv net over [depth features, image], padded to /112."""

    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/waft-chairs-16b9cbc4.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/waft-things-24bd04dc.ckpt",
        "tar": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/waft-tar-48597867.ckpt",
        "tar-c-t": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/waft-tar-c-t-eaa5c133.ckpt",
    }
    frozen_prefixes = ("da_feature",)

    def __init__(self, dav2_backbone: str = "vits",
                 network_backbone: str = "vits", gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 5, var_min: float = 0,
                 var_max: float = 10, **kwargs):
        super().__init__(output_stride=112,
                         loss_fn=WAFTSequenceLoss(gamma, max_flow), **kwargs)
        self.iters = iters
        self.var_min = var_min
        self.var_max = var_max
        self.da_feature = DepthAnythingFeatureA1(dav2_backbone)
        self.pretrain_dim = VIT_CONFIGS[dav2_backbone]["features"]
        self.network_dim = VIT_CONFIGS[network_backbone]["features"]
        self.refine_net = RefineViT(network_backbone, self.network_dim,
                                    patch_size=8)
        self.fnet = ResNet18DeconvA1(self.pretrain_dim // 2 + 3, 64)
        self.fmap_conv = CastConv2d(self.pretrain_dim // 2 + 64,
                                    self.network_dim, 1)
        self.hidden_conv = CastConv2d(self.network_dim * 2,
                                      self.network_dim, 1)
        self._heads(self.network_dim)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, Any]:
        images, resizer = self._preprocess(inputs)
        h, w = images.shape[-2:]
        fmaps = []
        for k in range(2):
            image = images[:, k]
            with torch.no_grad():
                da = self.da_feature(image)["out"]
            feat = self.fnet(torch.cat([da, image], dim=1))[0]
            da_2x = interpolate(da, (h // 2, w // 2), align_corners=True)
            fmaps.append(self.fmap_conv(torch.cat([feat, da_2x], dim=1)))
        net = self.hidden_conv(torch.cat(fmaps, dim=1))
        flows, infos = self._iterate(fmaps[0], fmaps[1], net, resizer,
                                     training)
        return self._outputs(flows, infos, inputs, training)


class WAFTa2(WAFTBase):
    """A frozen feature encoder (``twins`` or ``dav2``) beside a trainable
    ResNet18-deconv net over the image; padded to /64 (Twins) or /112
    (DepthAnything)."""

    frozen_prefixes = ()

    def __init__(self, feature_encoder: str = "twins",
                 iterative_module: str = "vits", gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 5, var_min: float = 0,
                 var_max: float = 10, **kwargs):
        super().__init__(
            output_stride=112 if feature_encoder == "dav2" else 64,
            loss_fn=WAFTSequenceLoss(gamma, max_flow), **kwargs)
        self.iters = iters
        self.var_min = var_min
        self.var_max = var_max
        if feature_encoder == "twins":
            self.encoder = TwinsFeatureEncoder()
            self.frozen_prefixes = ("encoder.backbone",)
        elif feature_encoder == "dav2":
            self.encoder = DepthAnythingFeatureA2("vits", lvl=-3)
            self.frozen_prefixes = ("encoder.encoder",)
        elif feature_encoder == "dinov3":
            raise NotImplementedError(
                "DINOv3 weights are gated (request from Meta); the "
                "reference similarly requires a local thirdparty/dinov3 "
                "checkout (waft/backbone/dinov3.py:46-52)")
        else:
            raise ValueError(f"Unknown feature encoder: {feature_encoder}")
        self.pretrain_dim = self.encoder.output_dim
        self.fnet = ResNet18DeconvA2(3, self.pretrain_dim)
        self.iter_dim = VIT_CONFIGS[iterative_module]["features"]
        self.refine_net = RefineViT(iterative_module, self.iter_dim,
                                    patch_size=8)
        self.fmap_conv = CastConv2d(self.pretrain_dim * 2, self.iter_dim, 1)
        self.hidden_conv = CastConv2d(self.iter_dim * 2, self.iter_dim, 1)
        self._heads(self.iter_dim)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, Any]:
        images, resizer = self._preprocess(inputs)
        fmaps = [self.fmap_conv(torch.cat(
            [self.encoder(images[:, k]), self.fnet(images[:, k])[0]], dim=1))
            for k in range(2)]
        net = self.hidden_conv(torch.cat(fmaps, dim=1))
        flows, infos = self._iterate(fmaps[0], fmaps[1], net, resizer,
                                     training)
        return self._outputs(flows, infos, inputs, training)


@register_model
@trainable
@ptlflow_trained
class waft_dav2_a1(WAFTa1):
    pass


@register_model
@trainable
@ptlflow_trained
class waft_dav2_a2(WAFTa2):
    pretrained_checkpoints = {
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/waft_dav2_a2-sintel-b346e853.ckpt",
        "zero_shot": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/waft_dav2_a2-zero_shot-4d51a008.ckpt",
    }

    def __init__(self, feature_encoder: str = "dav2", **kwargs):
        super().__init__(feature_encoder, **kwargs)


@register_model
@trainable
class waft_dinov3_a2(WAFTa2):
    def __init__(self, feature_encoder: str = "dinov3", **kwargs):
        super().__init__(feature_encoder, **kwargs)


@register_model
@trainable
@ptlflow_trained
class waft_twins_a2(WAFTa2):
    pretrained_checkpoints = {
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/waft_twins_a2-sintel-c3348f5f.ckpt",
        "zero_shot": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/waft_twins_a2-zero_shot-f81e2579.ckpt",
    }

    def __init__(self, feature_encoder: str = "twins", **kwargs):
        super().__init__(feature_encoder, **kwargs)
