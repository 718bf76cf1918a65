"""ReCoVEr and Flow-Anything (``ptlflow_tpu/models/recover/recover.py``):
SEA-RAFT (``models/sea_raft/sea_raft.py``) with its forward, loss and
mixed-precision mode as they are, and another context network: ReCoVEr's
MobileNetV3-L (``recover_mn``), ConvNeXt-T (``recover_cx``) or SEA-RAFT's
own ResNet34-FPN (``recover_rn``); Flow-Anything is SEA-RAFT on ResNet34
at 4 refinements with its own checkpoints.  Each forward launches the
lookup once a refinement: 4 at the registered depth.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ...nn import cast_params
from ...utils.registry import register_model, trainable
from ..sea_raft.sea_raft import SEARAFT
from .backbones import ConvNeXtExtractor, MobileNetV3Extractor

_URL = "https://github.com/hmorimitsu/ptlflow/releases/download/weights1"


class ReCoVEr(SEARAFT):
    """``extractor_name`` picks the context network: "mn", "cx" or "rn"
    (SEA-RAFT's, built the same way)."""

    extractor_name = "rn"

    def __init__(self, corr_levels: int = 4, radius: int = 4,
                 dim: int = 128, initial_dim: int = 64, num_blocks: int = 2,
                 block_dims: Sequence[int] = (64, 128, 256),
                 pretrain: str = "resnet34", gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 4,
                 use_var: bool = True, var_min: float = 0,
                 var_max: float = 10, **kwargs):
        super().__init__(corr_levels=corr_levels, corr_radius=radius,
                         dim=dim, initial_dim=initial_dim,
                         num_blocks=num_blocks, block_dims=block_dims,
                         pretrain=pretrain, gamma=gamma, max_flow=max_flow,
                         iters=iters, use_var=use_var, var_min=var_min,
                         var_max=var_max, **kwargs)
        if self.extractor_name == "mn":
            self.cnet = MobileNetV3Extractor(size="l", input_dim=6,
                                             output_dim=256)
        elif self.extractor_name == "cx":
            self.cnet = ConvNeXtExtractor(size="t", input_dim=6,
                                          output_dim=256)
        if self.extractor_name != "rn" and self.mixed_precision:
            cast_params(self.cnet, torch.bfloat16)


@register_model
@trainable
class recover_mn(ReCoVEr):
    extractor_name = "mn"
    pretrained_checkpoints = {
        "sintel": f"{_URL}/recover_mn-sintel-f70fe21a.ckpt",
    }


@register_model
@trainable
class recover_rn(ReCoVEr):
    extractor_name = "rn"
    pretrained_checkpoints = {
        "sintel": f"{_URL}/recover_rn-sintel-f04c5eb0.ckpt",
    }


@register_model
@trainable
class recover_cx(ReCoVEr):
    extractor_name = "cx"
    pretrained_checkpoints = {
        "sintel": f"{_URL}/recover_cx-sintel-3d446466.ckpt",
    }


class FlowAnything(SEARAFT):
    pretrained_checkpoints = {
        "mixed288": f"{_URL}/flow_anything-mixed288-821b5025.ckpt",
        "mixed432": f"{_URL}/flow_anything-mixed432-0beef53e.ckpt",
        "mixed_tskh432": f"{_URL}/flow_anything-mixed_tskh432-4786f170.ckpt",
    }

    def __init__(self, pretrain: str = "resnet34", iters: int = 4,
                 **kwargs):
        super().__init__(pretrain=pretrain, iters=iters, **kwargs)


@register_model
class flow_anything(FlowAnything):
    pass
