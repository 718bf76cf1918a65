"""RAFT eval forward (``ptlflow_tpu/models/raft/raft.py``), NCHW.

Same preprocessing (BGR shifted by -0.5 and scaled by 2, BGR->RGB,
replicate padding to /8 on both sides), correlation pyramid, lookup order,
update block and convex upsampling as the JAX package.  The lookup is
prepared once per forward (``make_corr_lookup``) and the GRU iterations are
a Python loop; each one launches the lookup kernel once.

Only the eval path is ported: training (the ``flow_preds`` stack, the
sequence loss, backward), the warm start from ``prev_preds`` and the
spatially sharded correlation are queued in ROADMAP.md.  ``alternate_corr``
is accepted and, as in the JAX package's RAFT, computes the same pyramid.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...nn import cast_params
from ...ops.correlation import (build_corr_pyramid, coords_grid,
                                make_corr_lookup)
from ...ops.upsample import convex_upsample, upflow
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..base import BaseModel
from .extractor import BasicEncoder, SmallEncoder
from .update import BasicUpdateBlock, SmallUpdateBlock

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


class RAFT(BaseModel):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/raft-chairs-590f38f7.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/raft-things-802bbcfd.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/raft-sintel-fb44381e.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/raft-kitti-3a831a4b.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32,
                 alternate_corr: bool = False,
                 corr_dtype: Optional[str] = None,
                 mixed_precision: bool = False, **kwargs):
        super().__init__(output_stride=8, **kwargs)
        if corr_dtype not in _DTYPES:
            raise ValueError(f"corr_dtype must be one of {list(_DTYPES)}")
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        # "bfloat16" stores the pyramid in bf16; the lookup accumulates fp32
        self.corr_dtype = corr_dtype
        # bf16 encoders and update block, as the JAX package's inference
        # mixed precision; implies a bf16 pyramid
        self.mixed_precision = mixed_precision
        self.dropout = dropout
        self.gamma = gamma
        self.max_flow = max_flow
        self.iters = iters
        self.alternate_corr = alternate_corr

        self.hidden_dim = 128
        self.context_dim = 128
        self._build()
        if mixed_precision:
            # weights are stored in bf16, the norms' running statistics
            # stay fp32: the cast the JAX package applies on every forward
            cast_params(self, torch.bfloat16)

    def _build(self):
        self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                 dropout=self.dropout)
        self.cnet = BasicEncoder(output_dim=self.hidden_dim + self.context_dim,
                                 norm_fn="batch", dropout=self.dropout)
        self.update_block = BasicUpdateBlock(self.corr_levels,
                                             self.corr_radius,
                                             hidden_dim=self.hidden_dim)

    @torch.no_grad()
    def forward(self, inputs: Dict[str, torch.Tensor],
                training: bool = False) -> Dict[str, torch.Tensor]:
        """Eval forward: ``flows`` (B, 1, 2, H, W) and ``flow_small``
        (B, 2, H/8, W/8)."""
        if training or self.training:
            raise NotImplementedError(
                "only the eval forward is ported; training (flow_preds, "
                "SequenceLoss, backward) is queued in ROADMAP.md")
        if inputs.get("prev_preds") is not None:
            raise NotImplementedError(
                "the warm start (prev_preds) is queued in ROADMAP.md")
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]

        corr_dtype = _DTYPES[self.corr_dtype]
        if self.mixed_precision:
            corr_dtype = torch.bfloat16
            image1 = image1.to(torch.bfloat16)
            image2 = image2.to(torch.bfloat16)

        fmap1 = self.fnet(image1)
        fmap2 = self.fnet(image2)
        pyramid = build_corr_pyramid(fmap1, fmap2, self.corr_levels,
                                     dtype=corr_dtype)
        corr_lookup = make_corr_lookup(pyramid, self.corr_radius)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])

        b, _, h, w = fmap1.shape
        # coords stay fp32 under mixed precision: bf16 cannot hold pixel
        # positions ~1000 px to sub-pixel accuracy
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        coords1 = coords0
        has_mask = isinstance(self.update_block, BasicUpdateBlock)
        mask = (torch.zeros((b, 64 * 9, h, w), dtype=fmap1.dtype,
                            device=fmap1.device) if has_mask else None)

        for _ in range(self.iters):
            corr = corr_lookup(coords1)
            flow = coords1 - coords0
            # the update block runs in the net dtype, coords stay fp32, and
            # the lookup output keeps the pyramid's dtype, as in the JAX
            # package: a bf16 pyramid feeds bf16 correlation convolutions
            net, up_mask, delta_flow = self.update_block(
                net, inp, corr, flow.to(net.dtype))
            coords1 = coords1 + delta_flow
            if up_mask is not None:
                mask = up_mask

        flow_small = coords1 - coords0
        if has_mask:
            flow_up = convex_upsample(flow_small, mask)
        else:
            flow_up = upflow(flow_small, 8)
        flow_up = self.postprocess_predictions(flow_up, image_resizer,
                                               is_flow=True)
        return {"flows": flow_up[:, None], "flow_small": flow_small}


class RAFTSmall(RAFT):
    pretrained_checkpoints = {
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/raft_small-things-b7d9f997.ckpt"
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 3,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32,
                 alternate_corr: bool = False, **kwargs):
        super().__init__(corr_levels=corr_levels, corr_radius=corr_radius,
                         dropout=dropout, gamma=gamma, max_flow=max_flow,
                         iters=iters, alternate_corr=alternate_corr, **kwargs)

    def _build(self):
        self.hidden_dim = 96
        self.context_dim = 64
        self.fnet = SmallEncoder(output_dim=128, norm_fn="instance",
                                 dropout=self.dropout)
        self.cnet = SmallEncoder(output_dim=self.hidden_dim + self.context_dim,
                                 norm_fn="none", dropout=self.dropout)
        self.update_block = SmallUpdateBlock(self.corr_levels,
                                             self.corr_radius,
                                             hidden_dim=self.hidden_dim)


@register_model
@trainable
@ptlflow_trained
class raft(RAFT):
    pass


@register_model
@trainable
@ptlflow_trained
class raft_small(RAFTSmall):
    pass
