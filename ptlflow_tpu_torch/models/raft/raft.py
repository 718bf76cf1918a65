"""RAFT (``ptlflow_tpu/models/raft/raft.py``), NCHW: the eval forward with
its warm start, the training forward and ``SequenceLoss``.

Same preprocessing (BGR shifted by -0.5 and scaled by 2, BGR->RGB,
replicate padding to /8 on both sides), correlation pyramid, lookup order,
update block and convex upsampling as the JAX package.  The lookup is
prepared once per forward (``make_corr_lookup``) and the GRU iterations are
a Python loop; each one launches the lookup kernel once, and in training
its backward kernel once.  ``alternate_corr`` is accepted and, as in the
JAX package's RAFT, computes the same pyramid.  The spatially sharded
correlation is queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ...nn import cast_params
from ...ops.correlation import (build_corr_pyramid, coords_grid,
                                make_corr_lookup)
from ...ops.upsample import convex_upsample, upflow
from ...ops.warp import forward_interpolate
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..base import BaseModel
from .extractor import BasicEncoder, SmallEncoder
from .update import BasicUpdateBlock, SmallUpdateBlock

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


class SequenceLoss:
    """gamma-weighted L1 over the iteration sequence: the sum over
    iterations i of gamma^(n-i-1) times the mean, over B, both channels, H
    and W, of valid * |pred_i - gt|, where valid means ``valids >= 0.5`` and
    |gt| < ``max_flow``."""

    def __init__(self, gamma: float, max_flow: float):
        self.gamma = gamma
        self.max_flow = max_flow

    def __call__(self, outputs: Dict[str, torch.Tensor],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        flow_preds = outputs["flow_preds"]  # (iters, B, 2, H, W)
        flow_gt = inputs["flows"][:, 0]  # (B, 2, H, W)
        valid = inputs["valids"][:, 0]  # (B, 1, H, W)
        n = flow_preds.shape[0]
        mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1, keepdim=True))
        valid = ((valid >= 0.5) & (mag < self.max_flow)).to(flow_gt.dtype)
        exponents = torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                 device=flow_preds.device)
        weights = self.gamma ** exponents
        i_loss = (flow_preds - flow_gt[None]).abs()
        per_iter = (valid[None] * i_loss).mean(dim=(1, 2, 3, 4))
        return torch.sum(weights * per_iter)


class RAFT(BaseModel):
    # BGR -> RGB in preprocessing (LCV-RAFT keeps BGR, as its reference does)
    bgr_to_rgb = True
    # refuse mixed_precision and corr_dtype: the JAX package's model computes
    # in fp32 whatever it is given (GMA, SKFlow, LCV-RAFT)
    fp32_only = False
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
        if self.fp32_only and (corr_dtype is not None or mixed_precision):
            raise ValueError(f"{type(self).__name__} computes in fp32 only, "
                             f"as the JAX package's does: no "
                             f"mixed_precision or corr_dtype")
        super().__init__(output_stride=8,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
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

    def _update_extras(self, inp: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Inputs of the update block after (net, inp, corr, flow), computed
        once per forward from the context features: none for RAFT."""
        return ()

    def _corr_pyramid(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                      dtype: Optional[torch.dtype]) -> List[torch.Tensor]:
        """The levels that the lookup samples: RAFT's pyramid."""
        return build_corr_pyramid(fmap1, fmap2, self.corr_levels, dtype=dtype)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8,
        W/8).  ``inputs["prev_preds"]["flow_small"]`` of the previous pair,
        where given, warm-starts the coords by its forward projection
        (``ops.forward_interpolate``).

        Training (``training=True``): ``flow_preds`` (iters, B, 2, H, W),
        every iteration's upsampled flow, and ``flows``, the last one as
        (B, 1, 2, H, W), differentiable with respect to the weights.  The
        coords are detached at the start of every iteration, as the JAX
        package stops their gradient.  ``BaseModel.forward`` sets the
        modes."""
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0,
            bgr_to_rgb=self.bgr_to_rgb, resize_mode="pad",
            pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]

        corr_dtype = _DTYPES[self.corr_dtype]
        if self.mixed_precision:
            corr_dtype = torch.bfloat16
            image1 = image1.to(torch.bfloat16)
            image2 = image2.to(torch.bfloat16)

        fmap1 = self.fnet(image1)
        fmap2 = self.fnet(image2)
        corr_lookup = make_corr_lookup(
            self._corr_pyramid(fmap1, fmap2, corr_dtype), self.corr_radius)

        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = torch.relu(cnet[:, self.hidden_dim:])
        extra = self._update_extras(inp)

        b, _, h, w = fmap1.shape
        # coords stay fp32 under mixed precision: bf16 cannot hold pixel
        # positions ~1000 px to sub-pixel accuracy
        coords0 = coords_grid(b, h, w, dtype=torch.float32,
                              device=fmap1.device)
        coords1 = coords0
        prev = inputs.get("prev_preds")
        if prev is not None and prev.get("flow_small") is not None:
            coords1 = coords1 + forward_interpolate(prev["flow_small"])
        has_mask = not isinstance(self.update_block, SmallUpdateBlock)
        mask = (torch.zeros((b, 64 * 9, h, w), dtype=fmap1.dtype,
                            device=fmap1.device) if has_mask else None)

        flows_lr, masks = [], []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_lookup(coords1)
            flow = coords1 - coords0
            # the update block runs in the net dtype, coords stay fp32, and
            # the lookup output keeps the pyramid's dtype, as in the JAX
            # package: a bf16 pyramid feeds bf16 correlation convolutions
            net, up_mask, delta_flow = self.update_block(
                net, inp, corr, flow.to(net.dtype), *extra)
            coords1 = coords1 + delta_flow
            # SmallUpdateBlock gives no mask: the last one carries over
            if up_mask is not None:
                mask = up_mask
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)

        if training:
            # all iterations upsampled in one batched call, (iters*B, 2, h, w)
            flow_lr = torch.stack(flows_lr).flatten(0, 1)
            if has_mask:
                flow_ups = convex_upsample(flow_lr,
                                           torch.stack(masks).flatten(0, 1))
            else:
                flow_ups = upflow(flow_lr, 8)
            flow_ups = self.postprocess_predictions(
                flow_ups.unflatten(0, (len(flows_lr), b)), image_resizer,
                is_flow=True)
            return {"flows": flow_ups[-1][:, None], "flow_preds": flow_ups}

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
