"""LCV-RAFT (``ptlflow_tpu/models/lcv/lcv_raft.py``), NCHW: RAFT whose cost
volume uses a learned metric.

The correlation of two feature vectors is f1 W f2 / sqrt(C) with
W = P^T D P symmetric positive definite: P is the Cayley transform
(I + S)(I - S)^-1 of the skew part S of an upper-triangular ``raw_P``, and
D a positive diagonal from ``raw_D`` (``LearnableCorrBlock.weight_matrix``,
taken in float32 whatever the weights' dtype).  Its initial weights
(``raw_P`` = I, ``raw_D`` = 0) give W = I, RAFT's correlation.

The pyramid has ``num_levels + 1`` levels, each the product of f1 W with
fmap2 average-pooled so far, and the pooling stops once a level's smaller
side is no larger than the lookup window (2r + 1): the last levels of a
small map repeat.  The lookup reads the first ``num_levels`` with coords /
2^l, as RAFT's, even where a level did not shrink.

Everything else is the port's RAFT (``models/raft/raft.py``), except that
the images stay BGR (``bgr_to_rgb = False``), as in the reference, whose
checkpoints were trained so.  ``lcv_raft_small`` has RAFT-small's encoders
and update block, r = 3 and ``upflow``.  It computes in fp32 only, as the
JAX package's LCV-RAFT: no mixed-precision mode.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import register_model, trainable
from ..raft.extractor import SmallEncoder
from ..raft.raft import RAFT
from ..raft.update import SmallUpdateBlock


class LearnableCorrBlock(nn.Module):
    """The learned metric and the cost volume (corr_lcv.py:8-77 of the
    reference).  ``eye`` is the reference's identity buffer, kept so that
    its checkpoints load strictly; the metric is computed with a fresh
    identity, as the JAX package's is."""

    def __init__(self, dim: int, num_levels: int = 4, radius: int = 4):
        super().__init__()
        self.dim = dim
        self.num_levels = num_levels
        self.radius = radius
        self.raw_P = nn.Parameter(torch.eye(dim))
        self.raw_D = nn.Parameter(torch.zeros(dim))
        self.register_buffer("eye", torch.eye(dim))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.raw_P.copy_(torch.eye(self.dim))
        self.raw_D.zero_()
        self.eye.copy_(torch.eye(self.dim))

    def weight_matrix(self) -> torch.Tensor:
        """W = P^T D P in float32."""
        eye = torch.eye(self.dim, device=self.raw_P.device)
        upper = torch.triu(self.raw_P.float())
        skew = (upper - upper.T) / 2
        p = torch.matmul(eye + skew, torch.linalg.inv(eye - skew))
        trans_d = torch.atan(self.raw_D.float()) * 2 / math.pi
        d = torch.diag((1 + trans_d) / (1 - trans_d))
        return p.T @ d @ p

    def compute_cost_volume(self, fmap1: torch.Tensor, fmap2: torch.Tensor
                            ) -> List[torch.Tensor]:
        """``num_levels + 1`` levels (B*H1*W1, h_l, w_l) in fmap1's dtype.
        Each level is a product against the pooled fmap2, the same numbers
        as pooling the level-0 volume, since the product is linear."""
        b, c, h, w = fmap1.shape
        wm = self.weight_matrix().to(fmap1.dtype)
        f1w = fmap1.reshape(b, c, h * w).transpose(1, 2) @ wm  # (B, HW, C)
        scale = 1.0 / math.sqrt(c)
        pyramid = []
        f2 = fmap2
        for i in range(self.num_levels + 1):
            hl, wl = f2.shape[-2:]
            lvl = torch.matmul(f1w, f2.reshape(b, c, hl * wl)) * scale
            pyramid.append(lvl.reshape(b * h * w, hl, wl))
            if i < self.num_levels and min(hl, wl) > 2 * self.radius + 1:
                f2 = F.avg_pool2d(f2, 2, 2)
        return pyramid


class LCV_RAFT(RAFT):
    bgr_to_rgb = False
    fp32_only = True
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/lcv_raft-chairs-8063d698.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/lcv_raft-things-4c7233b8.ckpt",
    }

    def __init__(self, corr_levels: int = 4, corr_radius: int = 4,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32, **kwargs):
        super().__init__(corr_levels=corr_levels, corr_radius=corr_radius,
                         dropout=dropout, gamma=gamma, max_flow=max_flow,
                         iters=iters, **kwargs)

    def _build(self):
        super()._build()
        self.corr_block = LearnableCorrBlock(256, self.corr_levels,
                                             self.corr_radius)

    def _corr_pyramid(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                      dtype: Optional[torch.dtype]) -> List[torch.Tensor]:
        return self.corr_block.compute_cost_volume(
            fmap1, fmap2)[:self.corr_levels]


class LCV_RAFTSmall(LCV_RAFT):
    pretrained_checkpoints = {}

    def __init__(self, corr_levels: int = 4, corr_radius: int = 3,
                 dropout: float = 0.0, gamma: float = 0.8,
                 max_flow: float = 400, iters: int = 32, **kwargs):
        super().__init__(corr_levels=corr_levels, corr_radius=corr_radius,
                         dropout=dropout, gamma=gamma, max_flow=max_flow,
                         iters=iters, **kwargs)

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
        self.corr_block = LearnableCorrBlock(128, self.corr_levels,
                                             self.corr_radius)


@register_model
@trainable
class lcv_raft(LCV_RAFT):
    pass


@register_model
@trainable
class lcv_raft_small(LCV_RAFTSmall):
    pass
