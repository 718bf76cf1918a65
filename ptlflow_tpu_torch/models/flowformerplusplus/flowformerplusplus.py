"""FlowFormer++ (``ptlflow_tpu/models/flowformerplusplus/
flowformerplusplus.py``): FlowFormer's architecture as the released
checkpoints hold it, with two differences:

- the decoder's cross-attention projects the attention output alone
  (``Linear(v_dim)``), not FlowFormer's output concatenated with the token;
- the memory encoder has no channel convertor.

The decoder also carries the masked-cost-volume pretraining head
(``pretrain_head``), which the flow forward never runs and which is kept
so that the released checkpoints load strictly.  Inputs are padded to a
multiple of 32.  ``flowformer_pp`` is not trainable, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ...nn import CastConv2d, CastLinear
from ...utils.registry import register_model
from ..flowformer.flowformer import (CrossAttentionLayerDec, FlowFormerBase,
                                     MemoryDecoder, MemoryEncoder)


class CrossAttentionLayerDecPP(CrossAttentionLayerDec):
    """The cross-attention with ``proj(x)`` in place of ``proj([x,
    token])``."""

    def __init__(self, qk_dim: int, v_dim: int, query_token_dim: int,
                 tgt_token_dim: int, add_flow_token: bool = True,
                 num_heads: int = 8, dropout: float = 0.0):
        super().__init__(qk_dim, v_dim, query_token_dim, tgt_token_dim,
                         add_flow_token=add_flow_token, num_heads=num_heads,
                         dropout=dropout)
        self.proj = CastLinear(v_dim, query_token_dim)

    def project(self, x: torch.Tensor, short_cut: torch.Tensor
                ) -> torch.Tensor:
        return self.proj(x)


class MemoryEncoderPP(MemoryEncoder):
    """Twins features, cost maps and the cost perceiver, with no channel
    convertor."""

    def __init__(self, cost_heads_num: int, **cfg):
        super().__init__(encoder_latent_dim=None,
                         cost_heads_num=cost_heads_num, **cfg)


class MemoryDecoderPP(MemoryDecoder):
    """FlowFormer's decoder with ``CrossAttentionLayerDecPP`` and the
    unused ``pretrain_head`` (gt_r^2 = 225 cost bins at the default gt_r of
    15)."""

    def __init__(self, query_latent_dim: int, cost_heads_num: int,
                 decoder_depth: int, cost_latent_dim: int,
                 encoder_latent_dim: int, dropout: float, gt_r: int = 15):
        d = query_latent_dim
        super().__init__(
            query_latent_dim=d, cost_heads_num=cost_heads_num,
            decoder_depth=decoder_depth, cost_latent_dim=cost_latent_dim,
            dropout=dropout, context_dim=encoder_latent_dim,
            cross_attend=CrossAttentionLayerDecPP(
                d, d, d, cost_latent_dim, add_flow_token=True,
                dropout=dropout))
        self.pretrain_head = nn.Sequential(
            CastConv2d(d, d * 2, 1, 1), nn.GELU(),
            CastConv2d(d * 2, d * 2, 1, 1), nn.GELU(),
            CastConv2d(d * 2, gt_r ** 2 if gt_r > 0 else 81, 1, 1))


class FlowFormerPlusPlus(FlowFormerBase):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowformerplusplus-chairs-a7745dd5.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowformerplusplus-things-4db3ecff.ckpt",
        "things288960": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowformerplusplus-things_288960-a4291d41.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowformerplusplus-sintel-d14a1968.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowformerplusplus-kitti-65b828c3.ckpt",
    }

    def __init__(self, cnet: str = "twins", fnet: str = "twins",
                 patch_size: int = 8, cost_heads_num: int = 1,
                 cost_latent_input_dim: int = 64,
                 cost_latent_token_num: int = 8, cost_latent_dim: int = 128,
                 pe: str = "linear", encoder_depth: int = 3,
                 encoder_latent_dim: int = 256, decoder_depth: int = 32,
                 dropout: float = 0.0, vert_c_dim: int = 64,
                 query_latent_dim: int = 64, cost_encoder_res: bool = True,
                 use_tile_input: bool = True, tile_height: int = 432,
                 tile_sigma: float = 0.05,
                 train_size: Optional[Tuple[int, int]] = None, **kwargs):
        if cnet != "twins" or fnet != "twins":
            raise ValueError("FlowFormer++'s encoders are Twins-SVT")
        super().__init__(output_stride=32, loss_fn=None,
                         use_tile_input=use_tile_input,
                         tile_height=tile_height, tile_sigma=tile_sigma,
                         train_size=train_size, **kwargs)
        self.memory_encoder = MemoryEncoderPP(
            cost_heads_num=cost_heads_num, patch_size=patch_size,
            cost_latent_input_dim=cost_latent_input_dim, pe=pe,
            encoder_depth=encoder_depth, cost_latent_dim=cost_latent_dim,
            dropout=dropout, vert_c_dim=vert_c_dim,
            cost_latent_token_num=cost_latent_token_num,
            cost_encoder_res=cost_encoder_res)
        self.memory_decoder = MemoryDecoderPP(
            query_latent_dim=query_latent_dim,
            cost_heads_num=cost_heads_num, decoder_depth=decoder_depth,
            cost_latent_dim=cost_latent_dim,
            encoder_latent_dim=encoder_latent_dim, dropout=dropout)


@register_model
class flowformer_pp(FlowFormerPlusPlus):
    pass
