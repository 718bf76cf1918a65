"""FlowFormer (``ptlflow_tpu/models/flowformer/flowformer.py``): a cost
volume of Twins-SVT features, encoded by a perceiver into 8 latent tokens
per pixel, and decoded by 32 recurrent steps of cross-attention and a GMA
update block.

- The cost volume has no 1/sqrt(C) scale; each pixel's (H1, W1) cost map
  is patch-embedded by three stride-2 convolutions with a coordinate FFN,
  and 8 latent tokens cross-attend those patches, then alternate
  self-attention over the tokens and windowed / sub-sampled attention over
  the pixels, with a context projection added to the queries and keys.
- The decoder prepares the correlation lookup of the raw cost maps once
  per forward (``ops.make_corr_lookup``: one level, radius 4) and launches
  it once per step: the hand-written kernel ``csrc/corr_lookup.cu`` on the
  card, whose gradient is ``csrc/corr_lookup_backward.cu`` in training.
- ``forward_tile`` serves inputs by overlapping tiles of ``train_size``
  blended with Gaussian weights, when a checkpoint sets ``train_size``.

Tokens are (B, N, C); features NCHW.  ``state_dict`` names are the
reference's (``ffn.3.``, ``decoder_layer.cross_attend.``, ``svt.``,
``latent_tokens``), so its checkpoints load with ``load_state_dict``.
Every layer casts its weights to its input's dtype, as the JAX package's
layers do, so the bfloat16 weight cast of ``validate --bf16`` computes what
the JAX package's does (ROADMAP.md, section 3).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import CastConv2d, CastLinear, LayerNorm
from ...ops.correlation import coords_grid, make_corr_lookup
from ...ops.upsample import convex_upsample
from ...ops.warp import forward_interpolate
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..gma.gma_utils import Aggregate, Attention
from ..raft.raft import SequenceLoss
from ..raft.update import BasicMotionEncoder, FlowHead, SepConvGRU
from .twins import Mlp, _mha, pad_to, twins_svt_large, unwindow, windows


def linear_position_embedding_sine(x: torch.Tensor, dim: int = 128,
                                   normalize_factor: float = 1 / 200
                                   ) -> torch.Tensor:
    """(..., 2) positions in (x, y) order -> (..., dim) sines and cosines
    of x and y at dim/4 frequencies each, in x's dtype.  The reference
    multiplies by 3.14, not pi."""
    freq = torch.arange(dim // 4, dtype=torch.float32, device=x.device)
    fx = 3.14 * x[..., -2:-1] * freq * normalize_factor
    fy = 3.14 * x[..., -1:] * freq * normalize_factor
    return torch.cat([torch.sin(fx), torch.cos(fx), torch.sin(fy),
                      torch.cos(fy)], dim=-1).to(x.dtype)


def grid_xy(h: int, w: int, dtype, device) -> torch.Tensor:
    """(h, w, 2) pixel positions in (x, y) order."""
    return coords_grid(1, h, w, dtype=dtype, device=device)[0].permute(1, 2, 0)


def ffn(dim: int, dropout: float) -> nn.Sequential:
    """The reference's FFN: Linear, GELU, Dropout, Linear, Dropout, so the
    second Linear is ``ffn.3``."""
    return nn.Sequential(CastLinear(dim, dim), nn.GELU(), nn.Dropout(dropout),
                         CastLinear(dim, dim), nn.Dropout(dropout))


# ----------------------------------------------------------- cost embedding
class CostPatchEmbed(nn.Module):
    """Each (H2, W2) cost map, zero-padded at the bottom and right to
    multiples of 8, to (H2/8)*(W2/8) tokens: three 6x6 stride-2
    convolutions, then a 1x1 FFN over the features and a sine embedding of
    each patch's centre, then a LayerNorm."""

    def __init__(self, patch_size: int = 8, in_chans: int = 1,
                 embed_dim: int = 64, pe: str = "linear"):
        super().__init__()
        if patch_size != 8 or pe != "linear":
            raise ValueError("FlowFormer's cost embedding has patch_size 8 "
                             "and the linear position encoding")
        self.patch_size = patch_size
        self.dim = embed_dim
        self.proj = nn.Sequential(
            CastConv2d(in_chans, embed_dim // 4, 6, stride=2, padding=2),
            nn.ReLU(),
            CastConv2d(embed_dim // 4, embed_dim // 2, 6, stride=2, padding=2),
            nn.ReLU(),
            CastConv2d(embed_dim // 2, embed_dim, 6, stride=2, padding=2))
        self.ffn_with_coord = nn.Sequential(
            CastConv2d(embed_dim * 2, embed_dim * 2, 1), nn.ReLU(),
            CastConv2d(embed_dim * 2, embed_dim * 2, 1))
        self.norm = LayerNorm(embed_dim * 2)

    def forward(self, x: torch.Tensor):
        """(B', C_in, H2, W2) -> tokens (B', h*w, 2*dim) and (h, w)."""
        p = self.patch_size
        h, w = x.shape[-2:]
        x = F.pad(x, (0, (p - w % p) % p, 0, (p - h % p) % p))
        x = self.proj(x)
        b, _, oh, ow = x.shape
        centre = grid_xy(oh, ow, x.dtype, x.device) * p + p / 2
        enc = linear_position_embedding_sine(centre, dim=self.dim)
        enc = enc.permute(2, 0, 1)[None].expand(b, -1, -1, -1)
        x = self.ffn_with_coord(torch.cat([x, enc], dim=1))
        return self.norm(x.flatten(2).transpose(1, 2)), (oh, ow)


# --------------------------------------------------- perceiver cost encoder
class SelfAttentionLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim / num_heads) ** -0.5
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.q = CastLinear(dim, dim, bias=True)
        self.k = CastLinear(dim, dim, bias=True)
        self.v = CastLinear(dim, dim, bias=True)
        self.proj = CastLinear(dim, dim)
        self.ffn = ffn(dim, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        short_cut = x
        x = self.norm1(x)
        out = _mha(self.q(x), self.k(x), self.v(x), self.num_heads,
                   self.scale)
        x = short_cut + self.proj(out)
        return x + self.ffn(self.norm2(x))


class CrossAttentionLayerEnc(nn.Module):
    """The encoder's cross-attention: query tokens (1, K, Cq) shared by
    every target sequence."""

    def __init__(self, qk_dim: int, v_dim: int, query_token_dim: int,
                 tgt_token_dim: int, num_heads: int = 8,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (qk_dim / num_heads) ** -0.5
        self.norm1 = LayerNorm(query_token_dim)
        self.norm2 = LayerNorm(query_token_dim)
        self.q = CastLinear(query_token_dim, qk_dim, bias=True)
        self.k = CastLinear(tgt_token_dim, qk_dim, bias=True)
        self.v = CastLinear(tgt_token_dim, v_dim, bias=True)
        self.proj = CastLinear(v_dim, query_token_dim)
        self.ffn = ffn(query_token_dim, dropout)

    def forward(self, query: torch.Tensor,
                tgt_token: torch.Tensor) -> torch.Tensor:
        """query (1, K, Cq), tgt_token (B', M, Ct) -> (B', K, Cq)."""
        n = tgt_token.shape[0]
        short_cut = query.expand(n, -1, -1)
        q = self.q(self.norm1(query)).expand(n, -1, -1)
        x = _mha(q, self.k(tgt_token), self.v(tgt_token), self.num_heads,
                 self.scale)
        x = short_cut + self.proj(x)
        return x + self.ffn(self.norm2(x))


def context_tokens(proj: nn.Module, context: torch.Tensor,
                   b: int) -> torch.Tensor:
    """``proj`` of the (B0, 256, H, W) context as (b, H*W, C) tokens, the
    batch tiled whole: sequence j reads image j mod B0, as the JAX
    package's ``jnp.tile`` and the reference's ``repeat`` do."""
    b0 = context.shape[0]
    ctx = proj(context.flatten(2).transpose(1, 2))
    return ctx.repeat(b // b0, 1, 1)


class LocallyGroupedAttnRPEContext(nn.Module):
    """Attention inside 7x7 windows, the queries and keys with the
    projected context concatenated and a sine embedding of the position in
    the window added."""

    def __init__(self, dim: int, num_heads: int = 8, ws: int = 7,
                 vert_c_dim: int = 64):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.ws = ws
        self.vert_c_dim = vert_c_dim
        self.context_proj = CastLinear(256, vert_c_dim)
        self.q = CastLinear(dim + vert_c_dim, dim, bias=True)
        self.k = CastLinear(dim + vert_c_dim, dim, bias=True)
        self.v = CastLinear(dim, dim, bias=True)
        self.proj = CastLinear(dim, dim)

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                context: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h, w = size
        ws = self.ws
        ctx = context_tokens(self.context_proj, context, b)
        x = x.reshape(b, h, w, c)
        x_qk = torch.cat([x, ctx.reshape(b, h, w, -1)], dim=-1)
        x, x_qk = pad_to(x, ws), pad_to(x_qk, ws)
        hp, wp = x.shape[1:3]
        enc = linear_position_embedding_sine(
            grid_xy(ws, ws, x.dtype, x.device), dim=x_qk.shape[-1])
        x_qk = windows(x_qk, ws) + enc.reshape(1, ws * ws, -1)
        out = _mha(self.q(x_qk), self.k(x_qk), self.v(windows(x, ws)),
                   self.num_heads, self.scale)
        out = unwindow(out, b, hp, wp, ws)[:, :h, :w]
        return self.proj(out.reshape(b, n, c))


class GlobalSubSampleAttnRPEContext(nn.Module):
    """Every pixel against the map sub-sampled by sr x sr stride-sr
    convolutions (keys from features and context, values from features),
    with sine embeddings of the positions added to queries and keys."""

    def __init__(self, dim: int, num_heads: int = 8, sr_ratio: int = 4,
                 vert_c_dim: int = 64):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.sr_ratio = sr_ratio
        self.vert_c_dim = vert_c_dim
        self.context_proj = CastLinear(256, vert_c_dim)
        self.q = CastLinear(dim + vert_c_dim, dim, bias=True)
        self.k = CastLinear(dim, dim, bias=True)
        self.v = CastLinear(dim, dim, bias=True)
        self.proj = CastLinear(dim, dim)
        self.sr_key = CastConv2d(dim + vert_c_dim, dim, sr_ratio,
                                 stride=sr_ratio)
        self.sr_value = CastConv2d(dim, dim, sr_ratio, stride=sr_ratio)
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                context: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h, w = size
        sr = self.sr_ratio
        ctx = context_tokens(self.context_proj, context, b)
        x = x.reshape(b, h, w, c)
        x_qk = torch.cat([x, ctx.reshape(b, h, w, -1)], dim=-1)
        x, x_qk = pad_to(x, sr), pad_to(x_qk, sr)
        hp, wp, c_qk = x_qk.shape[1:]
        enc = linear_position_embedding_sine(
            grid_xy(hp, wp, x.dtype, x.device).reshape(hp * wp, 2), dim=c_qk)
        q = self.q(x_qk.reshape(b, hp * wp, c_qk) + enc)

        xv = self.sr_value(x.permute(0, 3, 1, 2))
        xk = self.sr_key(x_qk.permute(0, 3, 1, 2))
        hs, ws_ = xv.shape[-2:]
        xv = self.norm(xv.flatten(2).transpose(1, 2))
        xk = self.norm(xk.flatten(2).transpose(1, 2))
        enc2 = linear_position_embedding_sine(
            (grid_xy(hs, ws_, x.dtype, x.device) * sr).reshape(hs * ws_, 2),
            dim=c)
        out = _mha(q, self.k(xk + enc2), self.v(xv), self.num_heads,
                   self.scale)
        out = out.reshape(b, hp, wp, c)[:, :h, :w]
        return self.proj(out.reshape(b, n, c))


class RPEBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 sr_ratio: int = 4, ws: int = 7, vert_c_dim: int = 64):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        if ws == 1:
            self.attn = GlobalSubSampleAttnRPEContext(dim, num_heads,
                                                      sr_ratio, vert_c_dim)
        else:
            self.attn = LocallyGroupedAttnRPEContext(dim, num_heads, ws,
                                                     vert_c_dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), size, context)
        return x + self.mlp(self.norm2(x))


class VerticalSelfAttentionLayer(nn.Module):
    def __init__(self, dim: int, vert_c_dim: int, num_heads: int = 8,
                 dropout: float = 0.0):
        super().__init__()
        self.local_block = RPEBlock(dim, num_heads, 4, sr_ratio=4, ws=7,
                                    vert_c_dim=vert_c_dim)
        self.global_block = RPEBlock(dim, num_heads, 4, sr_ratio=4, ws=1,
                                     vert_c_dim=vert_c_dim)

    def forward(self, x: torch.Tensor, size: Tuple[int, int],
                context: torch.Tensor) -> torch.Tensor:
        return self.global_block(self.local_block(x, size, context), size,
                                 context)


class CostPerceiverEncoder(nn.Module):
    def __init__(self, patch_size: int, cost_latent_input_dim: int, pe: str,
                 encoder_depth: int, cost_latent_dim: int, dropout: float,
                 vert_c_dim: int, cost_heads_num: int,
                 cost_latent_token_num: int, cost_encoder_res: bool):
        super().__init__()
        self.cost_latent_token_num = cost_latent_token_num
        self.cost_encoder_res = cost_encoder_res
        self.depth = encoder_depth
        self.patch_embed = CostPatchEmbed(
            in_chans=cost_heads_num, patch_size=patch_size,
            embed_dim=cost_latent_input_dim, pe=pe)
        self.input_layer = CrossAttentionLayerEnc(
            cost_latent_dim, cost_latent_dim, cost_latent_dim,
            cost_latent_input_dim * 2, dropout=dropout)
        self.encoder_layers = nn.ModuleList([
            SelfAttentionLayer(cost_latent_dim, dropout=dropout)
            for _ in range(encoder_depth)])
        self.vertical_encoder_layers = nn.ModuleList([
            VerticalSelfAttentionLayer(cost_latent_dim, vert_c_dim,
                                       dropout=dropout)
            for _ in range(encoder_depth)])
        self.latent_tokens = nn.Parameter(
            torch.zeros(1, cost_latent_token_num, cost_latent_dim))

    def init_own_params(self, gen: torch.Generator) -> None:
        """The latent tokens standard normal, as the JAX package draws
        them."""
        self.latent_tokens.copy_(torch.randn(self.latent_tokens.shape,
                                             generator=gen))

    def forward(self, cost_maps: torch.Tensor, size: Tuple[int, int],
                context: torch.Tensor) -> torch.Tensor:
        """cost_maps (B*H1*W1, heads, H2, W2), the (H1, W1) ``size`` of
        the pixel grid, context (B, 256, H1, W1) -> (B*H1*W1, K, C)."""
        h1, w1 = size
        b = cost_maps.shape[0] // (h1 * w1)
        k = self.cost_latent_token_num
        x, _ = self.patch_embed(cost_maps)
        x = self.input_layer(self.latent_tokens, x)
        short_cut = x
        for attn, vert in zip(self.encoder_layers,
                              self.vertical_encoder_layers):
            x = attn(x)
            # sequence bi*K + k of the vertical layer: token k of image bi
            x = x.reshape(b, h1 * w1, k, -1).transpose(1, 2)
            x = vert(x.reshape(b * k, h1 * w1, -1), size, context)
            x = x.reshape(b, k, h1 * w1, -1).transpose(1, 2)
            x = x.reshape(b * h1 * w1, k, -1)
        if self.cost_encoder_res:
            x = x + short_cut
        return x


def cost_maps_of(fmap1: torch.Tensor, fmap2: torch.Tensor,
                 heads: int) -> torch.Tensor:
    """Each pixel's correlation with every pixel of the other map, per head
    of C/heads channels, with no 1/sqrt(C) scale: (B, C, H, W) twice ->
    (B*H*W, heads, H, W) in fmap1's dtype, products summed in float32."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.reshape(b, heads, c // heads, h * w).float()
    f2 = fmap2.reshape(b, heads, c // heads, h * w).float()
    corr = torch.matmul(f1.transpose(-1, -2), f2)  # (B, heads, HW, HW)
    corr = corr.transpose(1, 2).reshape(b * h * w, heads, h, w)
    return corr.to(fmap1.dtype)


class MemoryEncoder(nn.Module):
    """Twins features of both frames, their cost maps, and the perceiver's
    cost memory.  ``encoder_latent_dim``, where given, is the width of
    FlowFormer's 1x1 channel convertor of the features; FlowFormer++ has
    none."""

    def __init__(self, encoder_latent_dim: Optional[int],
                 cost_heads_num: int, **cfg):
        super().__init__()
        if cost_heads_num != 1:
            raise NotImplementedError(
                "the decoder's lookup takes one cost map per pixel; "
                "cost_heads_num > 1 is not ported")
        self.cost_heads_num = cost_heads_num
        self.feat_encoder = twins_svt_large()
        self.channel_convertor = None if encoder_latent_dim is None else \
            CastConv2d(encoder_latent_dim, encoder_latent_dim, 1, padding=0,
                       bias=False)
        self.cost_perceiver_encoder = CostPerceiverEncoder(
            cost_heads_num=cost_heads_num, **cfg)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                context: torch.Tensor):
        """-> cost memory (B*H1*W1, K, C) and the cost maps (B*H1*W1,
        heads, H1, W1)."""
        feats = self.feat_encoder(torch.cat([img1, img2], dim=0))
        if self.channel_convertor is not None:
            feats = self.channel_convertor(feats)
        feat_s, feat_t = feats.chunk(2, dim=0)
        cost_maps = cost_maps_of(feat_s, feat_t, self.cost_heads_num)
        memory = self.cost_perceiver_encoder(cost_maps, feat_s.shape[-2:],
                                             context)
        return memory, cost_maps


# ----------------------------------------------------------------- decoder
class CrossAttentionLayerDec(nn.Module):
    """The decoder's cross-attention: each pixel's flow token (with a sine
    embedding of its coords) against its own K memory tokens;
    FlowFormer projects the attention output concatenated with the
    token."""

    def __init__(self, qk_dim: int, v_dim: int, query_token_dim: int,
                 tgt_token_dim: int, add_flow_token: bool = True,
                 num_heads: int = 8, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (qk_dim / num_heads) ** -0.5
        self.dim = qk_dim
        self.add_flow_token = add_flow_token
        self.norm1 = LayerNorm(query_token_dim)
        self.norm2 = LayerNorm(query_token_dim)
        self.q = CastLinear(query_token_dim, qk_dim, bias=True)
        self.k = CastLinear(tgt_token_dim, qk_dim, bias=True)
        self.v = CastLinear(tgt_token_dim, v_dim, bias=True)
        self.proj = CastLinear(v_dim * 2, query_token_dim)
        self.ffn = ffn(query_token_dim, dropout)

    def project(self, x: torch.Tensor, short_cut: torch.Tensor
                ) -> torch.Tensor:
        return self.proj(torch.cat([x, short_cut], dim=2))

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor, query_coord: torch.Tensor
                ) -> torch.Tensor:
        """query (B*H1*W1, 1, C); key, value (B*H1*W1, K, C); query_coord
        (B, 2, H1, W1)."""
        qc = query_coord.permute(0, 2, 3, 1).reshape(-1, 1, 2)
        qc_enc = linear_position_embedding_sine(qc, dim=self.dim)
        short_cut = query
        query = self.norm1(query)
        q = self.q(query + qc_enc if self.add_flow_token else qc_enc)
        x = _mha(q, key, value, self.num_heads, self.scale)
        x = short_cut + self.project(x, short_cut)
        return x + self.ffn(self.norm2(x))


class MemoryDecoderLayer(nn.Module):
    """Holds the cross-attention under the reference's
    ``decoder_layer.cross_attend`` name."""

    def __init__(self, cross_attend: nn.Module):
        super().__init__()
        self.cross_attend = cross_attend


class GMAUpdateBlock(nn.Module):
    """GMA's update block with FlowFormer's correlation features: the
    81-channel lookup and the 64-channel cross-attention output (the
    attention alone where ``only_global``), and the mask scaled by 0.25."""

    def __init__(self, only_global: bool, query_latent_dim: int,
                 hidden_dim: int = 128):
        super().__init__()
        cor_planes = query_latent_dim + (0 if only_global else 81)
        self.encoder = BasicMotionEncoder(cor_planes=cor_planes)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=128 + hidden_dim + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, 64 * 9, 1, padding=0))
        self.aggregator = Aggregate(dim=128, dim_head=128, heads=1)

    def forward(self, net, inp, corr, flow, attention):
        motion_features = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion_features)
        net = self.gru(net, torch.cat([inp, motion_features, motion_global],
                                      dim=1))
        delta_flow = self.flow_head(net)
        # 0.25 scales the mask gradients, as in the reference
        return net, 0.25 * self.mask(net), delta_flow


class MemoryDecoder(nn.Module):
    def __init__(self, query_latent_dim: int, cost_heads_num: int,
                 decoder_depth: int, cost_latent_dim: int,
                 add_flow_token: bool = True, dropout: float = 0.0,
                 only_global: bool = False, gma: bool = True,
                 context_dim: int = 256,
                 cross_attend: Optional[nn.Module] = None):
        super().__init__()
        if not gma:
            raise NotImplementedError("only the GMA decoder is implemented, "
                                      "as in the JAX package")
        self.dim = query_latent_dim
        self.depth = decoder_depth
        self.flow_token_encoder = nn.Sequential(
            CastConv2d(81 * cost_heads_num, query_latent_dim, 1, 1),
            nn.GELU(),
            CastConv2d(query_latent_dim, query_latent_dim, 1, 1))
        self.proj = CastConv2d(context_dim, 256, 1)
        self.decoder_layer = MemoryDecoderLayer(
            cross_attend or CrossAttentionLayerDec(
                query_latent_dim, query_latent_dim, query_latent_dim,
                cost_latent_dim, add_flow_token=add_flow_token,
                dropout=dropout))
        self.update_block = GMAUpdateBlock(only_global=only_global,
                                           query_latent_dim=query_latent_dim,
                                           hidden_dim=128)
        self.att = Attention(dim=128, heads=1, max_pos_size=160,
                             dim_head=128)

    def forward(self, cost_memory: torch.Tensor, context: torch.Tensor,
                cost_maps: torch.Tensor,
                prev_flow: Optional[torch.Tensor] = None,
                training: bool = False):
        """cost_memory (B*H1*W1, K, C), context (B, 256, H1, W1), cost_maps
        (B*H1*W1, 1, H1, W1).  Returns the upsampled flows (the last in
        eval, every step's in training), (steps, B, 2, 8*H1, 8*W1), and the
        last low-resolution flow (B, 2, H1, W1)."""
        b, _, h1, w1 = context.shape
        corr_lookup = make_corr_lookup([cost_maps[:, 0]], 4)
        # the coords carry the context's dtype, as in the JAX package; the
        # lookup takes them in float32
        coords0 = coords_grid(b, h1, w1, dtype=context.dtype,
                              device=context.device)
        coords1 = coords0
        if prev_flow is not None:
            coords1 = coords1 + forward_interpolate(prev_flow)

        context = self.proj(context)
        net = torch.tanh(context[:, :128])
        inp = torch.relu(context[:, 128:])
        attention = self.att(inp)

        cross = self.decoder_layer.cross_attend
        key = cross.k(cost_memory)
        value = cross.v(cost_memory)

        mask = context.new_zeros((b, 64 * 9, h1, w1))
        flows_lr: List[torch.Tensor] = []
        masks: List[torch.Tensor] = []
        for _ in range(self.depth):
            coords1 = coords1.detach()
            cost_forward = corr_lookup(coords1.float())
            query = self.flow_token_encoder(cost_forward)
            query = query.permute(0, 2, 3, 1).reshape(-1, 1, self.dim)
            cost_global = cross(query, key, value, coords1)
            cost_global = cost_global.reshape(b, h1, w1, self.dim)
            corr = torch.cat([cost_global.permute(0, 3, 1, 2), cost_forward],
                             dim=1)
            net, mask, delta_flow = self.update_block(
                net, inp, corr, coords1 - coords0, attention)
            coords1 = coords1 + delta_flow
            if training:
                flows_lr.append(coords1 - coords0)
                masks.append(mask)

        if training:
            ups = convex_upsample(torch.stack(flows_lr).flatten(0, 1),
                                  torch.stack(masks).flatten(0, 1))
            return ups.unflatten(0, (len(flows_lr), b)), coords1 - coords0
        flow_small = coords1 - coords0
        return convex_upsample(flow_small, mask)[None], flow_small


# ------------------------------------------------------------------- model
def compute_grid_indices(image_shape, patch_size, min_overlap: int = 20):
    """Top-left corners of the tiles, ``min_overlap`` apart at least, the
    last of each axis flush with the image, clamped so that every tile
    fits and without repeats."""
    hs = list(range(0, image_shape[0], patch_size[0] - min_overlap))
    ws = list(range(0, image_shape[1], patch_size[1] - min_overlap))
    hs[-1] = image_shape[0] - patch_size[0]
    ws[-1] = image_shape[1] - patch_size[1]
    hs = list(dict.fromkeys(min(h, image_shape[0] - patch_size[0])
                            for h in hs))
    ws = list(dict.fromkeys(min(w, image_shape[1] - patch_size[1])
                            for w in ws))
    return [(h, w) for h in hs for w in ws]


def compute_weight(hws, image_shape, patch_size,
                   sigma: float = 1.0) -> np.ndarray:
    """(tiles, H, W) float32 Gaussian blending weights, normalised over
    the tiles in float64: the reference divides the blended flow by the
    summed raw weights, which at sigma 0.05 underflow float32."""
    h, w = np.meshgrid(np.arange(patch_size[0], dtype=np.float64),
                       np.arange(patch_size[1], dtype=np.float64),
                       indexing="ij")
    h, w = h / patch_size[0] - 0.5, w / patch_size[1] - 0.5
    weights_hw = (h ** 2 + w ** 2) ** 0.5 / sigma
    denorm = 1 / (sigma * math.sqrt(2 * math.pi))
    weights_hw = denorm * np.exp(-0.5 * weights_hw ** 2)
    weights = np.zeros((len(hws),) + tuple(image_shape), np.float64)
    for i, (hh, ww) in enumerate(hws):
        eh = min(hh + patch_size[0], image_shape[0])
        ew = min(ww + patch_size[1], image_shape[1])
        weights[i, hh:eh, ww:ew] = weights_hw[:eh - hh, :ew - ww]
    weights /= weights.sum(0, keepdims=True)
    return weights.astype(np.float32)


class FlowFormerBase(BaseModel):
    """What FlowFormer and FlowFormer++ share: the Twins context encoder,
    the padded forward with its warm start and the tiled forward.
    Subclasses build ``memory_encoder`` and ``memory_decoder``."""

    def __init__(self, output_stride: int, loss_fn, use_tile_input: bool,
                 tile_height: int, tile_sigma: float,
                 train_size: Optional[Tuple[int, int]], **kwargs):
        super().__init__(output_stride=output_stride, loss_fn=loss_fn,
                         **kwargs)
        self.use_tile_input = use_tile_input
        self.tile_height = tile_height
        self.tile_sigma = tile_sigma
        self.train_size = train_size
        self.context_encoder = twins_svt_large()

    def _predict(self, image1, image2, prev_flow=None, training=False):
        context = self.context_encoder(image1)
        memory, cost_maps = self.memory_encoder(image1, image2, context)
        return self.memory_decoder(memory, context, cost_maps,
                                   prev_flow=prev_flow, training=training)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        if self.use_tile_input and self.train_size is not None \
                and not training:
            return self.forward_tile(inputs)
        return self.forward_pad(inputs, training)

    def forward_pad(self, inputs: Dict[str, Any],
                    training: bool = False) -> Dict[str, torch.Tensor]:
        """Replicate-padded to the output stride on both sides.  Eval:
        ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/8, W/8),
        warm-started from ``inputs["prev_preds"]["flow_small"]`` where
        given.  Training: ``flow_preds`` (steps, B, 2, H, W) and ``flows``,
        the last of them."""
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        prev = inputs.get("prev_preds")
        prev_flow = None if prev is None else prev.get("flow_small")
        flow_predictions, flow_small = self._predict(
            images[:, 0], images[:, 1], prev_flow, training)
        flow_predictions = self.postprocess_predictions(
            flow_predictions, image_resizer, is_flow=True)
        out = {"flows": flow_predictions[-1][:, None]}
        if training:
            out["flow_preds"] = flow_predictions
        else:
            out["flow_small"] = flow_small
        return out

    def forward_tile(self, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Tiles of ``train_size`` over the input, padded at the bottom with
        -1 to ``tile_height`` rows at least (and the width split evenly),
        each predicted alone, blended by ``compute_weight``'s Gaussian
        weights."""
        th, tw = self.train_size
        input_size = inputs["images"].shape[-2:]
        image_size = (max(self.tile_height, input_size[-2]), input_size[-1])
        hws = compute_grid_indices(image_size, (th, tw))
        images, image_resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", target_size=image_size, pad_two_side=False,
            pad_mode="constant", pad_value=-1)
        image1, image2 = images[:, 0], images[:, 1]
        weights = torch.from_numpy(compute_weight(
            hws, image_size, (th, tw), self.tile_sigma)).to(image1)

        flows = image1.new_zeros((image1.shape[0], 2) + image_size)
        flow_count = image1.new_zeros((1, 1) + image_size)
        for idx, (h, w) in enumerate(hws):
            preds, _ = self._predict(image1[..., h:h + th, w:w + tw],
                                     image2[..., h:h + th, w:w + tw])
            eh = min(h + th, image_size[0])
            ew = min(w + tw, image_size[1])
            wt = weights[idx, h:eh, w:ew]
            flows[..., h:eh, w:ew] += preds[-1][..., :eh - h, :ew - w] * wt
            flow_count[..., h:eh, w:ew] += wt
        output_flow = self.postprocess_predictions(flows / flow_count,
                                                   image_resizer,
                                                   is_flow=True)
        return {"flows": output_flow[:, None]}


class FlowFormer(FlowFormerBase):
    pretrained_checkpoints = {
        "chairs": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowformer-chairs-84881320.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowformer-things-dbe62dd3.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowformer-sintel-cce498f8.ckpt",
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/flowformer-kitti-d4225180.ckpt",
    }

    def __init__(self, add_flow_token: bool = True, cnet: str = "twins",
                 cost_encoder_res: bool = True, cost_heads_num: int = 1,
                 cost_latent_dim: int = 128,
                 cost_latent_input_dim: int = 64,
                 cost_latent_token_num: int = 8, decoder_depth: int = 32,
                 dropout: float = 0.0, encoder_depth: int = 3,
                 encoder_latent_dim: int = 256, fnet: str = "twins",
                 gamma: float = 0.8, max_flow: float = 400.0,
                 gma: bool = True, only_global: bool = False,
                 patch_size: int = 8, pe: str = "linear",
                 query_latent_dim: int = 64, vert_c_dim: int = 64,
                 use_tile_input: bool = True, tile_height: int = 432,
                 tile_sigma: float = 0.05,
                 train_size: Optional[Tuple[int, int]] = None, **kwargs):
        if cnet != "twins" or fnet != "twins":
            raise ValueError("FlowFormer's encoders are Twins-SVT")
        super().__init__(output_stride=8,
                         loss_fn=SequenceLoss(gamma, max_flow),
                         use_tile_input=use_tile_input,
                         tile_height=tile_height, tile_sigma=tile_sigma,
                         train_size=train_size, **kwargs)
        self.memory_encoder = MemoryEncoder(
            encoder_latent_dim=encoder_latent_dim,
            cost_heads_num=cost_heads_num, patch_size=patch_size,
            cost_latent_input_dim=cost_latent_input_dim, pe=pe,
            encoder_depth=encoder_depth, cost_latent_dim=cost_latent_dim,
            dropout=dropout, vert_c_dim=vert_c_dim,
            cost_latent_token_num=cost_latent_token_num,
            cost_encoder_res=cost_encoder_res)
        self.memory_decoder = MemoryDecoder(
            query_latent_dim=query_latent_dim,
            cost_heads_num=cost_heads_num, decoder_depth=decoder_depth,
            cost_latent_dim=cost_latent_dim, add_flow_token=add_flow_token,
            dropout=dropout, only_global=only_global, gma=gma)


@register_model
@trainable
class flowformer(FlowFormer):
    pass
