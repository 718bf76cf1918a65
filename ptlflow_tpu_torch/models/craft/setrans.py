"""CRAFT's squeeze-expanded transformer (SETrans) blocks
(``ptlflow_tpu/models/craft/setrans.py``), on tokens (B, N, C) and NCHW
feature maps.

Multi-mode attention: the scores of each of the ``num_modes`` heads are
divided by sqrt(mode_dim), clipped to +-``attn_clip`` (unconditionally,
which is the reference's clip-when-exceeded), offset by
``pos_code_weight`` times the sliding positional biases and softmaxed in
float32.  The inter-frame transformer shares one ``Linear`` between
``query`` and ``key`` (``tie_qk_scheme="shared"``): the reference's
``state_dict`` holds it under both names, and so does the port's, while
``parameters()`` counts it once, as the JAX package stores it.
``LayerNorm`` here has eps 1e-12 and no affine transform.  The products are
plain matrix products in float32, as the JAX package computes them outside
any Pallas kernel; every linear layer casts its weights to its input's
dtype, so a bf16 weight cast computes as the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...nn import CastLinear, LayerNorm


class SETransConfig:
    """A mutable bag of the reference's defaults (setrans.py:81-131)."""

    def __init__(self, **overrides):
        self.feat_dim = -1
        self.in_feat_dim = -1
        self.pos_dim = 2
        self.pos_code_weight = 1.0
        self.num_modes = 4
        self.tie_qk_scheme = "shared"
        self.trans_output_type = "private"
        self.attn_clip = 100.0
        self.base_initializer_range = 0.02
        self.qk_have_bias = False
        self.v_has_bias = False
        self.query_idbias_scale = 10
        self.feattrans_lin1_idbias_scale = 10
        self.pool_modes_feat = "softmax"
        self.pos_code_type = "bias"
        self.pos_bias_radius = 7
        self.out_attn_probs_only = False
        self.out_attn_scores_only = False
        self.attn_mask_radius = -1
        self.has_FFN = True
        self.has_input_skip = False
        for k, v in overrides.items():
            setattr(self, k, v)


class ModeLinear(CastLinear):
    """A linear layer with the JAX package's SETrans init: weights normal
    with std ``std``; where ``ident`` (k, in) is given, an identity or a
    tiled one, the first k output rows halved and offset by ``ident``
    times ``std * idbias_scale``."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 std: float, ident: Optional[torch.Tensor] = None,
                 idbias_scale: float = 0.0):
        super().__init__(in_features, out_features, bias=bias)
        self.std = std
        self.idbias_scale = idbias_scale
        self.ident = ident

    def init_own_params(self, gen: torch.Generator) -> None:
        w = self.std * torch.randn(self.weight.shape, generator=gen)
        if self.ident is not None:
            k = self.ident.shape[0]
            w[:k] = w[:k] * 0.5 + self.ident * self.std * self.idbias_scale
        self.weight.copy_(w)


class LearnedSoftAggregate(nn.Module):
    """Softmax-weighted sum over the modes axis ``group_dim``: scores from
    ``feat2score`` of each feature vector (of each score, when
    ``num_feat`` is 1), softmaxed in float32."""

    def __init__(self, num_feat: int, group_dim: int, keepdim: bool = False):
        super().__init__()
        self.num_feat = num_feat
        self.group_dim = group_dim
        self.keepdim = keepdim
        self.feat2score = CastLinear(num_feat, 1)

    def forward(self, x: torch.Tensor,
                score_basis: Optional[torch.Tensor] = None) -> torch.Tensor:
        if score_basis is None:
            score_basis = x
        if self.num_feat == 1:
            # the 1 -> 1 linear layer of each score, without a trailing axis
            w = self.feat2score.weight.to(score_basis.dtype)[0, 0]
            b = self.feat2score.bias.to(score_basis.dtype)[0]
            scores = score_basis * w + b
        else:
            scores = self.feat2score(score_basis)
        probs = torch.softmax(scores.float(), dim=self.group_dim).to(x.dtype)
        return torch.sum(x * probs, dim=self.group_dim, keepdim=self.keepdim)


class ExpandedFeatTrans(nn.Module):
    """Each mode's values (``first_linear``) mixed by its attention, the
    modes pooled by ``feat_softaggr``; with ``has_input_skip``, the input
    added by a learned coefficient and normalised.  CRAFT's configurations
    have no FFN branch, as in the JAX package."""

    def __init__(self, config: SETransConfig, name: str = ""):
        super().__init__()
        if getattr(config, "has_FFN", True):
            raise NotImplementedError(
                "ExpandedFeatTrans FFN branch is unused by CRAFT configs")
        self.name = name
        self.in_feat_dim = config.in_feat_dim
        self.feat_dim = config.feat_dim
        self.num_modes = config.num_modes
        self.has_input_skip = getattr(config, "has_input_skip", False)
        self.first_linear = ModeLinear(
            self.in_feat_dim, self.feat_dim * self.num_modes,
            bias=config.v_has_bias, std=config.base_initializer_range,
            ident=torch.eye(self.feat_dim, self.in_feat_dim),
            idbias_scale=config.feattrans_lin1_idbias_scale)
        self.feat_softaggr = LearnedSoftAggregate(self.feat_dim, group_dim=1)
        if self.has_input_skip:
            self.input_skip_coeff = nn.Parameter(torch.ones(1))
            self.skip_layer_norm = LayerNorm(self.feat_dim, eps=1e-12,
                                             elementwise_affine=False)

    def init_own_params(self, gen: torch.Generator) -> None:
        if self.has_input_skip:
            self.input_skip_coeff.fill_(1.0)

    def forward(self, input_feat: torch.Tensor,
                attention_probs: torch.Tensor) -> torch.Tensor:
        """input_feat (B, U2, IF), attention_probs (B, M, U1, U2) ->
        (B, U1, F)."""
        b, u2, _ = input_feat.shape
        m, f = self.num_modes, self.feat_dim
        v = self.first_linear(input_feat).reshape(b, u2, m, f).transpose(1, 2)
        fusion = torch.matmul(attention_probs.float(), v.float())
        trans = self.feat_softaggr(fusion.to(input_feat.dtype))
        if self.has_input_skip:
            trans = (self.input_skip_coeff.to(trans.dtype) * input_feat
                     + trans)
            trans = self.skip_layer_norm(trans)
        return trans


class CrossAttFeatTrans(nn.Module):
    """Multi-mode cross attention of ``query_feat`` against ``key_feat``:
    the aggregated scores (``out_attn_scores_only``), the probabilities
    (``out_attn_probs_only``) or the attended values (``out_trans``)."""

    def __init__(self, config: SETransConfig, name: str = ""):
        super().__init__()
        self.name = name
        self.num_modes = config.num_modes
        self.in_feat_dim = config.in_feat_dim
        self.feat_dim = config.feat_dim
        self.mode_dim = self.in_feat_dim // self.num_modes
        self.attn_clip = config.attn_clip
        self.tie_qk_scheme = config.tie_qk_scheme
        self.out_attn_scores_only = config.out_attn_scores_only
        self.out_attn_probs_only = config.out_attn_probs_only
        self.pos_code_weight = (config.pos_code_weight
                                if config.pos_code_type == "bias" else 1.0)
        att_all = self.num_modes * self.mode_dim
        std = config.base_initializer_range
        # the identity bias of the key's first mode (setrans.py:560-575)
        ident = torch.eye(self.mode_dim).repeat(
            1, self.in_feat_dim // self.mode_dim)
        self.tied_qk = self.tie_qk_scheme == "shared"
        if self.tied_qk:
            # one layer under both names, as the reference shares it
            self.query = ModeLinear(self.in_feat_dim, att_all,
                                    config.qk_have_bias, std, ident,
                                    config.query_idbias_scale)
            self.key = self.query
        else:
            self.query = ModeLinear(self.in_feat_dim, att_all,
                                    config.qk_have_bias, std)
            self.key = ModeLinear(self.in_feat_dim, att_all,
                                  config.qk_have_bias, std, ident,
                                  config.query_idbias_scale)
        if self.out_attn_scores_only or self.out_attn_probs_only:
            self.out_trans = None
            if self.num_modes > 1:
                self.attn_softaggr = LearnedSoftAggregate(1, group_dim=1,
                                                          keepdim=True)
        else:
            self.out_trans = ExpandedFeatTrans(config, name + "-out_trans")

    def _split_modes(self, x: torch.Tensor) -> torch.Tensor:
        b, u, _ = x.shape
        return x.reshape(b, u, self.num_modes, self.mode_dim).transpose(1, 2)

    def forward(self, query_feat: torch.Tensor,
                key_feat: Optional[torch.Tensor] = None,
                pos_biases: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if key_feat is None:
            key_feat = query_feat
        q = self._split_modes(self.query(query_feat))
        k = self._split_modes(self.key(key_feat))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / torch.sqrt(torch.tensor(float(self.mode_dim)))
        scores = torch.clamp(scores, -self.attn_clip, self.attn_clip)
        if pos_biases is not None:
            scores = scores + self.pos_code_weight * pos_biases
        if attention_mask is not None:
            scores = scores + attention_mask
        scores = scores.to(query_feat.dtype)
        if self.out_attn_scores_only:
            if self.num_modes > 1:
                scores = self.attn_softaggr(scores)
            return scores
        probs = torch.softmax(scores.float(), dim=-1).to(query_feat.dtype)
        if self.out_attn_probs_only:
            return probs
        return self.out_trans(key_feat, probs)


class SlidingPosBiases2D(nn.Module):
    """A learned bias for each relative offset within a (2R+1)^2 window:
    pos[i, j, u, v] = biases[u - i + R, v - j + R] where both offsets lie
    within R, else 0, as (1, 1, h*w, h*w).  Built by gathering the table
    at the offsets (exact, as the JAX package's one-hot contractions)."""

    def __init__(self, pos_dim: int = 2, pos_bias_radius: int = 7):
        super().__init__()
        assert pos_dim == 2
        self.R = pos_bias_radius
        n = 2 * self.R + 1
        self.biases = nn.Parameter(torch.zeros(n, n))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.biases.zero_()

    def forward(self, h: int, w: int) -> torch.Tensor:
        r, n = self.R, 2 * self.R + 1
        dev = self.biases.device

        def offsets(size):
            d = (torch.arange(size, device=dev)[None, :]
                 - torch.arange(size, device=dev)[:, None] + r)
            return d.clamp(0, n - 1), (d >= 0) & (d < n)

        du, mu = offsets(h)  # (i, u)
        dv, mv = offsets(w)  # (j, v)
        table = self.biases.float()
        # t[i, u, b] = biases[u - i + R, b], zero outside the window
        t = table[du] * mu[..., None]
        # pos[i, u, j, v] = t[i, u, v - j + R], zero outside the window
        pos = t[:, :, dv] * mv
        return pos.permute(0, 2, 1, 3).reshape(1, 1, h * w, h * w)


class SETransInputFeatEncoder(nn.Module):
    """(B, C, H, W) features -> normalised tokens (B, H*W, C), and the
    sliding positional biases where asked (the ``bias`` positional code,
    CRAFT's: no positional embedding is added to the tokens)."""

    def __init__(self, config: SETransConfig):
        super().__init__()
        assert config.pos_code_type == "bias", \
            "only the 'bias' positional code (CRAFT default) is implemented"
        self.feat_dim = config.in_feat_dim
        self.comb_norm_layer = LayerNorm(self.feat_dim, eps=1e-12,
                                         elementwise_affine=False)
        self.pos_coder = SlidingPosBiases2D(config.pos_dim,
                                            config.pos_bias_radius)

    def forward(self, vis_feat: torch.Tensor,
                return_pos_biases: bool = False):
        b, c, h, w = vis_feat.shape
        feat = self.comb_norm_layer(vis_feat.flatten(2).transpose(1, 2))
        if return_pos_biases:
            return feat, self.pos_coder(h, w)
        return feat


class SelfAttVisPosTrans(nn.Module):
    """Self-attention of a (B, C, H, W) feature map: the transformed map,
    or the attention (B, M, HW, HW) where the config asks for it alone."""

    def __init__(self, config: SETransConfig, name: str = ""):
        super().__init__()
        self.name = name
        self.out_attn_only = (config.out_attn_scores_only
                              or config.out_attn_probs_only)
        self.attn_mask_radius = config.attn_mask_radius
        self.setrans = CrossAttFeatTrans(config, name)
        self.vispos_encoder = SETransInputFeatEncoder(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        attn_mask = None
        if self.attn_mask_radius > 0:
            ii, jj = torch.meshgrid(torch.arange(h, device=x.device),
                                    torch.arange(w, device=x.device),
                                    indexing="ij")
            pts = torch.stack([ii.reshape(-1), jj.reshape(-1)], -1)
            diff = (pts[None] - pts[:, None]).abs().amax(-1)
            attn_mask = torch.where(diff > self.attn_mask_radius, -1e9,
                                    0.0)[None, None].float()
        tokens, pos_biases = self.vispos_encoder(x, return_pos_biases=True)
        out = self.setrans(tokens, pos_biases=pos_biases,
                           attention_mask=attn_mask)
        if not self.out_attn_only:
            out = out.transpose(1, 2).reshape(b, c, h, w)
        return out
