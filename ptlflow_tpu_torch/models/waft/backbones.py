"""WAFT's backbones (``ptlflow_tpu/models/waft/backbones.py``), NCHW: the
frozen DepthAnything V2 features (a1: the whole head; a2: a trainable
``lvl`` head), the 4-stage Twins feature encoder, the patch-8 ViT refine
network, and the ResNet18-style deconvolution nets.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from ...nn import CastConv2d, CastConvTranspose2d
from ...ops.grid_sample import interpolate, interpolate_bicubic
from ..flowformer.twins import Block as TwinsBlock
from ..flowformer.twins import PatchEmbed as TwinsPatchEmbed
from ..flowformer.twins import PosConv
from ..memfof.memfof import TVBasicBlock
from .dinov2 import DinoVisionTransformer, VitBlock, VitPatchEmbed
from .dpt import DPTHeadA1, DPTHeadLvl, FeatureFusionBlock, fuse_pyramid

VIT_CONFIGS = {
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024),
                 embed_dim=1024, depth=24, num_heads=16,
                 idx=(4, 11, 17, 23)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768),
                 embed_dim=768, depth=12, num_heads=12, idx=(2, 5, 8, 11)),
    "vits": dict(features=64, out_channels=(48, 96, 192, 384),
                 embed_dim=384, depth=12, num_heads=6, idx=(2, 5, 8, 11)),
    "vitt": dict(features=32, out_channels=(24, 48, 96, 192),
                 embed_dim=192, depth=12, num_heads=3, idx=(2, 5, 8, 11)),
}


class _DepthAnythingV2(nn.Module):
    """DINOv2 and the DPT depth head."""

    def __init__(self, encoder: str = "vits"):
        super().__init__()
        cfg = VIT_CONFIGS[encoder]
        self.idx = cfg["idx"]
        self.pretrained = DinoVisionTransformer(encoder)
        self.depth_head = DPTHeadA1(self.pretrained.embed_dim,
                                    cfg["features"], cfg["out_channels"],
                                    patch_size=14)


class DepthAnythingFeatureA1(nn.Module):
    """WAFT-a1's features: the whole DepthAnything V2 head's ``out`` and
    paths 1-4 (frozen wholesale by ``WAFTa1``)."""

    def __init__(self, encoder: str = "vits"):
        super().__init__()
        self.output_dim = VIT_CONFIGS[encoder]["features"]
        self.depth_anything = _DepthAnythingV2(encoder)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        da = self.depth_anything
        h, w = x.shape[-2:]
        feats = da.pretrained.get_intermediate_layers(x, da.idx)
        out, p1, p2, p3, p4 = da.depth_head(feats, h // 14, w // 14)
        return {"out": out, "path_1": p1, "path_2": p2, "path_3": p3,
                "path_4": p4}


class DepthAnythingFeatureA2(nn.Module):
    """WAFT-a2's DepthAnything features: the frozen DINOv2 and a trainable
    ``lvl`` = -3 head; returns the finest fused map resized to half the
    image."""

    def __init__(self, model_name: str = "vits", lvl: int = -3):
        super().__init__()
        cfg = VIT_CONFIGS[model_name]
        self.idx = cfg["idx"]
        self.output_dim = cfg["features"]
        self.encoder = DinoVisionTransformer(model_name)
        self.dpt_head = DPTHeadLvl(self.encoder.embed_dim,
                                   features=cfg["features"],
                                   out_channels=cfg["out_channels"], lvl=lvl)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        with torch.set_grad_enabled(_needs_grad(self.encoder)):
            feats = self.encoder.get_intermediate_layers(x, self.idx)
        outs = self.dpt_head(feats, h // 14, w // 14)
        return interpolate(outs[0], (h // 2, w // 2), align_corners=True)


def _needs_grad(module: nn.Module) -> bool:
    """Whether running ``module`` must record a graph: grad mode is on and
    one of its parameters is trained.  A frozen backbone that reads the
    images directly then runs without one (nothing trainable lies before
    it), as the JAX package's trainer leaves its gradient unused."""
    return torch.is_grad_enabled() and any(
        p.requires_grad for p in module.parameters())


class Twins4Stage(nn.Module):
    """timm's ``twins_svt_large`` with ``features_only``: 4 stages at
    strides 4, 8, 16 and 32, widths 128, 256, 512 and 1024.  timm's
    checkpoint also holds the classifier's ``norm``, ``head`` and
    ``head_drop``, which the features never run: a load drops them, as the
    JAX package's ``from_torch`` does."""

    DROPPED = ("norm.", "head.", "head_drop.")

    def __init__(self):
        super().__init__()
        dims = (128, 256, 512, 1024)
        heads = (4, 8, 16, 32)
        depths = (2, 2, 18, 2)
        srs = (8, 4, 2, 1)
        self.depths = depths
        self.patch_embeds = nn.ModuleList([
            TwinsPatchEmbed(4 if i == 0 else 2, 3 if i == 0 else dims[i - 1],
                            dims[i]) for i in range(4)])
        self.blocks = nn.ModuleList([
            nn.ModuleList([
                TwinsBlock(dims[k], heads[k], 4.0, sr_ratio=srs[k],
                           ws=1 if i % 2 == 1 else 7)
                for i in range(depths[k])]) for k in range(4)])
        self.pos_block = nn.ModuleList([PosConv(d, d) for d in dims])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for key in [k for k in state_dict
                    if k.startswith(tuple(prefix + d for d in self.DROPPED))]:
            del state_dict[key]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        b = x.shape[0]
        outs = []
        for i in range(4):
            x, size = self.patch_embeds[i](x)
            for j, blk in enumerate(self.blocks[i]):
                x = blk(x, size)
                if j == 0:
                    x = self.pos_block[i](x, size)
            x = x.transpose(1, 2).reshape(b, -1, *size)
            outs.append(x)
        return outs


class TwinsFeatureEncoder(nn.Module):
    """The frozen Twins backbone and a trainable DPT-style fusion: a
    64-channel map at half the image's size."""

    def __init__(self):
        super().__init__()
        self.backbone = Twins4Stage()
        self.out_channels = (128, 256, 512, 1024)
        self.features = 128
        self.output_dim = self.features // 2
        self.scratch = nn.ModuleList(
            [CastConv2d(oc, self.features, 3, padding=1, bias=False)
             for oc in self.out_channels])
        self.refine = nn.ModuleList(
            [FeatureFusionBlock(self.features) for _ in range(4)])
        self.final = CastConvTranspose2d(self.features, self.features // 2,
                                         4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.set_grad_enabled(_needs_grad(self.backbone)):
            maps = self.backbone(x)
        return self.final(fuse_pyramid(self.scratch, self.refine, maps)[0])


class RefineViT(nn.Module):
    """WAFT's refine network: a patch-8 ViT over the refine input with a
    learned 8x8 position embedding (bicubically resized, no cls token, no
    offset), four blocks tapped into a ``DPTHeadA1``; ``out`` is resized
    back to the input's size."""

    def __init__(self, model_name: str, input_dim: int, patch_size: int = 8):
        super().__init__()
        cfg = VIT_CONFIGS[model_name]
        self.embed_dim = cfg["embed_dim"]
        self.idx = cfg["idx"]
        self.patch_size = patch_size
        self.output_dim = cfg["features"]
        self.patch_embed = VitPatchEmbed(patch_size, input_dim,
                                         self.embed_dim)
        self.blks = nn.ModuleList([
            VitBlock(self.embed_dim, cfg["num_heads"], 4.0, qkv_bias=True,
                     init_values=None) for _ in range(cfg["depth"])])
        self.dpt_head = DPTHeadA1(self.embed_dim, cfg["features"],
                                  cfg["out_channels"], patch_size=14)
        self.pos_embed = nn.Parameter(torch.zeros(1, 64, self.embed_dim))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.pos_embed.zero_()

    def _pos_encoding(self, npatch: int, h: int, w: int) -> torch.Tensor:
        n, dim = self.pos_embed.shape[1:]
        if npatch == n and w == h:
            return self.pos_embed
        h0, w0 = h // self.patch_size, w // self.patch_size
        sqrt_n = int(math.sqrt(n))
        grid = self.pos_embed.float().reshape(1, sqrt_n, sqrt_n, dim)
        grid = interpolate_bicubic(grid.permute(0, 3, 1, 2),
                                   (h0 / sqrt_n, w0 / sqrt_n), size=(h0, w0))
        return grid.flatten(2).transpose(1, 2).to(self.pos_embed.dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h, w = x.shape[-2:]
        tokens = self.patch_embed(x)
        tokens = tokens + self._pos_encoding(tokens.shape[1], h,
                                             w).to(tokens.dtype)
        feats = []
        for i, blk in enumerate(self.blks):
            tokens = blk(tokens)
            if i in self.idx:
                feats.append((tokens, None))
        out, p1, p2, p3, p4 = self.dpt_head(feats, h // self.patch_size,
                                            w // self.patch_size)
        return {"out": interpolate(out, (h, w), align_corners=True),
                "path_1": p1, "path_2": p2, "path_3": p3, "path_4": p4}


class ResConvGELU(nn.Module):
    """GELU, conv (kernel ``k``, stride ``s``), GELU, 3x3 conv, plus a 1x1
    ``skip_conv`` where the width or the stride changes."""

    def __init__(self, inp: int, oup: int, k: int = 3, s: int = 1):
        super().__init__()
        self.conv = nn.Sequential(
            nn.GELU(), CastConv2d(inp, oup, k, stride=s, padding=k // 2),
            nn.GELU(), CastConv2d(oup, oup, 3, padding=1))
        self.skip_conv = (CastConv2d(inp, oup, 1, stride=s)
                          if inp != oup or s != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.skip_conv is None else self.skip_conv(x)
        return self.conv(x) + skip


def _tv_layer(in_p: int, dim: int, stride: int) -> nn.Sequential:
    return nn.Sequential(TVBasicBlock(in_p, dim, stride),
                         TVBasicBlock(dim, dim))


class _DeconvNet(nn.Module):
    """The shared top-down half: transposed-conv upsampling of each coarser
    level added to the finer one, then a ``ResConvGELU``; returns the
    4-level pyramid, finest (1/2) first."""

    def _top_down(self, o1, o2, o3, o4) -> List[torch.Tensor]:
        o3 = self.proj_3(o3 + self.up_4(o4))
        o2 = self.proj_2(o2 + self.up_3(o3))
        o1 = self.proj_1(o1 + self.up_2(o2))
        return [o1, o2, o3, o4]

    def _heads(self, oup: int) -> None:
        self.up_4 = CastConvTranspose2d(512, 256, 2, stride=2)
        self.proj_3 = ResConvGELU(256, 256)
        self.up_3 = CastConvTranspose2d(256, 128, 2, stride=2)
        self.proj_2 = ResConvGELU(128, 128)
        self.up_2 = CastConvTranspose2d(128, 64, 2, stride=2)
        self.proj_1 = ResConvGELU(64, oup)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        o1 = self.conv1(self.ds1(x))
        o2 = self.conv2(o1)
        o3 = self.conv3(o2)
        return self._top_down(o1, o2, o3, self.conv4(o3))


class ResNet18DeconvA1(_DeconvNet):
    """WAFT-a1's: a ResConvGELU stem, torchvision ResNet18 layers 1-4."""

    def __init__(self, inp: int, oup: int):
        super().__init__()
        self.ds1 = ResConvGELU(inp, 64, k=7, s=2)
        self.conv1 = _tv_layer(64, 64, 1)
        self.conv2 = _tv_layer(64, 128, 2)
        self.conv3 = _tv_layer(128, 256, 2)
        self.conv4 = _tv_layer(256, 512, 2)
        self._heads(oup)


class ResNet18DeconvA2(_DeconvNet):
    """WAFT-a2's: ResConvGELU stages throughout."""

    def __init__(self, inp: int, oup: int):
        super().__init__()
        self.ds1 = ResConvGELU(inp, 64, k=7, s=2)
        self.conv1 = ResConvGELU(64, 64)
        self.conv2 = ResConvGELU(64, 128, s=2)
        self.conv3 = ResConvGELU(128, 256, s=2)
        self.conv4 = ResConvGELU(256, 512, s=2)
        self._heads(oup)
