"""MEMFOF (``ptlflow_tpu/models/memfof/memfof.py``), NCHW: the 3-frame,
bidirectional, 1/16-resolution SEA-RAFT-style model, its eval forward, its
training forward with the Laplace-mixture terms of both directions and
``MemfofSequenceLoss``.

A torchvision-style ResNet trunk without its max-pool (``ResNetFPN16x``)
reads the three frames stacked on channels (context) or one frame at a time
(features).  The correlation of each direction is not a pooled pyramid:
level ``l`` is the full product of the middle frame's features against the
other frame's, resized bilinearly by 2^l (``MemfofCorrBlock``).  Each
direction's pyramid is looked up through one prepared lookup
(``make_corr_lookup``), once a refinement: two launches a refinement.  The
hidden state is refined by ConvNeXt blocks fed the motion features and
their global aggregation; flow and info of both directions share one
convex upsampling by 16 each.  Every layer casts its weights to its input's
dtype, so ``validate --bf16``'s weight cast computes in float32 on
bf16-rounded weights, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch import nn

from ... import nn as pnn
from ...nn import CastConv2d
from ...ops.correlation import coords_grid, make_corr_lookup
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample_data
from ...utils.registry import register_model
from ..base import BaseModel
from ..llaflow.llaflow import GlobalAttention
from ..sea_raft.layer import ConvNextBlock
from ..sea_raft.sea_raft import laplace_mixture_nll


class TVBasicBlock(nn.Module):
    """torchvision's ``resnet.BasicBlock``: two 3x3 conv-BatchNorms, a
    residual through ``downsample`` (1x1 conv, BatchNorm) where the stride
    or the width changes."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = CastConv2d(in_planes, planes, 3, stride=stride,
                                padding=1, bias=False)
        self.bn1 = pnn.BatchNorm2d(planes)
        self.conv2 = CastConv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = pnn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                CastConv2d(in_planes, planes, 1, stride=stride, bias=False),
                pnn.BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(y + x)


class TVResNetTrunk(nn.Module):
    """torchvision's resnet18/34 from ``conv1`` to ``layer3``, without the
    max-pool (MEMFOF deletes it), so ``layer1`` runs at 1/2."""

    def __init__(self, input_dim: int, arch: str = "resnet34"):
        super().__init__()
        blocks = {"resnet18": (2, 2, 2), "resnet34": (3, 4, 6)}[arch]
        self.conv1 = CastConv2d(input_dim, 64, 7, stride=2, padding=3,
                                bias=False)
        self.bn1 = pnn.BatchNorm2d(64)
        in_p = 64
        for li, (dim, num) in enumerate(zip((64, 128, 256), blocks)):
            layer = [TVBasicBlock(in_p, dim, 1 if li == 0 else 2)]
            layer += [TVBasicBlock(dim, dim) for _ in range(num - 1)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
            in_p = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        return self.layer3(self.layer2(self.layer1(x)))


class ResNetFPN16x(nn.Module):
    """The trunk, then a 2x2 stride-2 convolution: output at 1/16."""

    def __init__(self, input_dim: int, output_dim: int,
                 arch: str = "resnet34"):
        super().__init__()
        self.resnet = TVResNetTrunk(input_dim, arch)
        self.final_conv = CastConv2d(256, output_dim, 2, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_conv(self.resnet(x))


class MemfofCorrBlock:
    """The correlation of ``fmap1`` against ``fmap2`` (B, C, H, W) at
    ``num_levels`` scales: level ``l`` is the product of fmap1 with fmap2
    resized bilinearly (align_corners=False) to (h//2, w//2) ``l`` times,
    over sqrt(C), accumulated in float32 and stored (B*H*W, h_l, w_l) in
    the features' dtype.  Its lookup is prepared once, here; the kernel
    samples level ``l`` at coords / 2^l, the JAX package's convention for
    these levels too."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = 4, radius: int = 4):
        b, c, h, w = fmap1.shape
        f1 = fmap1.reshape(b, c, h * w).transpose(1, 2).float()
        self.pyramid = []
        for i in range(num_levels):
            h2, w2 = fmap2.shape[-2:]
            corr = torch.matmul(f1, fmap2.reshape(b, c, h2 * w2).float())
            corr = corr / math.sqrt(c)
            self.pyramid.append(corr.to(fmap1.dtype).reshape(b * h * w, h2,
                                                             w2))
            if i < num_levels - 1:
                fmap2 = interpolate(fmap2, (h2 // 2, w2 // 2),
                                    mode="bilinear", align_corners=False)
        self.lookup = make_corr_lookup(self.pyramid, radius)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        return self.lookup(coords)


class MemfofAttention(GlobalAttention):
    """GMA's attention without the position term, its queries also scaled
    by log_3(h * w) (MemFlow's length scaling)."""

    def scale_queries(self, q: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return q * self.scale * math.log(h * w, 3)


class MemfofAggregate(nn.Module):
    """``fmap + gamma * project(attention @ to_v(fmap))``, ``gamma`` zero
    at init; ``project`` only where the heads' width differs from ``dim``.
    The product accumulates in float32 and is cast to ``fmap``'s dtype."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        self.inner = heads * dim_head
        self.to_v = CastConv2d(dim, self.inner, 1, bias=False)
        self.project = (None if dim == self.inner
                        else CastConv2d(self.inner, dim, 1, bias=False))
        self.gamma = nn.Parameter(torch.zeros(1))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.gamma.zero_()

    def forward(self, attn: torch.Tensor, fmap: torch.Tensor) -> torch.Tensor:
        b, _, h, w = fmap.shape
        v = self.to_v(fmap).reshape(b, self.heads, self.dim_head, h * w)
        out = torch.matmul(attn.float(), v.transpose(-1, -2).float())
        out = out.to(fmap.dtype).transpose(-1, -2).reshape(b, self.inner, h,
                                                           w)
        if self.project is not None:
            out = self.project(out)
        return fmap + self.gamma.to(fmap.dtype) * out


class BasicMotionEncoder(nn.Module):
    """SEA-RAFT's motion encoder over both directions: both lookups' corr
    channels and the 4 flow channels in, the flows appended to its
    output."""

    def __init__(self, corr_channel: int, dim: int):
        super().__init__()
        self.convc1 = CastConv2d(corr_channel * 2, dim * 2, 1)
        self.convc2 = CastConv2d(dim * 2, dim + dim // 2, 3, padding=1)
        self.convf1 = CastConv2d(4, dim, 7, padding=3)
        self.convf2 = CastConv2d(dim, dim // 2, 3, padding=1)
        self.conv = CastConv2d(dim * 2, dim - 4, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class GMAUpdateBlock(nn.Module):
    """The motion encoder, its global aggregation and a stack of ConvNeXt
    refinement blocks over the hidden state."""

    def __init__(self, num_blocks: int, corr_channel: int, hdim: int,
                 cdim: int):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channel, cdim)
        self.refine = nn.ModuleList(
            [ConvNextBlock(3 * cdim + hdim, hdim) for _ in range(num_blocks)])
        self.aggregator = MemfofAggregate(cdim, 1, cdim)

    def forward(self, net, inp, corr, flow, attention):
        motion_features = self.encoder(flow, corr)
        motion_global = self.aggregator(attention, motion_features)
        inp_cat = torch.cat([inp, motion_features, motion_global], dim=1)
        for blk in self.refine:
            net = blk(torch.cat([net, inp_cat], dim=1))
        return net


class MemfofSequenceLoss:
    """gamma-weighted sum over the predictions of the mean Laplace-mixture
    NLL of both directions (``nf_preds``), over the pixels where the first
    ground truth is valid (``valids >= 0.5``, |gt| < ``max_flow``) and the
    NLL is finite."""

    def __init__(self, gamma: float, max_flow: float):
        self.gamma = gamma
        self.max_flow = max_flow

    def __call__(self, outputs: Dict[str, Any],
                 inputs: Dict[str, Any]) -> torch.Tensor:
        nf_preds = outputs["nf_preds"]  # list of (B, 2, 2, H, W)
        flow_gt = inputs["flows"][:, 0]
        valid = inputs["valids"][:, 0]
        mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1, keepdim=True))
        valid = (valid >= 0.5) & (mag < self.max_flow)
        n = len(nf_preds)
        total = 0.0
        for i, nf in enumerate(nf_preds):
            m = torch.isfinite(nf.detach()) & valid[:, None]
            total = total + (self.gamma ** (n - i - 1)
                             * torch.sum(torch.where(m, nf, 0.0))
                             / torch.clamp(m.sum(), min=1))
        return total


class MEMFOF(BaseModel):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memfof-kitti-ed27d6f1.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memfof-sintel-cbb45e24.ckpt",
        "spring": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memfof-spring-f8a968f7.ckpt",
        "tartan": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memfof-tartan-7ca03da2.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memfof-things-11146736.ckpt",
        "tskh": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/memfof-tskh-6fb0c129.ckpt",
    }

    def __init__(self, backbone: str = "resnet34", dim: int = 512,
                 corr_levels: int = 4, corr_radius: int = 4, iters: int = 8,
                 num_blocks: int = 2, gamma: float = 0.8,
                 max_flow: float = 400, use_var: bool = True,
                 var_min: float = 0.0, var_max: float = 10.0, **kwargs):
        super().__init__(output_stride=32,
                         loss_fn=MemfofSequenceLoss(gamma, max_flow),
                         **kwargs)
        self.dim = dim
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.iters = iters
        self.use_var = use_var
        self.var_min = var_min
        self.var_max = var_max
        self.cnet = ResNetFPN16x(9, dim * 2, backbone)
        self.init_conv = CastConv2d(2 * dim, 2 * dim, 3, padding=1)
        self.upsample_weight = nn.Sequential(
            CastConv2d(dim, dim * 2, 3, padding=1), nn.ReLU(),
            CastConv2d(dim * 2, 2 * 16 * 16 * 9, 1))
        self.flow_head = nn.Sequential(
            CastConv2d(dim, 2 * dim, 3, padding=1), nn.ReLU(),
            CastConv2d(2 * dim, 2 * 6, 3, padding=1))
        self.fnet = ResNetFPN16x(3, dim * 2, backbone)
        corr_channel = corr_levels * (corr_radius * 2 + 1) ** 2
        self.update_block = GMAUpdateBlock(num_blocks, corr_channel,
                                           hdim=dim, cdim=dim)
        self.att = MemfofAttention(dim=dim, heads=1, dim_head=dim)

    def _heads(self, net: torch.Tensor):
        """(flow 2<-1, info, flow 2->3, info, mask logits of both)."""
        update = self.flow_head(net)
        return (update[:, 0:2], update[:, 2:6], update[:, 6:8],
                update[:, 8:12], 0.25 * self.upsample_weight(net))

    def _upsampled(self, flow21, info21, flow23, info23, mask, resizer):
        """Both directions convex-upsampled by 16 and unpadded: flows
        (B, 2, 2, H, W) and infos (B, 2, 4, H, W), direction 2<-1 first."""
        n = 16 * 16 * 9
        outs = [convex_upsample_data(f, i, m, factor=16) for f, i, m in (
            (flow21, info21, mask[:, :n]), (flow23, info23, mask[:, n:]))]
        flows = [self.postprocess_predictions(f, resizer, is_flow=True)
                 for f, _ in outs]
        infos = [self.postprocess_predictions(i, resizer, is_flow=False)
                 for _, i in outs]
        return torch.stack(flows, 1), torch.stack(infos, 1)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, Any]:
        """Eval: ``flows`` (B, 1, 2, H, W), the flow from the second frame to
        the third (two frames are the first repeated, then the pair).

        Training (``training=True``): ``flow_preds`` and ``info_preds``,
        lists of (B, 2, 2, H, W) and (B, 2, 4, H, W) (the initial
        prediction's and every refinement's, both directions, 2<-1 first),
        ``nf_preds``, their Laplace-mixture NLL against ``inputs["flows"]``
        (one flow is used for both directions; zeros where absent), and
        ``flows``.  The flows are detached at the start of every
        refinement."""
        images = inputs["images"]
        if images.shape[1] == 2:
            images = torch.cat([images[:, :1], images], dim=1)
        if images.shape[1] != 3:
            raise ValueError(f"memfof takes 2 or 3 frames, got "
                             f"{images.shape[1]}")
        images, resizer = self.preprocess_images(
            images, bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        b = images.shape[0]

        cnet = self.init_conv(self.cnet(torch.cat(
            [images[:, 0], images[:, 1], images[:, 2]], dim=1)))
        net, context = cnet[:, :self.dim], cnet[:, self.dim:]
        attention = self.att(context)
        flow21, info21, flow23, info23, mask = self._heads(net)

        flow_preds: List[torch.Tensor] = []
        info_preds: List[torch.Tensor] = []
        if training or self.iters == 0:
            fp, ip = self._upsampled(flow21, info21, flow23, info23, mask,
                                     resizer)
            flow_preds.append(fp)
            info_preds.append(ip)

        if self.iters > 0:
            fmap1, fmap2, fmap3 = (self.fnet(images[:, k]) for k in range(3))
            corr_21 = MemfofCorrBlock(fmap2, fmap1, self.corr_levels,
                                      self.corr_radius)
            corr_23 = MemfofCorrBlock(fmap2, fmap3, self.corr_levels,
                                      self.corr_radius)
            _, _, hf, wf = fmap2.shape
            grid = coords_grid(b, hf, wf, dtype=torch.float32,
                               device=fmap2.device)
            for _ in range(self.iters):
                flow21, flow23 = flow21.detach(), flow23.detach()
                corr = torch.cat([corr_21(grid + flow21),
                                  corr_23(grid + flow23)], dim=1)
                net = self.update_block(net, context, corr,
                                        torch.cat([flow21, flow23], dim=1),
                                        attention)
                up21, info21, up23, info23, mask = self._heads(net)
                flow21, flow23 = flow21 + up21, flow23 + up23
                if training:
                    fp, ip = self._upsampled(flow21, info21, flow23, info23,
                                             mask, resizer)
                    flow_preds.append(fp)
                    info_preds.append(ip)
            if not training:
                fp, ip = self._upsampled(flow21, info21, flow23, info23, mask,
                                         resizer)
                flow_preds.append(fp)
                info_preds.append(ip)

        flows = flow_preds[-1][:, 1:]
        if not training:
            return {"flows": flows}
        if inputs.get("flows") is not None:
            gt = inputs["flows"]
            if gt.shape[1] == 1:
                gt = torch.cat([gt, gt], dim=1)
        else:
            gt = torch.zeros_like(flow_preds[0])
        var_max = self.var_max if self.use_var else 0.0
        var_min = self.var_min if self.use_var else 0.0
        nf_preds = [laplace_mixture_nll(fp, ip, gt, var_min, var_max)
                    for fp, ip in zip(flow_preds, info_preds)]
        return {"flows": flows, "flow_preds": flow_preds,
                "info_preds": info_preds, "nf_preds": nf_preds}


@register_model
class memfof(MEMFOF):
    pass
