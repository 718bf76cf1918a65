"""MS-RAFT+ (``ptlflow_tpu/models/ms_raft_plus/ms_raft_plus.py``), NCHW:
RAFT over a 4-scale pyramid from 1/16 to 1/2 with one shared update block.

Each scale builds its correlation of both frames' features (by default the
on-the-fly ``AltCorrBlock``, plain PyTorch; with ``alternate_corr=False``
``CorrBlock``, whose lookup is ``csrc/corr_lookup.cu`` on the card), runs
its iterations, and hands its coords to the next, finer scale through a
convex x2 upsampling with its last mask.  As in the JAX package, the
*coords* are upsampled (MS-RAFT's quirk), not the flow.

``flow_small`` is the 1/16 flow of the padded frames, which the warm start
reads back at the coords' grid: the JAX package takes it from the unpadded
flow, the same tensor where the input is a multiple of 16 and a grid of
another size elsewhere (ROADMAP.md, section 3).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn

from ...nn import CastConv2d
from ...ops.correlation import AltCorrBlock, CorrBlock, coords_grid
from ...ops.grid_sample import interpolate
from ...ops.upsample import convex_upsample, upflow
from ...ops.warp import forward_interpolate
from ...utils.registry import ptlflow_trained, register_model, trainable
from ..base import BaseModel
from ..raft.extractor import make_norm
from ..raft.raft import SequenceLoss
from ..raft.update import BasicUpdateBlock


class MSResidualBlock(nn.Module):
    """A stride-2 block projects its input through a 1x1 convolution and
    ``norm3``, one norm registered twice (also as ``downsample.1``), as the
    reference does; a stride-1 block whose width changes returns its
    branch without the residual."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1):
        super().__init__()
        self.residual = stride != 1 or in_planes == planes
        self.conv1 = CastConv2d(in_planes, planes, 3, padding=1,
                                stride=stride)
        self.conv2 = CastConv2d(planes, planes, 3, padding=1)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                CastConv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if not self.residual:
            return y
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


def ms_layer(in_planes: int, dim: int, norm_fn: str,
             stride: int) -> nn.Sequential:
    return nn.Sequential(MSResidualBlock(in_planes, dim, norm_fn, stride),
                         MSResidualBlock(dim, dim, norm_fn, 1))


class MSBasicEncoder(nn.Module):
    """Down to 1/16, then up: [1/16 (output_dim), 1/8 (128), 1/4 (96), 1/2
    (64)], or output_dim at every scale in ``context_mode``.  The up path
    resizes bilinearly with half-pixel centres."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "group",
                 context_mode: bool = False):
        super().__init__()
        self.norm1 = make_norm(norm_fn, 64)
        self.conv1 = CastConv2d(3, 64, 7, stride=2, padding=3)
        self.layer1 = ms_layer(64, 64, norm_fn, 1)
        self.layer2 = ms_layer(64, 96, norm_fn, 2)
        self.layer3 = ms_layer(96, 128, norm_fn, 2)
        self.layer4 = ms_layer(128, 160, norm_fn, 2)
        self.conv2 = CastConv2d(160, output_dim, 1)
        if context_mode:
            up = (output_dim, output_dim, output_dim)
            ins = (output_dim + 128, output_dim + 96, output_dim + 64)
        else:
            up = (128, 96, 64)
            ins = (output_dim + 128, 128 + 96, 96 + 64)
        self.up_layer2 = ms_layer(ins[0], up[0], norm_fn, 1)
        self.up_layer1 = ms_layer(ins[1], up[1], norm_fn, 1)
        self.up_layer0 = ms_layer(ins[2], up[2], norm_fn, 1)

    def forward(self, x: torch.Tensor):
        x = torch.relu(self.norm1(self.conv1(x)))
        e1 = self.layer1(x)
        e2 = self.layer2(e1)
        e3 = self.layer3(e2)
        e4 = self.conv2(self.layer4(e3))
        outs = [e4]
        for layer, skip in ((self.up_layer2, e3), (self.up_layer1, e2),
                            (self.up_layer0, e1)):
            up = interpolate(outs[-1], tuple(skip.shape[-2:]))
            outs.append(layer(torch.cat([up, skip], dim=1)))
        return outs


def downflow(flow: torch.Tensor, factor: float) -> torch.Tensor:
    """Bilinear (align_corners) resize of (B, 2, H, W) to int(factor * H) x
    int(factor * W), each component rescaled by its axis's ratio."""
    h, w = flow.shape[-2:]
    nh, nw = int(factor * h), int(factor * w)
    out = interpolate(flow, (nh, nw), align_corners=True)
    return out * torch.tensor([nw / w, nh / h], dtype=out.dtype,
                              device=out.device).view(1, 2, 1, 1)


class MSRAFTPlus(BaseModel):
    pretrained_checkpoints = {
        "mixed": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/ms_raft_plus-mixed-2bb01f62.ckpt",
    }

    def __init__(self, gamma: float = 0.8, max_flow: float = 400,
                 iters: Sequence[int] = (4, 6, 5, 10),
                 lookup_pyramid_levels: int = 2, lookup_radius: int = 4,
                 alternate_corr: bool = True, **kwargs):
        super().__init__(output_stride=16,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.iters = tuple(iters)
        self.alternate_corr = alternate_corr
        self.lookup_pyramid_levels = lookup_pyramid_levels
        self.lookup_radius = lookup_radius
        self.hidden_dim = 128
        self.fnet = MSBasicEncoder(output_dim=256, norm_fn="group")
        self.cnet = MSBasicEncoder(output_dim=256, norm_fn="group",
                                   context_mode=True)
        self.update_block = BasicUpdateBlock(
            lookup_pyramid_levels, lookup_radius, hidden_dim=128,
            mask_channels=2 * 2 * 9)

    def _corr_block(self, fmap1, fmap2):
        """``AltCorrBlock``, or ``CorrBlock`` where not
        ``alternate_corr``: CCMR shares it."""
        cls = AltCorrBlock if self.alternate_corr else CorrBlock
        return cls(fmap1, fmap2, num_levels=self.lookup_pyramid_levels,
                   radius=self.lookup_radius)

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Replicate-padded to /16 on both sides.  Eval: ``flows`` (B, 1, 2,
        H, W) and ``flow_small``; warm-started from
        ``inputs["prev_preds"]["flow_small"]`` where given.  Training:
        ``flow_preds``, every iteration of every scale upsampled to the
        input size (sum(iters), B, 2, H, W), and ``flows``.  The coords are
        detached at the start of every iteration."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=True,
            resize_mode="pad", pad_mode="replicate", pad_two_side=True)
        image1, image2 = images[:, 0], images[:, 1]
        b = image1.shape[0]
        fnet_pyr = self.fnet(torch.cat([image1, image2]))
        cnet_pyr = self.cnet(image1)

        h16, w16 = fnet_pyr[0].shape[-2:]
        coords0 = coords_grid(b, h16, w16, device=image1.device)
        coords1 = coords0
        prev = inputs.get("prev_preds")
        if prev is not None and prev.get("flow_small") is not None:
            coords1 = coords1 + forward_interpolate(prev["flow_small"])

        flow_preds, up_mask = [], None
        n_levels = len(fnet_pyr)
        for index in range(n_levels):
            fmap1, fmap2 = fnet_pyr[index].chunk(2)
            corr_fn = self._corr_block(fmap1, fmap2)
            cnet = cnet_pyr[index]
            net = torch.tanh(cnet[:, :self.hidden_dim])
            inp = torch.relu(cnet[:, self.hidden_dim:])
            if index >= 1:
                # the coords themselves, upsampled with the last mask
                coords1 = convex_upsample(coords1, up_mask, 2)
                coords0 = coords_grid(b, *fmap1.shape[-2:],
                                      device=image1.device)
            flows_lr, masks = [], []
            for _ in range(self.iters[index]):
                coords1 = coords1.detach()
                net, up_mask, delta = self.update_block(
                    net, inp, corr_fn(coords1), coords1 - coords0)
                coords1 = coords1 + delta
                if training:
                    flows_lr.append(coords1 - coords0)
                    masks.append(up_mask)
            if training:
                ups = convex_upsample(torch.cat(flows_lr), torch.cat(masks),
                                      2)
                for _ in range(n_levels - index - 1):
                    ups = upflow(ups, 2)
                flow_preds.append(self.postprocess_predictions(
                    ups.unflatten(0, (len(flows_lr), b)), resizer,
                    is_flow=True))

        flow_up = convex_upsample(coords1 - coords0, up_mask, 2)
        if training:
            preds = torch.cat(flow_preds)
            return {"flows": preds[-1][:, None], "flow_preds": preds}
        return {"flows": self.postprocess_predictions(
                    flow_up, resizer, is_flow=True)[:, None],
                "flow_small": downflow(flow_up, 0.0625)}


@register_model
@trainable
@ptlflow_trained
class ms_raft_p(MSRAFTPlus):
    pass
