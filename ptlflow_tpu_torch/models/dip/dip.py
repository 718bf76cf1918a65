"""DIP, Deep Inverse Patchmatch (``ptlflow_tpu/models/dip/dip.py``), NCHW:
its eval forward and its training forward.

A quarter-resolution encoder gives both frames' features, the first
frame's also the hidden state and context.  Flow starts random at 1/16
(``init_flow``) and is refined there for ``iters`` rounds, then at 1/4 for
``iters`` more; each round is an inverse propagation (the first frame's
features against the second frame's and its four diagonal one-pixel shifts,
all warped by the flow with border padding: 10 channels) through the small
update block, then a 5x5 local search around the warped second frame (25
channels) through the basic update block.  The flow is detached before
each half-round.  No cost volume, no lookup kernel.

``init_flow`` draws the initial flow from a ``torch.Generator`` seeded 20
(the reference seeds torch's generator with 20; the JAX package draws
``jax.random.uniform(PRNGKey(20))``): the same distribution, other numbers,
so the eval flows of the port and of the JAX package differ by design.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from ... import nn as pnn
from ...nn import CastConv2d
from ...ops.correlation import coords_grid
from ...ops.grid_sample import grid_sample, interpolate
from ...ops.upsample import convex_upsample
from ...utils.registry import register_model, trainable
from ..base import BaseModel
from ..raft.raft import SequenceLoss
from ..raft.update import ConvGRU, FlowHead, SepConvGRU

INIT_SEED = 20


def init_flow(batch: int, h: int, w: int, scale: float,
              generator: torch.Generator) -> torch.Tensor:
    """The random initial flow (B, 2, H, W): uniform in [-scale, scale),
    float32 on the CPU, drawn from ``generator``."""
    u = torch.rand((batch, 2, h, w), generator=generator)
    return (u - 0.5) * 2 * scale


class DIPResidualBlock(nn.Module):
    """Two conv-instance-norm-ReLUs and a residual through a 1x1 conv and an
    instance norm, which DIP's block always has (RAFT's only where the
    stride changes)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "instance",
                 stride: int = 1):
        super().__init__()
        if norm_fn != "instance":
            raise ValueError("DIP's residual block takes instance norm only")
        self.conv1 = CastConv2d(in_planes, planes, 3, padding=1,
                                stride=stride)
        self.conv2 = CastConv2d(planes, planes, 3, padding=1)
        self.norm1 = pnn.InstanceNorm2d(planes)
        self.norm2 = pnn.InstanceNorm2d(planes)
        self.norm3 = pnn.InstanceNorm2d(planes)
        self.downsample = nn.Sequential(
            CastConv2d(in_planes, planes, 1, stride=stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        return torch.relu(self.norm3(self.downsample(x)) + y)


class BasicEncoderQuarter(nn.Module):
    """The stride-4 encoder: a 7x7 stride-2 conv, three residual layers (the
    second of stride 2), a 1x1 conv to ``output_dim``."""

    def __init__(self, output_dim: int = 256, norm_fn: str = "instance"):
        super().__init__()
        self.norm1 = pnn.InstanceNorm2d(64)
        self.conv1 = CastConv2d(3, 64, 7, stride=2, padding=3)
        self.layer1 = nn.Sequential(DIPResidualBlock(64, 64, norm_fn, 1),
                                    DIPResidualBlock(64, 64, norm_fn, 1))
        self.layer2 = nn.Sequential(DIPResidualBlock(64, 96, norm_fn, 2),
                                    DIPResidualBlock(96, 96, norm_fn, 1))
        self.layer3 = nn.Sequential(DIPResidualBlock(96, 128, norm_fn, 1),
                                    DIPResidualBlock(128, 128, norm_fn, 1))
        self.conv2 = CastConv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class PathMatch:
    """The PatchMatch correlations of ``fmap1`` against ``fmap2`` (B, C, H,
    W) at a flow: ``search``, the 25 channel means of fmap1 times the
    warped fmap2 shifted by -2..2 px (x outer, y inner, edge-padded); and
    ``inverse_propagation``, the 10 of fmap1 against fmap2 and its four
    diagonal one-pixel shifts (edge-padded), warped together.  Warps are
    bilinear with border padding and align_corners=True."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor):
        self.map1 = fmap1
        self.map2 = fmap2
        b, c, h, w = fmap1.shape
        self.b, self.c, self.h, self.w = b, c, h, w
        self.coords = coords_grid(b, h, w, dtype=fmap1.dtype,
                                  device=fmap1.device)
        pad = lambda t, p: F.pad(t, p, mode="replicate")  # noqa: E731
        f = fmap2
        self.shift_map2 = torch.cat([
            f, pad(f, (1, 0, 1, 0))[..., :h, :w],
            pad(f, (0, 1, 1, 0))[..., :h, 1:],
            pad(f, (1, 0, 0, 1))[..., 1:, :w],
            pad(f, (0, 1, 0, 1))[..., 1:, 1:]], dim=1)

    def _warp(self, coords: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        grid = torch.stack([2.0 * coords[:, 0] / max(self.w - 1, 1) - 1.0,
                            2.0 * coords[:, 1] / max(self.h - 1, 1) - 1.0],
                           dim=-1)
        return grid_sample(image, grid, padding_mode="border",
                           align_corners=True)

    def search(self, flow: torch.Tensor) -> torch.Tensor:
        warped = F.pad(self._warp(self.coords + flow, self.map2),
                       (2, 2, 2, 2), mode="replicate")
        h, w = self.h, self.w
        return torch.stack([
            (self.map1 * warped[..., j:j + h, i:i + w]).mean(dim=1)
            for i in range(5) for j in range(5)], dim=1)

    def inverse_propagation(self, flow: torch.Tensor) -> torch.Tensor:
        warped = self._warp(self.coords + flow, self.shift_map2)
        b, c, h, w = self.b, self.c, self.h, self.w
        m2 = warped.reshape(b, c // 2, 2, 5, h, w)
        m1 = self.map1.reshape(b, c // 2, 2, 1, h, w)
        return (m2 * m1).mean(dim=1).reshape(b, 10, h, w)

    def __call__(self, flow: torch.Tensor, is_search: bool = True):
        return (self.search(flow) if is_search
                else self.inverse_propagation(flow))


class SmallMotionEncoder(nn.Module):
    """Motion features of the 10 inverse-propagation channels."""

    def __init__(self):
        super().__init__()
        self.convc1 = CastConv2d(10, 96, 1)
        self.convf1 = CastConv2d(2, 64, 5, padding=2)
        self.convf2 = CastConv2d(64, 32, 3, padding=1)
        self.conv = CastConv2d(128, 96 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class DIPBasicMotionEncoder(nn.Module):
    """Motion features of the 25 search channels."""

    def __init__(self):
        super().__init__()
        self.convc1 = CastConv2d(25, 64, 1)
        self.convc2 = CastConv2d(64, 128, 3, padding=1)
        self.convf1 = CastConv2d(2, 64, 5, padding=2)
        self.convf2 = CastConv2d(64, 64, 3, padding=1)
        self.conv = CastConv2d(64 + 128, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class _UpdateBlock(nn.Module):
    """Motion encoder, GRU, flow head and the 4x upsampling mask (scaled by
    0.25): returns (net, mask, delta flow)."""

    def _mask_head(self, hidden_dim: int) -> None:
        self.mask = nn.Sequential(
            CastConv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, 16 * 9, 1))

    def forward(self, net, inp, corr, flow):
        mf = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, mf], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class SmallUpdateBlock(_UpdateBlock):
    def __init__(self, hidden_dim: int = 128):
        super().__init__()
        self.encoder = SmallMotionEncoder()
        self.gru = ConvGRU(hidden_dim=hidden_dim, input_dim=96 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=128)
        self._mask_head(hidden_dim)


class DIPBasicUpdateBlock(_UpdateBlock):
    def __init__(self, hidden_dim: int = 128):
        super().__init__()
        self.encoder = DIPBasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self._mask_head(hidden_dim)


class DIP(BaseModel):
    pretrained_checkpoints = {
        "kitti": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dip-kitti-b0b678b4.ckpt",
        "sintel": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dip-sintel-7abeb652.ckpt",
        "things": "https://github.com/hmorimitsu/ptlflow/releases/download/weights1/dip-things-688d52a0.ckpt",
    }

    def __init__(self, gamma: float = 0.8, max_flow: float = 400,
                 iters: int = 20, max_offset: int = 256, **kwargs):
        super().__init__(output_stride=16,
                         loss_fn=SequenceLoss(gamma, max_flow), **kwargs)
        self.iters = iters
        self.max_offset = max_offset
        self.hidden_dim = 128
        self.context_dim = 128
        self.fnet = BasicEncoderQuarter(output_dim=256, norm_fn="instance")
        self.update_block_s = SmallUpdateBlock(hidden_dim=self.hidden_dim)
        self.update_block = DIPBasicUpdateBlock(hidden_dim=self.hidden_dim)

    def _stage(self, patch: PathMatch, flow, net, inp, training: bool):
        """``iters`` rounds of propagation then search; returns the flow,
        the last search's mask, and in training every half-round's (flow,
        mask)."""
        preds = []
        mask = None
        for _ in range(self.iters):
            flow = flow.detach()
            net, mask1, d1 = self.update_block_s(
                net, inp, patch(flow, is_search=False), flow)
            flow1 = flow + d1
            flow = flow1.detach()
            net, mask, d2 = self.update_block(
                net, inp, patch(flow, is_search=True), flow)
            flow = flow + d2
            if training:
                preds += [(flow1, mask1), (flow, mask)]
        return flow, mask, preds

    def _forward(self, inputs: Dict[str, Any],
                 training: bool) -> Dict[str, torch.Tensor]:
        """Eval: ``flows`` (B, 1, 2, H, W) and ``flow_small`` (B, 2, H/4,
        W/4).  Training: ``flow_preds`` (4 * iters, B, 2, H, W), each
        half-round's flow upsampled to the image (the 1/16 ones convex x4
        then bilinear x4), and ``flows``."""
        images, resizer = self.preprocess_images(
            inputs["images"], bgr_add=-0.5, bgr_mult=2.0, bgr_to_rgb=False,
            resize_mode="pad", pad_mode="constant", pad_two_side=True,
            pad_value=-1)
        b = images.shape[0]
        fmap1, fmap2 = self.fnet(torch.cat([images[:, 0], images[:, 1]],
                                           dim=0)).split(b, dim=0)
        net = torch.tanh(fmap1[:, :self.hidden_dim])
        inp = torch.relu(fmap1[:, self.hidden_dim:])

        s_fmap1, s_fmap2, s_net, s_inp = (F.avg_pool2d(t, 4, 4) for t in
                                          (fmap1, fmap2, net, inp))
        _, _, sh, sw = s_fmap1.shape
        s_flow = init_flow(b, sh, sw, self.max_offset // 16,
                           torch.Generator().manual_seed(INIT_SEED))
        s_flow = s_flow.to(device=fmap1.device, dtype=fmap1.dtype)
        s_flow, s_mask, s_preds = self._stage(
            PathMatch(s_fmap1, s_fmap2), s_flow, s_net, s_inp, training)
        flow = convex_upsample(s_flow, s_mask, 4)
        flow, mask, l_preds = self._stage(PathMatch(fmap1, fmap2), flow, net,
                                          inp, training)
        flow_up = self.postprocess_predictions(
            convex_upsample(flow, mask, 4), resizer, is_flow=True)
        if not training:
            return {"flows": flow_up[:, None], "flow_small": flow}

        def upflow4(f):
            return 4 * interpolate(f, (4 * f.shape[-2], 4 * f.shape[-1]),
                                   align_corners=False)

        ups = [upflow4(convex_upsample(f, m, 4)) for f, m in s_preds]
        ups += [convex_upsample(f, m, 4) for f, m in l_preds]
        flow_preds = self.postprocess_predictions(torch.stack(ups), resizer,
                                                  is_flow=True)
        return {"flows": flow_up[:, None], "flow_preds": flow_preds}


@register_model
@trainable
class dip(DIP):
    pass
