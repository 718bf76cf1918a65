"""RAFT update blocks: motion encoder, (Sep)ConvGRU and flow head
(``ptlflow_tpu/models/raft/update.py``), NCHW.

Attribute names are the JAX package's, so ``state_dict()`` keys match.
The motion encoders' correlation convolutions run in the correlation's
dtype (``CastConv2d``), as in the JAX package: a bfloat16 lookup output
stays bfloat16 through ``convc1``/``convc2`` and is promoted to float32
where it is concatenated with the float32 flow features.
Every convolution casts its weights to its input's dtype, so a model whose
weights ``validate --bf16`` or ``infer --bf16`` cast to bfloat16 runs them
as the JAX package does; on weights of the input's dtype this casts
nothing.
The JAX package runs the z and r convolutions of the GRU as one fused
convolution to read the GRU input once on the TPU; here they are the two
separate convolutions of the reference, which is the same math.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import CastConv2d


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = CastConv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = CastConv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=192 + 128):
        super().__init__()
        self.convz = CastConv2d(hidden_dim + input_dim, hidden_dim, 3,
                                padding=1)
        self.convr = CastConv2d(hidden_dim + input_dim, hidden_dim, 3,
                                padding=1)
        self.convq = CastConv2d(hidden_dim + input_dim, hidden_dim, 3,
                                padding=1)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim=128, input_dim=192 + 128):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz1 = CastConv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convr1 = CastConv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convq1 = CastConv2d(c, hidden_dim, (1, 5), padding=(0, 2))
        self.convz2 = CastConv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convr2 = CastConv2d(c, hidden_dim, (5, 1), padding=(2, 0))
        self.convq2 = CastConv2d(c, hidden_dim, (5, 1), padding=(2, 0))

    @staticmethod
    def _step(convz, convr, convq, h, x):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(convz(hx))
        r = torch.sigmoid(convr(hx))
        q = torch.tanh(convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        h = self._step(self.convz1, self.convr1, self.convq1, h, x)  # 1x5
        return self._step(self.convz2, self.convr2, self.convq2, h, x)  # 5x1


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_levels, corr_radius):
        super().__init__()
        cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = CastConv2d(cor_planes, 96, 1, padding=0)
        self.convf1 = CastConv2d(2, 64, 7, padding=3)
        self.convf2 = CastConv2d(64, 32, 3, padding=1)
        self.conv = CastConv2d(128, 80, 3, padding=1)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicMotionEncoder(nn.Module):
    """``cor_planes``, where given, is the width of the correlation
    features in place of the lookup's ``corr_levels * (2r+1)^2``
    (FlowFormer's update block adds its attention output to them)."""

    def __init__(self, corr_levels=None, corr_radius=None, cor_planes=None):
        super().__init__()
        if cor_planes is None:
            cor_planes = corr_levels * (2 * corr_radius + 1) ** 2
        self.convc1 = CastConv2d(cor_planes, 256, 1, padding=0)
        self.convc2 = CastConv2d(256, 192, 3, padding=1)
        self.convf1 = CastConv2d(2, 128, 7, padding=3)
        self.convf2 = CastConv2d(128, 64, 3, padding=1)
        self.conv = CastConv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallUpdateBlock(nn.Module):
    def __init__(self, corr_levels, corr_radius, hidden_dim=96):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_levels, corr_radius)
        self.gru = ConvGRU(hidden_dim=hidden_dim, input_dim=82 + 64)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=128)

    def forward(self, net, inp, corr, flow):
        motion_features = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion_features], dim=1))
        return net, None, self.flow_head(net)


class BasicUpdateBlock(nn.Module):
    """``cor_planes``, where given, is the correlation width in place of
    the lookup's (Flow1D's 2 x 65 channels of 1-D windows, SCV's 405 of
    sparse windows); ``mask_channels`` is 9 f^2 for convex upsampling by
    f (SCV's quarter model and MS-RAFT+ upsample by 4 and 2)."""

    def __init__(self, corr_levels, corr_radius, hidden_dim=128,
                 input_dim=128, cor_planes=None, mask_channels=64 * 9):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_levels, corr_radius,
                                          cor_planes)
        self.gru = SepConvGRU(hidden_dim=hidden_dim,
                              input_dim=128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim=256)
        self.mask = nn.Sequential(
            CastConv2d(128, 256, 3, padding=1), nn.ReLU(),
            CastConv2d(256, mask_channels, 1, padding=0))

    def forward(self, net, inp, corr, flow):
        motion_features = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion_features], dim=1))
        delta_flow = self.flow_head(net)
        # 0.25 scales the mask gradients, as in the reference
        mask = 0.25 * self.mask(net)
        return net, mask, delta_flow
