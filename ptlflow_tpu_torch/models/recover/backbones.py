"""ReCoVEr's context extractors (``ptlflow_tpu/models/recover/
backbones.py``), NCHW: MobileNetV3-L and ConvNeXt-T at stride 8, with
torchvision's module layouts, so ``state_dict()`` keys are the reference's
(``features.<i>...``, ``block.<j>...``, ``layer_scale``).  Every layer casts
its weights to its input's dtype.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ... import nn as pnn
from ...nn import CastConv2d, CastLinear


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6, in that order, as the JAX package's."""
    return x * F.relu6(x + 3.0) / 6.0


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


class Hardswish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hardswish(x)


class Permute(nn.Module):
    """torchvision's ``ops.misc.Permute`` (no parameters)."""

    def __init__(self, dims: List[int]):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


class ConvNormAct(nn.Sequential):
    """torchvision's ``Conv2dNormActivation``: "0" the convolution, "1"
    BatchNorm (eps 1e-3, momentum 0.01) or a LayerNorm over the channels
    (eps 1e-6), "2" hardswish (``act="hs"``) or ReLU (``"re"``) where
    given."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, act: Optional[str] = "hs",
                 padding: Optional[int] = None, bias: bool = False,
                 norm: str = "bn"):
        if padding is None:
            padding = (kernel_size - 1) // 2
        layers = [CastConv2d(in_ch, out_ch, kernel_size, stride=stride,
                             padding=padding, groups=groups, bias=bias),
                  pnn.BatchNorm2d(out_ch, eps=1e-3, momentum=0.01)
                  if norm == "bn" else pnn.LayerNorm2d(out_ch, eps=1e-6)]
        if act is not None:
            layers.append(Hardswish() if act == "hs" else nn.ReLU())
        super().__init__(*layers)


class SqueezeExcitation(nn.Module):
    """torchvision's SE block: the mean over the map through ``fc1``, ReLU,
    ``fc2`` and hardsigmoid scales the channels."""

    def __init__(self, input_ch: int, squeeze_ch: int):
        super().__init__()
        self.fc1 = CastConv2d(input_ch, squeeze_ch, 1)
        self.fc2 = CastConv2d(squeeze_ch, input_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * hardsigmoid(self.fc2(torch.relu(self.fc1(s))))


class InvertedResidual(nn.Module):
    """torchvision's MobileNetV3 block (``block``: expansion, depthwise,
    SE, projection), with a residual at stride 1 and equal widths."""

    def __init__(self, inp: int, kernel: int, expanded: int, out: int,
                 use_se: bool, act: str, stride: int):
        super().__init__()
        self.use_res = stride == 1 and inp == out
        a = "hs" if act == "HS" else "re"
        layers: List[nn.Module] = []
        if expanded != inp:
            layers.append(ConvNormAct(inp, expanded, 1, act=a))
        layers.append(ConvNormAct(expanded, expanded, kernel, stride=stride,
                                  groups=expanded, act=a))
        if use_se:
            layers.append(SqueezeExcitation(
                expanded, _make_divisible(expanded // 4, 8)))
        layers.append(ConvNormAct(expanded, out, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block(x)
        return x + y if self.use_res else y


_MNV3_L = [
    # (in, kernel, expanded, out, use_se, act, stride)
    (16, 3, 16, 16, False, "RE", 1),
    (16, 3, 64, 24, False, "RE", 2),
    (24, 3, 72, 24, False, "RE", 1),
    (24, 5, 72, 40, True, "RE", 2),
    (40, 5, 120, 40, True, "RE", 1),
    (40, 5, 120, 40, True, "RE", 1),
    (40, 3, 240, 80, False, "HS", 1),
    (80, 3, 200, 80, False, "HS", 1),
    (80, 3, 184, 80, False, "HS", 1),
    (80, 3, 184, 80, False, "HS", 1),
    (80, 3, 480, 112, True, "HS", 1),
    (112, 3, 672, 112, True, "HS", 1),
    (112, 5, 672, 160, True, "HS", 1),
    (160, 5, 960, 160, True, "HS", 1),
    (160, 5, 960, 160, True, "HS", 1),
]


class MobileNetV3Extractor(nn.Module):
    """MobileNetV3-L's features to 960 channels at stride 8, then a 1x1
    ``final`` convolution to ``output_dim``."""

    def __init__(self, size: str = "l", input_dim: int = 3,
                 output_dim: int = 256):
        super().__init__()
        if size != "l":
            raise ValueError(f"MobileNetV3 size must be 'l', got {size!r}")
        layers: List[nn.Module] = [ConvNormAct(input_dim, 16, 3, stride=2)]
        layers += [InvertedResidual(*cfg) for cfg in _MNV3_L]
        layers.append(ConvNormAct(160, 960, 1))
        self.features = nn.Sequential(*layers)
        self.final = CastConv2d(960, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final(self.features(x))


class CNBlock(nn.Module):
    """torchvision's ConvNeXt block: ``block`` (7x7 depthwise convolution,
    then over each pixel's channels LayerNorm, Linear, GELU, Linear), times
    ``layer_scale`` (dim, 1, 1), 1e-6 at init, plus a residual."""

    def __init__(self, dim: int, layer_scale: float = 1e-6):
        super().__init__()
        self.layer_scale_init = layer_scale
        self.block = nn.Sequential(
            CastConv2d(dim, dim, 7, padding=3, groups=dim, bias=True),
            Permute([0, 2, 3, 1]), pnn.LayerNorm(dim, eps=1e-6),
            CastLinear(dim, 4 * dim), nn.GELU(), CastLinear(4 * dim, dim),
            Permute([0, 3, 1, 2]))
        self.layer_scale = nn.Parameter(torch.full((dim, 1, 1), layer_scale))

    def init_own_params(self, gen: torch.Generator) -> None:
        self.layer_scale.fill_(self.layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer_scale.to(x.dtype) * self.block(x)


def _transition(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    """LayerNorm over the channels then a 2x2 convolution of ``stride``:
    at stride 1 zero-padded by one row and column at the end first."""
    if stride == 2:
        return nn.Sequential(pnn.LayerNorm2d(in_ch, eps=1e-6),
                             CastConv2d(in_ch, out_ch, 2, stride=2))
    return nn.Sequential(pnn.LayerNorm2d(in_ch, eps=1e-6),
                         nn.ZeroPad2d((0, 1, 0, 1)),
                         CastConv2d(in_ch, out_ch, 2, stride=1))


class ConvNeXtExtractor(nn.Module):
    """ConvNeXt-T at stride 8: the 4x4 stride-4 stem, then four stages of
    CNBlocks, each followed by a transition (stride 2 after the first,
    stride 1 after the others), the last to ``output_dim`` channels."""

    def __init__(self, size: str = "t", input_dim: int = 3,
                 output_dim: int = 256, layer_scale: float = 1e-6):
        super().__init__()
        if size != "t":
            raise ValueError(f"ConvNeXt size must be 't', got {size!r}")
        setting = [(96, 192, 3), (192, 384, 3), (384, 768, 9),
                   (768, output_dim, 3)]
        layers: List[nn.Module] = [
            ConvNormAct(input_dim, 96, 4, stride=4, padding=0, bias=True,
                        norm="ln", act=None)]
        for i, (in_ch, out_ch, num) in enumerate(setting):
            layers.append(nn.Sequential(
                *[CNBlock(in_ch, layer_scale) for _ in range(num)]))
            layers.append(_transition(in_ch, out_ch, 2 if i < 1 else 1))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)
