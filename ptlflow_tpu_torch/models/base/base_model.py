"""BaseModel: the model contract of ``ptlflow_tpu/models/base/base_model.py``
as a ``torch.nn.Module``.

- ``forward(inputs)`` takes ``images`` (B, N, 3, H, W), BGR in [0, 1], and
  returns ``flows`` (B, 1, 2, H, W) at input scale; a trainable model's
  ``forward(inputs, training=True)`` also returns what its ``loss_fn``
  (outputs, inputs) reads;
- ``preprocess_images`` shifts and scales BGR, optionally flips to RGB and
  pads or interpolates to a stride multiple; ``postprocess_predictions``
  undoes the resizing.

Everything is NCHW, so unlike the JAX package no layout moves happen here.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ...nn import train_mode
from ...ops.resize import InputPadder, InputScaler


def bgr_val_as_tensor(val, like: torch.Tensor) -> torch.Tensor:
    """(3, 1, 1) tensor of per-channel BGR values, from a scalar or a
    triple, broadcastable against (..., 3, H, W)."""
    if isinstance(val, (int, float)):
        val = [float(val)] * 3
    t = torch.as_tensor(val, dtype=like.dtype, device=like.device)
    if t.dim() > 1:  # already shaped to broadcast against the images
        return t
    if t.shape != (3,):
        raise ValueError(f"BGR value must be a scalar or a triple, got {val}")
    return t.view(3, 1, 1)


class BaseModel(nn.Module):
    pretrained_checkpoints: Dict[str, str] = {}
    # dotted module paths excluded from optimization (frozen backbones,
    # requires_grad=False in the reference); see nn.split_trainable
    frozen_prefixes: Tuple[str, ...] = ()

    def __init__(self, output_stride: int = 1,
                 loss_fn: Optional[Callable] = None, **kwargs):
        super().__init__()
        self.output_stride = output_stride
        # a plain callable, not a module: it holds no state_dict entries
        self.loss_fn = loss_fn
        self.train_size = None
        self.train_avg_length = None
        self.extra_params = None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "BaseModel":
        """Random weights from ``seed``, drawn with a ``torch.Generator`` on
        the CPU in a fixed module order, so a seed gives the same weights on
        every device, with the JAX package's initialisers: convs
        kaiming-normal (fan_out, relu) with uniform biases; linear weights
        and biases uniform in +-1/sqrt(in_features); embeddings standard
        normal; norms at weight 1, bias 0, mean 0, var 1.  A module's own
        parameters (layer scales, FlowFormer's latent tokens) are set by
        its ``init_own_params(gen)``."""
        gen = torch.Generator().manual_seed(seed)

        def uniform(t: torch.Tensor, bound: float) -> None:
            t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                                  generator=gen))

        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                kh, kw = mod.kernel_size
                std = math.sqrt(2.0 / (mod.out_channels * kh * kw))
                w = torch.empty(mod.weight.shape).normal_(0.0, std,
                                                          generator=gen)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    fan_in = mod.in_channels // mod.groups * kh * kw
                    uniform(mod.bias, 1.0 / math.sqrt(fan_in))
            elif isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                uniform(mod.weight, bound)
                if mod.bias is not None:
                    uniform(mod.bias, bound)
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.empty(mod.weight.shape).normal_(
                    generator=gen))
            elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
                mod.reset_parameters()
            if hasattr(mod, "init_own_params"):
                mod.init_own_params(gen)
        return self

    def forward(self, inputs: Dict[str, torch.Tensor],
                training: bool = False) -> Dict[str, torch.Tensor]:
        """``_forward`` with grad mode and every submodule's mode set from
        ``training``, not ``self.training``: BatchNorm uses batch statistics
        and updates its running statistics exactly when ``training`` is
        true, as in the JAX package, and the eval forward builds no autograd
        graph.  A model built with ``mixed_precision`` stores bf16 weights
        and refuses to train."""
        if training and getattr(self, "mixed_precision", False):
            raise ValueError(
                "this model stores bf16 weights (mixed_precision=True), where "
                "the JAX package keeps fp32 weights and trains in fp32 "
                "(ROADMAP.md, section 3); build it without mixed_precision "
                "to train it")
        with torch.set_grad_enabled(training), train_mode(self, training):
            return self._forward(inputs, training)

    def _forward(self, inputs: Dict[str, torch.Tensor],
                 training: bool) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def preprocess_images(
        self, images: torch.Tensor,
        stride: Optional[int] = None,
        bgr_add: Union[float, Sequence[float]] = 0,
        bgr_mult: Union[float, Sequence[float]] = 1,
        bgr_to_rgb: bool = False,
        image_resizer=None,
        resize_mode: str = "pad",
        target_size: Optional[Tuple[int, int]] = None,
        pad_mode: str = "replicate",
        pad_value: float = 0.0,
        pad_two_side: bool = True,
        interpolation_mode: str = "bilinear",
        interpolation_align_corners: bool = True,
    ):
        """(B, N, 3, H, W) BGR -> shifted, scaled, optionally RGB, padded or
        scaled to a stride multiple.  Returns (images, resizer)."""
        images = images + bgr_val_as_tensor(bgr_add, images)
        images = images * bgr_val_as_tensor(bgr_mult, images)
        if bgr_to_rgb:
            images = torch.flip(images, dims=[-3])

        stride = self.output_stride if stride is None else stride
        if target_size is not None:
            stride = None

        if image_resizer is None:
            if resize_mode == "pad":
                image_resizer = InputPadder(
                    images.shape, stride=stride, size=target_size,
                    pad_mode=pad_mode, two_side_pad=pad_two_side,
                    pad_value=pad_value)
            elif resize_mode == "interpolation":
                image_resizer = InputScaler(
                    images.shape, stride=stride, size=target_size,
                    interpolation_mode=interpolation_mode,
                    interpolation_align_corners=interpolation_align_corners)
            else:
                raise ValueError(
                    f"resize_mode must be one of (pad, interpolation). "
                    f"Found: {resize_mode}.")

        return image_resizer.fill(images), image_resizer

    def postprocess_predictions(self, prediction: torch.Tensor, image_resizer,
                                is_flow: bool) -> torch.Tensor:
        """Revert the resizing on an NCHW prediction."""
        if image_resizer is None:
            return prediction
        if isinstance(image_resizer, InputScaler):
            return image_resizer.unfill(prediction, is_flow=is_flow)
        return image_resizer.unfill(prediction)
