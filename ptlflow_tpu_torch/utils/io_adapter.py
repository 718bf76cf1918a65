"""IOAdapter (``ptlflow_tpu/utils/io_adapter.py``): numpy HWC frames to the
model's (B, N, 3, H, W) input on the model's device, and ``unscale`` to
bring predictions back to the input resolution.  Without a model or a
device the inputs go to the card, as ``get_model``'s models do."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.resize import InputScaler


class IOAdapter:
    def __init__(self, model=None, input_size: Optional[Tuple[int, int]] = None,
                 target_size: Optional[Tuple[int, int]] = None,
                 target_scale_factor: Optional[float] = None,
                 interpolation_mode: str = "bilinear",
                 interpolation_align_corners: bool = True,
                 output_stride: Optional[int] = None,
                 device: Union[str, torch.device, None] = None):
        self.output_stride = (output_stride if output_stride is not None
                              else getattr(model, "output_stride", 1))
        if device is None:
            device = model.device if model is not None else "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        self.target_size = target_size
        self.target_scale_factor = target_scale_factor
        self.interpolation_mode = interpolation_mode
        self.interpolation_align_corners = interpolation_align_corners
        self.scaler: Optional[InputScaler] = None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def prepare_inputs(self, images: Union[np.ndarray, Sequence[np.ndarray]],
                       flows: Optional[np.ndarray] = None,
                       inputs: Optional[Dict[str, Any]] = None,
                       image_only: bool = False, **kwargs) -> Dict[str, Any]:
        """images: HWC (or a list of HWC, or NHWC, or BNHWC), uint8 or
        float in [0, 1]; or a float tensor already in the model's
        (B, N, 3, H, W) layout, as the datasets give it."""
        if inputs is None:
            inputs = {}
        if isinstance(images, torch.Tensor):
            if images.dim() != 5 or not images.is_floating_point():
                raise ValueError(f"a tensor of images must be float "
                                 f"(B, N, 3, H, W), not {images.dtype} "
                                 f"{tuple(images.shape)}")
            inputs["images"] = images.to(self.device, torch.float32)
        else:
            arr = (np.stack([np.asarray(im) for im in images])
                   if isinstance(images, (list, tuple))
                   else np.asarray(images))
            if arr.ndim == 3:
                arr = arr[None]
            if arr.ndim == 4:
                arr = arr[None]  # (B, N, H, W, C)
            if arr.dtype == np.uint8:
                arr = arr.astype(np.float32) / 255.0
            arr = arr.astype(np.float32)
            inputs["images"] = self._tensor(
                np.transpose(arr, (0, 1, 4, 2, 3)))

        if flows is not None and not image_only:
            f = np.asarray(flows, np.float32)
            while f.ndim < 5:
                f = f[None]
            if f.shape[-1] == 2:
                f = np.transpose(f, (0, 1, 4, 2, 3))
            inputs["flows"] = self._tensor(f)
        for k, v in kwargs.items():
            if v is not None:
                inputs[k] = self._tensor(v)

        if (self.target_size is not None
                or self.target_scale_factor not in (None, 1.0)):
            self.scaler = InputScaler(
                inputs["images"].shape, size=self.target_size,
                scale_factor=self.target_scale_factor,
                interpolation_mode=self.interpolation_mode,
                interpolation_align_corners=self.interpolation_align_corners)
            inputs["images"] = self.scaler.fill(inputs["images"])
        return inputs

    def unscale(self, outputs: Dict[str, Any],
                image_only: bool = False) -> Dict[str, Any]:
        """Rescale predictions of four or more dims back to the original
        size; flows are rescaled in magnitude too."""
        if self.scaler is None:
            return outputs
        return {k: (self.scaler.unfill(v, is_flow="flow" in k)
                    if isinstance(v, torch.Tensor) and v.dim() >= 4 else v)
                for k, v in outputs.items()}
