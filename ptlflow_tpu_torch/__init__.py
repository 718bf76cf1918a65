"""ptlflow_tpu_torch: the PyTorch/CUDA port of ptlflow_tpu.

The public API of ``ptlflow_tpu`` (``get_model``, ``get_model_reference``,
``get_model_names``, ``get_trainable_model_names``,
``get_ptlflow_trained_model_names``, ``restore_model``) over ``torch.nn``
models that take (B, N, 3, H, W) BGR images and return ``flows``
(B, 1, 2, H, W).  Models run on the card unless the caller asks for the CPU;
on the card the hot loop runs the hand-written CUDA kernels of ``csrc/``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from . import models as _models  # noqa: F401  (registers the models)
from . import nn, ops  # noqa: F401
from .utils.ckpt import restore_model  # noqa: F401
from .utils.registry import (_models_dict, _ptlflow_trained_models,
                             _trainable_models)

__version__ = "0.1.0"


def get_model_reference(model_name: str):
    if model_name not in _models_dict:
        raise ValueError(
            f"unknown model '{model_name}'. Available: {sorted(_models_dict)}")
    return _models_dict[model_name]


def get_model(model_name: str, ckpt_path: Optional[str] = None,
              args: Optional[Dict[str, Any]] = None,
              device: Union[str, torch.device] = "cuda"):
    """Build a registered model in eval mode on ``device``, with the weights
    of ``ckpt_path`` or, without one, the seeded random weights of
    ``init_params()``.  ``args`` holds constructor kwargs.  The default
    device is the card; where CUDA is absent this raises rather than fall
    back, so pass ``device="cpu"`` to run the plain versions of the
    kernels on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    model = get_model_reference(model_name)(**(args or {}))
    model = restore_model(model, ckpt_path)
    return model.to(device).eval()


def get_model_names():
    return sorted(_models_dict.keys())


def get_trainable_model_names():
    return sorted(m for m in _models_dict if m in _trainable_models)


def get_ptlflow_trained_model_names():
    return sorted(m for m in _models_dict if m in _ptlflow_trained_models)
