"""Layers and module helpers of the PyTorch port."""

from .layers import (BatchNorm2d, BatchNorm3d, CastConv2d,  # noqa: F401
                     CastConv3d, CastConvTranspose2d, CastConvTranspose3d,
                     CastLinear, InstanceNorm2d, LayerNorm, LayerNorm2d)
from .module import (STATE_LEAVES, cast_params,  # noqa: F401
                     split_trainable, train_mode)
