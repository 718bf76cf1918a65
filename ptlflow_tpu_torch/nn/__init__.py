"""Layers and module helpers of the PyTorch port."""

from .layers import (BatchNorm2d, CastConv2d,  # noqa: F401
                     CastConvTranspose2d, CastLinear, InstanceNorm2d,
                     LayerNorm, LayerNorm2d)
from .module import (STATE_LEAVES, cast_params,  # noqa: F401
                     split_trainable, train_mode)
