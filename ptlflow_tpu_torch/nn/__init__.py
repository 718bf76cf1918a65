"""Layers and module helpers of the PyTorch port."""

from .layers import (BatchNorm2d, CastConv2d, CastLinear,  # noqa: F401
                     InstanceNorm2d, LayerNorm)
from .module import (STATE_LEAVES, cast_params,  # noqa: F401
                     split_trainable, train_mode)
