"""Module-tree helpers of the JAX package's ``nn/module.py`` that the port
needs: which leaves are state, and the mixed-precision cast."""

from __future__ import annotations

import torch
from torch import nn

# Leaf names that are state, not trainable parameters.
STATE_LEAVES = ("running_mean", "running_var", "num_batches_tracked")


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast floating-point parameters and buffers to ``dtype`` in place,
    leaving the state leaves (norm running statistics) as they are."""
    for mod in module.modules():
        for store in (mod._parameters, mod._buffers):
            for name, t in store.items():
                if (t is not None and name not in STATE_LEAVES
                        and t.is_floating_point()):
                    t.data = t.data.to(dtype)
    return module
