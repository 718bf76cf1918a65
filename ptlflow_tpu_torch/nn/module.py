"""Module-tree helpers of the JAX package's ``nn/module.py`` that the port
needs: which leaves are state, the trainable split, the mixed-precision
cast, and the training flag of the norms."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Sequence, Tuple

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


def split_trainable(module: nn.Module, frozen_prefixes: Sequence[str] = ()
                    ) -> Tuple[Dict[str, nn.Parameter],
                               Dict[str, torch.Tensor]]:
    """Split a module's tensors into (trainable, state) by dotted name, as
    the JAX package splits its parameter tree: parameters are trainable,
    buffers (the ``STATE_LEAVES`` of the norms) are state, and every tensor
    under a dotted prefix in ``frozen_prefixes`` is state.  The frozen
    parameters get ``requires_grad=False``, as in the reference."""
    def frozen(name: str) -> bool:
        return any(name.startswith(p + ".") for p in frozen_prefixes)

    trainable, state = {}, {}
    for name, p in module.named_parameters():
        if frozen(name):
            p.requires_grad_(False)
            state[name] = p
        else:
            trainable[name] = p
    for name, b in module.named_buffers():
        state[name] = b
    return trainable, state


@contextlib.contextmanager
def train_mode(module: nn.Module, training: bool) -> Iterator[None]:
    """Run the block with every submodule's ``training`` flag set to
    ``training``, and restore each flag afterwards.  A model's forward takes
    its mode from its ``training`` argument this way, as the JAX package's
    does, whatever ``module.train()`` or ``module.eval()`` set."""
    flags = [(m, m.training) for m in module.modules()]
    module.train(training)
    try:
        yield
    finally:
        for m, flag in flags:
            m.training = flag
