"""JAX parameter trees to the port's ``state_dict``.

The inverse of ``Module.from_torch`` in ``ptlflow_tpu/nn/module.py``: nested
names become dotted ones, convolution weights go from HWIO back to OIHW,
linear weights from (in, out) back to (out, in), and every BatchNorm gets
the ``num_batches_tracked`` counter that the JAX tree drops.  Takes numpy
leaves (the caller converts JAX arrays), so nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def state_dict_from_jax(params: Dict[str, Any],
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(state_dict_from_jax(v, prefix=name + "."))
            continue
        a = np.asarray(v)
        if k == "weight" and a.ndim == 4:  # conv HWIO -> OIHW
            a = np.transpose(a, (3, 2, 0, 1))
        elif k == "weight" and a.ndim == 2:  # linear (in, out) -> (out, in)
            a = a.T
        out[name] = torch.from_numpy(np.ascontiguousarray(a).copy())
        if k == "running_mean":
            out[f"{prefix}num_batches_tracked"] = torch.tensor(0)
    return out
