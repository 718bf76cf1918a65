"""GMFlow's sine position embedding (``ptlflow_tpu/models/gmflow/
transformer.py::position_embedding_sine``), which Flow1D adds to its
features.  The rest of GMFlow's transformer is not ported yet."""

from __future__ import annotations

import math

import numpy as np
import torch


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64,
                            temperature: float = 10000.0,
                            dtype=torch.float32, device=None
                            ) -> torch.Tensor:
    """(2*num_pos_feats, H, W) sine embedding of the normalised pixel
    positions, the y channels first, computed in float32 with numpy as the
    JAX package computes it."""
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, 1)
    x_embed = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, 0)
    eps = 1e-6
    scale = 2 * math.pi
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2).transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(pos)).to(dtype=dtype,
                                                          device=device)
