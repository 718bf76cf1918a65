"""RAFT's correlation pyramid and its per-iteration lookup, NCHW.

Semantics of ``ptlflow_tpu/ops/correlation.py`` (``coords_grid``,
``build_corr_pyramid``, ``corr_pyramid_lookup``), in the port's layout:
coords are (B, 2, H1, W1) with channel 0 = x and 1 = y, pyramid level ``l``
is (Q, H2/2^l, W2/2^l) with Q = B*H1*W1 queries in (b, y, x) order, and the
lookup returns (B, L*(2r+1)^2, H1, W1).

:func:`corr_pyramid_lookup` is the hand-written CUDA kernel
(``csrc/corr_lookup.cu``) for tensors on the card and the plain PyTorch
version :func:`corr_pyramid_lookup_plain` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils import cuda_build

MAX_RADIUS = 8  # (2r+2)^2 fp32 patches of 32 queries fit in 48 KB of smem


def coords_grid(batch: int, ht: int, wd: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """(B, 2, H, W) grid of (x, y) pixel coordinates."""
    y, x = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                          torch.arange(wd, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y])[None].expand(batch, 2, ht, wd)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4,
                       dtype: Optional[torch.dtype] = None
                       ) -> List[torch.Tensor]:
    """List of (B*H1*W1, H2/2^l, W2/2^l) all-pairs correlation levels.

    Level ``l`` is the product of fmap1 with fmap2 average-pooled by 2^l,
    scaled by 1/sqrt(C): the same numbers as pooling the level-0 volume,
    since the dot product is linear.  ``dtype`` stores the levels in
    reduced precision (bfloat16); the product is taken in the features'
    dtype.
    """
    b, c, h, w = fmap1.shape
    f1 = fmap1.reshape(b, c, h * w).transpose(1, 2)  # (B, HW, C)
    scale = 1.0 / math.sqrt(c)
    pyramid = []
    for i in range(num_levels):
        h2, w2 = fmap2.shape[-2:]
        lvl = torch.matmul(f1, fmap2.reshape(b, c, h2 * w2)) * scale
        if dtype is not None:
            lvl = lvl.to(dtype)
        pyramid.append(lvl.reshape(b * h * w, h2, w2))
        if i < num_levels - 1:
            fmap2 = F.avg_pool2d(fmap2, 2, 2)
    return pyramid


def _check(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
           radius: int) -> None:
    if coords.dim() != 4 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (B, 2, H1, W1), got "
                         f"{tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius must be in [0, {MAX_RADIUS}], got {radius}")
    q = coords.shape[0] * coords.shape[2] * coords.shape[3]
    dt = pyramid[0].dtype
    for lvl in pyramid:
        if lvl.dim() != 3 or lvl.shape[0] != q:
            raise ValueError(f"each level must be (Q={q}, H, W), got "
                             f"{tuple(lvl.shape)}")
        if lvl.dtype != dt or dt not in (torch.float32, torch.bfloat16):
            raise TypeError("levels must all be float32 or all bfloat16")
        if lvl.device != coords.device:
            raise ValueError("levels and coords must be on one device")


def corr_pyramid_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """Sample each level in a (2r+1)^2 window around coords / 2^l.

    Returns (B, L*(2r+1)^2, H1, W1) in the pyramid's dtype: level-major,
    and within a level channel a*(2r+1) + b holds the bilinear sample at
    (x + a - r, y + b - r), so the first window axis offsets x (the
    reference's channel order, which converted checkpoints depend on).
    Zero outside the map.  A CUDA tensor goes to the kernel, a CPU tensor
    to :func:`corr_pyramid_lookup_plain`.
    """
    if coords.device.type == "cuda":
        return corr_lookup_kernel(pyramid, coords, radius)
    if coords.device.type == "cpu":
        return corr_pyramid_lookup_plain(pyramid, coords, radius)
    raise ValueError(f"no lookup for device {coords.device}")


def corr_pyramid_lookup_plain(pyramid: Sequence[torch.Tensor],
                              coords: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """Plain PyTorch version of the lookup kernel, same arithmetic: gather
    each query's (2r+2)^2 integer patch around floor(coords / 2^l), zero
    outside the map, then apply the 2x2 bilinear stencil that the whole
    window shares, y first, in float32."""
    _check(pyramid, coords, radius)
    b, _, h1, w1 = coords.shape
    q = b * h1 * w1
    n = 2 * radius + 1
    p = n + 1
    dev = coords.device
    cxy = coords.permute(0, 2, 3, 1).reshape(q, 2)
    offs = torch.arange(p, device=dev) - radius
    outs = []
    for i, lvl in enumerate(pyramid):
        h2, w2 = lvl.shape[1:]
        c = cxy / (2 ** i)
        c0 = torch.floor(c)
        fx, fy = (c - c0).unbind(1)
        # clamp like the kernel: a window that far out is all zeros anyway
        x0, y0 = c0.clamp(-2 ** 20, 2 ** 20).long().unbind(1)
        ys = y0[:, None] + offs  # (Q, p)
        xs = x0[:, None] + offs
        valid = (((ys >= 0) & (ys < h2))[:, :, None]
                 & ((xs >= 0) & (xs < w2))[:, None, :])  # (Q, p, p)
        idx = (ys.clamp(0, h2 - 1)[:, :, None] * w2
               + xs.clamp(0, w2 - 1)[:, None, :])
        patch = torch.gather(lvl.reshape(q, h2 * w2).float(), 1,
                             idx.reshape(q, p * p)).reshape(q, p, p)
        patch = patch * valid  # [q, y, x]
        fy = fy[:, None, None]
        fx = fx[:, None, None]
        t = (1 - fy) * patch[:, :n, :] + fy * patch[:, 1:, :]  # (Q, n_b, p)
        val = (1 - fx) * t[:, :, :n] + fx * t[:, :, 1:]  # (Q, n_b, n_a)
        # channel a*n + b: x offset on the slow axis
        outs.append(val.transpose(1, 2).reshape(b, h1, w1, n * n))
    out = torch.cat(outs, dim=-1).permute(0, 3, 1, 2).contiguous()
    return out.to(pyramid[0].dtype)


def corr_lookup_kernel(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """Launch ``csrc/corr_lookup.cu`` on the current stream.  Takes CUDA
    tensors only and raises on anything the kernel does not take; counts
    its launches in ``corr_lookup_kernel.launches``."""
    _check(pyramid, coords, radius)
    if coords.device.type != "cuda":
        raise ValueError("corr_lookup_kernel takes CUDA tensors")
    if not 1 <= len(pyramid) <= 8:
        raise ValueError(f"1 to 8 levels, got {len(pyramid)}")
    coords = coords.contiguous()
    levels = [lvl.contiguous() for lvl in pyramid]
    b, _, h1, w1 = coords.shape
    n = 2 * radius + 1
    dt = levels[0].dtype
    out = torch.empty((b, len(levels) * n * n, h1, w1), dtype=dt,
                      device=coords.device)
    if out.numel() == 0:
        return out
    lib = _corr_lookup_lib()
    nl = len(levels)
    ptrs = (ctypes.c_void_p * nl)(*[lvl.data_ptr() for lvl in levels])
    hs = (ctypes.c_int * nl)(*[lvl.shape[1] for lvl in levels])
    ws = (ctypes.c_int * nl)(*[lvl.shape[2] for lvl in levels])
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_lookup(coords.data_ptr(), ptrs, hs, ws, nl,
                              out.data_ptr(), b, h1, w1, radius,
                              int(dt == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: CUDA error "
                           f"{err}")
    corr_lookup_kernel.launches += 1
    return out


corr_lookup_kernel.launches = 0


def _corr_lookup_lib() -> ctypes.CDLL:
    lib = cuda_build.load("corr_lookup")
    fn = lib.corr_lookup
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(i),
                       ctypes.POINTER(i), i, vp, i, i, i, i, i, vp]
        fn.restype = i
    return lib
