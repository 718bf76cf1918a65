"""RAFT's correlation pyramid and its per-iteration lookup, NCHW.

Semantics of ``ptlflow_tpu/ops/correlation.py`` (``coords_grid``,
``build_corr_pyramid``, ``make_corr_lookup``, ``corr_pyramid_lookup``), in
the port's layout: coords are (B, 2, H1, W1) with channel 0 = x and 1 = y,
pyramid level ``l`` is (Q, H2/2^l, W2/2^l) with Q = B*H1*W1 queries in
(b, y, x) order, and the lookup returns (B, L*(2r+1)^2, H1, W1).

:func:`make_corr_lookup` prepares the lookup of one pyramid once and returns
a function of the coords: the hand-written CUDA kernel
(``csrc/corr_lookup.cu``) for a pyramid on the card, the plain PyTorch
version :func:`corr_pyramid_lookup_plain` for one on the CPU.
:func:`corr_pyramid_lookup` is the same as a one-shot call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils import cuda_build

MAX_RADIUS = 8  # (2r+2)^2 fp32 patches of 32 queries fit in 48 KB of smem
MAX_LEVELS = 8


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
    dtype.  A side under 2 px pools to 0 px, as the JAX package's
    ``avg_pool2d`` floors it, so a small map gives empty levels.
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
            if min(h2, w2) >= 2:
                fmap2 = F.avg_pool2d(fmap2, 2, 2)
            else:  # F.avg_pool2d refuses an output side of 0
                fmap2 = fmap2.new_zeros((b, c, h2 // 2, w2 // 2))
    return pyramid


def _check_pyramid(pyramid: Sequence[torch.Tensor], radius: int) -> None:
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius must be in [0, {MAX_RADIUS}], got {radius}")
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(pyramid)}")
    q, dt, dev = pyramid[0].shape[0], pyramid[0].dtype, pyramid[0].device
    for lvl in pyramid:
        if lvl.dim() != 3 or lvl.shape[0] != q:
            raise ValueError(f"each level must be (Q={q}, H, W), got "
                             f"{tuple(lvl.shape)}")
        if lvl.dtype != dt or dt not in (torch.float32, torch.bfloat16):
            raise TypeError("levels must all be float32 or all bfloat16")
        if lvl.device != dev:
            raise ValueError("levels must all be on one device")


def _check_coords(coords: torch.Tensor, q: int,
                  device: torch.device) -> None:
    if coords.dim() != 4 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (B, 2, H1, W1), got "
                         f"{tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.device != device:
        raise ValueError("levels and coords must be on one device")
    if coords.shape[0] * coords.shape[2] * coords.shape[3] != q:
        raise ValueError(f"coords hold {coords.shape[0]}*{coords.shape[2]}*"
                         f"{coords.shape[3]} queries, the levels Q={q}")


def make_corr_lookup(pyramid: Sequence[torch.Tensor], radius: int
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Prepare the lookup of ``pyramid`` once; returns ``lookup(coords)``.

    For a pyramid on the card the levels are checked and made contiguous
    and the kernel's pointer and shape arrays are built here, so each call
    only checks the coords, allocates the output and launches
    ``csrc/corr_lookup.cu``.  For a pyramid on the CPU each call is
    :func:`corr_pyramid_lookup_plain`.  Coords on another device than the
    pyramid raise: neither path stands in for the other.
    """
    _check_pyramid(pyramid, radius)
    dev = pyramid[0].device
    if dev.type == "cuda":
        return _kernel_lookup(pyramid, radius)
    if dev.type == "cpu":
        return lambda coords: corr_pyramid_lookup_plain(pyramid, coords,
                                                        radius)
    raise ValueError(f"no lookup for device {dev}")


def corr_pyramid_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                        radius: int) -> torch.Tensor:
    """Sample each level in a (2r+1)^2 window around coords / 2^l.

    Returns (B, L*(2r+1)^2, H1, W1) in the pyramid's dtype: level-major,
    and within a level channel a*(2r+1) + b holds the bilinear sample at
    (x + a - r, y + b - r), so the first window axis offsets x (the
    reference's channel order, which converted checkpoints depend on).
    Zero outside the map.  A one-shot :func:`make_corr_lookup`: the kernel
    for tensors on the card, the plain version for tensors on the CPU.
    """
    return make_corr_lookup(pyramid, radius)(coords)


def corr_pyramid_lookup_plain(pyramid: Sequence[torch.Tensor],
                              coords: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """Plain PyTorch version of the lookup kernel, same arithmetic: gather
    each query's (2r+2)^2 integer patch around floor(coords / 2^l), zero
    outside the map, then apply the 2x2 bilinear stencil that the whole
    window shares, y first, in float32.  An empty level reads zeros."""
    _check_pyramid(pyramid, radius)
    q = pyramid[0].shape[0]
    _check_coords(coords, q, pyramid[0].device)
    b, _, h1, w1 = coords.shape
    n = 2 * radius + 1
    p = n + 1
    dev = coords.device
    cxy = coords.permute(0, 2, 3, 1).reshape(q, 2)
    offs = torch.arange(p, device=dev) - radius
    outs = []
    for i, lvl in enumerate(pyramid):
        h2, w2 = lvl.shape[1:]
        if h2 == 0 or w2 == 0:
            outs.append(coords.new_zeros((b, h1, w1, n * n)))
            continue
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


def _kernel_lookup(pyramid: Sequence[torch.Tensor], radius: int,
                   lib: Optional[ctypes.CDLL] = None
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The prepared launch of ``csrc/corr_lookup.cu`` (or of ``lib``, a
    library with the same C interface) for a checked pyramid on the card.
    Each call launches on the current stream, raises on a refused launch
    and counts it in ``corr_lookup_kernel.launches``."""
    lib = _corr_lookup_lib(lib)
    levels = [lvl.contiguous() for lvl in pyramid]
    nl, q = len(levels), levels[0].shape[0]
    dt, dev = levels[0].dtype, levels[0].device
    # An empty level's data_ptr() may be 0: the kernel never reads it, as
    # no window row or column lies inside a map of 0 rows or columns.
    ptrs = (ctypes.c_void_p * nl)(*[lvl.data_ptr() for lvl in levels])
    hs = (ctypes.c_int * nl)(*[lvl.shape[1] for lvl in levels])
    ws = (ctypes.c_int * nl)(*[lvl.shape[2] for lvl in levels])
    channels = nl * (2 * radius + 1) ** 2
    is_bf16 = int(dt == torch.bfloat16)
    fn = lib.corr_lookup

    def lookup(coords: torch.Tensor) -> torch.Tensor:
        _check_coords(coords, q, dev)
        if torch.cuda.current_device() != dev.index:
            with torch.cuda.device(dev):
                return lookup(coords)
        coords = coords.contiguous()
        b, _, h1, w1 = coords.shape
        out = torch.empty((b, channels, h1, w1), dtype=dt, device=dev)
        if q == 0:
            return out
        err = fn(coords.data_ptr(), ptrs, hs, ws, nl, out.data_ptr(), b, h1,
                 w1, radius, is_bf16, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"corr_lookup kernel launch failed: CUDA "
                               f"error {err}")
        corr_lookup_kernel.launches += 1
        return out

    lookup.levels = levels  # keeps the contiguous copies alive
    return lookup


def corr_lookup_kernel(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """Launch ``csrc/corr_lookup.cu`` once on the current stream.  Takes
    CUDA tensors only and raises on anything the kernel does not take;
    ``corr_lookup_kernel.launches`` counts every launch of the kernel,
    those of :func:`make_corr_lookup`'s prepared lookups included."""
    _check_pyramid(pyramid, radius)
    if pyramid[0].device.type != "cuda":
        raise ValueError("corr_lookup_kernel takes CUDA tensors")
    return _kernel_lookup(pyramid, radius)(coords)


corr_lookup_kernel.launches = 0


def _corr_lookup_lib(lib: Optional[ctypes.CDLL] = None) -> ctypes.CDLL:
    """``lib``, or the library built from ``csrc/corr_lookup.cu``, with the
    C signature of ``corr_lookup`` declared: pointers as ``c_void_p``, so
    that ctypes does not cut them to 32 bits."""
    lib = cuda_build.load("corr_lookup") if lib is None else lib
    fn = lib.corr_lookup
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(i),
                       ctypes.POINTER(i), i, vp, i, i, i, i, i, vp]
        fn.restype = i
    return lib
