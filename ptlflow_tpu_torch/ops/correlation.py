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
:func:`corr_pyramid_lookup` is the same as a one-shot call, and
:class:`CorrBlock` the pyramid of two feature maps with its prepared lookup.
:func:`all_pairs_correlation` is the float32 level-0 volume and
:func:`pool_volume_pyramid` pools such a volume into levels, for the models
that change the volume before pooling it (LLA-Flow, CSFlow).
:class:`AltCorrBlock` computes :class:`CorrBlock`'s numbers on the fly,
without the volume, in plain PyTorch on either device (MS-RAFT+, CCMR).

The lookup is differentiable with respect to the pyramid and, by default,
never the coords, as RAFT trains it (RAFT's family stops the coords'
gradient).  On the card the gradient is a second hand-written kernel
(``csrc/corr_lookup_backward.cu``) inside a ``torch.autograd.Function``; on
the CPU autograd differentiates the plain version,
:func:`corr_pyramid_lookup_backward_plain` is the kernel's plain version.
A lookup prepared with ``coords_grad=True`` is also differentiable with
respect to the coords, as the JAX package's XLA lookup is where a model does
not stop their gradient (NeuFlow v2): on the card
:func:`lookup_coords_grad` takes that gradient from four launches of the
forward kernel a level.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, List, Optional, Sequence, Tuple

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


def all_pairs_correlation(fmap1: torch.Tensor,
                          fmap2: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) features -> the (B, H*W, H, W) volume of every pair's
    dot product over sqrt(C), accumulated and returned in float32 (a
    reduced-precision product is exact in float32) whatever the features'
    dtype, as the JAX package's ``all_pairs_correlation``."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.reshape(b, c, h * w).transpose(1, 2).float()
    corr = torch.matmul(f1, fmap2.reshape(b, c, -1).float()) / math.sqrt(c)
    return corr.reshape(b, h * w, *fmap2.shape[-2:])


def pool_volume_pyramid(volume: torch.Tensor,
                        num_levels: int) -> List[torch.Tensor]:
    """``num_levels`` levels of a (Q, H, W) volume, each the 2x2 average
    pool of the last (the JAX package's ``avg_pool2d`` of the volume, as
    LLA-Flow and CSFlow pool theirs): a side under 2 px pools to 0 px,
    floored as ``build_corr_pyramid`` floors it, so a small map gives empty
    levels."""
    pyramid = [volume]
    for _ in range(num_levels - 1):
        q, h, w = volume.shape
        if min(h, w) >= 2:
            volume = F.avg_pool2d(volume[:, None], 2, 2)[:, 0]
        else:  # F.avg_pool2d refuses an output side of 0
            volume = volume.new_zeros((q, h // 2, w // 2))
        pyramid.append(volume)
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


def _check_coords_grad(coords: torch.Tensor) -> None:
    if coords.requires_grad and torch.is_grad_enabled():
        raise ValueError(
            "the correlation lookup is differentiable with respect to the "
            "pyramid only; detach the coords (RAFT stops their gradient, as "
            "the JAX package does)")


def make_corr_lookup(pyramid: Sequence[torch.Tensor], radius: int,
                     coords_grad: bool = False
                     ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Prepare the lookup of ``pyramid`` once; returns ``lookup(coords)``.

    For a pyramid on the card the levels are checked and made contiguous
    and the kernel's pointer and shape arrays are built here, so each call
    only checks the coords, allocates the output and launches
    ``csrc/corr_lookup.cu``; where autograd needs the pyramid's gradient,
    the call goes through a ``torch.autograd.Function`` whose backward
    launches ``csrc/corr_lookup_backward.cu``.  For a pyramid on the CPU
    each call is :func:`corr_pyramid_lookup_plain`, which autograd
    differentiates.  Coords on another device than the pyramid raise:
    neither path stands in for the other.  On either device, coords that
    require a gradient raise while grad mode is on, unless ``coords_grad``:
    then the lookup gives their gradient too (:func:`lookup_coords_grad` on
    the card, autograd of the plain version on the CPU).
    """
    _check_pyramid(pyramid, radius)
    dev = pyramid[0].device
    if dev.type == "cuda":
        return _KernelLookup(pyramid, radius, coords_grad=coords_grad)
    if dev.type == "cpu":
        def lookup(coords: torch.Tensor) -> torch.Tensor:
            if not coords_grad:
                _check_coords_grad(coords)
            return corr_pyramid_lookup_plain(pyramid, coords, radius)
        return lookup
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


def _check_backward(grad_out: torch.Tensor, coords: torch.Tensor,
                    shapes: Sequence[Tuple[int, int]], radius: int) -> None:
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"radius must be in [0, {MAX_RADIUS}], got {radius}")
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(shapes)}")
    if coords.dim() != 4 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (B, 2, H1, W1), got "
                         f"{tuple(coords.shape)}")
    b, _, h1, w1 = coords.shape
    want = (b, len(shapes) * (2 * radius + 1) ** 2, h1, w1)
    if tuple(grad_out.shape) != want:
        raise ValueError(f"grad_out must be {want}, got "
                         f"{tuple(grad_out.shape)}")
    if grad_out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("grad_out must be float32 or bfloat16")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if grad_out.device != coords.device:
        raise ValueError("grad_out and coords must be on one device")


def corr_pyramid_lookup_backward_plain(grad_out: torch.Tensor,
                                       coords: torch.Tensor,
                                       shapes: Sequence[Tuple[int, int]],
                                       radius: int) -> List[torch.Tensor]:
    """Plain PyTorch version of the backward kernel: the gradient of the
    lookup with respect to each level, given the output's gradient
    ``grad_out`` (B, L*(2r+1)^2, H1, W1) in the pyramid's dtype, the coords
    and the levels' (H2, W2) ``shapes``.  Returns one dense (Q, H2, W2)
    gradient per level in grad_out's dtype: the transpose of
    :func:`corr_pyramid_lookup_plain`'s arithmetic, x-lerp then y-lerp
    backwards in float32, scattered into a zero map per query at the
    in-range cells of its (2r+2)^2 patch.  An empty level gets an empty
    gradient.  Used by the tests and to check the kernel, never by the
    model."""
    _check_backward(grad_out, coords, shapes, radius)
    b, _, h1, w1 = coords.shape
    q = b * h1 * w1
    n = 2 * radius + 1
    p = n + 1
    dev = coords.device
    cxy = coords.permute(0, 2, 3, 1).reshape(q, 2)
    # [q, level, a (x offset), b (y offset)]
    g = grad_out.float().permute(0, 2, 3, 1).reshape(q, len(shapes), n, n)
    offs = torch.arange(p, device=dev) - radius
    grads = []
    for i, (h2, w2) in enumerate(shapes):
        out = torch.zeros((q, h2 * w2), dtype=torch.float32, device=dev)
        if h2 > 0 and w2 > 0:
            c = cxy / (2 ** i)
            c0 = torch.floor(c)
            fx, fy = (c - c0).unbind(1)
            x0, y0 = c0.clamp(-2 ** 20, 2 ** 20).long().unbind(1)
            fx = fx[:, None, None]
            fy = fy[:, None, None]
            gv = g[:, i].transpose(1, 2)  # (Q, n_b, n_a): [q, y, x]
            # val = (1 - fx) * t[:, :, :n] + fx * t[:, :, 1:]
            gt = F.pad((1 - fx) * gv, (0, 1)) + F.pad(fx * gv, (1, 0))
            # t = (1 - fy) * patch[:, :n, :] + fy * patch[:, 1:, :]
            gp = (F.pad((1 - fy) * gt, (0, 0, 0, 1))
                  + F.pad(fy * gt, (0, 0, 1, 0)))  # (Q, p, p)
            ys = y0[:, None] + offs
            xs = x0[:, None] + offs
            valid = (((ys >= 0) & (ys < h2))[:, :, None]
                     & ((xs >= 0) & (xs < w2))[:, None, :])
            idx = (ys.clamp(0, h2 - 1)[:, :, None] * w2
                   + xs.clamp(0, w2 - 1)[:, None, :])
            # out-of-map cells are clamped onto the map and add zeros
            out.scatter_add_(1, idx.reshape(q, p * p),
                             (gp * valid).reshape(q, p * p))
        grads.append(out.reshape(q, h2, w2).to(grad_out.dtype))
    return grads


def lookup_coords_grad(lookup: Callable, levels: Sequence[torch.Tensor],
                       coords: torch.Tensor, grad_out: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """The gradient of a lookup with respect to its (B, 2, H1, W1) coords,
    given the output's gradient ``grad_out``.  ``lookup(levels, coords)``
    is a one-level lookup: the kernel's launch on the card, the plain
    version in the tests.

    At level ``l`` the output is bilinear in the coords' fraction
    c / 2^l - floor(c / 2^l), and both 2x2 stencils share it across the
    window; so its derivative along x is (L(x0 + 1, y) - L(x0, y)) / 2^l,
    with L the level's lookup at the integer corner x0 = floor(x / 2^l)
    (fraction 0: exactly the corner's window) and y as given, and likewise
    along y.  That is four lookups a level, whose difference weighs the
    output's gradient channel by channel: the derivative of the JAX
    package's XLA lookup, whose one-hot weights are linear in the
    fraction."""
    n2 = (2 * radius + 1) ** 2
    g = grad_out.float()
    out = torch.zeros_like(coords)
    for i, lvl in enumerate(levels):
        c = coords / 2 ** i  # exact: a power of two
        corner = torch.floor(c)
        gl = g[:, i * n2:(i + 1) * n2]
        for axis in (0, 1):
            lo = c.clone()
            lo[:, axis] = corner[:, axis]
            hi = lo.clone()
            hi[:, axis] += 1
            diff = lookup([lvl], hi).float() - lookup([lvl], lo).float()
            out[:, axis] += (gl * diff).sum(1) / 2 ** i
    return out


class _LookupFunction(torch.autograd.Function):
    """The prepared lookup on the card as an autograd node: the forward
    launches ``csrc/corr_lookup.cu``, the backward
    ``csrc/corr_lookup_backward.cu``, one gradient per level.  It saves the
    coords and the levels' shapes, and nothing of the pyramid unless the
    lookup was prepared with ``coords_grad``: only then does it give the
    coords a gradient (:func:`lookup_coords_grad`, which launches the
    forward kernel on the levels; the caller refuses coords that need one
    otherwise)."""

    @staticmethod
    def forward(ctx, coords, prepared, *levels):
        ctx.shapes = prepared.shapes
        ctx.radius = prepared.radius
        ctx.prepared = prepared if prepared.coords_grad else None
        ctx.save_for_backward(coords)
        return prepared.launch(coords)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (coords,) = ctx.saved_tensors
        grads = [None] * len(ctx.shapes)
        if any(ctx.needs_input_grad[2:]):
            grads = corr_lookup_backward_kernel(grad_out, coords, ctx.shapes,
                                                ctx.radius)
        coords_grad = None
        if ctx.needs_input_grad[0]:
            coords_grad = lookup_coords_grad(
                ctx.prepared.launch_level, ctx.prepared.levels, coords,
                grad_out, ctx.radius)
        return (coords_grad, None, *grads)


class _KernelLookup:
    """The prepared launch of ``csrc/corr_lookup.cu`` (or of ``lib``, a
    library with the same C interface) for a checked pyramid on the card.
    Each call launches on the current stream, raises on a refused launch
    and counts it in ``corr_lookup_kernel.launches``.  Where grad mode is on
    and a level (or, with ``coords_grad``, the coords) requires a gradient,
    the call goes through :class:`_LookupFunction`."""

    def __init__(self, pyramid: Sequence[torch.Tensor], radius: int,
                 lib: Optional[ctypes.CDLL] = None,
                 coords_grad: bool = False):
        self.lib = _corr_lookup_lib(lib)
        self.coords_grad = coords_grad
        self._level_lookups = {}
        # keeps the contiguous copies alive while the lookup is
        self.levels = [lvl.contiguous() for lvl in pyramid]
        nl = len(self.levels)
        self.q = self.levels[0].shape[0]
        self.dtype, self.device = self.levels[0].dtype, self.levels[0].device
        self.radius = radius
        self.shapes = [tuple(lvl.shape[1:]) for lvl in self.levels]
        # An empty level's data_ptr() may be 0: the kernel never reads it,
        # as no window row or column lies inside a map of 0 rows or columns.
        self.ptrs = (ctypes.c_void_p * nl)(
            *[lvl.data_ptr() for lvl in self.levels])
        self.hs = (ctypes.c_int * nl)(*[h for h, _ in self.shapes])
        self.ws = (ctypes.c_int * nl)(*[w for _, w in self.shapes])
        self.channels = nl * (2 * radius + 1) ** 2

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        _check_coords(coords, self.q, self.device)
        if not self.coords_grad:
            _check_coords_grad(coords)
        if torch.is_grad_enabled() and (
                any(lvl.requires_grad for lvl in self.levels)
                or (self.coords_grad and coords.requires_grad)):
            return _LookupFunction.apply(coords, self, *self.levels)
        return self.launch(coords)

    def launch_level(self, levels: Sequence[torch.Tensor],
                     coords: torch.Tensor) -> torch.Tensor:
        """One launch on the one level ``levels`` of this pyramid, at coords
        on that level's grid: :func:`lookup_coords_grad`'s lookup."""
        (lvl,) = levels
        key = lvl.data_ptr()
        if key not in self._level_lookups:
            self._level_lookups[key] = _KernelLookup([lvl], self.radius,
                                                     self.lib)
        return self._level_lookups[key].launch(coords)

    def launch(self, coords: torch.Tensor) -> torch.Tensor:
        if torch.cuda.current_device() != self.device.index:
            with torch.cuda.device(self.device):
                return self.launch(coords)
        coords = coords.detach().contiguous()
        b, _, h1, w1 = coords.shape
        out = torch.empty((b, self.channels, h1, w1), dtype=self.dtype,
                          device=self.device)
        if self.q == 0:
            return out
        err = self.lib.corr_lookup(
            coords.data_ptr(), self.ptrs, self.hs, self.ws, len(self.shapes),
            out.data_ptr(), b, h1, w1, self.radius,
            int(self.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"corr_lookup kernel launch failed: CUDA "
                               f"error {err}")
        corr_lookup_kernel.launches += 1
        return out


def corr_lookup_kernel(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """Launch ``csrc/corr_lookup.cu`` once on the current stream.  Takes
    CUDA tensors only and raises on anything the kernel does not take;
    ``corr_lookup_kernel.launches`` counts every launch of the kernel,
    those of :func:`make_corr_lookup`'s prepared lookups included."""
    _check_pyramid(pyramid, radius)
    if pyramid[0].device.type != "cuda":
        raise ValueError("corr_lookup_kernel takes CUDA tensors")
    return _KernelLookup(pyramid, radius)(coords)


corr_lookup_kernel.launches = 0


class CorrBlock:
    """RAFT's correlation block (``ptlflow_tpu/ops/correlation.py::CorrBlock``):
    the ``num_levels``-level pyramid of ``fmap1`` against ``fmap2``
    (:func:`build_corr_pyramid`) and its lookup at ``radius``
    (:func:`make_corr_lookup`), both prepared once, here.  Each call is then
    one lookup: one launch of ``csrc/corr_lookup.cu`` for features on the
    card, the plain version for features on the CPU.  The JAX class looks
    the pyramid up afresh on every call; the numbers are the same.
    ``coords_grad`` is :func:`make_corr_lookup`'s."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = 4, radius: int = 4,
                 dtype: Optional[torch.dtype] = None,
                 coords_grad: bool = False):
        self.pyramid = build_corr_pyramid(fmap1, fmap2, num_levels, dtype)
        self.lookup = make_corr_lookup(self.pyramid, radius,
                                       coords_grad=coords_grad)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        """(B, L*(2r+1)^2, H1, W1), as :func:`corr_pyramid_lookup`."""
        return self.lookup(coords)


def _alt_corr_taps(shape: Tuple[int, int], coords: torch.Tensor,
                   radius: int):
    """The integer taps of each query's (2r+2)^2 patch around floor(coords)
    on one level: its rows of the level's (B*H2*W2, C) table in (dy, dx)
    order,
    clamped onto the map, the in-map mask and the bilinear fractions.
    ``coords`` (q, 3): batch index, x, y on the level's grid."""
    h2, w2 = shape
    p = 2 * radius + 2
    offs = torch.arange(p, device=coords.device) - radius
    c0 = torch.floor(coords[:, 1:])
    fx, fy = (coords[:, 1:] - c0).unbind(1)
    x0, y0 = c0.clamp(-2 ** 20, 2 ** 20).long().unbind(1)
    ys = y0[:, None] + offs
    xs = x0[:, None] + offs
    valid = (((ys >= 0) & (ys < h2))[:, :, None]
             & ((xs >= 0) & (xs < w2))[:, None, :]).reshape(-1, p * p)
    rows = (coords[:, 0].long()[:, None, None] * (h2 * w2)
            + (ys.clamp(0, h2 - 1) * w2)[:, :, None]
            + xs.clamp(0, w2 - 1)[:, None, :].expand(-1, p, p)
            ).reshape(-1, p * p)
    return rows, valid, fx[:, None, None], fy[:, None, None]


class _AltCorrFunction(torch.autograd.Function):
    """:class:`AltCorrBlock`'s lookup as an autograd node that saves only
    its inputs (the coords, fmap1's rows and the levels' tables) and
    gathers the patches again in the backward, chunk by chunk: plain
    autograd would keep every gathered patch of every iteration.  The
    coords get no gradient, as the JAX package stops it."""

    @staticmethod
    def forward(ctx, coords, block, f1, *tables):
        ctx.block = block
        ctx.save_for_backward(coords, f1, *tables)
        return block._lookup(coords, f1, tables)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        coords, f1, *tables = ctx.saved_tensors
        grad_f1, grad_tables = ctx.block._lookup_backward(coords, f1, tables,
                                                          grad_out)
        return (None, None, grad_f1, *grad_tables)


class AltCorrBlock:
    """The on-the-fly windowed correlation
    (``ptlflow_tpu/ops/correlation.py::AltCorrBlock``): the numbers of
    :class:`CorrBlock` without its O((HW)^2) volume, for the fine scales of
    MS-RAFT+ and CCMR.  Level ``l`` is fmap2 average-pooled by 2^l (floored
    as :func:`build_corr_pyramid` floors it), sampled bilinearly at
    coords / 2^l with zeros outside the map, each tap the dot product with
    fmap1 over sqrt(C); the output is (B, L*(2r+1)^2, H1, W1) in fmap1's
    dtype, level-major, the first window axis offsetting x.

    Each query gathers its (2r+2)^2 integer patch of the level's rows
    (channels last, laid out once here), dots it with its fmap1 row and
    applies the 2x2 stencil that the whole window shares, in float32;
    queries go in chunks of at most ``max_patch_elems`` gathered elements
    (256 MB of float32).
    Plain PyTorch on either device: the JAX package computes it in XLA.
    Where autograd needs the features' gradient the lookup is
    :class:`_AltCorrFunction`, which keeps no gathered patch."""

    max_patch_elems = 1 << 26

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = 4, radius: int = 4):
        b, c, h, w = fmap1.shape
        self.radius = radius
        self.channels = c
        self.f1 = fmap1.permute(0, 2, 3, 1).reshape(b * h * w, c)
        self.tables, self.shapes = [], []
        for i in range(num_levels):
            h2, w2 = fmap2.shape[-2:]
            self.tables.append(fmap2.permute(0, 2, 3, 1).reshape(-1, c))
            self.shapes.append((h2, w2))
            if i < num_levels - 1:
                if min(h2, w2) >= 2:
                    fmap2 = F.avg_pool2d(fmap2, 2, 2)
                else:  # F.avg_pool2d refuses an output side of 0
                    fmap2 = fmap2.new_zeros((b, c, h2 // 2, w2 // 2))

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        _check_coords(coords, self.f1.shape[0], self.f1.device)
        _check_coords_grad(coords)
        b, _, h1, w1 = coords.shape
        q = b * h1 * w1
        bidx = torch.arange(b, device=coords.device, dtype=coords.dtype)
        cq = torch.cat([bidx.view(b, 1, 1, 1).expand(b, 1, h1, w1),
                        coords.detach()], dim=1)
        cq = cq.permute(0, 2, 3, 1).reshape(q, 3)
        if torch.is_grad_enabled() and (
                self.f1.requires_grad
                or any(t.requires_grad for t in self.tables)):
            out = _AltCorrFunction.apply(cq, self, self.f1, *self.tables)
        else:
            out = self._lookup(cq, self.f1, self.tables)
        return out.reshape(b, h1, w1, -1).permute(0, 3, 1, 2).contiguous()

    def _chunks(self, q: int):
        p2 = (2 * self.radius + 2) ** 2
        step = max(1, self.max_patch_elems // (p2 * self.channels))
        return [slice(s, min(s + step, q)) for s in range(0, q, step)]

    def _lookup(self, cq, f1, tables) -> torch.Tensor:
        """(Q, L*(2r+1)^2) in f1's dtype."""
        r = self.radius
        n = 2 * r + 1
        q = cq.shape[0]
        out = torch.zeros((q, len(tables), n * n), dtype=torch.float32,
                          device=f1.device)
        scale = 1.0 / math.sqrt(self.channels)
        for i, (table, shape) in enumerate(zip(tables, self.shapes)):
            if 0 in shape:
                continue
            lvl = cq / torch.tensor([1.0, 2 ** i, 2 ** i], device=cq.device)
            for s in self._chunks(q):
                rows, valid, fx, fy = _alt_corr_taps(shape, lvl[s], r)
                patch = table[rows].float()  # (q, p*p, C)
                d = torch.bmm(patch, f1[s].float()[:, :, None])[..., 0]
                d = (d * valid).view(-1, n + 1, n + 1)  # [q, y, x]
                t = (1 - fy) * d[:, :n, :] + fy * d[:, 1:, :]
                val = (1 - fx) * t[:, :, :n] + fx * t[:, :, 1:]
                # channel a*n + b: x offset on the slow axis
                out[s, i] = val.transpose(1, 2).reshape(-1, n * n) * scale
        return out.reshape(q, -1).to(f1.dtype)

    def _lookup_backward(self, cq, f1, tables, grad_out):
        """The gradients of f1's rows and of each table, the patches
        gathered again; the transpose of :meth:`_lookup`."""
        r = self.radius
        n = 2 * r + 1
        q = cq.shape[0]
        scale = 1.0 / math.sqrt(self.channels)
        g = grad_out.float().reshape(q, len(tables), n, n)
        grad_f1 = torch.zeros(f1.shape, dtype=torch.float32, device=f1.device)
        grad_tables = []
        for i, (table, shape) in enumerate(zip(tables, self.shapes)):
            gt_ = torch.zeros(table.shape, dtype=torch.float32,
                              device=table.device)
            grad_tables.append(gt_)
            if 0 in shape:
                continue
            lvl = cq / torch.tensor([1.0, 2 ** i, 2 ** i], device=cq.device)
            for s in self._chunks(q):
                rows, valid, fx, fy = _alt_corr_taps(shape, lvl[s], r)
                gv = g[s, i].transpose(1, 2) * scale  # [q, y, x]
                gt = F.pad((1 - fx) * gv, (0, 1)) + F.pad(fx * gv, (1, 0))
                gd = (F.pad((1 - fy) * gt, (0, 0, 0, 1))
                      + F.pad(fy * gt, (0, 0, 1, 0)))
                gd = gd.reshape(-1, (n + 1) ** 2) * valid  # (q, p*p)
                patch = table[rows].float()
                grad_f1[s] += torch.bmm(gd[:, None, :], patch)[:, 0]
                fq = f1[s].float()
                gt_.index_add_(0, rows.reshape(-1),
                               (gd[:, :, None] * fq[:, None, :]).reshape(
                                   -1, fq.shape[1]))
        return (grad_f1.to(f1.dtype),
                [gt_.to(t.dtype) for gt_, t in zip(grad_tables, tables)])


def corr_lookup_backward_kernel(grad_out: torch.Tensor, coords: torch.Tensor,
                                shapes: Sequence[Tuple[int, int]],
                                radius: int) -> List[torch.Tensor]:
    """Launch ``csrc/corr_lookup_backward.cu`` once on the current stream;
    returns the level gradients, every element written by the kernel.
    Takes CUDA tensors only and raises on anything the kernel does not
    take; ``corr_lookup_backward_kernel.launches`` counts every launch of
    the kernel, those of the lookup's autograd backward included."""
    _check_backward(grad_out, coords, shapes, radius)
    dev = coords.device
    if dev.type != "cuda":
        raise ValueError("corr_lookup_backward_kernel takes CUDA tensors")
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return corr_lookup_backward_kernel(grad_out, coords, shapes,
                                               radius)
    lib = _corr_lookup_backward_lib()
    grad_out = grad_out.contiguous()
    coords = coords.detach().contiguous()
    b, _, h1, w1 = coords.shape
    q = b * h1 * w1
    grads = [torch.empty((q, h, w), dtype=grad_out.dtype, device=dev)
             for h, w in shapes]
    if q == 0:
        return grads
    nl = len(shapes)
    # an empty level's pointer may be 0; the kernel never writes it
    ptrs = (ctypes.c_void_p * nl)(*[g.data_ptr() for g in grads])
    hs = (ctypes.c_int * nl)(*[h for h, _ in shapes])
    ws = (ctypes.c_int * nl)(*[w for _, w in shapes])
    err = lib.corr_lookup_backward(
        coords.data_ptr(), grad_out.data_ptr(), ptrs, hs, ws, nl, b, h1, w1,
        radius, int(grad_out.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup_backward kernel launch failed: CUDA "
                           f"error {err}")
    corr_lookup_backward_kernel.launches += 1
    return grads


corr_lookup_backward_kernel.launches = 0


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


def _corr_lookup_backward_lib() -> ctypes.CDLL:
    """The library built from ``csrc/corr_lookup_backward.cu``, with the C
    signature of ``corr_lookup_backward`` declared."""
    lib = cuda_build.load("corr_lookup_backward")
    fn = lib.corr_lookup_backward
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ctypes.POINTER(vp), ctypes.POINTER(i),
                       ctypes.POINTER(i), i, i, i, i, i, i, vp]
        fn.restype = i
    return lib


def local_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      max_displacement: int, normalize: bool = True,
                      dilation: int = 1, stride: int = 1) -> torch.Tensor:
    """PWC-style local correlation over a (2d+1)^2 window of displacements
    (``ptlflow_tpu/ops/correlation.py::local_correlation`` without
    ``coords``, the form every model of the zoo calls): (B, C, H, W) maps
    -> (B, (2d+1)^2, H', W'), channel (dy, dx) row-major, each the sum over
    C of ``fmap1`` times ``fmap2`` moved by (dy, dx) times ``dilation``,
    zero outside the map; divided by C where ``normalize``; every
    ``stride``-th query position.  The models call it as PWC (radius 4),
    FlowNetC (radius 10, dilation 2: 441 windows), LiteFlowNet (radius 3,
    dilation and stride 1 or 2; radius 4) and FastFlowNet (radius 4) do;
    LiteFlowNet3 passes one map as both arguments (its self-correlation),
    and autograd then adds the two arguments' gradients into that map's.

    One ``unfold`` of the zero-padded ``fmap2`` gathers every window at
    the query positions ((2d+1)^2 times the strided map, kept for the
    backward: 3.24 GB at FlowNetC's 256 channels on 56x128), then one
    product and one channel sum: 3 launches (4 with the division; the
    product and the sum each split in two where their tensors pass 2^31
    bytes), where the JAX package slices the padded map once per
    displacement."""
    b, c = fmap1.shape[:2]
    n = 2 * max_displacement + 1
    f1 = fmap1[:, :, ::stride, ::stride]
    ho, wo = f1.shape[-2:]
    win = F.unfold(fmap2, n, dilation=dilation,
                   padding=max_displacement * dilation, stride=stride)
    corr = (f1[:, :, None] * win.view(b, c, n * n, ho, wo)).sum(1)
    return corr / c if normalize else corr
