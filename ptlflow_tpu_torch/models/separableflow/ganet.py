"""GANet's aggregations for SeparableFlow
(``ptlflow_tpu/models/separableflow/ganet.py``), as plain functions on
tensors, so that a hand kernel can later take the same signature.

- ``sga``: semi-global aggregation of a (B, C, D, H, W) volume, the
  elementwise max of four directions (down, up, right, left).  Each is a
  recursion over rows (columns) with 5 guidance weights of (B, 5, H, W):
  the current value, the previous row's value at d, d - 1 and d + 1, and
  the previous row's maximum over D; every previous-row term falls back to
  the current value outside the volume.  The maximum makes the step
  non-linear, so the rows run in a Python loop, six launches a step; the
  opposite directions share the loop, the flipped volume stacked along the
  batch axis.  The maximum is ``torch.max(dim).values``, whose gradient
  goes to one index, as the JAX package's ``take_along_axis`` of the
  argmax does.
- ``nlf_iter``: the non-local filter, down, up, right then left over a
  (B, C, H, W) volume.  Each direction recurses over rows with the terms
  (r, c), (r-1, c), (r-1, c-1), (r-1, c+1) and (r, c-1).  Within a row the
  (r, c-1) term makes a first-order linear recurrence ``y[c] = a[c] +
  f4[c] y[c-1]`` whose coefficient all C channels share, so each row is one
  product with the lower-triangular transfer matrix ``M[t, s] =
  prod_{s<u<=t} f4[u]``, built for all rows at once by a ``cumprod``
  without division (|f4| <= 1 after the L1 normalisation: no overflow).
  The rows run in a Python loop, five launches a row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _l1_normalize(g: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``F.normalize(p=1)``: divided by the sum of absolute values."""
    return g / g.abs().sum(dim, keepdim=True).clamp(min=1e-12)


def _edges(n: int, like: torch.Tensor):
    """(first, last) one-hot masks of length ``n``."""
    e = torch.zeros((2, n), dtype=like.dtype, device=like.device)
    e[0, 0] = 1
    e[1, n - 1] = 1
    return e[0], e[1]


def _sga_rows(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """One SGA direction over axis 0 of ``x`` (R, N, C, L, D) with the
    guidance ``g`` (R, N, 5, L), in order of R."""
    d = x.shape[-1]
    f = g[:, :, :, None, :, None]  # (R, N, 5, 1, L, 1)
    first, last = _edges(d, x)
    # the current value's own terms, the D edges' fallbacks among them
    own = x * (f[:, :, 0] + first * f[:, :, 2] + last * f[:, :, 3])
    prev = x[0] * f[0].sum(1)
    rows = [prev]
    for r in range(1, x.shape[0]):
        fr = f[r]
        pp = F.pad(prev, (1, 1))
        top = torch.max(prev, -1, keepdim=True).values
        out = torch.addcmul(own[r], prev, fr[:, 1])
        out = torch.addcmul(out, pp[..., :-2], fr[:, 2])
        out = torch.addcmul(out, pp[..., 2:], fr[:, 3])
        prev = torch.addcmul(out, top, fr[:, 4])
        rows.append(prev)
    return torch.stack(rows)


def sga(x: torch.Tensor, g0: torch.Tensor, g1: torch.Tensor,
        g2: torch.Tensor, g3: torch.Tensor) -> torch.Tensor:
    """Semi-global aggregation: ``x`` (B, C, D, H, W), ``g0``-``g3`` (B, 5,
    H, W) the L1-normalised guidance of down, up, right and left ->
    (B, C, D, H, W), the elementwise max of the four directions."""
    b = x.shape[0]
    # down and up: rows over H, (H, 2B, C, W, D), up's volume flipped
    xs = x.permute(3, 0, 1, 4, 2)
    gs = torch.cat([g0.permute(2, 0, 1, 3), g1.permute(2, 0, 1, 3).flip(0)],
                   dim=1)
    out = _sga_rows(torch.cat([xs, xs.flip(0)], dim=1), gs)
    best = torch.maximum(out[:, :b], out[:, b:].flip(0))
    # right and left: rows over W, (W, 2B, C, H, D)
    xs = x.permute(4, 0, 1, 3, 2)
    gs = torch.cat([g2.permute(3, 0, 1, 2), g3.permute(3, 0, 1, 2).flip(0)],
                   dim=1)
    out = _sga_rows(torch.cat([xs, xs.flip(0)], dim=1), gs)
    best_w = torch.maximum(out[:, :b], out[:, b:].flip(0))
    best = torch.maximum(best, best_w.permute(3, 1, 2, 0, 4))
    return best.permute(1, 2, 4, 0, 3)


def transfer_matrices(f4: torch.Tensor) -> torch.Tensor:
    """(..., L) coefficients -> (..., L, L) lower-triangular ``M[t, s] =
    prod_{s<u<=t} f4[u]`` (1 on the diagonal), by one ``cumprod`` over t
    of f4[t] where s < t and 1 elsewhere, masked to t >= s."""
    n = f4.shape[-1]
    idx = torch.arange(n, device=f4.device)
    below = idx[:, None] > idx[None, :]  # t > s
    steps = torch.where(below, f4[..., :, None],
                        torch.ones((), dtype=f4.dtype, device=f4.device))
    return torch.cumprod(steps, dim=-2) * (idx[:, None] >= idx[None, :]).to(
        f4.dtype)


def _nlf_rows(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """One NLF direction in the down orientation over ``x`` (R, B, C, L)
    with the guidance ``g`` (B, 5, R, L): rows in order of R, each row's
    (r, c-1) recurrence one product with its transfer matrix."""
    f = g.permute(2, 0, 1, 3)[:, :, :, None, :]  # (R, B, 5, 1, L)
    first, last = _edges(x.shape[-1], x)
    # (R, B, L, L): the product's right factor M^T of each row
    mt = transfer_matrices(g[:, 4].permute(1, 0, 2)).transpose(-1, -2)
    # the current value's own terms: (r, c) and the fallbacks of (r, c-1)
    # and (r-1, c-1) at the first column and of (r-1, c+1) at the last;
    # row 0 takes every (r-1, *) term from the current value
    coef = f[:, :, 0] + first * (f[:, :, 2] + f[:, :, 4]) + last * f[:, :, 3]
    coef0 = f[0, :, :4].sum(1) + first * f[0, :, 4]
    own = x * coef
    prev = torch.matmul(x[0] * coef0, mt[0])
    rows = [prev]
    for r in range(1, x.shape[0]):
        fr = f[r]
        pp = F.pad(prev, (1, 1))
        out = torch.addcmul(own[r], prev, fr[:, 1])
        out = torch.addcmul(out, pp[..., :-2], fr[:, 2])
        out = torch.addcmul(out, pp[..., 2:], fr[:, 3])
        prev = torch.matmul(out, mt[r])
        rows.append(prev)
    return torch.stack(rows)


def _swap23(g: torch.Tensor) -> torch.Tensor:
    """Guidance channels 2 and 3 swapped: mirroring both axes maps the
    down template's (r-1, c-1) and (r-1, c+1) onto (r+1, c+1) and (r+1,
    c-1), while the reference's up and left filters pair f2 with (r+1, c-1)
    and f3 with (r+1, c+1)."""
    return g[:, [0, 1, 3, 2, 4]]


def nlf_down(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return _nlf_rows(x.permute(2, 0, 1, 3), g).permute(1, 2, 0, 3)


def nlf_up(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return nlf_down(x.flip(2, 3), _swap23(g).flip(2, 3)).flip(2, 3)


def nlf_right(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return nlf_down(x.transpose(2, 3), g.transpose(2, 3)).transpose(2, 3)


def nlf_left(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return nlf_right(x.flip(2, 3), _swap23(g).flip(2, 3)).flip(2, 3)


def nlf_iter(x: torch.Tensor, g0: torch.Tensor, g1: torch.Tensor,
             g2: torch.Tensor, g3: torch.Tensor) -> torch.Tensor:
    """The four filters in turn: ``x`` (B, C, H, W), ``g0``-``g3`` (B, 5,
    H, W) L1-normalised.  The volume stays in the rows' layout between
    the directions that share one: (H, B, C, W) for down and up, (W, B, C,
    H) for right and left."""
    xs = _nlf_rows(x.permute(2, 0, 1, 3), g0)
    xs = _nlf_rows(xs.flip(0, 3), _swap23(g1).flip(2, 3)).flip(0, 3)
    xs = _nlf_rows(xs.permute(3, 1, 2, 0), g2.transpose(2, 3))
    xs = _nlf_rows(xs.flip(0, 3),
                   _swap23(g3).flip(2, 3).transpose(2, 3)).flip(0, 3)
    return xs.permute(1, 2, 3, 0)
