"""Resampling of NCHW tensors (``ptlflow_tpu/ops/grid_sample.py``): the
bilinear ``interpolate``, the general ``grid_sample`` (zero or border
padding, either ``align_corners``), the pixel-coordinate
``bilinear_sampler`` and ``interpolate_bicubic`` with explicit scale
factors."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def interpolate(x: torch.Tensor, size: Tuple[int, int],
                mode: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    """``F.interpolate`` of an NCHW tensor to an explicit (H, W) size, in
    float32 at least; returns the input unchanged when the size already
    matches."""
    oh, ow = size
    if tuple(x.shape[-2:]) == (oh, ow):
        return x
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(mode)
    xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    y = F.interpolate(xf, size=(oh, ow), mode=mode,
                      align_corners=align_corners if mode == "bilinear"
                      else None)
    return y.to(x.dtype)


def grid_sample(img: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """Bilinear ``F.grid_sample`` of ``img`` (N, C, H, W) at ``grid`` (N,
    Ho, Wo, 2; normalised x then y), as the JAX package's ``grid_sample``:
    zero or border padding, either ``align_corners``, computed in float32
    at least (a reduced-precision image is sampled in float32 and only the
    output cast back to its dtype)."""
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(padding_mode)
    compute = torch.promote_types(img.dtype, torch.float32)
    out = F.grid_sample(img.to(compute), grid.to(compute), mode="bilinear",
                        padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.to(img.dtype)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor,
                     mask: bool = False):
    """Sample ``img`` (N, C, H, W) bilinearly at pixel coordinates
    ``coords`` (N, 2, Ho, Wo; x then y), align_corners=True, zero padding
    (``ptlflow_tpu/ops/grid_sample.py::bilinear_sampler``).  The coords are
    normalised to [-1, 1] in float32 at least, as the JAX package normalises
    them, and a reduced-precision image is sampled in float32: only the
    output is cast back to the image's dtype, as the JAX package's
    ``grid_sample`` does (a bfloat16 grid would put the samples of a map
    1024 px wide up to 4 px off).  With ``mask``, also returns
    (N, 1, Ho, Wo) in the coords' dtype, 1 where the normalised coordinates
    lie strictly inside (-1, 1) on both axes, else 0."""
    h, w = img.shape[-2:]
    cdtype = torch.promote_types(coords.dtype, torch.float32)
    c = coords.to(cdtype)
    xgrid = 2.0 * c[:, 0] / (w - 1) - 1.0
    ygrid = 2.0 * c[:, 1] / (h - 1) - 1.0
    grid = torch.stack([xgrid, ygrid], dim=-1)
    out = grid_sample(img.to(torch.promote_types(img.dtype, cdtype)), grid,
                      align_corners=True)
    out = out.to(img.dtype)
    if mask:
        m = (xgrid > -1) & (ygrid > -1) & (xgrid < 1) & (ygrid < 1)
        return out, m[:, None].to(coords.dtype)
    return out


def _cubic_weights(t: torch.Tensor, a: float = -0.75):
    """The cubic-convolution weights of the 4 taps at distances (1+t, t,
    1-t, 2-t) from a fractional offset ``t`` (torch's bicubic kernel)."""
    def near(x):  # |x| <= 1
        return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1

    def far(x):  # 1 < |x| < 2
        return a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a

    return (far(t + 1.0), near(t), near(1.0 - t), far(2.0 - t))


def interpolate_bicubic(x: torch.Tensor, scale: Tuple[float, float],
                        size: Optional[Tuple[int, int]] = None
                        ) -> torch.Tensor:
    """``F.interpolate(mode="bicubic", align_corners=False)`` of an NCHW
    tensor with the EXPLICIT scale factors ``scale`` (scale_h, scale_w):
    output pixel ``d`` reads source position (d + 0.5) / scale - 0.5, even
    where ``size`` overrides the output size floor(in * scale), as DINOv2's
    position-embedding resize needs.  The taps clamp at the edges; computed
    in float32 at least and returned in the input's dtype (the JAX
    package's ``interpolate_bicubic``)."""
    h, w = x.shape[-2:]
    sh, sw = scale
    oh = size[0] if size is not None else int(h * sh)
    ow = size[1] if size is not None else int(w * sw)
    compute = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(compute)

    def taps(n_out: int, n_in: int, s: float):
        pos = (torch.arange(n_out, dtype=compute, device=x.device) + 0.5) / s
        pos = pos - 0.5
        p0 = torch.floor(pos)
        weights = _cubic_weights(pos - p0)
        idx = [(p0.long() + (i - 1)).clamp(0, n_in - 1) for i in range(4)]
        return idx, weights

    yi, wy = taps(oh, h, sh)
    xi, wx = taps(ow, w, sw)
    rows = 0.0
    for i in range(4):
        r = xf.index_select(-2, yi[i])
        cols = 0.0
        for j in range(4):
            cols = cols + r.index_select(-1, xi[j]) * wx[j]
        rows = rows + cols * wy[i][:, None]
    return rows.to(x.dtype)


def bilinear_coverage(coords: torch.Tensor, shape: Tuple[int, int],
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """What ``bilinear_sampler`` of an all-ones (h, w) map at ``coords``
    (N, 2, Ho, Wo; x then y) gives, in closed form: the in-range share of
    the 2x2 stencil, (N, 1, Ho, Wo) in ``dtype`` (the coords' by default),
    as ``ptlflow_tpu/ops/grid_sample.py::bilinear_coverage``.  The
    coordinates take the sampler's normalise and denormalise round trip
    step for step, in float32 at least, so that a threshold such as PWC's
    ``>= 0.9999`` cuts at the pixels where the sampled ones would."""
    h, w = shape
    c = coords.to(torch.promote_types(coords.dtype, torch.float32))
    gx = 2.0 * c[:, 0] / (w - 1) - 1.0
    gy = 2.0 * c[:, 1] / (h - 1) - 1.0
    x = (gx + 1.0) * 0.5 * (w - 1)
    y = (gy + 1.0) * 0.5 * (h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    vx0 = ((x0 >= 0) & (x0 <= w - 1)).to(c.dtype)
    vx1 = ((x0 >= -1) & (x0 <= w - 2)).to(c.dtype)
    vy0 = ((y0 >= 0) & (y0 <= h - 1)).to(c.dtype)
    vy1 = ((y0 >= -1) & (y0 <= h - 2)).to(c.dtype)
    cov = (vy0 * (1 - fy) + vy1 * fy) * (vx0 * (1 - fx) + vx1 * fx)
    return cov[:, None].to(dtype or coords.dtype)
