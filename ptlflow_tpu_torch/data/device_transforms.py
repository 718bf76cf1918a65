"""Training augmentation on the card
(``ptlflow_tpu/data/device_transforms.py``).

The reference's ``train_transform_cuda`` moves the per-sample augmentation
pipeline onto the accelerator; the CPU loader then only decodes.
``DeviceCompose`` runs a ``transforms.Compose`` training pipeline as torch
ops on the card: scale and crop in one resampling (the JAX package's
``jax.image.scale_and_translate``: a triangle-kernel weight matrix per axis,
two matrix products per plane), then colour jitter, noise, patch eraser and
flips.

The random numbers are drawn on the host with the same ``random`` calls, in
the same order, as the JAX package's ``DeviceCompose._draw_randoms``, so the
augmentation distribution is the numpy pipeline's.  Since they are host
floats, the choices they make (the jitter order, asymmetric jitter, the
eraser's patches, the flips) are Python branches.  The Gaussian noise field
alone is drawn on the card, from a ``torch.Generator`` seeded per call from
a counter.

Pipelines with a member that has no device form (sparse scatter resize,
``GenerateFBCheckFlowOcclusion``, an eraser that does not fill with the
mean colour) make ``from_compose`` return None, and the caller keeps the
numpy pipeline.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Optional

import numpy as np
import torch

from . import transforms as ft

BINARY_KEYS = ft.BINARY_KEYS
FLOW_KEYS = ft.FLOW_KEYS
OCC_KEYS = ft.OCC_KEYS

_MAX_PATCHES = 8
_LUMA = (0.299, 0.587, 0.114)
_F32_EPS = float(np.finfo(np.float32).eps)

f32 = np.float32


def resize_weights(in_size: int, out_size: int, scale: np.float32,
                   translation: np.float32,
                   device: torch.device) -> torch.Tensor:
    """(in_size, out_size) weights of ``jax.image.scale_and_translate`` with
    the linear (triangle) kernel and no antialiasing: output o samples the
    input at (o + 0.5) / scale - translation / scale - 0.5, each column is
    renormalised to sum 1, and outputs whose sample lies outside
    [-0.5, in_size - 0.5] are 0.  The same float32 arithmetic as JAX's
    ``compute_weight_mat`` compiled by XLA, which fuses the sample position's
    product and difference into one multiply-add (one rounding, emulated
    here in float64)."""
    inv = f32(1) / f32(scale)
    shift = f32(translation) * inv
    half = torch.arange(out_size, dtype=torch.float32, device=device) + 0.5
    sample = (half.double() * float(inv) - float(shift)).float() - 0.5
    pos = torch.arange(in_size, dtype=torch.float32, device=device)
    weights = torch.clamp(1 - (sample[None, :] - pos[:, None]).abs(), min=0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0)


def scale_crop(v: torch.Tensor, crop, sy: np.float32, sx: np.float32,
               y0: np.float32, x0: np.float32, nearest: bool) -> torch.Tensor:
    """out[o] = v[(o + offset) / scale] for an (N, C, H, W) tensor, to the
    crop size: bilinear by ``resize_weights`` (two matrix products per
    plane), or, for binary masks, the floor-index nearest sample of the
    numpy pipeline's nearest resize and integer crop."""
    n, c, h, w = v.shape
    if nearest:
        iy = torch.floor((torch.arange(crop[0], dtype=torch.float32,
                                       device=v.device) + float(y0))
                         / float(sy)).long().clamp(0, h - 1)
        ix = torch.floor((torch.arange(crop[1], dtype=torch.float32,
                                       device=v.device) + float(x0))
                         / float(sx)).long().clamp(0, w - 1)
        return v[:, :, iy][:, :, :, ix]
    wy = resize_weights(h, crop[0], sy, -y0, v.device).to(v.dtype)
    wx = resize_weights(w, crop[1], sx, -x0, v.device).to(v.dtype)
    planes = v.reshape(n * c, h, w)
    out = torch.matmul(torch.matmul(wy.t(), planes), wx)
    return out.reshape(n, c, crop[0], crop[1])


def update_oob_flows(occs: torch.Tensor, flows: torch.Tensor) -> torch.Tensor:
    """Occlusion masks with every pixel whose flow leaves the frame set."""
    _, _, h, w = flows.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flows.dtype, device=flows.device),
        torch.arange(w, dtype=flows.dtype, device=flows.device),
        indexing="ij")
    cx = flows[:, 0] + gx
    cy = flows[:, 1] + gy
    oob = (cx < 0) | (cx > w) | (cy < 0) | (cy > h)
    return torch.maximum(occs, oob[:, None].to(occs.dtype))


def shift_hue(imgs: torch.Tensor, shift: float) -> torch.Tensor:
    """(N, 3, H, W) hue shift by ``shift`` (a fraction of the wheel), as
    the numpy pipeline's ``transforms._shift_hue``: HSV with divisions by
    max(delta, 1e-12), the sector picked by ``floor(6 h) % 6``."""
    r, g, b = imgs[:, 0], imgs[:, 1], imgs[:, 2]
    maxc = imgs.amax(dim=1)
    minc = imgs.amin(dim=1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), dtype=imgs.dtype, device=imgs.device)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), zero)
    dd = torch.clamp(delta, min=1e-12)
    rc = torch.where(delta > 0, (maxc - r) / dd, zero)
    gc = torch.where(delta > 0, (maxc - g) / dd, zero)
    bc = torch.where(delta > 0, (maxc - b) / dd, zero)
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.remainder(h + shift, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.long() % 6)[None]
    r2 = torch.gather(torch.stack([v, q, p, p, t, v]), 0, i)[0]
    g2 = torch.gather(torch.stack([t, v, v, q, p, p]), 0, i)[0]
    b2 = torch.gather(torch.stack([p, p, t, v, v, q]), 0, i)[0]
    return torch.stack([r2, g2, b2], dim=1)


def _jitter(imgs: torch.Tensor, order, factors) -> torch.Tensor:
    """Brightness (op 0), contrast (1), saturation (2) and hue (3) in the
    drawn ``order``, slot k with factor ``factors[k]``, each clamped to
    [0, 1]; the contrast mean is taken per frame."""
    luma = torch.tensor(_LUMA, dtype=imgs.dtype,
                        device=imgs.device).view(1, 3, 1, 1)
    for op, f in zip(order, factors):
        f = float(f)
        if op == 0:
            imgs = imgs * f
        elif op == 1:
            gray = (imgs * luma).sum(dim=1, keepdim=True)
            mean = gray.mean(dim=(1, 2, 3), keepdim=True)
            imgs = (imgs - mean) * f + mean
        elif op == 2:
            gray = (imgs * luma).sum(dim=1, keepdim=True)
            imgs = (imgs - gray) * f + gray
        else:
            imgs = shift_hue(imgs, f)
        imgs = torch.clamp(imgs, 0.0, 1.0)
    return imgs


class DeviceCompose:
    """A ``transforms.Compose`` training pipeline as torch ops on
    ``device`` (default the card).  Build it with :meth:`from_compose`,
    which returns None for a pipeline with no device form."""

    def __init__(self, steps, crop, max_frames: int = 2,
                 out_dtype: Optional[torch.dtype] = None, device=None):
        self.steps = tuple(steps)
        self.crop = crop
        self.max_frames = max_frames
        # the reference's train_transform_fp16 halves the transforms'
        # output precision; bf16 here, as in the JAX package
        self.out_dtype = out_dtype
        self.device = torch.device(device or "cuda")
        self._seed = 0

    @classmethod
    def from_compose(cls, compose: ft.Compose, max_frames: int = 2,
                     out_dtype: Optional[torch.dtype] = None,
                     device=None) -> Optional["DeviceCompose"]:
        steps = []
        crop = None
        for t in compose.transforms:
            if isinstance(t, ft.RandomScaleAndCrop):
                if t.sparse or t.crop_size is None:
                    return None  # scatter resize stays on the host
                crop = tuple(t.crop_size)
                steps.append(("scale_crop",
                              {"major": t.major_scale,
                               "space": t.space_scale}))
            elif isinstance(t, ft.ColorJitter):
                steps.append(("jitter", {
                    "brightness": t.brightness, "contrast": t.contrast,
                    "saturation": t.saturation, "hue": t.hue,
                    "asymmetric_prob": t.asymmetric_prob}))
            elif isinstance(t, ft.GaussianNoise):
                steps.append(("noise", {"stdev": t.stdev}))
            elif isinstance(t, ft.RandomPatchEraser):
                if t.noise_type != "mean" or t.num_patches > _MAX_PATCHES:
                    return None
                steps.append(("eraser", {
                    "prob": t.prob, "bounds": t.bounds,
                    "num_patches": t.num_patches}))
            elif isinstance(t, ft.RandomFlip):
                steps.append(("flip", {"ph": t.ph, "pv": t.pv}))
            elif isinstance(t, ft.ToTensor):
                continue
            else:
                return None
        if crop is None:
            return None
        return cls(steps, crop, max_frames, out_dtype=out_dtype,
                   device=device)

    # ----------------------------------------------------------- randomness
    def _draw_randoms(self, sample) -> np.ndarray:
        """Host-side draws, one flat float32 vector in ``_apply``'s order,
        with the JAX package's ``random`` calls."""
        out = []
        h, w = sample["images"].shape[-2:]
        for name, params in self.steps:
            if name == "scale_crop":
                h, w = self.crop
                out.append(2 ** random.uniform(*params["major"]))
                out.append(2 ** random.uniform(params["space"][0],
                                               params["space"][1]))
                out.append(2 ** random.uniform(params["space"][2],
                                               params["space"][3]))
                out.append(random.random())   # y0 fraction
                out.append(random.random())   # x0 fraction
            elif name == "jitter":
                out.append(random.random())   # asymmetric draw
                order = list(range(4))
                random.shuffle(order)
                out.extend(order)
                for _ in range(self.max_frames):
                    fac = {0: random.uniform(*params["brightness"]),
                           1: random.uniform(*params["contrast"]),
                           2: random.uniform(*params["saturation"]),
                           3: random.uniform(*params["hue"])}
                    out.extend(fac[o] for o in order)
            elif name == "noise":
                out.append(random.random())
            elif name == "eraser":
                out.append(random.random())   # prob draw
                b = params["bounds"]
                for _ in range(_MAX_PATCHES):
                    out.append(random.randint(b[0][0],
                                              max(b[0][0],
                                                  min(b[0][1], h - 1))))
                    out.append(random.randint(b[1][0],
                                              max(b[1][0],
                                                  min(b[1][1], w - 1))))
                    out.append(random.random())                   # fy
                    out.append(random.random())                   # fx
                n_act = random.randint(1, params["num_patches"])
                out.extend([1.0 if i < n_act else 0.0
                            for i in range(_MAX_PATCHES)])
            elif name == "flip":
                out.append(random.random())
                out.append(random.random())
        return np.asarray(out, np.float32)

    def noise_field(self, like: torch.Tensor, seed: int) -> torch.Tensor:
        """A standard normal field shaped as ``like``, on its device, from
        a generator seeded with ``seed`` (the call counter)."""
        gen = torch.Generator(device=like.device).manual_seed(seed)
        return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                           device=like.device)

    # ------------------------------------------------------------- pipeline
    def _apply(self, sample: Dict[str, torch.Tensor], rnd: np.ndarray,
               seed: int) -> Dict[str, torch.Tensor]:
        sample = dict(sample)
        pos = 0

        def take(k=1):
            nonlocal pos
            pos += k
            return rnd[pos - k] if k == 1 else rnd[pos - k:pos]

        crop = self.crop
        for name, params in self.steps:
            if name == "scale_crop":
                ref_key = "flows" if "flows" in sample else "images"
                h, w = sample[ref_key].shape[2:4]
                major, ssh, ssw = take(), take(), take()
                sy = max(f32(major * ssh), f32((crop[0] + 1e-3) / h))
                sx = max(f32(major * ssw), f32((crop[1] + 1e-3) / w))
                # uniform in [0, scaled - crop]; h * sy - crop as one
                # multiply-add, as XLA fuses it
                y0 = f32(take() * f32(h * np.float64(sy) - crop[0]))
                x0 = f32(take() * f32(w * np.float64(sx) - crop[1]))
                for k, v in sample.items():
                    out = scale_crop(v, crop, sy, sx, y0, x0,
                                     nearest=k in BINARY_KEYS)
                    if k in FLOW_KEYS:
                        out = out * torch.tensor(
                            [float(sx), float(sy)], dtype=out.dtype,
                            device=out.device).view(1, 2, 1, 1)
                    sample[k] = out
                for occ_key, flow_key in zip(OCC_KEYS, FLOW_KEYS):
                    if occ_key in sample and flow_key in sample:
                        sample[occ_key] = update_oob_flows(sample[occ_key],
                                                           sample[flow_key])
            elif name == "jitter":
                imgs = sample["images"]
                asym = take()
                order = [int(o) for o in take(4)]
                fac = take(4 * self.max_frames).reshape(self.max_frames, 4)
                if asym < params["asymmetric_prob"]:
                    sample["images"] = torch.cat([
                        _jitter(imgs[i:i + 1], order,
                                fac[min(i, self.max_frames - 1)])
                        for i in range(imgs.shape[0])])
                else:
                    sample["images"] = _jitter(imgs, order, fac[0])
            elif name == "noise":
                std = float(f32(take() * f32(params["stdev"])))
                v = sample["images"]
                noise = self.noise_field(v, seed)
                sample["images"] = torch.clamp(v + std * noise, 0.0, 1.0)
            elif name == "eraser":
                imgs = sample["images"]
                if imgs.shape[0] < 2:
                    continue
                do = take()
                rects = take(4 * _MAX_PATCHES).reshape(_MAX_PATCHES, 4)
                active = take(_MAX_PATCHES)
                if do >= params["prob"]:
                    continue
                imgs = imgs.clone()
                img2 = imgs[1]
                _, h, w = img2.shape
                mean_color = img2.reshape(img2.shape[0], -1).mean(dim=1)
                for p in range(params["num_patches"]):
                    if active[p] <= 0:
                        continue
                    dy, dx, fy, fx = rects[p]
                    # rows y with py <= y < py + dy, columns likewise
                    py = f32(fy * f32(h - dy))
                    px = f32(fx * f32(w - dx))
                    img2[:, math.ceil(py):math.ceil(f32(py + dy)),
                         math.ceil(px):math.ceil(f32(px + dx))] = \
                        mean_color[:, None, None]
                sample["images"] = imgs
            elif name == "flip":
                fh = take() < params["ph"]
                fv = take() < params["pv"]
                for k, v in sample.items():
                    if fh:
                        v = v.flip(-1)
                        if k in FLOW_KEYS:
                            v = v * torch.tensor([-1.0, 1.0], dtype=v.dtype,
                                                 device=v.device).view(
                                                     1, 2, 1, 1)
                    if fv:
                        v = v.flip(-2)
                        if k in FLOW_KEYS:
                            v = v * torch.tensor([1.0, -1.0], dtype=v.dtype,
                                                 device=v.device).view(
                                                     1, 2, 1, 1)
                    sample[k] = v
        return sample

    def __call__(self, inputs: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        """Augment one sample: its 4-D numpy arrays go to the device once
        and come back as tensors there (images as ``out_dtype`` where set);
        anything else passes through."""
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                      self.device, non_blocking=True)
                  for k, v in inputs.items()
                  if isinstance(v, np.ndarray) and v.ndim == 4}
        rnd = self._draw_randoms(arrays)
        self._seed += 1
        out = self._apply(arrays, rnd, self._seed)
        if self.out_dtype is not None:
            out["images"] = out["images"].to(self.out_dtype)
        out.update({k: v for k, v in inputs.items() if k not in arrays})
        return out
