"""Augmentation pipeline over dicts of NCHW numpy arrays: a copy of
``ptlflow_tpu/data/transforms.py``.

Behavioral parity with ptlflow's ptlflow/data/flow_transforms.py:
- RandomScaleAndCrop (flow_transforms.py:686-879): major/space scales
  (2**uniform), scale floored at crop size, bilinear (align_corners=True)
  resize with flow magnitude scaling, nearest for binary keys,
  sparse-aware scatter resize for KITTI-style GT (:1254-1375), OOB flows
  folded into occlusion masks (:1375-1404).
- ColorJitter (:310): brightness/contrast/saturation/hue with optional
  per-frame asymmetric sampling.
- GaussianNoise (:381), RandomPatchEraser (:429), RandomFlip (:524),
  Resize (:1142), CenterCrop (:238), GenerateFBCheckFlowOcclusion (:139).

Host-side numpy, run in the DataLoader's workers: nothing here touches the
card.  ``GenerateFBCheckFlowOcclusion`` warps with the port's
``ops/warp.py::backward_warp`` on CPU tensors, where the JAX package uses
its own ``backward_warp``.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.warp import backward_warp

BINARY_KEYS = ("mbs", "occs", "valids", "mbs_b", "occs_b", "valids_b")
FLOW_KEYS = ("flows", "flows_b")
OCC_KEYS = ("occs", "occs_b")


def _is_array(v):
    return isinstance(v, np.ndarray)


def _resize_bilinear_nchw(v: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """align_corners=True bilinear resize of NCHW numpy."""
    n, c, h, w = v.shape
    oh, ow = size
    if (oh, ow) == (h, w):
        return v
    ys = np.linspace(0, h - 1, oh) if oh > 1 else np.zeros(1)
    xs = np.linspace(0, w - 1, ow) if ow > 1 else np.zeros(1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[None, None, :, None]
    wx = (xs - x0)[None, None, None, :]
    top = v[:, :, y0][:, :, :, x0] * (1 - wx) + v[:, :, y0][:, :, :, x1] * wx
    bot = v[:, :, y1][:, :, :, x0] * (1 - wx) + v[:, :, y1][:, :, :, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(v.dtype)


def _resize_nearest_nchw(v: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    n, c, h, w = v.shape
    oh, ow = size
    ys = np.floor(np.arange(oh) * (h / oh)).astype(np.int64)
    xs = np.floor(np.arange(ow) * (w / ow)).astype(np.int64)
    return v[:, :, ys][:, :, :, xs]


def resize_dict(inputs: Dict[str, np.ndarray], target_size: Tuple[int, int],
                sparse: bool = False, valid_key: str = "valids",
                ignore_keys: Optional[Sequence[str]] = None):
    """Reference ``_resize`` (dense + sparse scatter variants)."""
    if sparse:
        assert valid_key in inputs
        valids = inputs[valid_key]
        n, k, h, w = valids.shape
        hs, ws = target_size
        scale = np.array([ws / w, hs / h], np.float32)
        valids_out = np.zeros((n, k, hs, ws), np.float32)
        scatter = []
        for i in range(n):
            vmask = valids[i, 0] >= 1
            yy, xx = np.nonzero(vmask)
            xs = np.round(xx * scale[0]).astype(np.int64)
            ys = np.round(yy * scale[1]).astype(np.int64)
            inb = (xs > 0) & (xs < ws) & (ys > 0) & (ys < hs)
            scatter.append((yy[inb], xx[inb], ys[inb], xs[inb]))
            valids_out[i, 0, ys[inb], xs[inb]] = 1
        inputs[valid_key] = valids_out
        for key, v in inputs.items():
            if key == valid_key or not _is_array(v):
                continue
            if ignore_keys is not None and key in ignore_keys:
                continue
            if key in BINARY_KEYS or key in FLOW_KEYS:
                out = np.zeros((v.shape[0], v.shape[1], hs, ws), v.dtype)
                for i in range(v.shape[0]):
                    yy, xx, ys, xs = scatter[min(i, len(scatter) - 1)]
                    vals = v[i, :, yy, xx]
                    if key in FLOW_KEYS:
                        vals = vals * scale[None]
                    out[i, :, ys, xs] = vals
                inputs[key] = out
            else:
                inputs[key] = _resize_bilinear_nchw(v, target_size)
    else:
        for key, v in inputs.items():
            if not _is_array(v):
                continue
            if ignore_keys is not None and key in ignore_keys:
                continue
            h, w = v.shape[-2:]
            if key in BINARY_KEYS:
                v = _resize_nearest_nchw(v, target_size)
            else:
                v = _resize_bilinear_nchw(v, target_size)
            if key in FLOW_KEYS:
                mult = np.array([target_size[1] / w, target_size[0] / h],
                                v.dtype)[None, :, None, None]
                v = v * mult
            inputs[key] = v
    return inputs


def _update_oob_flows(occs: np.ndarray, flows: np.ndarray) -> np.ndarray:
    n, _, h, w = flows.shape
    gy, gx = np.meshgrid(np.arange(h, dtype=flows.dtype),
                         np.arange(w, dtype=flows.dtype), indexing="ij")
    coords_x = flows[:, 0] + gx
    coords_y = flows[:, 1] + gy
    oob = (coords_x < 0) | (coords_x > w) | (coords_y < 0) | (coords_y > h)
    return np.maximum(occs, oob[:, None].astype(occs.dtype))


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, inputs):
        for t in self.transforms:
            inputs = t(inputs)
        return inputs


class ToTensor:
    """No-op placeholder for API parity: the dataset already produces
    stacked NCHW float arrays (reference flow_transforms.py:72-139)."""

    def __call__(self, inputs):
        return inputs


class RandomScaleAndCrop:
    def __init__(self, crop_size: Optional[Tuple[int, int]] = None,
                 major_scale: Tuple[float, float] = (0.0, 0.0),
                 space_scale: Union[Tuple[float, ...], Tuple[float, float]] = (0.0, 0.0),
                 time_scale: Tuple[float, ...] = (0.0, 0.0),
                 sparse: bool = False, valid_key: str = "valids"):
        self.crop_size = crop_size
        self.major_scale = major_scale
        ss = tuple(space_scale)
        self.space_scale = ss if len(ss) == 4 else (ss[0], ss[1], ss[0], ss[1])
        self.sparse = sparse
        self.valid_key = valid_key

    def __call__(self, inputs):
        ref_key = "flows" if "flows" in inputs else "images"
        h, w = inputs[ref_key].shape[2:4]
        major = 2 ** random.uniform(self.major_scale[0], self.major_scale[1])
        ssh = 2 ** random.uniform(self.space_scale[0], self.space_scale[1])
        ssw = 2 ** random.uniform(self.space_scale[2], self.space_scale[3])
        min_size = self.crop_size or (1, 1)
        scaled = (max(min_size[0], int(h * major * ssh)),
                  max(min_size[1], int(w * major * ssw)))
        inputs = resize_dict(inputs, scaled, sparse=self.sparse,
                             valid_key=self.valid_key)
        if self.crop_size is not None:
            y0 = random.randint(0, scaled[0] - self.crop_size[0])
            x0 = random.randint(0, scaled[1] - self.crop_size[1])
            for k, v in inputs.items():
                if _is_array(v):
                    inputs[k] = v[:, :, y0:y0 + self.crop_size[0],
                                  x0:x0 + self.crop_size[1]]
        for occ_key, flow_key in zip(OCC_KEYS, FLOW_KEYS):
            if occ_key in inputs and flow_key in inputs:
                inputs[occ_key] = _update_oob_flows(inputs[occ_key],
                                                    inputs[flow_key])
        return inputs


class Resize:
    def __init__(self, size: Tuple[int, int], sparse: bool = False):
        self.size = size
        self.sparse = sparse

    def __call__(self, inputs):
        return resize_dict(inputs, self.size, sparse=self.sparse)


class CenterCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, inputs):
        for k, v in inputs.items():
            if _is_array(v):
                h, w = v.shape[-2:]
                y0 = max(0, (h - self.size[0]) // 2)
                x0 = max(0, (w - self.size[1]) // 2)
                inputs[k] = v[..., y0:y0 + self.size[0], x0:x0 + self.size[1]]
        return inputs


class RandomFlip:
    """Horizontal/vertical flips with flow component negation
    (flow_transforms.py:524-686)."""

    def __init__(self, prob_horizontal: float = 0.5,
                 prob_vertical: float = 0.0):
        self.ph = prob_horizontal
        self.pv = prob_vertical

    def __call__(self, inputs):
        if random.random() < self.ph:
            for k, v in inputs.items():
                if _is_array(v):
                    v = v[..., ::-1].copy()
                    if k in FLOW_KEYS:
                        v[:, 0] = -v[:, 0]
                    inputs[k] = v
        if random.random() < self.pv:
            for k, v in inputs.items():
                if _is_array(v):
                    v = v[..., ::-1, :].copy()
                    if k in FLOW_KEYS:
                        v[:, 1] = -v[:, 1]
                    inputs[k] = v
        return inputs


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter, optionally asymmetric
    per-frame (flow_transforms.py:310-381).  Operates on [0,1] images."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0,
                 asymmetric_prob: float = 0.0):
        def rng(v, center=1.0, lo=0.0):
            if isinstance(v, (tuple, list)):
                return tuple(v)
            return (max(lo, center - v), center + v)

        self.brightness = rng(brightness)
        self.contrast = rng(contrast)
        self.saturation = rng(saturation)
        self.hue = (-hue, hue) if not isinstance(hue, (tuple, list)) else tuple(hue)
        self.asymmetric_prob = asymmetric_prob

    # ITU-R 601 luma weights, applied positionally on the channel axis like
    # torchvision's rgb_to_grayscale (the reference wraps
    # torchvision.transforms.ColorJitter, flow_transforms.py:310-381).
    _LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)

    def _jitter_stack(self, imgs: np.ndarray) -> np.ndarray:
        """imgs: (N, C, H, W) in [0, 1]; one factor per op shared across the
        N frames, contrast mean computed per frame (torchvision
        adjust_contrast semantics on a batched tensor)."""
        luma = self._LUMA[None, :, None, None]
        ops = list(range(4))
        random.shuffle(ops)
        for op in ops:
            if op == 0:
                f = random.uniform(*self.brightness)
                imgs = imgs * f
            elif op == 1:
                f = random.uniform(*self.contrast)
                gray = (imgs * luma).sum(axis=1, keepdims=True)
                mean = gray.mean(axis=(1, 2, 3), keepdims=True)
                imgs = (imgs - mean) * f + mean
            elif op == 2:
                f = random.uniform(*self.saturation)
                gray = (imgs * luma).sum(axis=1, keepdims=True)
                imgs = (imgs - gray) * f + gray
            elif op == 3 and (self.hue[0] != 0 or self.hue[1] != 0):
                shift = random.uniform(*self.hue)
                imgs = np.stack([_shift_hue(im, shift) for im in imgs])
            imgs = np.clip(imgs, 0.0, 1.0)
        return imgs

    def __call__(self, inputs):
        imgs = inputs.get("images")
        if imgs is None:
            return inputs
        if random.random() < self.asymmetric_prob:
            out = np.concatenate([self._jitter_stack(im[None])
                                  for im in imgs])
        else:
            out = self._jitter_stack(imgs)
        inputs["images"] = out.astype(np.float32)
        return inputs


def _shift_hue(img_chw: np.ndarray, shift: float) -> np.ndarray:
    """Shift hue of a (3, H, W) image by ``shift`` (fraction of the wheel)."""
    import colorsys  # noqa: F401  (documented reference algorithm)

    r, g, b = img_chw[0], img_chw[1], img_chw[2]
    maxc = np.max(img_chw, axis=0)
    minc = np.min(img_chw, axis=0)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    rc = np.where(delta > 0, (maxc - r) / np.maximum(delta, 1e-12), 0.0)
    gc = np.where(delta > 0, (maxc - g) / np.maximum(delta, 1e-12), 0.0)
    bc = np.where(delta > 0, (maxc - b) / np.maximum(delta, 1e-12), 0.0)
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = (h + shift) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2])


class GaussianNoise:
    def __init__(self, stdev: float = 0.0):
        self.stdev = stdev

    def __call__(self, inputs):
        if "images" in inputs:
            std = random.uniform(0.0, self.stdev)
            v = inputs["images"]
            noise = std * np.random.randn(*v.shape).astype(v.dtype)
            inputs["images"] = np.clip(v + noise, 0.0, 1.0)
        return inputs


class RandomPatchEraser:
    """Covers random patches of the second image with mean color to create
    pseudo-occlusions (flow_transforms.py:429-524)."""

    def __init__(self, prob: float = 0.0, inside_bounds=((50, 100), (50, 100)),
                 num_patches: int = 1, noise_type: str = "mean"):
        self.prob = prob
        self.bounds = inside_bounds
        self.num_patches = num_patches
        self.noise_type = noise_type

    def __call__(self, inputs):
        if random.random() >= self.prob or "images" not in inputs:
            return inputs
        imgs = inputs["images"]
        if imgs.shape[0] < 2:
            return inputs
        img2 = imgs[1]
        h, w = img2.shape[-2:]
        mean_color = img2.reshape(img2.shape[0], -1).mean(axis=1)
        for _ in range(random.randint(1, self.num_patches)):
            dy = random.randint(self.bounds[0][0],
                                min(self.bounds[0][1], h - 1))
            dx = random.randint(self.bounds[1][0],
                                min(self.bounds[1][1], w - 1))
            y0 = random.randint(0, h - dy)
            x0 = random.randint(0, w - dx)
            if self.noise_type == "mean":
                img2[:, y0:y0 + dy, x0:x0 + dx] = mean_color[:, None, None]
            else:
                img2[:, y0:y0 + dy, x0:x0 + dx] = np.random.rand(
                    img2.shape[0], dy, dx).astype(img2.dtype)
        inputs["images"] = imgs
        return inputs


class GenerateFBCheckFlowOcclusion:
    """Generates occlusion masks from forward/backward consistency
    (flow_transforms.py:139-238), used when datasets lack occ GT."""

    def __init__(self, threshold: float = 1.0):
        self.threshold = threshold

    def __call__(self, inputs):
        if "flows" not in inputs or "flows_b" not in inputs:
            return inputs
        fw = torch.from_numpy(np.ascontiguousarray(inputs["flows"]))
        bw = torch.from_numpy(np.ascontiguousarray(inputs["flows_b"]))

        def occ_of(f, b):
            warped, valid = backward_warp(b, f, return_mask=True)
            diff = torch.linalg.vector_norm(f + warped, dim=1, keepdim=True)
            return ~((diff < self.threshold) & (valid > 0.5))

        inputs["occs"] = occ_of(fw, bw).numpy().astype(np.float32)
        inputs["occs_b"] = occ_of(bw, fw).numpy().astype(np.float32)
        return inputs


def _np_grid_sample(x: np.ndarray, grid: np.ndarray,
                    mode: str = "bilinear") -> np.ndarray:
    """torch F.grid_sample on NCHW numpy input (align_corners=True for
    bilinear, torch default semantics for nearest), zero padding.

    grid: (N, H, W, 2) normalized coords in [-1, 1].
    """
    n, c, h, w = x.shape
    if mode == "nearest":
        # torch default align_corners=False mapping (the reference calls
        # nearest grid_sample without align_corners)
        gx = ((grid[..., 0] + 1) * w - 1) / 2
        gy = ((grid[..., 1] + 1) * h - 1) / 2
        ix = np.round(gx).astype(np.int64)
        iy = np.round(gy).astype(np.int64)
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        ixc = np.clip(ix, 0, w - 1)
        iyc = np.clip(iy, 0, h - 1)
        out = x[np.arange(n)[:, None, None], :, iyc, ixc]
        out = np.moveaxis(out, -1, 1) * valid[:, None].astype(x.dtype)
        return out
    gx = (grid[..., 0] + 1) * (w - 1) / 2
    gy = (grid[..., 1] + 1) * (h - 1) / 2
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    fx = (gx - x0).astype(x.dtype)
    fy = (gy - y0).astype(x.dtype)
    out = np.zeros_like(x)
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            xic = np.clip(xi, 0, w - 1)
            yic = np.clip(yi, 0, h - 1)
            v = x[np.arange(n)[:, None, None], :, yic, xic]
            v = np.moveaxis(v, -1, 1)
            out = out + v * (wgt * valid.astype(x.dtype))[:, None]
    return out


class RandomTranslate:
    """Alternated-crop translation between consecutive frames
    (flow_transforms.py:879-962)."""

    def __init__(self, translation=0):
        if not isinstance(translation, (tuple, list)):
            translation = (translation, translation)
        self.translation = tuple(translation)

    def __call__(self, inputs):
        if "flows" not in inputs:
            return inputs
        _, _, h, w = inputs["flows"].shape
        th, tw = self.translation
        tw = random.randint(-tw, tw)
        th = random.randint(-th, th)
        if tw == 0 and th == 0:
            return inputs
        out = {}
        for t in range(2):
            ftw, fth = (tw, th) if t == 0 else (-tw, -th)
            x1, x2 = max(0, ftw), min(w + ftw, w)
            y1, y2 = max(0, fth), min(h + fth, h)
            for k, v in inputs.items():
                if not _is_array(v):
                    out[k] = v
                    continue
                if k not in out:
                    out[k] = np.empty_like(
                        v[:, :, :h - abs(th), :w - abs(tw)])
                out[k][t::2] = v[t::2, :, y1:y2, x1:x2]
                if k in FLOW_KEYS:
                    out[k][t::2, 0] += ftw
                    out[k][t::2, 1] += fth
        for occ_key, flow_key in zip(OCC_KEYS, FLOW_KEYS):
            if occ_key in out and flow_key in out:
                out[occ_key] = _update_oob_flows(out[occ_key],
                                                 out[flow_key])
        return out


class RandomRotate:
    """Alternated rotation around the image center
    (flow_transforms.py:964-1140): a shared major angle plus an alternating
    inter-frame angle; flows get the rotation-field offset added and their
    components rotated (twice, reproducing the reference's behavior
    exactly)."""

    def __init__(self, angle: float = 0.0, diff_angle: float = 0.0,
                 sparse: bool = False):
        self.angle = angle
        self.diff_angle = diff_angle
        self.sparse = sparse

    def __call__(self, inputs):
        if "flows" not in inputs:
            return inputs
        major_angle = random.uniform(-self.angle, self.angle)
        inter_angle = random.uniform(-self.diff_angle, self.diff_angle)
        b, _, h, w = inputs["flows"].shape

        def rotation_grid(rot_angle, batch):
            vy, vx = np.meshgrid(np.arange(h, dtype=np.float32),
                                 np.arange(w, dtype=np.float32),
                                 indexing="ij")
            vx = vx - (w - 1.0) / 2.0
            vy = vy - (h - 1.0) / 2.0
            rad = rot_angle * 2 * np.pi / 360
            rotx = (np.cos(rad) * vx - np.sin(rad) * vy) / ((w - 1) / 2)
            roty = (np.sin(rad) * vx + np.cos(rad) * vy) / ((h - 1) / 2)
            g = np.stack([rotx, roty], axis=2)[None]
            return np.repeat(g, batch, axis=0)

        def rotation_matrix(rot_angle, batch):
            vx, vy = np.meshgrid(np.arange(h, dtype=np.float32),
                                 np.arange(w, dtype=np.float32),
                                 indexing="ij")
            rotx = (vx - h / 2.0) * (rot_angle * np.pi / 180.0)
            roty = -(vy - w / 2.0) * (rot_angle * np.pi / 180.0)
            m = np.stack([rotx, roty], axis=0)[None]
            return np.repeat(m, batch, axis=0)

        def rotate_flow(flow, rot_angle):
            rad = rot_angle * 2 * np.pi / 360
            rot = flow.copy()
            rot[:, 0] = np.cos(rad) * flow[:, 0] + np.sin(rad) * flow[:, 1]
            rot[:, 1] = -np.sin(rad) * flow[:, 0] + np.cos(rad) * flow[:, 1]
            return rot

        rot_mat = rotation_matrix(inter_angle, b // 2 + 1)
        for t in range(2):
            inangle = -inter_angle if t == 0 else inter_angle
            rmat = rot_mat if t == 0 else -rot_mat
            angle = major_angle + inangle / 2
            num_flows = inputs["flows"][t::2].shape[0]
            grid = rotation_grid(angle, num_flows + 1)
            for k in list(inputs.keys()):
                v = inputs[k]
                if not _is_array(v):
                    continue
                if k in FLOW_KEYS:
                    v = v.copy()
                    v[t::2] += rmat[:num_flows]
                sel = v[t::2]
                if k in BINARY_KEYS:
                    v[t::2] = _np_grid_sample(sel, grid[:sel.shape[0]],
                                              mode="nearest")
                else:
                    if k in FLOW_KEYS:
                        mode = "nearest" if self.sparse else "bilinear"
                        v[t::2] = _np_grid_sample(sel, grid[:sel.shape[0]],
                                                  mode=mode)
                        v[t::2] = rotate_flow(v[t::2], angle)
                    else:
                        v[t::2] = _np_grid_sample(sel, grid[:sel.shape[0]],
                                                  mode="bilinear")
                if k in FLOW_KEYS:
                    # the reference applies rotate_flow a second time here
                    # (flow_transforms.py:1125-1126); reproduced faithfully
                    v[t::2] = rotate_flow(v[t::2], angle)
                inputs[k] = v
        for occ_key, flow_key in zip(OCC_KEYS, FLOW_KEYS):
            if occ_key in inputs and flow_key in inputs:
                inputs[occ_key] = _update_oob_flows(inputs[occ_key],
                                                    inputs[flow_key])
        return inputs
