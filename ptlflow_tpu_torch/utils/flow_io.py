"""Flow-format codecs: .flo, KITTI .png (64x/128x), .pfm, .flo5, .npy,
Kubric PNG, VIPER npz.

Format behavior matches the reference wrappers
(ptlflow's ptlflow/utils/flow_utils.py:78-246 and the codecs in
ptlflow/utils/external/{flowpy.py,flow_IO.py,raft.py,selflow.py}):
- .flo: "PIEH" magic, W,H uint32, float32 HWC2; |v|>1e9 -> NaN on read.
- KITTI .png: 16-bit RGB; flow = (png[..., :2] - 2^15) / mult, invalid
  (channel 2 == 0) -> NaN; mult=64 (".png") or 128 (".png128", Spring).
- .pfm: Middlebury PFM; color PFM stores (u, v, mask), mask>0.5 -> NaN.
- .flo5: HDF5 with a "flow" dataset (Spring).
- Kubric PNG: uint16 channels 1: scaled by data_ranges.json min/max.
- VIPER npz: u/v arrays, |v|>512 -> NaN.

All functions take/return numpy HWC float32 arrays (host-side IO layer).
A copy of ``ptlflow_tpu/utils/flow_io.py`` that reads and writes 16-bit PNGs
through ``image_io`` (numpy and zlib) in place of OpenCV; ``.flo5`` needs
``h5py``, and says so where it is absent.
"""

from __future__ import annotations

import json
import re
import struct
from pathlib import Path
from typing import Any, Optional, Sequence, Union

import numpy as np

from . import image_io

PathLike = Union[str, Path]


# ---------------------------------------------------------------------- .flo

def read_flo(path: PathLike) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"PIEH":
            raise IOError(f"{path} does not have a .flo signature")
        width, height = struct.unpack("II", f.read(8))
        data = np.fromfile(f, dtype=np.float32).reshape(height, width, 2)
    invalid = np.zeros(data.shape[:2], bool)
    with np.errstate(invalid="ignore"):
        invalid |= np.abs(data[..., 0]) > 1e9
        invalid |= np.abs(data[..., 1]) > 1e9
    data[invalid] = np.nan
    return data


def write_flo(path: PathLike, flow: np.ndarray) -> None:
    SENTINEL = 1666666800.0
    height, width, _ = flow.shape
    out = flow.astype(np.float32).copy()
    out[np.isnan(out)] = SENTINEL
    with open(path, "wb") as f:
        f.write(b"PIEH")
        f.write(struct.pack("II", width, height))
        out.tofile(f)


# ------------------------------------------------------------- KITTI 16b png

def read_flow_png(path: PathLike, mult: float = 64.0) -> np.ndarray:
    img = image_io.imread(path, image_io.IMREAD_UNCHANGED)
    # imread gives BGR; KITTI png stores (u, v, valid) as RGB -> reverse
    img = img[..., ::-1].astype(np.float32)
    flow = (img[..., :2] - 2 ** 15) / mult
    valid = img[..., 2] > 0
    flow[~valid] = np.nan
    return flow


def write_flow_png(path: PathLike, flow: np.ndarray,
                   mult: float = 64.0) -> None:
    height, width, _ = flow.shape
    valid = ~(np.isnan(flow[..., 0]) | np.isnan(flow[..., 1]))
    out = flow.copy()
    out[~valid] = 0.0
    out = (out * mult + 2 ** 15).astype(np.uint16)
    rgb = np.dstack((out, valid.astype(np.uint16)))
    image_io.imwrite(path, rgb[..., ::-1])  # write as BGR so file is RGB


# ----------------------------------------------------------------------- pfm

def read_pfm(path: PathLike) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim_match = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.flipud(data.reshape(shape))
    if color:
        mask = np.tile(data[:, :, 2:3], (1, 1, 2))
        flow = data[:, :, :2].astype(np.float32)
        flow[mask > 0.5] = np.nan
        return flow
    return data.astype(np.float32)


def write_pfm(path: PathLike, data: np.ndarray, scale: float = 1.0) -> None:
    data = np.asarray(data, np.float32)
    if data.ndim == 3 and data.shape[2] == 2:
        # store (u, v, 0-mask) as color PFM, matching FlyingThings layout
        data = np.concatenate(
            [data, np.zeros_like(data[..., :1])], axis=-1)
        data = np.nan_to_num(data)
    color = data.ndim == 3 and data.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        endian = data.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        np.flipud(data).tofile(f)


# ---------------------------------------------------------------------- flo5

def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(".flo5 flow files (Spring) need h5py, which is not "
                          "installed") from e
    return h5py


def read_flo5(path: PathLike) -> np.ndarray:
    h5py = _h5py()

    with h5py.File(path, "r") as f:
        if "flow" not in f.keys():
            raise IOError(f"{path} has no 'flow' key; not a valid flo5 file")
        return f["flow"][()]


def write_flo5(path: PathLike, flow: np.ndarray) -> None:
    h5py = _h5py()

    with h5py.File(path, "w") as f:
        f.create_dataset("flow", data=flow, compression="gzip",
                         compression_opts=5)


# --------------------------------------------------------- kubric/viper misc

def read_kubric_flow(path: PathLike, flow_direction: str) -> np.ndarray:
    with open(Path(path).parent / "data_ranges.json", "r") as f:
        data_ranges = json.load(f)
    lo = data_ranges[flow_direction]["min"]
    hi = data_ranges[flow_direction]["max"]
    flow = image_io.imread(path, image_io.IMREAD_UNCHANGED)[..., 1:].astype(
        np.float32)
    return flow / 65535 * (hi - lo) + lo


def read_viper_flow(path: PathLike) -> np.ndarray:
    flow_npz = np.load(path)
    flow = np.stack([flow_npz["u"], flow_npz["v"]], 2).astype(np.float32)
    flow[np.abs(flow) > 512] = np.nan
    return flow


def write_viper_flow(path: PathLike, flow: np.ndarray) -> None:
    flow = flow.astype(np.float16)
    np.savez(path, u=flow[..., 0], v=flow[..., 1])


# ------------------------------------------------------------------ dispatch

def flow_read(input_data: Union[Sequence[Any], PathLike],
              format: Optional[str] = None) -> np.ndarray:
    """Extension-dispatched reader (flow_utils.py:78-123 contract)."""
    s = str(input_data)
    fmt = format
    if fmt == "pfm" or s.endswith("pfm"):
        return read_pfm(input_data)
    if fmt == "flo5" or s.endswith("flo5"):
        return read_flo5(input_data)
    if fmt == "npy" or s.endswith("npy"):
        return np.load(input_data)
    if fmt == "kubric_png":
        return read_kubric_flow(input_data[0], input_data[1])
    if fmt == "viper_npz":
        return read_viper_flow(input_data)
    if fmt == "png128" or s.endswith("png128"):
        return read_flow_png(s.replace("png128", "png") if s.endswith("png128")
                             else input_data, mult=128.0)
    if fmt == "png" or s.endswith("png"):
        return read_flow_png(input_data)
    return read_flo(input_data)


def flow_write(output_file: PathLike, flow: np.ndarray,
               format: Optional[str] = None) -> None:
    s = str(output_file)
    fmt = format
    if fmt == "pfm" or s.endswith("pfm"):
        return write_pfm(output_file, flow)
    if fmt == "flo5" or s.endswith("flo5"):
        return write_flo5(output_file, flow)
    if fmt == "npy" or s.endswith("npy"):
        return np.save(output_file, flow)
    if fmt == "viper_npz":
        return write_viper_flow(output_file, flow)
    if fmt == "png128" or s.endswith("png128"):
        return write_flow_png(
            s.replace("png128", "png") if s.endswith("png128") else output_file,
            flow, mult=128.0)
    if fmt == "png" or s.endswith("png"):
        return write_flow_png(output_file, flow)
    return write_flo(output_file, flow)
