"""Image files without OpenCV: ``imread`` and ``imwrite`` in numpy and zlib,
returning what ``cv2.imread`` returns for the files the datasets hold.

Reads PNG (8-bit gray, gray+alpha, RGB and RGBA; 16-bit gray, gray+alpha,
RGB and RGBA; not interlaced; all five row filters) and binary PPM/PGM (P6,
P5; maxval 255 or 65535).  Writes the same PNG and PPM/PGM kinds.  The flags
are OpenCV's:

- ``IMREAD_COLOR`` (1, the default): 3-channel BGR uint8; gray is repeated,
  alpha dropped, 16-bit reduced to 8 by its high byte;
- ``IMREAD_GRAYSCALE`` (0): 1-channel uint8; colour is converted with the
  fixed-point weights OpenCV's decoders use (libpng's for PNG, ``cvtColor``'s
  for PPM), bit for bit;
- ``IMREAD_UNCHANGED`` (-1): the stored channels in BGR(A) order, uint16 for
  16-bit files; a gray+alpha PNG comes back as BGRA, as OpenCV gives it.

Anything else (JPEG, palette or interlaced PNG, bit depths under 8, a
transparency chunk, a missing file) raises with the reason; no call returns
``None``.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np
from numpy.lib.stride_tricks import as_strided

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

PathLike = Union[str, Path]
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour types: channels stored per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# libpng's rgb_to_gray coefficients for OpenCV's (0.299, 0.587), x 32768
_PNG_GRAY_RGB = (9797, 19234, 32768 - 9797 - 19234)
# cv2.cvtColor(BGR2GRAY) fixed point, x 16384
_CVT_GRAY_RGB = (4899, 9617, 1868)


class ImageFormatError(ValueError):
    """A file this reader does not decode, with the reason."""


def imread(path: PathLike, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Decode ``path`` as ``cv2.imread(path, flags)`` does, for
    ``flags`` in (``IMREAD_COLOR``, ``IMREAD_GRAYSCALE``,
    ``IMREAD_UNCHANGED``)."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED):
        raise ValueError(f"imread flags {flags} not supported; use "
                         f"IMREAD_COLOR (1), IMREAD_GRAYSCALE (0) or "
                         f"IMREAD_UNCHANGED (-1)")
    data = Path(path).read_bytes()
    if data.startswith(_PNG_SIG):
        img, weights, rounding = _decode_png(data, path), _PNG_GRAY_RGB, True
    elif data[:2] in (b"P5", b"P6"):
        img, weights, rounding = _decode_pnm(data, path), _CVT_GRAY_RGB, False
    elif data[:3] == b"\xff\xd8\xff":
        raise ImageFormatError(f"{path}: JPEG is not supported (PNG, PPM and "
                               f"PGM only)")
    else:
        raise ImageFormatError(f"{path}: not a PNG, PPM or PGM file "
                               f"(starts with {data[:8]!r})")
    return _convert(img, flags, weights, png=rounding)


def _convert(img: np.ndarray, flags: int, weights, png: bool) -> np.ndarray:
    """``img`` (H, W, C) in file order (gray, gray+alpha, RGB or RGBA) to
    what OpenCV returns for ``flags``."""
    c = img.shape[2]
    if flags == IMREAD_UNCHANGED:
        if c == 1:
            return img[:, :, 0]
        if c == 2:  # OpenCV expands gray+alpha to BGRA
            return np.ascontiguousarray(img[:, :, [0, 0, 0, 1]])
        return np.ascontiguousarray(img[:, :, [2, 1, 0, 3][:c]])
    if flags == IMREAD_COLOR:
        img8 = _to_8bit(img)
        if c <= 2:
            return np.ascontiguousarray(np.repeat(img8[:, :, :1], 3, axis=2))
        return np.ascontiguousarray(img8[:, :, 2::-1])
    # grayscale
    if c <= 2:
        return np.ascontiguousarray(_to_8bit(img[:, :, 0]))
    wr, wg, wb = weights
    if png:
        # libpng converts at the file's depth (16-bit with rounding), then
        # OpenCV strips 16-bit to 8
        src = img[:, :, :3].astype(np.int64)
        rnd = 16384 if img.dtype == np.uint16 else 0
        gray = (wr * src[..., 0] + wg * src[..., 1] + wb * src[..., 2]
                + rnd) >> 15
        return _to_8bit(gray.astype(img.dtype))
    src = _to_8bit(img[:, :, :3]).astype(np.int64)
    gray = (wr * src[..., 0] + wg * src[..., 1] + wb * src[..., 2]
            + 8192) >> 14
    return gray.astype(np.uint8)


def _to_8bit(a: np.ndarray) -> np.ndarray:
    return (a >> 8).astype(np.uint8) if a.dtype == np.uint16 else a


# ------------------------------------------------------------------ PNG read

def _decode_png(data: bytes, path) -> np.ndarray:
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ImageFormatError(f"{path}: truncated PNG chunk {ctype!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + body):
            raise ImageFormatError(f"{path}: bad CRC in PNG chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"tRNS":
            raise ImageFormatError(f"{path}: PNG transparency (tRNS) chunk "
                                   f"not supported")
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise ImageFormatError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _PNG_CHANNELS:
        kind = "palette" if ctype == 3 else "unknown"
        raise ImageFormatError(f"{path}: {kind} PNG (colour type {ctype}) "
                               f"not supported")
    if interlace:
        raise ImageFormatError(f"{path}: interlaced (Adam7) PNG not "
                               f"supported")
    if depth not in (8, 16):
        raise ImageFormatError(f"{path}: PNG bit depth {depth} not supported "
                               f"(8 and 16 only)")
    if comp or filt:
        raise ImageFormatError(f"{path}: unknown PNG compression or filter "
                               f"method")
    chans = _PNG_CHANNELS[ctype]
    bpp = chans * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ImageFormatError(f"{path}: PNG data holds {raw.size} bytes, "
                               f"expected {h * (1 + w * bpp)}")
    rows = raw.reshape(h, 1 + w * bpp)
    pix = unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp), path)
    if depth == 16:
        pix = pix.reshape(h, w * bpp).view(">u2").astype(np.uint16)
    return pix.reshape(h, w, chans)


def unfilter(ftypes: np.ndarray, filtered: np.ndarray, path="") -> np.ndarray:
    """Undo PNG's per-row filters: ``filtered`` (H, W, bpp) uint8 bytes,
    ``ftypes`` (H,) the filter type of each row.  Rows of None, Sub and Up
    only are undone row by row; Average and Paeth depend on the pixel to the
    left, so an image with such rows is undone along anti-diagonals, all
    rows at once: pixel (r, x) needs (r, x-1), (r-1, x) and (r-1, x-1),
    which lie on the two diagonals before its own."""
    h, w, bpp = filtered.shape
    if ftypes.size and ftypes.max() > 4:
        raise ImageFormatError(f"{path}: PNG row filter type "
                               f"{int(ftypes.max())} unknown")
    if not ftypes.any():
        return filtered.copy()
    if ftypes.max() <= 2:
        out = np.empty_like(filtered)
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            row, f = filtered[r], ftypes[r]
            if f == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif f == 2:
                row = row + prev
            out[r] = row
            prev = out[r]
        return out
    return _unfilter_diagonals(ftypes, filtered)


def _unfilter_diagonals(ftypes: np.ndarray, filtered: np.ndarray
                        ) -> np.ndarray:
    h, w, bpp = filtered.shape
    # buf row 0 is the zero row above the image and column 0 the zero column
    # left of it: image pixel (r, x) is buf[r + 1, x + 1]
    buf = np.zeros((h + 1, w + 1, bpp), np.int16)
    buf[1:, 1:] = filtered
    es = buf.itemsize
    # diag[e, R] = buf[R, e - R] (pixel (R - 1, e - R - 1) lies on
    # anti-diagonal d = e - 2); the last element of this view is the last of
    # buf, and only elements with 0 <= e - R <= w are read or written
    diag = as_strided(buf, shape=(h + w + 1, h + 1, bpp),
                      strides=(bpp * es, w * bpp * es, es))
    masks = [(ftypes == k).astype(np.int16)[:, None] for k in range(5)]
    use = [bool(m.any()) for m in masks]
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d) + 1
        a = diag[d + 1, r0 + 1:r1 + 1]   # left
        b = diag[d + 1, r0:r1]           # up
        c = diag[d, r0:r1]               # up-left
        pred = 0
        if use[1]:
            pred = pred + masks[1][r0:r1] * a
        if use[2]:
            pred = pred + masks[2][r0:r1] * b
        if use[3]:
            pred = pred + masks[3][r0:r1] * ((a + b) >> 1)
        if use[4]:
            pa, pb = np.abs(b - c), np.abs(a - c)
            pc = np.abs(a + b - 2 * c)
            paeth = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
            pred = pred + masks[4][r0:r1] * paeth
        cur = diag[d + 2, r0 + 1:r1 + 1]
        cur[...] = (cur + pred) & 255
    return buf[1:, 1:].astype(np.uint8)


# ------------------------------------------------------------------ PNM read

def _decode_pnm(data: bytes, path) -> np.ndarray:
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ImageFormatError(f"{path}: truncated PPM/PGM header")
        fields.append(int(data[start:pos]))
    pos += 1  # one whitespace byte ends the header
    w, h, maxval = fields
    if maxval not in (255, 65535):
        raise ImageFormatError(f"{path}: PPM/PGM maxval {maxval} not "
                               f"supported (255 or 65535)")
    chans = 3 if data[:2] == b"P6" else 1
    dtype = np.dtype(np.uint8) if maxval == 255 else np.dtype(">u2")
    n = w * h * chans
    pix = np.frombuffer(data, dtype, count=n, offset=pos)
    return pix.astype(dtype.newbyteorder("=")).reshape(h, w, chans)


# --------------------------------------------------------------------- write

def imwrite(path: PathLike, img: np.ndarray) -> bool:
    """Write ``img`` as ``cv2.imwrite(path, img)`` does: PNG for ``.png``,
    binary PPM/PGM for ``.ppm``/``.pgm``/``.pnm``.  ``img`` is (H, W) gray,
    or (H, W, C) with C = 1, 3 (BGR) or 4 (BGRA, PNG only), uint8 or
    uint16."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"imwrite: {img.dtype} image; uint8 or uint16 only")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"imwrite: image of shape {img.shape}")
    c = img.shape[2]
    rgb = img if c == 1 else img[:, :, [2, 1, 0, 3][:c]]
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        payload = _encode_png(rgb)
    elif suffix in (".ppm", ".pgm", ".pnm"):
        if c == 4:
            raise ValueError(f"imwrite: {path}: PPM holds no alpha")
        payload = _encode_pnm(rgb)
    else:
        raise ImageFormatError(f"imwrite: {path}: only .png, .ppm, .pgm and "
                               f".pnm are written")
    Path(path).write_bytes(payload)
    return True


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _encode_png(img: np.ndarray) -> bytes:
    """(H, W, C) in file channel order; every row filter None."""
    h, w, c = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    pix = img.astype(">u2") if depth == 16 else img
    rows = np.zeros((h, 1 + w * c * depth // 8), np.uint8)
    rows[:, 1:] = pix.reshape(h, -1).view(np.uint8)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def _encode_pnm(img: np.ndarray) -> bytes:
    h, w, c = img.shape
    maxval = 65535 if img.dtype == np.uint16 else 255
    head = f"{'P6' if c == 3 else 'P5'}\n{w} {h}\n{maxval}\n".encode()
    pix = img.astype(">u2") if maxval == 65535 else img
    return head + np.ascontiguousarray(pix).tobytes()

