"""The port's file readers and writers against OpenCV and the JAX package.

``ptlflow_tpu_torch.utils.image_io`` must decode what ``cv2.imread`` decodes,
bit for bit, for every PNG row filter, depth and channel count the
datasets hold, and for binary PPM/PGM, under the three ``imread`` flags the
JAX package uses; its files must read back in OpenCV bit for bit.  PNGs come
from a small encoder below that gives the rows filter types 0-4 in turn (so
that Average and Paeth rows sit between None, Sub and Up rows).  The copies
of ``flow_io`` and ``flow_viz`` must agree with the JAX package's on random
flows.  Tolerances: 0 (equality) throughout, NaN where NaN.
"""

import struct
import zlib

import numpy as np
import pytest

from tests._torch_threads import cap_torch_threads  # noqa: F401

from ptlflow_tpu.utils import flow_io as jflow_io
from ptlflow_tpu.utils import flow_viz as jflow_viz
from ptlflow_tpu_torch.utils import flow_io, flow_viz, image_io

cv = pytest.importorskip("cv2")


# ------------------------------------------------------------ test encoder
def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(kind, row, prev, bpp):
    """PNG filter ``kind`` of one row of bytes (int64), by the spec."""
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2,
            4: _paeth(left, prev, upleft)}[kind]
    return (row - pred) % 256


def encode_png(img, filters=(0, 1, 2, 3, 4), interlace=0, ctype=None,
               extra=b""):
    """``img`` (H, W, C) in file channel order, uint8 or uint16; row r gets
    filter ``filters[r % len(filters)]``."""
    h, w, c = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c] if ctype is None else ctype
    data = (img.astype(">u2") if depth == 16 else img).reshape(h, -1)
    data = data.view(np.uint8).astype(np.int64)
    bpp = c * depth // 8
    prev = np.zeros(data.shape[1], np.int64)
    raw = bytearray()
    for r in range(h):
        kind = filters[r % len(filters)]
        raw.append(kind)
        raw += _filter_row(kind, data[r], prev, bpp).astype(np.uint8).tobytes()
        prev = data[r]

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + extra
            + chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + chunk(b"IEND", b""))


FLAGS = [cv.IMREAD_COLOR, cv.IMREAD_GRAYSCALE, cv.IMREAD_UNCHANGED]
KINDS = [  # (channels, dtype)
    (1, np.uint8), (2, np.uint8), (3, np.uint8), (4, np.uint8),
    (1, np.uint16), (3, np.uint16), (4, np.uint16)]


def _rand_img(rng, h, w, c, dtype):
    hi = 256 if dtype == np.uint8 else 65536
    return rng.randint(0, hi, (h, w, c)).astype(dtype)


@pytest.mark.parametrize("chans,dtype", KINDS)
@pytest.mark.parametrize("filters", [(0, 1, 2, 3, 4), (4, 3, 2, 1, 0),
                                     (1, 2), (3,), (4,)])
def test_png_matches_cv2(tmp_path, chans, dtype, filters):
    """Every filter type, in runs and alone, at odd sizes, under each flag;
    one image is random noise (no byte predicts the next), one smooth."""
    rng = np.random.RandomState(chans * 7 + len(filters))
    noise = _rand_img(rng, 13, 17, chans, dtype)
    smooth = np.cumsum(noise // 64, axis=1).astype(dtype)
    for k, img in enumerate((noise, smooth)):
        path = tmp_path / f"img{k}.png"
        path.write_bytes(encode_png(img, filters))
        for flag in FLAGS:
            want = cv.imread(str(path), flag)
            got = image_io.imread(path, flag)
            assert got.dtype == want.dtype and got.shape == want.shape, flag
            np.testing.assert_array_equal(got, want)


def test_png_large_all_filters(tmp_path):
    """A 3-channel 8-bit frame wider than tall with every filter type, the
    case of the anti-diagonal unfiltering over many rows."""
    rng = np.random.RandomState(3)
    img = _rand_img(rng, 37, 91, 3, np.uint8)
    path = tmp_path / "big.png"
    path.write_bytes(encode_png(img, (4, 4, 3, 1, 0, 2, 4)))
    np.testing.assert_array_equal(image_io.imread(path), cv.imread(str(path)))
    np.testing.assert_array_equal(image_io.imread(path, -1), img[..., ::-1])


@pytest.mark.parametrize("ext,chans,dtype", [
    (".pgm", 1, np.uint8), (".ppm", 3, np.uint8), (".pgm", 1, np.uint16),
    (".ppm", 3, np.uint16)])
def test_pnm_matches_cv2(tmp_path, ext, chans, dtype):
    rng = np.random.RandomState(chans)
    img = _rand_img(rng, 11, 19, chans, dtype)
    path = tmp_path / f"img{ext}"
    assert cv.imwrite(str(path), img)
    for flag in FLAGS:
        np.testing.assert_array_equal(image_io.imread(path, flag),
                                      cv.imread(str(path), flag))
    # the port's writer, read by OpenCV
    path2 = tmp_path / f"mine{ext}"
    image_io.imwrite(path2, img)
    np.testing.assert_array_equal(cv.imread(str(path2), cv.IMREAD_UNCHANGED),
                                  img[..., 0] if chans == 1 else img)


@pytest.mark.parametrize("shape,dtype", [((9, 14), np.uint8),
                                         ((9, 14, 3), np.uint8),
                                         ((9, 14, 4), np.uint8),
                                         ((9, 14), np.uint16),
                                         ((9, 14, 3), np.uint16)])
def test_imwrite_reads_back_in_cv2(tmp_path, shape, dtype):
    rng = np.random.RandomState(len(shape))
    hi = 256 if dtype == np.uint8 else 65536
    img = rng.randint(0, hi, shape).astype(dtype)
    path = tmp_path / "out.png"
    assert image_io.imwrite(path, img)
    np.testing.assert_array_equal(cv.imread(str(path), cv.IMREAD_UNCHANGED),
                                  img)
    np.testing.assert_array_equal(image_io.imread(path, -1), img)


@pytest.mark.parametrize("case,match", [
    ("interlaced", "interlaced"), ("palette", "palette"),
    ("trns", "tRNS"), ("jpeg", "JPEG"), ("bad_crc", "CRC"),
    ("missing", "No such file")])
def test_unsupported_files_raise(tmp_path, case, match):
    img = np.zeros((4, 5, 3), np.uint8)
    path = tmp_path / "x.png"
    if case == "interlaced":
        path.write_bytes(encode_png(img, interlace=1))
    elif case == "palette":
        path.write_bytes(encode_png(img[..., :1], ctype=3))
    elif case == "trns":
        body = b"\x00\x01\x00\x02\x00\x03"
        extra = (struct.pack(">I", 6) + b"tRNS" + body
                 + struct.pack(">I", zlib.crc32(b"tRNS" + body)))
        path.write_bytes(encode_png(img, extra=extra))
    elif case == "jpeg":
        path.write_bytes(b"\xff\xd8\xff\xe0" + bytes(16))
    elif case == "bad_crc":
        data = bytearray(encode_png(img))
        data[-20] ^= 0xFF  # inside the IDAT chunk's body
        path.write_bytes(bytes(data))
    else:
        path = tmp_path / "missing.png"
    with pytest.raises((ValueError, OSError), match=match):
        image_io.imread(path)


# --------------------------------------------------------- flow_io / viz
def _rand_flow(seed, h=21, w=34, nan_share=0.0):
    rng = np.random.RandomState(seed)
    flow = (rng.randn(h, w, 2) * 20).astype(np.float32)
    flow[rng.rand(h, w) < nan_share] = np.nan
    return flow


@pytest.mark.parametrize("fmt", ["flo", "png", "pfm"])
def test_flow_io_matches_jax(tmp_path, fmt):
    """Each writer's file read by both packages, and both packages' files
    byte-compared where the formats are deterministic."""
    flow = _rand_flow(5, nan_share=0.2 if fmt in ("png", "flo") else 0.0)
    mine, theirs = tmp_path / f"m.{fmt}", tmp_path / f"j.{fmt}"
    flow_io.flow_write(mine, flow)
    jflow_io.flow_write(theirs, flow)
    for path in (mine, theirs):
        np.testing.assert_array_equal(flow_io.flow_read(path),
                                      jflow_io.flow_read(path))
    if fmt != "png":  # PNG bytes depend on the encoder's filters and zlib
        assert mine.read_bytes() == theirs.read_bytes()
    got = flow_io.flow_read(mine)
    if fmt == "png":  # 1/64 px steps, NaN where invalid
        np.testing.assert_array_equal(np.isnan(got), np.isnan(flow))
        ok = ~np.isnan(flow)
        assert np.abs(got[ok] - flow[ok]).max() <= 1 / 64
    else:
        np.testing.assert_array_equal(got, flow)


def test_flo5_needs_h5py(tmp_path, monkeypatch):
    """Spring's .flo5 needs h5py, which a PyTorch install may lack: a clear
    error, not an AttributeError deep inside."""
    import builtins

    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        flow_io.flow_read(tmp_path / "x.flo5")


@pytest.mark.parametrize("background", ["bright", "dark"])
@pytest.mark.parametrize("max_radius", [None, 7.5])
def test_flow_viz_matches_jax(background, max_radius):
    flow = _rand_flow(9, nan_share=0.1)
    np.testing.assert_array_equal(
        flow_viz.flow_to_rgb(flow, max_radius, background),
        jflow_viz.flow_to_rgb(flow, max_radius, background))


def test_jet_colormap_matches_cv2():
    ramp = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(flow_viz.apply_jet(ramp),
                                  cv.applyColorMap(ramp, cv.COLORMAP_JET))
