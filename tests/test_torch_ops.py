"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both; the port is NCHW and the
JAX package NHWC, so results are transposed once here.  On the CPU the
port's lookup takes its plain version; ``test_torch_kernels.py`` holds the
CUDA kernel against that plain version on a card.
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax.numpy as jnp

from ptlflow_tpu.ops import correlation as jcorr
from ptlflow_tpu.ops import resize as jresize
from ptlflow_tpu.ops import upsample as jup
from ptlflow_tpu.ops.grid_sample import interpolate as jinterpolate
from ptlflow_tpu_torch.ops import correlation as tcorr
from ptlflow_tpu_torch.ops import resize as tresize
from ptlflow_tpu_torch.ops import upsample as tup
from ptlflow_tpu_torch.ops.grid_sample import interpolate as tinterpolate


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def _pyramids(rng, shape1, shape2, c=16, levels=4, dtype=None):
    """The same pyramid for both packages: JAX levels (Q, h, w, 1) and the
    port's (Q, h, w), both from the JAX package's build_corr_pyramid."""
    f1 = jnp.asarray(rng.randn(*shape1, c).astype(np.float32))
    f2 = jnp.asarray(rng.randn(*shape2, c).astype(np.float32))
    jpyr = jcorr.build_corr_pyramid(f1, f2, levels, dtype=dtype)
    tdt = torch.bfloat16 if dtype is not None else torch.float32
    tpyr = [torch.from_numpy(np.array(p[..., 0].astype(jnp.float32)))
            .to(tdt) for p in jpyr]
    return jpyr, tpyr


def _coords(rng, b, h, w, lo, hi):
    """In-range, fractional and out-of-range sample points."""
    return (rng.rand(b, h, w, 2) * (hi - lo) + lo).astype(np.float32)


# ----------------------------------------------------------------- lookup
@pytest.mark.parametrize("radius", [3, 4])
def test_lookup_fp32_matches_jax_and_pallas(radius):
    rng = np.random.RandomState(20 + radius)
    b, h, w = 1, 8, 12  # Q = 96, which the Pallas query tile divides
    jpyr, tpyr = _pyramids(rng, (b, h, w), (b, h, w))
    coords = _coords(rng, b, h, w, -6.0, 18.0)

    got = tcorr.corr_pyramid_lookup(tpyr, nchw(coords), radius)
    n = 2 * radius + 1
    assert got.shape == (b, 4 * n * n, h, w) and got.dtype == torch.float32
    ungrouped = np.asarray(jcorr.corr_pyramid_lookup(
        jpyr, jnp.asarray(coords), radius, group=0))
    pallas = np.asarray(jcorr._lookup_pallas(jpyr, jnp.asarray(coords),
                                             radius))
    np.testing.assert_allclose(nhwc(got), ungrouped, atol=1e-5)
    np.testing.assert_allclose(nhwc(got), pallas, atol=1e-5)
    # the window reaches outside the map somewhere, so zero padding is hit
    assert (np.abs(coords) > 8).any()


def test_lookup_prime_query_count():
    """Q = 37 has no divisor: the kernel and its plain version take any Q."""
    rng = np.random.RandomState(21)
    jpyr, tpyr = _pyramids(rng, (1, 1, 37), (1, 8, 12), c=8)
    coords = _coords(rng, 1, 1, 37, -3.0, 14.0)
    got = tcorr.corr_pyramid_lookup(tpyr, nchw(coords), 4)
    want = np.asarray(jcorr.corr_pyramid_lookup(jpyr, jnp.asarray(coords), 4,
                                                group=0))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


def test_lookup_bf16_pyramid():
    """bf16 levels: the port accumulates in fp32 and rounds once, the JAX
    path rounds between its two contractions, so they agree to bf16
    rounding: 2% of the largest value, compared in fp32."""
    rng = np.random.RandomState(22)
    b, h, w = 1, 8, 16
    jpyr, tpyr = _pyramids(rng, (b, h, w), (b, h, w), c=32,
                           dtype=jnp.bfloat16)
    coords = _coords(rng, b, h, w, -3.0, 19.0)
    got = tcorr.corr_pyramid_lookup(tpyr, nchw(coords), 4)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jcorr.corr_pyramid_lookup(
        jpyr, jnp.asarray(coords), 4, group=0).astype(jnp.float32))
    assert np.abs(nhwc(got) - want).max() < 0.02 * np.abs(want).max()


def test_plain_lookup_empty_levels_match_jax():
    """5x5 maps pool to 2x2, 1x1 and 0x0: the empty level reads zeros and
    the lookup still returns all L*(2r+1)^2 channels, as in JAX."""
    rng = np.random.RandomState(32)
    jpyr, tpyr = _pyramids(rng, (1, 5, 5), (1, 5, 5), c=8)
    assert tuple(tpyr[-1].shape) == (25, 0, 0)
    coords = _coords(rng, 1, 5, 5, -2.0, 7.0)
    got = tcorr.corr_pyramid_lookup(tpyr, nchw(coords), 4)
    assert got.shape == (1, 4 * 81, 5, 5)
    assert not got[:, 3 * 81:].any()
    for group in (0, None):
        want = np.asarray(jcorr.corr_pyramid_lookup(
            jpyr, jnp.asarray(coords), 4, group=group))
        np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


# ------------------------------------------------------ pyramid and grid
@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
def test_build_corr_pyramid_matches_jax(dtype):
    rng = np.random.RandomState(26)
    f1 = rng.randn(2, 8, 12, 16).astype(np.float32)
    f2 = rng.randn(2, 8, 12, 16).astype(np.float32)
    want = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4,
                                    dtype=dtype)
    tdt = None if dtype is None else torch.bfloat16
    got = tcorr.build_corr_pyramid(nchw(f1), nchw(f2), 4, dtype=tdt)
    assert [tuple(g.shape) for g in got] == [tuple(p.shape[:3])
                                             for p in want]
    for g, p in zip(got, want):
        ref = np.asarray(p[..., 0].astype(jnp.float32))
        if dtype is None:
            np.testing.assert_allclose(g.numpy(), ref, atol=1e-5)
        else:
            assert g.dtype == torch.bfloat16
            # one bf16 rounding of the same fp32 product
            np.testing.assert_allclose(g.float().numpy(), ref,
                                       atol=1e-2 * np.abs(ref).max())


@pytest.mark.parametrize("size", [(5, 5), (3, 3), (2, 7)])
def test_build_corr_pyramid_small_maps_match_jax(size):
    """Sides under 2 px pool to 0 px as the JAX package's avg_pool2d
    floors them: the levels are empty, not an error."""
    rng = np.random.RandomState(33)
    f1 = rng.randn(1, *size, 8).astype(np.float32)
    f2 = rng.randn(1, *size, 8).astype(np.float32)
    want = jcorr.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = tcorr.build_corr_pyramid(nchw(f1), nchw(f2), 4)
    assert [tuple(g.shape) for g in got] == [tuple(p.shape[:3])
                                             for p in want]
    assert got[-1].numel() == 0
    for g, p in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(p[..., 0]),
                                   atol=1e-5)


def test_coords_grid_matches_jax():
    want = np.asarray(jcorr.coords_grid(2, 5, 7))
    got = tcorr.coords_grid(2, 5, 7)
    assert got.shape == (2, 2, 5, 7)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


# ------------------------------------------------------------- upsample
def test_convex_upsample_matches_jax():
    rng = np.random.RandomState(27)
    flow = rng.randn(2, 6, 9, 2).astype(np.float32)
    mask = rng.randn(2, 6, 9, 9 * 64).astype(np.float32)
    want = np.asarray(jup.convex_upsample(jnp.asarray(flow),
                                          jnp.asarray(mask)))
    got = tup.convex_upsample(nchw(flow), nchw(mask))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


def test_upflow_matches_jax():
    rng = np.random.RandomState(28)
    flow = rng.randn(1, 5, 7, 2).astype(np.float32)
    want = np.asarray(jup.upflow(jnp.asarray(flow), 8))
    np.testing.assert_allclose(nhwc(tup.upflow(nchw(flow), 8)), want,
                               atol=1e-5)


@pytest.mark.parametrize("mode,align", [("bilinear", True),
                                        ("bilinear", False),
                                        ("nearest", False)])
def test_interpolate_matches_jax(mode, align):
    rng = np.random.RandomState(29)
    x = rng.randn(2, 9, 13, 3).astype(np.float32)
    for size in [(18, 26), (5, 7), (9, 13)]:
        want = np.asarray(jinterpolate(jnp.asarray(x), size, mode=mode,
                                       align_corners=align))
        got = tinterpolate(nchw(x), size, mode=mode, align_corners=align)
        np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


# --------------------------------------------------------------- resize
@pytest.mark.parametrize("two_side,mode", [(True, "replicate"),
                                           (False, "constant"),
                                           (True, "reflect")])
def test_input_padder_fill_unfill_matches_jax(two_side, mode):
    rng = np.random.RandomState(30)
    x = rng.rand(2, 2, 61, 83, 3).astype(np.float32)  # (B, N, H, W, C)
    jp = jresize.InputPadder(x.shape, stride=8, two_side_pad=two_side,
                             pad_mode=mode, pad_value=0.5)
    tp = tresize.InputPadder(x.shape[:-3] + (3, 61, 83), stride=8,
                             two_side_pad=two_side, pad_mode=mode,
                             pad_value=0.5)
    want = np.asarray(jp.fill(jnp.asarray(x)))
    got = tp.fill(nchw(x))
    assert got.shape[-2:] == (64, 88)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    np.testing.assert_allclose(nhwc(tp.unfill(got)),
                               np.asarray(jp.unfill(jnp.asarray(want))),
                               atol=1e-5)
    np.testing.assert_allclose(nhwc(tp.unfill(got)), x, atol=0)


def test_input_padder_sintel_shape():
    """436 rows pad to 440, two rows on each side."""
    tp = tresize.InputPadder((1, 2, 3, 436, 1024), stride=8)
    assert tp._pad == (0, 0, 2, 2)


@pytest.mark.parametrize("align", [True, False])
def test_input_scaler_fill_unfill_matches_jax(align):
    rng = np.random.RandomState(31)
    x = rng.randn(1, 2, 20, 30, 2).astype(np.float32)
    js = jresize.InputScaler(x.shape, stride=8,
                             interpolation_align_corners=align)
    ts = tresize.InputScaler((1, 2, 2, 20, 30), stride=8,
                             interpolation_align_corners=align)
    want = np.asarray(js.fill(jnp.asarray(x), is_flow=True))
    got = ts.fill(nchw(x), is_flow=True)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    np.testing.assert_allclose(
        nhwc(ts.unfill(got, is_flow=True)),
        np.asarray(js.unfill(jnp.asarray(want), is_flow=True)), atol=1e-5)
