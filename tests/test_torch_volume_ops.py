"""The port's volume and splat ops of MEMFOF, LLA-Flow, CSFlow and
SplatFlow against the JAX package's, on the CPU (``tests/test_torch_kernels.py``
holds the kernels at these shapes and the splat on the card).

Inputs come from numpy seeds; the port is NCHW, the JAX package NHWC.  The
JAX lookup is its ungrouped XLA path (``group=0``).  Float32 sums of the
same terms in another order agree within 1e-5 of the volumes' size here.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax.numpy as jnp

from ptlflow_tpu.nn.layers import avg_pool2d as javg_pool2d
from ptlflow_tpu.ops import correlation as jcorr
from ptlflow_tpu.ops.warp import softsplat_average as jsoftsplat
from ptlflow_tpu_torch.ops import correlation as tcorr
from ptlflow_tpu_torch.ops.warp import softsplat_average
from tests.test_torch_train import nchw, nhwc

jmemfof = importlib.import_module("ptlflow_tpu.models.memfof.memfof")
tmemfof = importlib.import_module("ptlflow_tpu_torch.models.memfof.memfof")
jcs = importlib.import_module("ptlflow_tpu.models.csflow.csflow")
tcs = importlib.import_module("ptlflow_tpu_torch.models.csflow.csflow")


def features(seed, b, h, w, c, n=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, w, c).astype(np.float32) for _ in range(n)]


def coords_over(rng, b, h, w, lo=-0.3, hi=1.3):
    """(B, H, W, 2) coords from ``lo`` to ``hi`` of the map's size."""
    return ((lo + (hi - lo) * rng.rand(b, h, w, 2))
            * np.array([w, h])).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_pairs_correlation_matches_jax(dtype):
    """(B, HW, H, W) over sqrt(C), float32 whatever the features' dtype:
    within 1e-5 of the JAX package's (bf16 products are exact in fp32)."""
    f1, f2 = features(80, 2, 5, 7, 32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jcorr.all_pairs_correlation(
        jnp.asarray(f1).astype(jdt), jnp.asarray(f2).astype(jdt)))
    got = tcorr.all_pairs_correlation(nchw(f1).to(getattr(torch, dtype)),
                                      nchw(f2).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == (2, 35, 5, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_pooled_volume_pyramid_matches_jax():
    """A (Q, 5, 7) volume pooled into 4 levels, 5x7, 2x3, 1x1 and an empty
    0x0 (floored as the JAX package's ``avg_pool2d``), each within 1e-6 of
    the JAX pooling of the level before."""
    vol = np.random.RandomState(81).randn(6, 5, 7).astype(np.float32)
    got = tcorr.pool_volume_pyramid(torch.from_numpy(vol), 4)
    assert [tuple(g.shape) for g in got] == [(6, 5, 7), (6, 2, 3),
                                             (6, 1, 1), (6, 0, 0)]
    want = jnp.asarray(vol)[..., None]
    for g in got:
        np.testing.assert_allclose(g.numpy(), np.asarray(want)[..., 0],
                                   atol=1e-6)
        want = javg_pool2d(want, 2, 2)
    # an empty level reads zeros
    coords = torch.zeros(1, 2, 2, 3)
    out = tcorr.corr_pyramid_lookup(got, coords, 1)
    assert out.shape == (1, 36, 2, 3)
    assert out[:, 27:].abs().max() == 0


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_softsplat_average_matches_jax(scale):
    """Average-mode splatting of 5 channels over a 7x9 map by flows of
    ``scale`` px: sources that leave the frame are dropped, targets that
    nothing reaches stay 0, and the port is within 1e-5 of the JAX
    package's."""
    rng = np.random.RandomState(82)
    x = rng.randn(2, 7, 9, 5).astype(np.float32)
    flow = (scale * rng.randn(2, 7, 9, 2)).astype(np.float32)
    flow[0, 0, 0] = (-50.0, 3.0)  # far out of the frame
    want = np.asarray(jsoftsplat(jnp.asarray(x), jnp.asarray(flow)))
    got = nhwc(softsplat_average(nchw(x), nchw(flow)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    grid = np.stack(np.meshgrid(np.arange(9), np.arange(7)), -1)
    tgt = grid[None] + flow
    assert ((tgt[..., 0] < -1) | (tgt[..., 0] > 9)).any()
    if scale > 1:
        assert (np.abs(want).sum(-1) == 0).any()  # empty targets


def test_memfof_corr_lookup_matches_jax():
    """MEMFOF's re-correlated pyramid of a 17x30 map (levels 17x30, 8x15,
    4x7, 2x3: resized bilinearly, not 2^l-pooled) and its lookup at r = 4,
    looked up by the port's prepared lookup at coords / 2^l as by the JAX
    package's ``corr_pyramid_lookup``: levels within 1e-5, the lookup
    within 1e-4."""
    f1, f2 = features(83, 1, 17, 30, 64)
    rng = np.random.RandomState(83)
    coords = coords_over(rng, 1, 17, 30)
    jblk = jmemfof.MemfofCorrBlock(jnp.asarray(f1), jnp.asarray(f2), 4, 4)
    tblk = tmemfof.MemfofCorrBlock(nchw(f1), nchw(f2), 4, 4)
    assert [tuple(p.shape[1:]) for p in tblk.pyramid] == [
        (17, 30), (8, 15), (4, 7), (2, 3)]
    for t, j in zip(tblk.pyramid, jblk.pyramid):
        np.testing.assert_allclose(t.numpy(), np.asarray(j)[..., 0],
                                   atol=1e-5)
    want = np.asarray(jcorr.corr_pyramid_lookup(jblk.pyramid,
                                                jnp.asarray(coords), 4,
                                                group=0))
    got = nhwc(tblk(nchw(coords)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_csflow_lookup_matches_jax_two_channel_lookup():
    """CSFlow's two one-channel pyramids (the product and the strip
    volume of a 6x10 map, 4 levels down to an empty one) and their two
    lookups, interleaved level by level: equal, channel for channel,
    within 1e-5, to the JAX lookup of its two-channel volume, whose
    output is channel-major within a level."""
    f1, f2 = features(84, 2, 6, 10, 32)
    strip = np.random.RandomState(85).randn(2, 6, 10, 1, 6, 10).astype(
        np.float32)
    coords = coords_over(np.random.RandomState(84), 2, 6, 10)
    pyramid = jcs.build_csflow_pyramid(jnp.asarray(f1), jnp.asarray(f2),
                                       jnp.asarray(strip), 4)
    assert pyramid[0].shape[-1] == 2 and pyramid[-1].size == 0
    want = np.asarray(jcorr.corr_pyramid_lookup(pyramid, jnp.asarray(coords),
                                                4, group=0))
    blk = tcs.CSFlowCorrBlock(nchw(f1), nchw(f2), torch.from_numpy(strip),
                              4, 4)
    got = nhwc(blk(nchw(coords)))
    assert got.shape == (2, 6, 10, 4 * 2 * 81)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the second channel of level 0 is the strip volume's own lookup
    strip_only = nhwc(tcorr.corr_pyramid_lookup(blk.pyramids[1],
                                                nchw(coords), 4))
    np.testing.assert_allclose(got[..., 81:162], strip_only[..., :81],
                               rtol=0, atol=0)
