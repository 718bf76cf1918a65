"""The port's local correlation and warps of the PWC family against the JAX
package's, on the CPU: ``local_correlation`` (the identity window, with
dilation and stride), ``bilinear_coverage`` at PWC's 0.9999 threshold,
``pwc_warp``, IRR's ``irr_warp``, ``rescale_flow`` and the 3x3
neighbourhood of its refinements."""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu.ops.correlation import local_correlation as jlocal
from ptlflow_tpu.ops.grid_sample import bilinear_coverage as jcoverage
from ptlflow_tpu.ops.grid_sample import bilinear_sampler as jsampler
from ptlflow_tpu_torch.ops import (bilinear_coverage, bilinear_sampler,
                                   local_correlation)
from tests.test_torch_train import nchw, nhwc

jpwc = importlib.import_module("ptlflow_tpu.models.pwcnet.pwcnet")
tpwc = importlib.import_module("ptlflow_tpu_torch.models.pwcnet.pwcnet")
jirr = importlib.import_module("ptlflow_tpu.models.irr.pwc_modules")
tirr = importlib.import_module("ptlflow_tpu_torch.models.irr.pwc_modules")


@pytest.mark.parametrize("d,dilation,stride", [(4, 1, 1), (3, 2, 1),
                                               (4, 1, 2), (2, 2, 2)])
def test_local_correlation_matches_jax(d, dilation, stride):
    """(2, 9, 13, 11) features (odd sides: the strided positions stop short
    of the edge): every (dy, dx) channel in row-major order within 1e-5 of
    the JAX package's, normalised by C and not; channel (d, d) of the
    unnormalised form is the plain dot product."""
    rng = np.random.RandomState(d * 10 + dilation + stride)
    f1, f2 = (rng.randn(2, 13, 11, 9).astype(np.float32) for _ in range(2))
    for normalize in (True, False):
        want = np.asarray(jlocal(jnp.asarray(f1), jnp.asarray(f2), d,
                                 normalize=normalize, dilation=dilation,
                                 stride=stride))
        got = local_correlation(nchw(f1), nchw(f2), d, normalize=normalize,
                                dilation=dilation, stride=stride)
        assert got.shape == (2, (2 * d + 1) ** 2) + want.shape[1:3]
        np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    centre = got[:, (2 * d + 1) * d + d]
    np.testing.assert_allclose(
        centre.numpy(), (f1 * f2).sum(-1)[:, ::stride, ::stride], atol=1e-5)


@pytest.mark.parametrize("d,dilation,stride", [(4, 1, 1), (3, 2, 1),
                                               (4, 1, 2), (2, 2, 2)])
def test_local_correlation_gradients_match_jax_grad(d, dilation, stride):
    """The gradients of both maps, under a random cotangent of the output,
    within 1e-5 of ``jax.grad``'s: the windows' backward scatters each
    displacement back to its strided, dilated pixels and nowhere else."""
    rng = np.random.RandomState(d * 10 + dilation + stride + 50)
    f1, f2 = (rng.randn(2, 13, 11, 9).astype(np.float32) for _ in range(2))
    n = 2 * d + 1
    ho, wo = -(-13 // stride), -(-11 // stride)
    cot = rng.randn(2, ho, wo, n * n).astype(np.float32)

    def loss(a, b):
        return jnp.sum(jlocal(a, b, d, dilation=dilation, stride=stride)
                       * cot)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f1), jnp.asarray(f2))
    t1, t2 = nchw(f1).requires_grad_(), nchw(f2).requires_grad_()
    out = local_correlation(t1, t2, d, dilation=dilation, stride=stride)
    got = torch.autograd.grad((out * nchw(cot)).sum(), (t1, t2))
    for a, b in zip(got, want):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=1e-5)


def test_local_correlation_launches():
    """Radius 4 runs one ``unfold`` of the padded map, one product and one
    channel sum, and the division by C: 4 operators that compute, where
    the JAX package slices the padded map once per displacement (81
    times)."""
    from torch.profiler import ProfilerActivity, profile

    f1, f2 = torch.randn(1, 8, 6, 7), torch.randn(1, 8, 6, 7)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        local_correlation(f1, f2, 4)
    views = ("aten::alias", "aten::unsqueeze", "aten::slice", "aten::view")
    ops = [e.name for e in prof.events()
           if e.cpu_parent is None and e.name not in views]
    assert ops == ["aten::im2col", "aten::mul", "aten::sum", "aten::div"], ops


def coords_near_edges(rng, n, h, w):
    """Pixel coords within a few rounding steps of whole pixels at and
    beyond both edges, where the sampled ones of a 2x2 stencil sit at the
    0.9999 threshold, and some spread over and past the map."""
    edge_x = np.array([0, w - 1, -1, w, 0.5, w - 1.5], np.float32)
    edge_y = np.array([0, h - 1, -1, h, 0.5, h - 1.5], np.float32)
    tiny = rng.choice([-3e-5, -1e-5, -1e-7, 0, 1e-7, 1e-5, 3e-5], (n, 2))
    base = np.stack([rng.choice(edge_x, n), rng.choice(edge_y, n)], -1)
    wide = rng.uniform(-2, [w + 1, h + 1], (n, 2))
    return np.where(rng.rand(n, 1) < 0.7, base + tiny, wide).astype(
        np.float32)


def test_bilinear_coverage_matches_jax_at_the_threshold():
    """The sampled-ones coverage at 4,000 coords near the map's edges: the
    JAX package's values within 1e-6 and the same pixels at or above
    0.9999; and the ones the sampler of an all-ones map gives."""
    rng = np.random.RandomState(7)
    h, w = 9, 13
    c = coords_near_edges(rng, 4000, h, w).reshape(2, 40, 50, 2)
    want = np.asarray(jcoverage(jnp.asarray(c), (h, w)))
    got = bilinear_coverage(nchw(c), (h, w))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)
    np.testing.assert_array_equal(nhwc(got) >= 0.9999, want >= 0.9999)
    ones = bilinear_sampler(torch.ones(2, 1, h, w), nchw(c))
    np.testing.assert_allclose(got.numpy(), ones.numpy(), atol=1e-6)
    cut = (want >= 0.9999).mean()
    assert 0.2 < cut < 0.9, cut


def test_pwc_warp_and_irr_warp_match_jax():
    """PWC's masked warp and IRR's (full-image flow units over div_flow,
    the analytic in-bounds mask) of (2, 5, 9, 13) features by flows that
    move many pixels out of the map: within 1e-5 of the JAX package's."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 9, 13, 5).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 9, 13, 2)).astype(np.float32)
    flow[0, :3, :3] = [1.0, -1.0]  # whole pixels: samples on the edge
    want = np.asarray(jpwc.pwc_warp(jnp.asarray(x), jnp.asarray(flow)))
    got = tpwc.pwc_warp(nchw(x), nchw(flow))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    assert (want == 0).all(-1).mean() > 0.2
    want = np.asarray(jirr.irr_warp(jnp.asarray(x), jnp.asarray(flow * 0.05),
                                    36, 52, 0.05))
    got = tirr.irr_warp(nchw(x), nchw(flow * 0.05), 36, 52, 0.05)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


@pytest.mark.parametrize("to_local", [True, False])
def test_rescale_flow_and_neighbours_match_jax(to_local):
    rng = np.random.RandomState(9)
    flow = rng.randn(2, 5, 7, 2).astype(np.float32)
    want = np.asarray(jirr.rescale_flow(jnp.asarray(flow), 0.05, 112, 80,
                                        to_local))
    got = tirr.rescale_flow(nchw(flow), 0.05, 112, 80, to_local)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6)
    want = np.asarray(jirr._neighbors3x3(jnp.asarray(flow[..., :1])))
    got = tirr._neighbors3x3(nchw(flow[..., :1]))
    np.testing.assert_array_equal(nhwc(got), want)
    # the window's centre is the map itself; its corners replicate edges
    np.testing.assert_array_equal(got[:, 4].numpy(), flow[..., 0])
    np.testing.assert_array_equal(got[:, 0, 0, 0].numpy(), flow[:, 0, 0, 0])


def test_jax_sampler_of_ones_is_the_coverage():
    """The identity this port relies on, in the JAX package: its sampler of
    an all-ones map is its closed-form coverage."""
    rng = np.random.RandomState(10)
    c = jnp.asarray(coords_near_edges(rng, 600, 6, 8).reshape(1, 20, 30, 2))
    ones = jsampler(jnp.ones((1, 6, 8, 1)), c)
    np.testing.assert_allclose(np.asarray(ones),
                               np.asarray(jcoverage(c, (6, 8))), atol=1e-6)
    assert jax.numpy.isfinite(ones).all()
