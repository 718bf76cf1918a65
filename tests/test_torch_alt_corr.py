"""The PyTorch port's ``AltCorrBlock``, the on-the-fly windowed correlation
of MS-RAFT+ and CCMR, against the JAX package's and against the port's
``CorrBlock`` (the plain lookup of the materialised pyramid), on the CPU.

Features and coords come from numpy seeds; coords spread 30% past each side
of the map, one query a million pixels out.  The block is plain PyTorch on
either device, so these cases are also its card's; ``chip_smoke.py`` holds
the models built on it against their ``CorrBlock`` route, whose lookup is
the CUDA kernel there.
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu.ops import correlation as jcorr
from ptlflow_tpu_torch.ops import correlation as tcorr

B, C, H, W = 2, 24, 12, 16
RADIUS = 4


def inputs(seed):
    rng = np.random.RandomState(seed)
    f1 = rng.randn(B, C, H, W).astype(np.float32)
    f2 = rng.randn(B, C, H, W).astype(np.float32)
    coords = ((rng.rand(B, 2, H, W) * 1.6 - 0.3)
              * np.array([W, H], np.float32).reshape(1, 2, 1, 1))
    coords[0, :, 0, 0] = [1e6, -3e5]
    coords[1, :, 2, 3] = [-7.5, H + 3.25]
    return f1, f2, coords.astype(np.float32)


def nhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


def jax_alt_corr(f1, f2, coords, levels):
    """The JAX package's block: (B, L*81, H, W), and the gradients of
    sum(out * g) with respect to both feature maps (NCHW)."""
    def run(a, b):
        blk = jcorr.AltCorrBlock(a, b, num_levels=levels, radius=RADIUS)
        return blk(nhwc(coords))

    out = np.moveaxis(np.asarray(jax.jit(run)(nhwc(f1), nhwc(f2))), -1, 1)
    g = np.random.RandomState(7).randn(*out.shape).astype(np.float32)
    grads = jax.jit(jax.grad(
        lambda a, b: jnp.sum(run(a, b) * nhwc(g)), argnums=(0, 1)))(
        nhwc(f1), nhwc(f2))
    return out, g, [np.moveaxis(np.asarray(x), -1, 1) for x in grads]


@pytest.mark.parametrize("levels,chunked", [(2, False), (2, True),
                                            (4, False)])
def test_alt_corr_matches_jax_and_the_corr_block(levels, chunked):
    """2 and 4 levels (the last of 4 is 1x2), radius 4, coords far
    outside; ``chunked`` forces 1 query a chunk (384 chunks a level).  The
    output within 1e-5 of the JAX package's block and of the port's
    ``CorrBlock``, and the features' gradients within 1e-5 of
    ``jax.grad``'s."""
    f1, f2, coords = inputs(60 + levels)
    want, g, want_grads = jax_alt_corr(f1, f2, coords, levels)
    t1 = torch.from_numpy(f1).requires_grad_()
    t2 = torch.from_numpy(f2).requires_grad_()
    blk = tcorr.AltCorrBlock(t1, t2, num_levels=levels, radius=RADIUS)
    if chunked:
        blk.max_patch_elems = (2 * RADIUS + 2) ** 2 * C
    assert len(blk._chunks(B * H * W)) == (B * H * W if chunked else 1)
    got = blk(torch.from_numpy(coords))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    with torch.no_grad():
        ref = tcorr.CorrBlock(torch.from_numpy(f1), torch.from_numpy(f2),
                              num_levels=levels,
                              radius=RADIUS)(torch.from_numpy(coords))
    np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), atol=1e-5)
    assert np.abs(want).max() > 1.0
    assert (want[0, :, 0, 0] == 0).all()  # the far query reads zeros
    grads = torch.autograd.grad(got, (t1, t2), torch.from_numpy(g))
    for have, exp in zip(grads, want_grads):
        np.testing.assert_allclose(have.numpy(), exp, atol=1e-5)
        assert np.abs(exp).max() > 1.0


def test_alt_corr_backward_keeps_no_gathered_patch():
    """Every tensor that autograd saves for the lookup's backward, through
    ``saved_tensors_hooks``, is at most a feature map's size: a (Q,
    (2r+2)^2, C) patch, which plain autograd of the gather would keep,
    holds 100 times more.  The gradient is still the ``CorrBlock``'s."""
    f1, f2, coords = inputs(65)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    t1 = torch.from_numpy(f1).requires_grad_()
    t2 = torch.from_numpy(f2).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tcorr.AltCorrBlock(t1, t2, num_levels=2,
                                 radius=RADIUS)(torch.from_numpy(coords))
    patch = B * H * W * (2 * RADIUS + 2) ** 2 * C
    assert saved and max(saved) <= f1.size < patch / 50
    g = torch.from_numpy(
        np.random.RandomState(8).randn(*out.shape).astype(np.float32))
    grads = torch.autograd.grad(out, (t1, t2), g)
    r1 = torch.from_numpy(f1).requires_grad_()
    r2 = torch.from_numpy(f2).requires_grad_()
    ref = tcorr.corr_pyramid_lookup_plain(
        tcorr.build_corr_pyramid(r1, r2, 2), torch.from_numpy(coords),
        RADIUS)
    for have, exp in zip(grads, torch.autograd.grad(ref, (r1, r2), g)):
        torch.testing.assert_close(have, exp, rtol=0, atol=1e-5)


def test_alt_corr_refuses_coords_that_need_a_gradient():
    """As the lookup does: the coords' gradient is stopped, as in the JAX
    package's models."""
    f1, f2, coords = inputs(66)
    blk = tcorr.AltCorrBlock(torch.from_numpy(f1), torch.from_numpy(f2), 2)
    with pytest.raises(ValueError, match="detach the coords"):
        blk(torch.from_numpy(coords).requires_grad_())
