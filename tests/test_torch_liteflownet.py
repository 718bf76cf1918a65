"""The port's LiteFlowNet against the JAX package's, on the CPU: the eval
forward of frames of 120x150, which both packages resize by interpolation
to 128x160 (1/32: 4x5), and ``lfn_warp``'s mask at the map's edges.

Weights are ``random_params``; the last convolution of each level's
matching and sub-pixel flow networks is damped by 0.1 (``HEADS``), which
leaves flows of a few pixels (undamped, ~70 px at this size, which the
warps then read outside the maps).
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax.numpy as jnp

from ptlflow_tpu.models.liteflownet.liteflownet import lfn_warp as jlfn_warp
from ptlflow_tpu_torch.models.liteflownet.liteflownet import lfn_warp
from tests.test_torch_flownet import assert_forward_matches, build, images_of
from tests.test_torch_pwcnet import compile_o0

HEADS = ("matching_nets.*.flow_net.6", "subpixel_nets.*.flow_net.6")


def test_eval_forward_matches_jax():
    """``flows`` within 5e-3 px of the JAX package's: the five levels'
    matching (the dilated and strided correlation at 1/4 and 1/2, its
    grouped upsampling), sub-pixel and regularization stages (the green
    channel's brightness error, the k x k softmax over the flow's
    neighbourhood), flows of a few pixels."""
    jmodel, tmodel, _ = build("liteflownet", 150, HEADS)
    want = assert_forward_matches(jmodel, tmodel, images_of(151, h=120,
                                                            w=150))
    assert 1.0 < np.abs(np.asarray(want["flows"])).max() < 100.0


@pytest.mark.parametrize("mult", [1.0, 1.25])
def test_lfn_warp_matches_jax_at_the_edges(mult):
    """A 6x7 map warped to points exactly on the last column and row and
    on 0, and 2^-12 px past each: in-bounds samples kept, the others zero
    (the mask is "fully inside", inclusive of w - 1 and h - 1), as the
    JAX package's closed form gives; and random flows within 1e-6 of the
    JAX package's."""
    h, w = 6, 7
    rng = np.random.RandomState(152)
    x = rng.randn(2, 3, h, w).astype(np.float32)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    eps = 2.0 ** -12
    targets = [(w - 1, h - 1), (w - 1 + eps, h - 1), (w - 1, h - 1 + eps),
               (0.0, 0.0), (-eps, 0.0), (0.0, -eps)]
    flow_all = np.concatenate(
        [np.stack([np.stack([(tx - gx) / mult, (ty - gy) / mult])
                   for tx, ty in targets]).astype(np.float32),
         (3 * rng.randn(2, 2, h, w)).astype(np.float32)])
    xs = np.concatenate([x] * 4)
    got = lfn_warp(torch.from_numpy(xs), torch.from_numpy(flow_all), mult)
    args = (jnp.asarray(np.moveaxis(xs, 1, -1)),
            jnp.asarray(np.moveaxis(flow_all, 1, -1)))
    want = compile_o0(lambda x, f: jlfn_warp(x, f, mult), *args)(*args)
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(want), -1, 1),
                               atol=1e-6)
    coords = flow_all * mult + np.stack([gx, gy])
    inside = ((coords[:, 0] >= 0) & (coords[:, 0] <= w - 1)
              & (coords[:, 1] >= 0) & (coords[:, 1] <= h - 1))
    assert np.all((got.numpy() != 0).any(1) <= inside)
    assert inside[0].all() and inside[3].all()
    assert not inside[1].any() and not inside[2].any()
    assert not inside[4].any() and not inside[5].any()
