"""The port's SeparableFlow against the JAX package's, on the CPU: the 1-D
lookup, the volume separation, ``CostAggregation`` in eval and training
(batch statistics) on both directions, the whole eval forward at 64x64
with 2 iterations, and the converter's 3-D weights.

Weights are ``random_params`` (3-D convolutions uniform in +-0.1), carried
into the port by ``state_dict_from_jax`` and loaded strictly; the RAFT flow
head's last convolution is damped by 0.1 (``build``), as for RAFT: random
GRU steps are chaotic; the shift regressions' convolutions by SHIFT_DAMP.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_ganet import rolled_sga_scans  # noqa: F401
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_train import carry_random, nhwc, random_params

jsf = importlib.import_module(
    "ptlflow_tpu.models.separableflow.separableflow")
tsf = importlib.import_module(
    "ptlflow_tpu_torch.models.separableflow.separableflow")
jca = importlib.import_module("ptlflow_tpu.models.separableflow.cost_agg")
tca = importlib.import_module(
    "ptlflow_tpu_torch.models.separableflow.cost_agg")

H, W = 64, 64
ITERS = 2
# the U-Nets' shift regressions: random 3-D convolutions saturate the
# softmax over the 193 bins, and one-hot bins concentrate the gradient on a
# few elements (``tests/test_torch_separableflow_train.py``)
SHIFT_DAMP = 0.1


def build(seed, iters=ITERS):
    """(JAX model, port model, numpy params): ``random_params`` with the
    flow head's last convolution damped by 0.1 and the shift regressions'
    3-D convolutions by SHIFT_DAMP, the port loaded strictly."""
    jmodel = ptlflow_tpu.get_model_reference("separableflow")(iters=iters)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    head = params["update_block"]["flow_head"]["conv2"]
    for leaf in ("weight", "bias"):
        head[leaf] = head[leaf] * 0.1
    for agg in ("cost_agg1", "cost_agg2"):
        for shift in ("shift0", "shift1", "shift2"):
            conv = params[agg][shift]["conv3d_2d"]
            for leaf in ("weight", "bias"):
                conv[leaf] = conv[leaf] * SHIFT_DAMP
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model("separableflow",
                                         args={"iters": iters}, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


def test_lookup_1d_matches_jax():
    """Windows of radius 4 of 13-long rows over 4 levels (13, 6, 3, 1: the
    pooling drops each odd tail), coords before, on and past the row, with
    and without the clamp to [-1, 1]: the JAX package's dense contraction
    within 1e-6."""
    rng = np.random.RandomState(80)
    vol = rng.randn(2, 3, 5, 13).astype(np.float32)
    coords = rng.uniform(-8, 20, (2, 3, 5)).astype(np.float32)
    coords[0, 0, :3] = [0.0, 4.0, 12.0]
    for clamp in (False, True):
        want = np.asarray(jsf.lookup_1d(jnp.asarray(vol), jnp.asarray(coords),
                                        4, 4, clamp_coords=clamp))
        got = tsf.lookup_1d(torch.from_numpy(vol), torch.from_numpy(coords),
                            4, 4, clamp_coords=clamp)
        assert got.shape == (2, 36, 3, 5)
        np.testing.assert_allclose(nhwc(got), want, atol=1e-6)


def test_separate_volume_matches_jax():
    """Max and mean profiles of a 4-level (8x12 ... 1x1) pyramid of 2 x 5x6
    queries, resized to 12 and 8 bins: equal to the JAX package's within
    1e-6."""
    rng = np.random.RandomState(81)
    vol = torch.from_numpy(rng.randn(2 * 5 * 6, 8, 12).astype(np.float32))
    from ptlflow_tpu_torch.ops import pool_volume_pyramid

    pyr = pool_volume_pyramid(vol, 4)
    want = jsf.separate_volume([jnp.asarray(p.numpy()[..., None])
                                for p in pyr], (2, 5, 6, 8, 12))
    got = tsf.separate_volume(pyr, (2, 5, 6, 8, 12))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("is_ux,training", [(True, False), (False, True)])
def test_cost_aggregation_matches_jax(is_ux, training):
    """The U-Net of x in eval (shift map, volume) and of y in training
    (three shift maps, volume; BatchNorm on batch statistics) on a (2, 8,
    8, 8, 8) volume with the 5 guidance maps at 1/1 and 1/2: within 1e-4 of
    the JAX package's."""
    jmod, tmod = jca.CostAggregation(in_channel=8), tca.CostAggregation(
        in_channel=8)
    params = carry_random(jmod, tmod, 82 + is_ux)
    rng = np.random.RandomState(84 + is_ux)
    h = w = d = 8
    x = rng.randn(2, 8, d, h, w).astype(np.float32)
    g = {k: rng.randn(2, 20, h // s, w // s).astype(np.float32)
         for k, s in (("sg1", 1), ("sg2", 1), ("sg3", 1), ("sg11", 2),
                      ("sg12", 2))}
    jx = jnp.asarray(x.transpose(0, 2, 3, 4, 1))
    jgd = {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in g.items()}
    want = compile_o0(lambda p, a, b: jmod(p, a, b, max_shift=384,
                                           is_ux=is_ux, training=training),
                      params, jx, jgd)(params, jx, jgd)
    tmod.train(training)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x),
                   {k: torch.from_numpy(v) for k, v in g.items()},
                   max_shift=384, is_ux=is_ux, training=training)
    assert len(got) == (4 if training else 2)
    for a, b in zip(got[:-1], want[:-1]):
        assert a.shape == (2, 1, 8 * h, 8 * w)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(got[-1].numpy(), np.moveaxis(
        np.asarray(want[-1]), -1, 1), atol=1e-4)
    assert np.abs(np.asarray(want[-2])).max() > 0.1


def test_eval_forward_matches_jax():
    """2 iterations at 64x64 (8x8 feature maps, padded to /64 already):
    ``flows`` and ``flow_small`` within 5e-3 px of the JAX package's, no
    autograd graph, and the U-Nets' initial flow moves the result (the
    flow is far from its update steps' size)."""
    jmodel, tmodel, _ = build(86)
    images = np.random.RandomState(87).rand(1, 2, 3, H, W).astype(np.float32)
    x = jnp.asarray(images)
    want = compile_o0(lambda p, x: jmodel.forward(p, {"images": x}),
                      jmodel.params, x)(jmodel.params, x)
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)
    assert np.abs(np.asarray(want["flows"])).max() > 5.0


def test_converter_carries_3d_weights_both_ways():
    """A 3-D convolution's DHWIO and a transposed one's DHWOI weights, and
    ``_BN3d``'s flat leaves, go to the port's OIDHW, IODHW and BatchNorm3d
    and back through the JAX package's ``from_torch`` unchanged; the
    converted port module computes the JAX module's output."""
    jmod = jca.Conv2x(16, 8, deconv=True, kernel=(3, 4, 4))
    tmod = tca.Conv2x(16, 8, kernel=(3, 4, 4))
    params = carry_random(jmod, tmod, 88)
    sd = tmod.state_dict()
    assert sd["conv1.conv.weight"].shape == (16, 8, 3, 4, 4)
    assert sd["conv2.conv.weight"].shape == (8, 16, 3, 3, 3)
    assert "conv1.bn.num_batches_tracked" in sd
    back = jmod.from_torch({k: v.numpy() for k, v in sd.items()})
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    rng = np.random.RandomState(89)
    x = rng.randn(1, 16, 3, 4, 5).astype(np.float32)
    rem = rng.randn(1, 8, 5, 8, 10).astype(np.float32)
    want = jmod(params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
                jnp.asarray(rem.transpose(0, 2, 3, 4, 1)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(rem))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(
        np.asarray(want), -1, 1), atol=1e-5)
