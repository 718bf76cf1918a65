"""The PyTorch port's NeuFlow v2 against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``: BatchNorm
statistics and affine weights randomised, so that BatchNorm is not the
identity); ``state_dict_from_jax`` carries them into the port, which loads
them with ``strict=True``.  Inputs come from numpy seeds; the port is NCHW,
the JAX package NHWC.  The JAX blocks and the model's forward are jitted.
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
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_train import carry_random, nchw, nhwc, random_params

jnf = importlib.import_module("ptlflow_tpu.models.neuflow2.neuflow2")
tnf = importlib.import_module("ptlflow_tpu_torch.models.neuflow2.neuflow2")

ITERS_S8 = 2


def build(seed, **args):
    """(JAX ``neuflow2`` with seeded weights, the port's on the CPU with
    the same weights, numpy params)."""
    jmodel = ptlflow_tpu.get_model_reference("neuflow2")(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model("neuflow2", args=args,
                                         device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


@pytest.fixture(scope="module")
def nf():
    jmodel, tmodel, params = build(180, iters_s8=ITERS_S8)
    forward = jax.jit(lambda p, x: jmodel.forward(p, x))
    return jmodel, tmodel, forward


# ---------------------------------------------------------------- blocks
def test_encoder_matches_jax():
    """The backbone at 64x96 (1/16 features with the centred position
    channels, 1/8 features), BatchNorm on running statistics: within 1e-4
    of the JAX package's."""
    jenc = jnf.CNNEncoder2(32, 16, 24, 8)
    tenc = tnf.CNNEncoder2(32, 16, 24, 8)
    params = carry_random(jenc, tenc, 181)
    x = np.random.RandomState(181).rand(2, 64, 96, 3).astype(np.float32)
    want = jax.jit(jenc)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tenc(nchw(x))
    assert got[0].shape == (2, 48, 4, 6) and got[1].shape == (2, 32, 8, 12)
    np.testing.assert_array_equal(nhwc(got[0])[0, :, 0, -2:],
                                  [[-2.0, -3.0], [-1, -3], [0, -3], [1, -3]])
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("training", [False, True])
def test_feature_attention_matches_jax(training):
    """Two cross-attention layers between the frames of a batch of 2
    pairs, 24 channels on 5x6, with the BatchNorm post-norm on running
    statistics, or in training on the batch's: within 1e-4 of the JAX
    package's."""
    jmod = jnf.FeatureAttention2(24, 2, post_norm=True)
    tmod = tnf.FeatureAttention2(24, 2, post_norm=True)
    params = carry_random(jmod, tmod, 182)
    tmod.train(training)
    x = np.random.RandomState(182).randn(4, 5, 6, 24).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jmod(p, x, training=training))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_refine_matches_jax():
    """The 1/8 refiner (r = 4, one level) with ``conv3``'s iteration
    context channels scaled by 20 so that they reach the +-4 clip: both
    outputs within 1e-4 of the JAX package's."""
    jmod = jnf.Refine(16, 12, num_layers=2, levels=1, radius=4, inter_dim=24)
    tmod = tnf.Refine(16, 12, num_layers=2, levels=1, radius=4, inter_dim=24)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(183))
    # the iteration context's output channels (HWIO: the last axis)
    params["conv3"]["weight"][..., 2:] *= 20
    params["conv3"]["bias"][2:] *= 20
    tmod.load_state_dict(state_dict_from_jax(params, tmod), strict=True)
    rng = np.random.RandomState(183)
    args = [rng.randn(2, 6, 8, c).astype(np.float32)
            for c in (81, 16, 12, 2)]  # corrs, context, iter_context, flow
    want = jax.jit(jmod)(params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tmod(*map(nchw, args))
    assert got[0].abs().max() == 4.0
    assert (got[0].abs() < 4.0).any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


def test_upsample_matches_jax():
    jmod, tmod = jnf.UpSample(16, 8), tnf.UpSample(16, 8)
    params = carry_random(jmod, tmod, 184)
    rng = np.random.RandomState(184)
    feat = rng.randn(2, 5, 7, 16).astype(np.float32)
    flow = 3 * rng.randn(2, 5, 7, 2).astype(np.float32)
    want = np.asarray(jax.jit(jmod)(params, jnp.asarray(feat),
                                    jnp.asarray(flow)))
    with torch.no_grad():
        got = tmod(nchw(feat), nchw(flow))
    assert got.shape == (2, 2, 40, 56)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


# ----------------------------------------------------------- full model
@pytest.mark.parametrize("size", [(64, 96), (60, 90)])
def test_eval_forward_matches_jax(nf, size):
    """``iters_s8`` 2 at 64x96 and at 60x90, which is resized bilinearly
    to 64x96 and the flow back: flows within 5e-3 px of the JAX package's
    and no autograd graph."""
    jmodel, tmodel, forward = nf
    h, w = size
    images = np.random.RandomState(185).rand(1, 2, 3, h, w).astype(
        np.float32)
    want = np.asarray(forward(jmodel.params,
                              {"images": jnp.asarray(images)})["flows"])
    got = tmodel({"images": torch.from_numpy(images)})
    assert set(got) == {"flows"}
    assert got["flows"].shape == (1, 1, 2, h, w)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(), want, atol=5e-3)
    assert np.abs(want).max() > 1.0


def test_state_dict_matches_jax_params():
    """The port's keys are the JAX tree's plus torch's BatchNorm
    counters."""
    jmodel = jnf.NeuFlow2()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model("neuflow2", device="cpu")
    assert set(tmodel.state_dict()) == jax_state_keys(shapes)
    assert tmodel.output_stride == 16
