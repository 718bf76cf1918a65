"""The PyTorch port's MatchFlow (``matchflow``: GMA's update on the
quadtree matching features) against the JAX package's, on the CPU: the
eval forward, the warm start and the tiled forward
(``tests/test_torch_matchflow_raft.py`` holds ``matchflow_raft``).

JAX parameter trees get seeded numpy weights (``random_params``) with the
flow head's last convolution damped by 0.03 (at RAFT's 0.1 the random
matching features give 33 px flows in 3 steps, along which fp32 rounding
grows ~8x a step, to 5e-3 px for ``matchflow_raft``);
``state_dict_from_jax`` carries them into the port, which loads them with
``strict=True``.  The models keep their registered widths at 64x96 (an 8x12
map at 1/8, pooled to 4x6 and 2x3 by the quadtree attention), with 3
iterations.  The JAX model's ``predict`` is jitted once a model and input
shape and its cold start is a warm start from zeros, which forward-project
to exactly 0 (``jitted_predict``); the tiles are 64x96 too, so one compiled
``predict`` serves the whole module.
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu.models.matchflow import quadtree as jqt
from ptlflow_tpu_torch.models.matchflow import quadtree as tqt
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_train import random_params

H, W = 64, 96
ITERS = 3
TILE = (64, 96)


def jitted_predict(jmodel):
    """``jmodel.predict`` jitted once: a missing ``flow_prev`` becomes
    zeros, an NCHW one NHWC."""
    core = jax.jit(lambda p, a, b, prev: type(jmodel).predict(
        jmodel, p, a, b, prev))

    def predict(params, image1, image2, flow_prev=None, training=False):
        assert not training
        b, h, w, _ = image1.shape
        if flow_prev is None:
            flow_prev = jnp.zeros((b, h // 8, w // 8, 2), image1.dtype)
        elif flow_prev.shape[-1] != 2:
            flow_prev = jnp.moveaxis(flow_prev, -3, -1)
        return core(params, image1, image2, flow_prev)

    jmodel.predict = predict
    return jmodel


def build(name, seed, jit_eval=True, shallow=False, **args):
    """(JAX model, port model on the CPU, numpy params), the same seeded
    weights, the flow head damped by 0.03; the JAX eval ``predict`` jitted
    where ``jit_eval``.  ``shallow`` gives both matching encoders one
    self/cross layer pair in place of 4 (the JAX train step's compile)."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args).eval()
    if shallow:
        jmodel.fnet.loftr_coarse = jqt.LocalFeatureTransformer(
            ["self", "cross"], topks=[16, 8, 8])
        tmodel.fnet.loftr_coarse = tqt.LocalFeatureTransformer(
            ["self", "cross"], topks=[16, 8, 8])
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    head = params["update_block"]["flow_head"]["conv2"]
    for leaf in ("weight", "bias"):
        head[leaf] = head[leaf] * 0.03
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return (jitted_predict(jmodel) if jit_eval else jmodel), tmodel, params


def images_of(seed, b=1, h=H, w=W):
    return np.random.RandomState(seed).rand(b, 2, 3, h, w).astype(np.float32)


@pytest.fixture(scope="module")
def mf():
    return build("matchflow", 110, iters=ITERS)


def check_eval_and_warm_start(built):
    """Cold, then warm-started from a ``flow_small`` of ~2 px: flows and
    ``flow_small`` within 5e-3 px of the JAX package's, and the warm
    start moves the flow."""
    jmodel, tmodel, _ = built
    images = images_of(111)
    prev = (2.0 + np.random.RandomState(112).uniform(
        -0.2, 0.2, (1, 2, H // 8, W // 8))).astype(np.float32)
    flows = []
    for warm in (False, True):
        inputs = {"images": images}
        if warm:
            inputs["prev_preds"] = {"flow_small": prev}
        want = jmodel.forward(
            jmodel.params, jax.tree_util.tree_map(jnp.asarray, inputs))
        got = tmodel(jax.tree_util.tree_map(torch.from_numpy, inputs))
        for key in ("flows", "flow_small"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=5e-3)
        flows.append(got["flows"])
    assert np.abs(np.asarray(want["flows"])).max() > 1.0
    assert (flows[1] - flows[0]).abs().max() > 0.5


def test_eval_forward_and_warm_start_match_jax(mf):
    check_eval_and_warm_start(mf)


def test_tiled_forward_matches_jax(mf):
    """``train_size`` 64x96 over a 64x128 input (``tile_height`` 64): two
    tiles, 32 px apart, blended by the Gaussian weights, within 5e-3 px of
    the JAX package's.  A tile of the training size rescales no positions,
    so the twins' matching encoders (built without a ``train_size``) serve
    the tiles as they are."""
    jmodel, tmodel, _ = mf
    images = images_of(114, w=128)
    for m in (jmodel, tmodel):
        m.train_size, m.tile_height = TILE, 64
    try:
        want = jmodel.forward(jmodel.params, {"images": jnp.asarray(images)})
        got = tmodel({"images": torch.from_numpy(images)})
    finally:
        for m in (jmodel, tmodel):
            m.train_size, m.tile_height = None, 416
    assert set(got) == {"flows"} == set(want)
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    # the blend is not one tile's flow
    with torch.no_grad():
        one = tmodel({"images": torch.from_numpy(
            images[..., :TILE[0], :TILE[1]])})["flows"]
    assert (got["flows"][..., :TILE[1]] - one).abs().max() > 1e-3
