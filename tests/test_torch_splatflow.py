"""The PyTorch port's SplatFlow against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``: the
aggregator's ``gamma``, zero at init, drawn in [0.1, 1]) and both flow
heads' last convolutions are damped by 0.1 (``build``), as
``tests/test_torch_train.py`` does for RAFT.  ``state_dict_from_jax``
carries them into the port, which loads them with ``strict=True``.  Inputs
come from numpy seeds; the port is NCHW, the JAX package NHWC.
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
from tests.test_torch_gma import random_attention
from tests.test_torch_train import carry_random, nchw, nhwc, random_params

jsp = importlib.import_module("ptlflow_tpu.models.splatflow.splatflow")
tsp = importlib.import_module("ptlflow_tpu_torch.models.splatflow.splatflow")

H, W = 64, 96
ITERS = 2


def build(seed, **args):
    jmodel = ptlflow_tpu.get_model_reference("splatflow")(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    for head in ("flow_head", "flow_head_sp"):
        conv = params["update"][head]["conv2"]
        for leaf in ("weight", "bias"):
            conv[leaf] = conv[leaf] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model("splatflow", args=args,
                                         device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


@pytest.mark.parametrize("splatted", [False, True])
def test_update_block_matches_jax(splatted):
    """Both branches of the update (the plain GRU, and the one that reads
    splatted motion features) on 6x8 inputs: hidden state, mask, flow step
    and motion features within 1e-4 of the JAX package's."""
    jblk, tblk = jsp.SplatUpdate(128), tsp.SplatUpdate(128)
    params = carry_random(jblk, tblk, 120)
    rng = np.random.RandomState(120)
    args = [rng.randn(2, 6, 8, c).astype(np.float32)
            for c in (128, 128, 324, 2)]  # net, inp, corr, flow
    attn = random_attention(rng, 2, 1, 48)
    mf_t = rng.randn(2, 6, 8, 128).astype(np.float32) if splatted else None
    want = jax.jit(lambda p, *a: jblk(p, *a))(
        params, *map(jnp.asarray, args), jnp.asarray(attn),
        None if mf_t is None else jnp.asarray(mf_t))
    with torch.no_grad():
        got = tblk(*map(nchw, args), torch.from_numpy(attn),
                   None if mf_t is None else nchw(mf_t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


@pytest.fixture(scope="module")
def sp():
    return build(121, iters=ITERS)


@pytest.mark.parametrize("frames", [2, 3])
def test_forward_matches_jax(sp, frames):
    """Two frames (one pair) or three (0 -> 1, its motion features splatted
    by its 1/8 flow into 1 -> 2) at 64x96: flows and ``flow_small`` within
    5e-3 px of the JAX package's; with three frames the splat changes the
    flow."""
    jmodel, tmodel, _ = sp
    images = np.random.RandomState(122).rand(1, frames, 3, H, W).astype(
        np.float32)
    want = jax.jit(lambda p, x: jmodel.forward(p, {"images": x}))(
        jmodel.params, jnp.asarray(images))
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(nhwc(got["flow_small"]),
                               np.asarray(want["flow_small"]), atol=5e-3)
    assert np.abs(np.asarray(want["flows"])).max() > 1.0
    if frames == 3:
        pair = tmodel({"images": torch.from_numpy(images[:, 1:])})["flows"]
        assert (pair - got["flows"]).abs().max() > 1e-2
