"""The PyTorch port's MEMFOF against the JAX package's, on the CPU.

At a narrow width (``dim=64``, 128x160, 2 refinements) JAX parameter trees
get seeded numpy weights (``random_params``: the aggregator's ``gamma``,
zero at init, drawn in [0.1, 1]), are conditioned as SEA-RAFT's are
(``condition``: the flow head's four flow channels damped by 0.01, its
eight info channels by 0.1, each ConvNeXt ``final`` conv by 0.1) and get
the BatchNorm statistics of the test's images from the JAX package's
training forward (``tests/test_torch_sea_raft.py::calibrate_norms``).
``state_dict_from_jax`` carries them into the port, which loads them with
``strict=True``.  Inputs come from numpy seeds; the port is NCHW, the JAX
package NHWC.
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
from tests.test_torch_sea_raft import calibrate_norms
from tests.test_torch_train import (carry_random, nchw, nhwc, random_params,
                                    synthetic_batch)

jmf = importlib.import_module("ptlflow_tpu.models.memfof.memfof")
tmf = importlib.import_module("ptlflow_tpu_torch.models.memfof.memfof")

H, W = 128, 160
SMALL = {"dim": 64, "iters": 2}


def condition(params):
    head = params["flow_head"]["2"]  # HWIO: the output channel is last
    for channels, factor in (((0, 1, 6, 7), 0.01),
                             ((2, 3, 4, 5, 8, 9, 10, 11), 0.1)):
        head["weight"][..., list(channels)] *= factor
        head["bias"][list(channels)] *= factor
    for blk in params["update_block"]["refine"].values():
        blk["final"]["weight"] *= 0.1


def build(seed, images, **args):
    """(JAX ``memfof``, the port's on the CPU, numpy params) with the same
    seeded, conditioned weights and the norms calibrated on ``images``."""
    args = dict(SMALL, **args)
    jmodel = ptlflow_tpu.get_model_reference("memfof")(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    condition(params)
    params = calibrate_norms(jmodel, params, images)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model("memfof", args=args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


def images_of(seed, frames=3, b=1):
    return np.random.RandomState(seed).rand(b, frames, 3, H, W).astype(
        np.float32)


def test_attention_and_aggregate_match_jax():
    """The attention of a 32-channel 6x8 map, queries scaled by
    log_3(48) too, and the aggregation of a map by a random attention
    (``gamma`` drawn): within 1e-5 and 1e-4 of the JAX package's."""
    jatt, tatt = jmf.MemfofAttention(32, 1, 32), tmf.MemfofAttention(32, 1, 32)
    jagg, tagg = jmf.MemfofAggregate(32, 1, 32), tmf.MemfofAggregate(32, 1, 32)
    patt = carry_random(jatt, tatt, 110)
    pagg = carry_random(jagg, tagg, 111)
    assert float(pagg["gamma"][0]) >= 0.1
    rng = np.random.RandomState(110)
    ctx, fmap = (rng.randn(2, 6, 8, 32).astype(np.float32) for _ in range(2))
    attn = random_attention(rng, 2, 1, 48)
    want_att = np.asarray(jax.jit(jatt)(patt, jnp.asarray(ctx)))
    want = np.asarray(jax.jit(jagg)(pagg, jnp.asarray(attn),
                                    jnp.asarray(fmap)))
    with torch.no_grad():
        got_att = tatt(nchw(ctx)).numpy()
        got = nhwc(tagg(torch.from_numpy(attn), nchw(fmap)))
    np.testing.assert_allclose(got_att, want_att, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.fixture(scope="module")
def mf():
    """The models of ``build`` and the JAX eval forward, jitted once for
    both frame counts' tests (3 frames of 128x160)."""
    jmodel, tmodel, params = build(112, images_of(112))
    forward = jax.jit(lambda p, x: jmodel.forward(p, {"images": x})["flows"])
    return jmodel, tmodel, params, forward


@pytest.mark.parametrize("frames", [2, 3])
def test_eval_forward_matches_jax(mf, frames):
    """Three frames, or two (the first repeated, as the JAX package pads
    them: its forward of the three frames is the oracle) at 128x160: the
    flow of the middle frame to the last within 5e-3 px of the JAX
    package's, no autograd graph."""
    jmodel, tmodel, _, forward = mf
    images = images_of(112, frames)
    three = (images if frames == 3
             else np.concatenate([images[:, :1], images], 1))
    want = np.asarray(forward(jmodel.params, jnp.asarray(three)))
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(), want, atol=5e-3)
    assert np.abs(want).max() > 1.0


def test_training_forward_and_loss_match_jax(mf):
    """Batch 2 of two frames, BatchNorm on batch statistics: every
    prediction's flows and infos (the initial one and both refinements,
    both directions) within 5e-3, the Laplace-mixture NLL within 5e-3
    plus 2e-3 of its size where the loss reads it (|gt| under
    ``max_flow``): a pixel's NLL grows with |pred - gt| / b and moves by
    that times its log scale's error (1e-3 here, the flows' 2.4e-3 at 50
    px), and ``MemfofSequenceLoss`` within 1e-5 relative of the JAX
    package's."""
    jmodel, tmodel, _, _ = mf
    batch = synthetic_batch(113, h=H, w=W)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, x: jmodel.forward(p, x, training=True))(
        jax.tree_util.tree_map(jnp.array, jmodel.params), jbatch)
    want_loss = float(jmodel.loss_fn(want, jbatch))
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tmodel(tbatch, training=True)
    loss = tmodel.loss_fn(got, tbatch)
    tmodel.load_state_dict(start)
    assert len(got["flow_preds"]) == len(want["flow_preds"]) == 3
    assert got["flow_preds"][0].shape == (2, 2, 2, H, W)
    for key, atol in (("flow_preds", 5e-3), ("info_preds", 5e-3)):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=atol)
    read = np.linalg.norm(batch["flows"], axis=2) < 400  # (B, 1, H, W)
    read = read[:, :, :, :, None]  # both directions, both channels
    for g, w in zip(got["nf_preds"], want["nf_preds"]):
        g, w = np.broadcast_arrays(nhwc(g), np.asarray(w))
        np.testing.assert_allclose(g[np.broadcast_to(read, g.shape)],
                                   w[np.broadcast_to(read, w.shape)],
                                   rtol=2e-3, atol=5e-3)
    assert loss.requires_grad
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    torch.testing.assert_close(got["flows"], got["flow_preds"][-1][:, 1:],
                               rtol=0, atol=0)
