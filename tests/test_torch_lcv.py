"""The PyTorch port's LCV-RAFT and LCV-RAFT-small against the JAX
package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``: norm
statistics randomised, the flow head's last conv damped by 0.1, as the RAFT
tests do) and a learned metric far from the identity: the init's
``raw_P`` = I and ``raw_D`` = 0 give W = I, RAFT's correlation, which would
test nothing, so ``raw_P`` is drawn normal with std 0.3 and ``raw_D``
standard normal (W's eigenvalues, the diagonal of D, then span ~0.05-20).
``state_dict_from_jax`` carries them into the port, adding the reference's
``corr_block.eye`` buffer; the port loads them with ``strict=True``.

The JAX models' eval forwards are jitted once each and always given a
``prev_preds`` (zero for a cold forward: its forward projection is exactly
0), so cold and warm-started forwards share one compilation.
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
from ptlflow_tpu.ops import correlation as jcorr
from ptlflow_tpu_torch.ops import correlation as tcorr
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_skflow import zero_prev
from tests.test_torch_train import nchw, nhwc, random_params, synthetic_batch

# the modules, not the classes that the packages re-export under their names
jlcv = importlib.import_module("ptlflow_tpu.models.lcv.lcv_raft")
tlcv = importlib.import_module("ptlflow_tpu_torch.models.lcv.lcv_raft")

H, W = 64, 96
ITERS = 2


def learned_metric(corr_params, rng):
    """``raw_P`` normal with std 0.3, ``raw_D`` standard normal."""
    dim = corr_params["raw_D"].shape[0]
    corr_params["raw_P"] = (0.3 * rng.randn(dim, dim)).astype(np.float32)
    corr_params["raw_D"] = rng.randn(dim).astype(np.float32)


def build(name, seed, **args):
    """(JAX model with seeded weights, its flow head damped and its metric
    far from the identity; port model on the CPU with the same weights;
    numpy params)."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = random_params(shapes, rng)
    learned_metric(params["corr_block"], rng)
    head = params["update_block"]["flow_head"]["conv2"]
    head["weight"] = head["weight"] * 0.1
    head["bias"] = head["bias"] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args)
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel.eval(), params


@pytest.fixture(scope="module")
def models():
    return {name: build(name, seed, iters=ITERS)
            for name, seed in (("lcv_raft", 120), ("lcv_raft_small", 121))}


def corr_block(dim, radius, seed):
    jblk = jlcv.LearnableCorrBlock(dim, 4, radius)
    tblk = tlcv.LearnableCorrBlock(dim, 4, radius)
    params = {"raw_P": np.eye(dim, dtype=np.float32),
              "raw_D": np.zeros(dim, np.float32)}
    learned_metric(params, np.random.RandomState(seed))
    tblk.load_state_dict(state_dict_from_jax(params, tblk), strict=True)
    return jblk, tblk, jax.tree_util.tree_map(jnp.asarray, params)


# ---------------------------------------------------------------- metric
def test_weight_matrix_matches_jax():
    """W = P^T D P from a perturbed ``raw_P`` and ``raw_D``, through the
    Cayley transform's inverse: within 1e-5 of the JAX package's relative
    to its largest entry, symmetric, far from the identity, and the
    identity at the init."""
    jblk, tblk, params = corr_block(256, 4, 122)
    want = np.asarray(jblk.weight_matrix(params))
    with torch.no_grad():
        got = tblk.weight_matrix().numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale)
    np.testing.assert_allclose(got, got.T, atol=1e-5 * scale)
    assert np.abs(want - np.eye(256)).max() > 1.0
    # the seeded init gives W = I
    fresh = ptlflow_tpu_torch.get_model("lcv_raft", args={"iters": 1},
                                        device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(
            fresh.corr_block.weight_matrix().numpy(), np.eye(256), atol=1e-6)


@pytest.mark.parametrize("radius,shapes", [
    (4, [(16, 20), (8, 10), (8, 10), (8, 10), (8, 10)]),
    (3, [(16, 20), (8, 10), (4, 5), (4, 5), (4, 5)])])
def test_cost_volume_stops_pooling(radius, shapes):
    """The features of 128x160 images (16x20): pooling stops once a level's
    smaller side is no larger than 2r + 1, so the last levels repeat; each
    level within 1e-4 of the JAX package's, and the lookup of the first 4,
    which reads the repeated levels at coords / 2^l, too."""
    jblk, tblk, params = corr_block(64, radius, 123)
    rng = np.random.RandomState(123)
    f1 = rng.randn(2, 16, 20, 64).astype(np.float32)
    f2 = rng.randn(2, 16, 20, 64).astype(np.float32)
    want = jblk.compute_cost_volume(params, jnp.asarray(f1), jnp.asarray(f2))
    with torch.no_grad():
        got = tblk.compute_cost_volume(nchw(f1), nchw(f2))
    assert [tuple(g.shape[1:]) for g in got] == shapes
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[..., 0],
                                   atol=1e-4)
    coords = (rng.rand(2, 16, 20, 2) * np.array([24, 20]) - 2).astype(
        np.float32)
    jlook = jcorr.corr_pyramid_lookup(want[:4], jnp.asarray(coords), radius,
                                      group=0)
    tlook = tcorr.make_corr_lookup(got[:4], radius)(nchw(coords))
    np.testing.assert_allclose(nhwc(tlook), np.asarray(jlook), atol=1e-4)


# ----------------------------------------------------------- full model
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("name", ["lcv_raft", "lcv_raft_small"])
def test_eval_forward_matches_jax(models, name, warm):
    """2 iterations at 61x83 (padded to 64x88: an 8x11 map, whose pyramid
    stops pooling at once for r = 4 and after one level for r = 3), cold or
    warm-started: flows and ``flow_small`` within 5e-3 px of the JAX
    package's, and no autograd graph."""
    jmodel, tmodel, _ = models[name]
    rng = np.random.RandomState(124)
    images = rng.rand(1, 2, 3, 61, 83).astype(np.float32)
    prev = (2.0 + rng.uniform(-0.2, 0.2, (1, 2, 8, 11))).astype(np.float32)
    jprev = ({"flow_small": jnp.asarray(prev)} if warm else
             zero_prev(np.zeros((1, 2, 3, 64, 88), np.float32)))
    want = jmodel({"images": images, "prev_preds": jprev})
    inputs = {"images": torch.from_numpy(images)}
    if warm:
        inputs["prev_preds"] = {"flow_small": torch.from_numpy(prev)}
    got = tmodel(inputs)
    assert got["flows"].shape == (1, 1, 2, 61, 83)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)
    assert np.abs(np.asarray(want["flows"])).max() > 1.0


def test_small_training_forward_matches_jax(models):
    """``lcv_raft_small``'s ``flow_preds`` (``upflow``) of 2 iterations at
    64x96, batch 2, within 5e-3 px of the JAX package's, and
    ``SequenceLoss`` within 1e-5 (``lcv_raft``'s train step is in
    ``tests/test_torch_lcv_train.py``)."""
    jmodel, tmodel, _ = models["lcv_raft_small"]
    batch = synthetic_batch(125)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, x: jmodel.forward(p, x, training=True))(
        jmodel.params, {"images": jbatch["images"]})
    got = tmodel({"images": torch.from_numpy(batch["images"])},
                 training=True)
    assert got["flow_preds"].shape == (ITERS, 2, 2, H, W)
    np.testing.assert_allclose(nhwc(got["flow_preds"]),
                               np.asarray(want["flow_preds"]), atol=5e-3)
    want_loss = jmodel.loss_fn({"flow_preds": want["flow_preds"]}, jbatch)
    got_loss = tmodel.loss_fn(
        got, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)


# -------------------------------------------------- weights and names
@pytest.mark.parametrize("name,dim", [("lcv_raft", 256),
                                      ("lcv_raft_small", 128)])
def test_state_dict_loads_strictly_with_eye(name, dim):
    """The port's keys are the JAX tree's, plus torch's BatchNorm counters
    and the reference's ``corr_block.eye``, which the converter adds; a
    reference-layout ``state_dict`` with it loads strictly, and one without
    it does not; mixed precision is refused (the JAX package computes
    fp32)."""
    jmodel = ptlflow_tpu.get_model_reference(name)(iters=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model(name, args={"iters": 1},
                                         device="cpu")
    keys = set(tmodel.state_dict())
    assert keys == jax_state_keys(shapes) | {"corr_block.eye"}
    params = random_params(shapes, np.random.RandomState(126))
    converted = state_dict_from_jax(params, tmodel)
    assert set(converted) == keys
    torch.testing.assert_close(converted["corr_block.eye"], torch.eye(dim))
    tmodel.load_state_dict(converted, strict=True)
    np.testing.assert_array_equal(tmodel.corr_block.raw_P.detach().numpy(),
                                  params["corr_block"]["raw_P"])
    del converted["corr_block.eye"]
    with pytest.raises(RuntimeError, match="eye"):
        tmodel.load_state_dict(converted, strict=True)
    with pytest.raises(ValueError, match="fp32 only"):
        ptlflow_tpu_torch.get_model(name, args={"mixed_precision": True},
                                    device="cpu")
