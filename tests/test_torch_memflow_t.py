"""The PyTorch port's MemFlow-T (MemFlow on Twins-SVT encoders) against the
JAX package's, on the CPU.

Its Twins encoders make the JAX compilations heavy, so it has a file of its
own.  Weights are drawn and conditioned as ``tests/test_torch_skflow.py``
says; Twins' ``proj`` and ``channel_convertor`` come with them.
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from tests.test_torch_raft import jax_state_keys
from tests.test_torch_skflow import H, W, build, images_of
from tests.test_torch_train import nhwc, synthetic_batch

DEPTH = 2


@pytest.fixture(scope="module")
def mft():
    return build("memflow_t", 150, decoder_depth=DEPTH)


def test_eval_forward_matches_jax(mft):
    """2 decoder steps at 64x96 on an empty memory: flows and
    ``flow_small`` within 5e-3 px of the JAX package's, no autograd graph;
    the port's keys are the JAX tree's under ``network.``, Twins'
    ``svt.`` included."""
    jmodel, tmodel, params = mft
    assert set(tmodel.state_dict()) == {
        "network." + k for k in jax_state_keys(params)} | {
        "network.att.pos_emb.rel_ind"}
    assert "network.channel_convertor.weight" in tmodel.state_dict()
    images = images_of(151)
    want = jmodel({"images": images})
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)
    assert np.abs(np.asarray(want["flows"])).max() > 1.0


def test_training_forward_matches_jax(mft):
    """``flow_preds`` of 2 decoder steps at 64x96, batch 2, within 5e-3 px
    of the JAX package's pure forward, and ``SequenceLoss`` within
    1e-5."""
    jmodel, tmodel, _ = mft
    batch = synthetic_batch(152)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, x: jmodel.forward(p, x, training=True))(
        jmodel.params, {"images": jbatch["images"]})
    got = tmodel({"images": torch.from_numpy(batch["images"])},
                 training=True)
    assert got["flow_preds"].shape == (DEPTH, 2, 2, H, W)
    np.testing.assert_allclose(nhwc(got["flow_preds"]),
                               np.asarray(want["flow_preds"]), atol=5e-3)
    want_loss = jmodel.loss_fn({"flow_preds": want["flow_preds"]}, jbatch)
    got_loss = tmodel.loss_fn(
        got, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
