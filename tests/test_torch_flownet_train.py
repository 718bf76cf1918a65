"""The port's FlowNetC training step against ``jax.value_and_grad`` of the
JAX package's, on the CPU: ``MultiScaleLoss`` over the decoder's five
flows (1/4 to 1/64) at 128x128, batch 2, the weights drawn and the flow
heads damped as ``tests/test_torch_flownet.py::build`` does.  The
gradient reaches both trunks through the correlation's two arguments.
The eval forward of ``flownetc`` is held here too, to the same compiled
step: without BatchNorm the JAX package's training forward computes the
same ``flows`` and only adds ``flow_preds``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

from ptlflow_tpu import nn as jnn
from tests.test_torch_flownet import build
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_pwcnet_train import assert_list_step_matches
from tests.test_torch_train import synthetic_batch


def compiled_step(jmodel, batch):
    """The JAX package's train step on ``batch``'s shapes, compiled once by
    ``compile_o0``: (trainable, state, batch) to ((loss, (state, outputs)),
    gradient), outputs holding ``flow_preds`` and ``flows``; and the
    ``assert_list_step_matches`` step that runs it on ``jmodel.params``
    (or on ``params``)."""
    def loss_and_outputs(trainable, bn_state, jbatch):
        full = jnn.merge_params(jnn.tree_copy(trainable),
                                jnn.tree_copy(bn_state))
        out = jmodel.forward(full, jbatch, training=True)
        _, new_state = jnn.split_trainable(full)
        return jmodel.loss_fn(out, jbatch), (new_state, {
            k: out[k] for k in ("flow_preds", "flows")})

    trainable, state = jnn.split_trainable(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = compile_o0(jax.value_and_grad(loss_and_outputs, has_aux=True),
                      trainable, state, jbatch)

    def run(jm, b, params=None):
        trainable, state = jnn.split_trainable(
            jm.params if params is None else params)
        (loss, (new_state, out)), grads = step(
            trainable, state, {k: jnp.asarray(v) for k, v in b.items()})
        return (loss, (new_state, out)), grads

    return run


def assert_eval_matches_step(tmodel, jmodel, run, batch, params=None):
    """The port's eval forward of ``batch``'s images within 5e-3 px of the
    ``flows`` of the JAX package's compiled step (``run``), no autograd
    graph.  Returns both flows as numpy arrays."""
    (_, (_, out)), _ = run(jmodel, batch, params)
    want = np.asarray(out["flows"])
    got = tmodel({"images": torch.from_numpy(batch["images"])})["flows"]
    assert got.shape == want.shape and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    return got.numpy(), want


@pytest.fixture(scope="module")
def flownetc_step():
    jmodel, tmodel, _ = build("flownetc", 130)
    batch = synthetic_batch(131, h=128, w=128)
    return jmodel, tmodel, batch, compiled_step(jmodel, batch)


def test_train_step_matches_jax_value_and_grad(flownetc_step):
    """The five flows within 5e-3 px, the loss within 1e-5 and every
    parameter's gradient within 1e-3 of the JAX package's, the shared
    trunk's and the correlation's neighbours' among them."""
    jmodel, tmodel, batch, run = flownetc_step

    def step(jm, b):
        (loss, (state, out)), grads = run(jm, b)
        return (loss, (state, out["flow_preds"])), grads

    named = assert_list_step_matches(tmodel, batch, jmodel, step=step)
    for name in ("conv1.0.weight", "conv3.0.weight", "conv_redir.0.weight",
                 "conv3_1.0.weight", "predict_flow6.weight",
                 "upsampled_flow6_to_5.weight"):
        assert named[name].abs().max() > 0, name


def test_eval_forward_matches_jax(flownetc_step):
    """``flownetc``'s eval forward of the step's two 128x128 pairs: its
    441-channel dilated correlation (radius 10, dilation 2) included,
    within 5e-3 px of the JAX package's, flows of a few pixels."""
    jmodel, tmodel, batch, run = flownetc_step
    _, want = assert_eval_matches_step(tmodel, jmodel, run, batch)
    assert 1.0 < np.abs(want).max() < 100.0
