"""The PyTorch port's NeuFlow v2 training step against
``jax.value_and_grad`` of the JAX package's, on the CPU.

NeuFlow v2 does not stop the flow's gradient between its refinement steps,
so the gradient reaches the global matching through the coords of every
lookup, as the JAX package's XLA lookup gives it; its loss is
``SequenceLoss2`` with the fixed weights (0.2, 1, 1).  Weights are drawn
as ``tests/test_torch_neuflow2.py`` says.
"""

import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu import nn as jnn
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests import test_torch_neuflow2
from tests.test_torch_lcv_train import assert_step_matches
from tests.test_torch_train import bn_stats, synthetic_batch


def jax_step_but(jmodel, batch, leaked):
    """``tests/test_torch_lcv_train.py::jax_step`` with the BatchNorm
    statistics of the module ``leaked`` left out of the new state: the JAX
    package's NeuFlow v2 runs ``conv_s8`` in training inside ``lax.scan``,
    whose BatchNorm writes its running statistics into the parameter tree
    from the scan's trace, so they are leaked tracers that no jitted step
    can return (the JAX package's own train step fails on them)."""
    def loss_and_updates(trainable, bn_state, jbatch):
        full = jnn.merge_params(jnn.tree_copy(trainable),
                                jnn.tree_copy(bn_state))
        outputs = jmodel.forward(full, jbatch, training=True)
        loss = jmodel.loss_fn(outputs, jbatch)
        _, new_state = jnn.split_trainable(full, ())
        new_state.pop(leaked)
        return loss, (new_state, outputs["flow_preds"])

    trainable, state = jnn.split_trainable(jmodel.params, ())
    return jax.jit(jax.value_and_grad(loss_and_updates, has_aux=True))(
        trainable, state, {k: jnp.asarray(v) for k, v in batch.items()})


def test_neuflow2_train_step_matches_jax_value_and_grad():
    """One step of ``neuflow2`` (1 + 2 refinement steps, 64x96, batch 2,
    BatchNorm on batch statistics): the 3 predictions, the loss and every
    gradient, the global matching's cross-attention among them, as
    ``assert_step_matches`` holds them; the BatchNorm statistics within
    1e-5 of the JAX package's but those of ``conv_s8`` (see
    ``jax_step_but``), which the port moves at each of its 2 calls in the
    step, as the reference's torch modules do."""
    jmodel, tmodel, _ = test_torch_neuflow2.build(210, iters_s8=2)
    batch = synthetic_batch(210)
    start = bn_stats(tmodel)
    (jloss, (jstate, jpreds)), jgrads = jax_step_but(jmodel, batch,
                                                     "conv_s8")
    assert np.asarray(jpreds).shape == (3, 2, 64, 96, 2)
    tparams, grads = assert_step_matches(tmodel, batch, jloss, jgrads,
                                         jpreds=jpreds)
    want_stats = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), tmodel)
    moved = bn_stats(tmodel)
    for name, v in moved.items():
        if name.startswith("conv_s8."):
            assert not torch.equal(v, start[name]), name
        else:
            torch.testing.assert_close(v, want_stats[name], rtol=0,
                                       atol=1e-5, msg=name)
    assert tmodel.conv_s8.norm1.num_batches_tracked.item() == 2
    named = dict(zip(tparams, grads))
    for name in ("cross_attn_s16.layers.0.q_proj.weight",
                 "backbone.block_16_1.conv1.weight",
                 "refine_s16.conv3.weight", "conv_s8.conv1.weight"):
        assert named[name].abs().max() > 0, name
