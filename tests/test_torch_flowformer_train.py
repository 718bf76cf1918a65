"""The PyTorch port's FlowFormer training step against
``jax.value_and_grad`` of the JAX package's, on the CPU.

Its compilation (~20 s) sets it apart from ``tests/test_torch_flowformer.py``,
whose docstring says how the weights are drawn and conditioned.
"""

import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu_torch.nn import split_trainable
from ptlflow_tpu_torch.parallel import train as ttrain
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_flowformer import DEPTH, H, W, build
from tests.test_torch_train import nhwc, synthetic_batch


def test_train_step_matches_jax_value_and_grad():
    """``flowformer``'s training forward (2 decoder steps, 1 encoder layer:
    the constructor takes it; 64x96, batch 2): every step's flow within
    5e-3 px, ``SequenceLoss`` within 1e-5 relative, and every parameter's
    gradient within 1e-3 of its tensor's largest, or within 1e-6 of the
    model's largest gradient (the relative-position tables GMA's content
    attention never reads get zeros in both)."""
    jmodel, tmodel, params = build("flowformer", 100, jit_eval=False,
                                   encoder_depth=1)
    batch = synthetic_batch(100)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_and_preds(trainable):
        out = jmodel.forward(trainable, jbatch, training=True)
        return jmodel.loss_fn(out, jbatch), out["flow_preds"]

    (jloss, jpreds), jgrads = jax.jit(jax.value_and_grad(
        loss_and_preds, has_aux=True))(jmodel.params)
    want_grads = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), tmodel)

    tparams, _ = split_trainable(tmodel)
    assert set(tparams) <= set(want_grads)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = tmodel(tbatch, training=True)
    assert out["flow_preds"].shape == (DEPTH, 2, 2, H, W)
    np.testing.assert_allclose(nhwc(out["flow_preds"]), np.asarray(jpreds),
                               atol=5e-3)
    loss, grads = ttrain.loss_and_grads(tmodel, tparams, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    gmax = max(w.abs().max().item() for w in want_grads.values())
    for name, g in zip(tparams, grads):
        w = want_grads[name]
        tol = max(1e-3 * w.abs().max().item(), 1e-6 * gmax)
        assert (g - w).abs().max().item() <= tol, name
