"""The port's PWC-Net training step against ``jax.value_and_grad`` of the
JAX package's, on the CPU (``MultiScaleLoss`` over the five decoders'
flows).  Its compilation sets it apart from ``tests/test_torch_pwcnet.py``,
whose ``build`` draws the weights; ``assert_list_step_matches`` also holds
the IRR steps, whose predictions are lists of lists."""

import jax
import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax.numpy as jnp

from ptlflow_tpu import nn as jnn
from ptlflow_tpu_torch import nn as tnn
from ptlflow_tpu_torch.parallel import train as ttrain
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_pwcnet import build, compile_o0
from tests.test_torch_train import bn_stats, nhwc, synthetic_batch


def flat_preds(preds):
    """A nested list of prediction tensors, depth first."""
    if isinstance(preds, (list, tuple)):
        return [t for p in preds for t in flat_preds(p)]
    return [preds]


def jax_step(jmodel, batch):
    """``tests/test_torch_lcv_train.py::jax_step`` (the loss, the new
    BatchNorm statistics and the predictions, and the gradient), compiled
    by ``compile_o0``."""
    def loss_and_updates(trainable, bn_state, jbatch):
        full = jnn.merge_params(jnn.tree_copy(trainable),
                                jnn.tree_copy(bn_state))
        outputs = jmodel.forward(full, jbatch, training=True)
        _, new_state = jnn.split_trainable(full)
        return jmodel.loss_fn(outputs, jbatch), (new_state,
                                                 outputs["flow_preds"])

    trainable, state = jnn.split_trainable(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.value_and_grad(loss_and_updates, has_aux=True)
    return compile_o0(step, trainable, state, jbatch)(trainable, state,
                                                       jbatch)


def assert_list_step_matches(tmodel, batch, jmodel, keys=("flow_preds",),
                             whole=False, step=None):
    """One train step of ``tmodel`` against ``jax.value_and_grad`` of
    ``jmodel`` on ``batch``: every prediction under ``keys`` (nested lists
    of NCHW tensors against the JAX package's NHWC ones) within 5e-3 px,
    the loss within 1e-5 relative, the gradient within 1e-3 of the JAX
    package's, by tensor (of its largest element, or 1e-6 of the model's
    largest where both hold only rounding), or where ``whole`` as one
    vector by its largest element and by its norm, and the BatchNorm
    statistics within 1e-5.  ``step(jmodel, batch)``, where given, stands
    in for ``jax_step``.  Returns the port's gradients by name."""
    (jloss, (jstate, jpreds)), jgrads = (step or jax_step)(jmodel, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with torch.no_grad():
        out = tmodel(tbatch, training=True)
    tmodel.load_state_dict(start, strict=True)  # the BN statistics moved
    for key in keys:
        got, want = flat_preds(out[key]), jax.tree_util.tree_leaves(
            jpreds if key == "flow_preds" else None)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=5e-3)
    tparams, _ = tnn.split_trainable(tmodel)
    loss, grads = ttrain.loss_and_grads(tmodel, tparams, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                               tmodel)
    gmax = max(w.abs().max().item() for w in want.values())
    if whole:
        got = torch.cat([g.flatten() for g in grads])
        ref = torch.cat([want[n].flatten() for n in tparams])
        diff = got - ref
        ratios = (diff.abs().max().item() / ref.abs().max().item(),
                  (diff.norm() / ref.norm()).item())
        assert ratios[0] <= 1e-3 and ratios[1] <= 1e-3, ratios
    else:
        for name, g in zip(tparams, grads):
            w = want[name]
            tol = max(1e-3 * w.abs().max().item(), 1e-6 * gmax)
            assert (g - w).abs().max().item() <= tol, name
    want_stats = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), tmodel)
    for name, v in bn_stats(tmodel).items():
        torch.testing.assert_close(v, want_stats[name], rtol=0, atol=1e-5,
                                   msg=name)
    return dict(zip(tparams, grads))


def test_train_step_matches_jax_value_and_grad():
    """One step of ``pwcnet`` at 64x128 (a multiple of 64, as the loss's
    pooled ground truth needs), batch 2: the five flows (1/4 to 1/64), the
    loss and every parameter's gradient, the dilated-context refinement's
    and the coarsest level's among them."""
    jmodel, tmodel, _ = build("pwcnet", 102)
    named = assert_list_step_matches(tmodel, synthetic_batch(103, h=64,
                                                             w=128), jmodel)
    for name in ("dc_conv1.0.weight", "conv6_0.0.weight", "upfeat6.weight",
                 "conv1a.0.weight"):
        assert named[name].abs().max() > 0, name
