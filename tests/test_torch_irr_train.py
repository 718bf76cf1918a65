"""The port's IRR-PWC training step against ``jax.value_and_grad`` of the
JAX package's, on the CPU: both directions' flows and occlusions under
``MultiScaleEPE_PWC_Bi_Occ_upsample``, the EPE and the balanced F1
occlusion loss weighted to each other by ratios that carry no gradient.
Its compilation sets it apart from ``tests/test_torch_irr.py``, whose
``build_irr`` draws the weights; the eval forwards of ``irr_pwc`` and
``scopeflow`` are held here too, to the same compiled step: the JAX
package's IRR-PWC computes the same flows and occlusions in training,
where it only adds ``flow_preds``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

from ptlflow_tpu import nn as jnn
from tests.test_torch_irr import H, W, build_irr
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_pwcnet_train import assert_list_step_matches
from tests.test_torch_train import synthetic_batch


def irr_batch():
    """One 128x128 pair with backward flows and both occlusion maps."""
    batch = synthetic_batch(121, b=1, h=H, w=W)
    rng = np.random.RandomState(122)
    batch["flows_b"] = (3 * rng.randn(1, 1, 2, H, W)).astype(np.float32)
    for key in ("occs", "occs_b"):
        batch[key] = (rng.rand(1, 1, 1, H, W) > 0.7).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def irr_step():
    """(JAX model, port model, the JAX step compiled once): the step maps
    (trainable, state, batch) to ((loss, (state, outputs)), gradient),
    outputs holding ``flow_preds`` and the four eval outputs."""
    jmodel, tmodel, _ = build_irr("irr_pwc", 120)

    def loss_and_outputs(trainable, bn_state, jbatch):
        full = jnn.merge_params(jnn.tree_copy(trainable),
                                jnn.tree_copy(bn_state))
        out = jmodel.forward(full, jbatch, training=True)
        _, new_state = jnn.split_trainable(full)
        keep = ("flow_preds", "flows", "flows_b", "occs", "occs_b")
        return jmodel.loss_fn(out, jbatch), (new_state, {
            k: out[k] for k in keep})

    trainable, state = jnn.split_trainable(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in irr_batch().items()}
    step = compile_o0(jax.value_and_grad(loss_and_outputs, has_aux=True),
                      trainable, state, jbatch)
    return jmodel, tmodel, step


def test_train_step_matches_jax_value_and_grad(irr_step):
    """One step of ``irr_pwc`` at 128x128, batch 1, with backward flows and
    both occlusion maps in the batch: the 7 levels' flows (5 estimation
    levels of 4, 2 upsampling levels of 2), the loss and every parameter's
    gradient; the occlusion branch, the refinements and the occlusion
    upsampler get a gradient.

    Held as one vector (``whole``): per tensor the refinements' first
    convolutions carry small, ill-conditioned gradients.  The port's whole
    gradient is 1.5e-5 (largest element) and 5.4e-6 (norm) off the JAX
    package's; against a float64 run of the port, ``refine_occ.convs.1``
    is 4.2e-3 off in both (and the port's input one rounding off moves its
    whole gradient by 1.0e-6), and the JAX package's
    ``refine_flow.convs.0`` 2.2e-3, where the port's is within 2e-3."""
    jmodel, tmodel, step = irr_step

    def jax_step(jm, batch):
        trainable, state = jnn.split_trainable(jm.params)
        (loss, (new_state, out)), grads = step(
            trainable, state, {k: jnp.asarray(v) for k, v in batch.items()})
        return (loss, (new_state, out["flow_preds"])), grads

    named = assert_list_step_matches(tmodel, irr_batch(), jmodel,
                                     whole=True, step=jax_step)
    for name in ("occ_estimators.conv_last.0.weight",
                 "occ_shuffle_upsample.out_convs.0.weight",
                 "refine_occ.convs.6.0.weight",
                 "refine_flow.convs.6.0.weight", "conv_1x1_1.0.weight",
                 "feature_pyramid_extractor.convs.0.0.0.weight"):
        assert named[name].abs().max() > 0, name


@pytest.mark.parametrize("name", ["irr_pwc", "scopeflow"])
def test_eval_forward_matches_jax(irr_step, name):
    """The eval forward of ``irr_pwc`` and of ``scopeflow`` (IRR-PWC's
    architecture; its quirk touches only ``flow_preds``), each on its own
    seeded weights: ``flows``, ``flows_b``, ``occs`` and ``occs_b`` within
    5e-3 of the JAX package's (its training forward through the compiled
    step), no autograd graph, the occlusions in [0, 1]."""
    _, _, step = irr_step
    jmodel, tmodel, _ = build_irr(name, 110)
    batch = irr_batch()
    trainable, state = jnn.split_trainable(jmodel.params)
    (_, (_, want)), _ = step(trainable, state,
                             {k: jnp.asarray(v) for k, v in batch.items()})
    got = tmodel({"images": torch.from_numpy(batch["images"])})
    for key in ("flows", "flows_b", "occs", "occs_b"):
        assert got[key].grad_fn is None
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=5e-3, err_msg=key)
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["occs"].shape == (1, 1, 1, H, W)
    assert 0.5 < np.abs(np.asarray(want["flows"])).max() < 100.0
    assert 0.0 <= got["occs"].min() and got["occs"].max() <= 1.0
