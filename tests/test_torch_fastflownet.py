"""The port's FastFlowNet against the JAX package's, on the CPU, at 128x192
(1/64: 2x3), batch 2: one training step against ``jax.value_and_grad``
(``MultiScaleLoss`` over the five levels' flows), the eval forward and
``validate --bf16``'s weight cast, the last two held to the ``flows`` of
the same compiled step (without BatchNorm the JAX package's training
forward computes the eval ``flows``).

The mean is taken over both frames together; the cost volume keeps 53 of
the 81 displacements of the 9x9 correlation; the decoders shuffle their
grouped channels.  Weights are ``random_params``; each level's decoder
output (``decoder*.conv7``) is damped by 0.1, which leaves flows of a few
pixels (undamped, random decoders add up to ~40 px at this size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

from ptlflow_tpu import nn as jnn
from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
from tests.test_torch_flownet import build
from tests.test_torch_flownet_train import (assert_eval_matches_step,
                                            compiled_step)
from tests.test_torch_pwcnet_train import assert_list_step_matches
from tests.test_torch_train import synthetic_batch

H, W = 128, 192
HEADS = ("decoder*.conv7",)


@pytest.fixture(scope="module")
def fastflownet_step():
    jmodel, tmodel, _ = build("fastflownet", 142, HEADS, meta=False)
    batch = synthetic_batch(143, h=H, w=W)
    return jmodel, tmodel, batch, compiled_step(jmodel, batch)


def test_train_step_matches_jax_value_and_grad(fastflownet_step):
    """One step: the five flows (1/4 to 1/64) within 5e-3 px, the loss
    within 1e-5 and every parameter's gradient within 1e-3 of the JAX
    package's, the coarsest decoder's and the pyramid's first
    convolution's among them."""
    jmodel, tmodel, batch, run = fastflownet_step

    def step(jm, b):
        (loss, (state, out)), grads = run(jm, b)
        return (loss, (state, out["flow_preds"])), grads

    named = assert_list_step_matches(tmodel, batch, jmodel, step=step)
    for name in ("pconv1_1.0.weight", "decoder6.conv1.0.weight",
                 "decoder2.conv7.weight", "up6.weight", "rconv6.0.weight"):
        assert named[name].abs().max() > 0, name


def test_eval_forward_and_bf16_cast_match_jax(fastflownet_step):
    """``flows`` within 5e-3 px of the JAX package's, of a few pixels.
    Then ``validate --bf16`` (``fastflownet`` is on the allow-list): the
    port's weights cast to bfloat16, each layer computing in the float32
    images' dtype, within 5e-3 px of the JAX package's forward on
    ``cast_params(params, bfloat16)``, and off the float32 flows by more
    than that (the cast took place).  The JAX layers cast those weights
    back to the float32 input's dtype, so the compiled step runs the cast
    tree's values exactly (cast back to float32)."""
    jmodel, tmodel, batch, run = fastflownet_step
    got, want = assert_eval_matches_step(tmodel, jmodel, run, batch)
    assert 1.0 < np.abs(want).max() < 100.0

    rounded = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        jnn.cast_params(jmodel.params, jnp.bfloat16))
    assert cast_to_bf16(tmodel, "fastflownet")
    assert tmodel.decoder2.conv7.weight.dtype == torch.bfloat16
    assert tmodel.up3.weight.dtype == torch.bfloat16
    got_bf16, _ = assert_eval_matches_step(tmodel, jmodel, run, batch,
                                           rounded)
    assert np.abs(got_bf16 - got).max() > 5e-3
