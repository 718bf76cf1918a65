"""The PyTorch port's StreamFlow training step against
``jax.value_and_grad`` of the JAX package's, on the CPU.

Its loss is the sequence loss summed over the 3 frame pairs, each against
its own ground truth.  Weights are drawn as
``tests/test_torch_streamflow.py`` says; NeuFlow v2's step is
``tests/test_torch_neuflow2_train.py``.
"""

import numpy as np

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests import test_torch_streamflow
from tests.test_torch_lcv_train import assert_step_matches, jax_step


def test_streamflow_train_step_matches_jax_value_and_grad():
    """One step of ``streamflow`` (2 iterations, 4 frames of 48x64, batch
    1, which its lack of BatchNorm allows and which keeps the JAX step
    short; 3 ground-truth flows): every iteration's 3 flows, the loss and every
    gradient, the temporal transformer's (drawn, not zero) among them."""
    jmodel, tmodel, _ = test_torch_streamflow.build(211, iters=2)
    batch = test_torch_streamflow.batch_of(211, b=1, h=48, w=64)
    (jloss, (jstate, jpreds)), jgrads = jax_step(jmodel, batch)
    # pairs first in the JAX package: (pairs, iters, B, H, W, 2)
    jpreds = np.moveaxis(np.asarray(jpreds), 0, 2)
    assert jpreds.shape == (2, 1, 3, 48, 64, 2)
    tparams, grads = assert_step_matches(tmodel, batch, jloss, jgrads,
                                         jstate, jpreds)
    named = dict(zip(tparams, grads))
    for name in ("update_block.transformer_block.transformer_block.attn."
                 "qkv.weight", "fnet.svt.blocks.1.1.attn.q.weight",
                 "att.to_qk.weight", "update_block.flow_head.ffn2.2.weight"):
        assert named[name].abs().max() > 0, name
