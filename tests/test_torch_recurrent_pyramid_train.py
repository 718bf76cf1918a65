"""The PyTorch port's train steps of the coarse-to-fine recurrent-pyramid
family against ``jax.value_and_grad`` of the JAX package's, on the CPU:
``rapidflow`` (RAFT's L1 sequence loss over every level's steps) here,
``dpflow`` with its Laplace-mixture loss in
``tests/test_torch_dpflow_train.py`` and with ``loss="l1"`` in
``tests/test_torch_dpflow_l1_train.py``: the JAX package takes ~20 s to
trace and compile one DPFlow step, so each sits in a file of its own.

Weights are drawn and conditioned as ``tests/test_torch_rapidflow.py``
says.  ``rapidflow`` runs at the registered widths, one block deep, one
step a level (3 levels at 64x96); ``dpflow`` (``DP_TRAIN``) at narrow
widths, one block deep, one step a level on an explicit 2-level pyramid:
at the registered widths (seed 51, one block deep, 3 levels) the JAX
package's own fp32 gradient of the encoder's stem is 1.4% off its float64
gradient, where the port's fp32 gradient is within 3e-6 of the port's
float64 one and of JAX's float64 one.  ``assert_step_matches``
(``tests/test_torch_lcv_train.py``) holds the predictions within 5e-3 px,
the loss within 1e-5 relative and every gradient within 1e-3 of its
tensor's largest.
"""

import numpy as np

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_lcv_train import assert_step_matches, jax_step
from tests.test_torch_rapidflow import build
from tests.test_torch_train import synthetic_batch

# DPFlow's train-step configuration: the encoder at hidden widths 16, 24,
# 32 and 96 output channels (32 matching, 16 + 16 context a frame), the
# decoder's hidden state and input at 32
DP_TRAIN = {"pyramid_levels": 2, "iters_per_level": 1, "enc_depth": 1,
            "dec_gru_depth": 1, "enc_hidden_chs": (16, 24, 32),
            "enc_out_1x1_chs": "96", "dec_net_chs": 32, "dec_inp_chs": 32,
            "dec_flow_head_chs": 64}


def check_step(name, seed, args, n_preds):
    """One step at 64x96, batch 2 (ground truth of a few px, some of it
    above ``max_flow``, a fifth of the pixels invalid): the ``n_preds``
    predictions, the loss and every gradient as ``assert_step_matches``
    holds them; the flow head's last convolution gets a gradient.
    Returns the port's model, the batch and its named gradients."""
    jmodel, tmodel, _ = build(name, seed, **args)
    batch = synthetic_batch(seed)
    (jloss, (_, jpreds)), jgrads = jax_step(jmodel, batch)
    assert jpreds.shape == (n_preds, 2, 64, 96, 2)
    assert np.isfinite(float(jloss))
    tparams, grads = assert_step_matches(tmodel, batch, jloss, jgrads,
                                         jpreds=jpreds)
    named = dict(zip(tparams, grads))
    assert named["update_block.flow_head.conv2.weight"].abs().max() > 0
    return tmodel, batch, named


def test_rapidflow_train_step_matches_jax_value_and_grad():
    """``check_step`` of ``rapidflow``: 3 levels, one step each, the last
    through the convex mask; the NeXt1D factors of every stage get
    gradients."""
    _, _, named = check_step("rapidflow", 50, {"iters": 3, "enc_depth": 1,
                                               "dec_depth": 1}, 3)
    for key in ("fnet.rec_stage.blocks.0.conv_dw.weight_h",
                "update_block.decoder.conv.blocks.0.conv_dw.weight_v",
                "upnet_layer.2.blocks.0.conv_dw.weight_h"):
        assert named[key].abs().max() > 0, key
