"""The PyTorch port's ``dpflow`` train step with its Laplace-mixture loss
against ``jax.value_and_grad`` of the JAX package's, on the CPU
(``tests/test_torch_recurrent_pyramid_train.py`` says how the weights are
drawn, at which widths the step runs, and why it sits in a file of its
own)."""

import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_recurrent_pyramid_train import DP_TRAIN, check_step


def test_laplace_train_step_matches_jax_value_and_grad():
    """``check_step`` on a 2-level pyramid, one step a level; the info
    channels of the flow head get gradients, and the NLL of every
    prediction (``nf_preds``) is finite."""
    tmodel, batch, named = check_step("dpflow", 51, DP_TRAIN, 2)
    head = named["update_block.flow_head.conv2.weight"]
    assert head.shape[0] == 6 and head[2:].abs().max() > 0
    with torch.no_grad():
        out = tmodel({k: torch.from_numpy(v) for k, v in batch.items()},
                     training=True)
    assert out["nf_preds"].shape == (2, 2, 2, 64, 96)
    assert out["info_preds"].shape == (2, 2, 4, 64, 96)
    assert torch.isfinite(out["nf_preds"]).all()
