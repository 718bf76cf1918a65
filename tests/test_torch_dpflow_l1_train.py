"""The PyTorch port's ``dpflow`` train step with ``loss="l1"`` (RAFT's
gamma-weighted L1 over the steps, a 2-channel flow head) against
``jax.value_and_grad`` of the JAX package's, on the CPU: the Laplace
case's twin (``tests/test_torch_dpflow_train.py``);
``tests/test_torch_recurrent_pyramid_train.py`` says how the weights are
drawn, at which widths the step runs, and why it sits in a file of its
own."""

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_recurrent_pyramid_train import DP_TRAIN, check_step


def test_l1_train_step_matches_jax_value_and_grad():
    tmodel, _, named = check_step("dpflow", 52, dict(DP_TRAIN, loss="l1"),
                                  2)
    assert named["update_block.flow_head.conv2.weight"].shape[0] == 2
    assert tmodel.loss_fn.loss == "l1"
