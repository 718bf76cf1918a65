"""The PyTorch port's CCMR+ (``ccmr_p``: 4 scales, from 1/16 to 1/2)
against the JAX package's, on the CPU: the eval forward and the warm start
at 64x96, 2 iterations a scale, weights and checks as
``tests/test_torch_ms_raft_plus.py`` makes them (its own module: the JAX
model's compile)."""

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_ms_raft_plus import build, check_eval_and_warm_start


def test_eval_forward_and_warm_start_match_jax():
    jmodel, tmodel, _ = build("ccmr_p", 154, iters=(2, 2, 2, 2))
    check_eval_and_warm_start(jmodel, tmodel, 155)
