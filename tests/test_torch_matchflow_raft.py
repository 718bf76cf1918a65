"""The PyTorch port's ``matchflow_raft`` (MatchFlow's quadtree matching
features under RAFT's update block) against the JAX package's, on the CPU:
the eval forward and the warm start, at 64x96 and 3 iterations, weights and
checks as ``tests/test_torch_matchflow.py`` makes them (its own module: the
JAX model's compile)."""

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_matchflow import ITERS, build, check_eval_and_warm_start


def test_eval_forward_and_warm_start_match_jax():
    check_eval_and_warm_start(build("matchflow_raft", 115, iters=ITERS))
