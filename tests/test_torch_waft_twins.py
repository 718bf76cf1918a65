"""The PyTorch port's ``waft_twins_a2`` eval forward against the JAX
package's, on the CPU: 2 refinements, the second warping by the first's
flow.

The model is built as ``tests/test_torch_waft.py`` builds it (small ViTs,
the Twins third stage shallow, conditioned weights); the JAX compilation of
the Twins backbone sets it apart from that file and from the train step in
``tests/test_torch_waft_train.py``.
"""

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_waft import (assert_eval_forward_matches, build,
                                   small_vits)  # noqa: F401


def test_eval_forward_matches_jax(small_vits):  # noqa: F811
    jmodel, tmodel, _ = build("waft_twins_a2", 40, iters=2)
    assert_eval_forward_matches(jmodel, tmodel, "waft_twins_a2", 41)
