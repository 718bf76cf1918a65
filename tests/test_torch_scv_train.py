"""The PyTorch port's SCV training step against ``jax.value_and_grad`` of
the JAX package's, on the CPU.

Its compilation sets it apart from ``tests/test_torch_scv.py``, whose
docstring says how the weights are made.
"""

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_matchflow_train import assert_whole_step_matches
from tests.test_torch_scv import build
from tests.test_torch_train import synthetic_batch


def test_train_step_matches_jax_value_and_grad():
    """One step of ``scv4`` (2 iterations, 64x96, batch 2), held by
    ``tests/test_torch_matchflow_train.py::assert_whole_step_matches``;
    the feature encoder gets its gradient through the selected scores
    alone.

    Per tensor the step is ill-conditioned in the context encoder (its
    BatchNorms on batch statistics at 16x24): on batch seeds 135-144 the
    port's input one rounding off moves the port's worst tensor by 12 to
    127 times 1e-3 of that tensor's largest element, and on seeds 135-141
    the JAX package's and the port's float32 steps are 6 to 54 times it
    apart, each as far from a float64 run of the port.  The whole gradient
    holds, but its top-k selection may not: on seed 139 the two part by up
    to 0.5 px in 12% of the flows, as the port parts from itself with its
    input one rounding off, where one row's set of 32 matches changes.  On this seed the flows agree within 6.1e-5 px, the
    whole gradients within 1.1e-4 (largest element) and 7.6e-5 (norm),
    and the port is 1.4e-4 and 1.0e-4 off float64."""
    jmodel, tmodel = build("scv4", 134, iters=2)
    named, _ = assert_whole_step_matches(tmodel, synthetic_batch(140),
                                         jmodel, 2)
    for name in ("fnet.conv1.weight", "fnet.layer3.1.downsample.0.weight",
                 "cnet.layer1.0.norm3.weight"):
        assert named[name].abs().max() > 0, name
