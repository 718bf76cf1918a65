"""The PyTorch port's MS-RAFT+ training step against ``jax.value_and_grad``
of the JAX package's, on the CPU.

Its compilation sets it apart from ``tests/test_torch_ms_raft_plus.py``,
whose docstring says how the weights are made; both encoders keep one
residual block a layer here (``shallow``: the JAX step takes 27 s to
trace, compile and run with two and 23 s with one).  The step runs on
``AltCorrBlock``, whose backward gathers the patches again
(``tests/test_torch_alt_corr.py``).
"""

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_matchflow_train import assert_whole_step_matches
from tests.test_torch_ms_raft_plus import build
from tests.test_torch_train import synthetic_batch

ITERS = (2, 2, 2, 2)
# the JAX package's step runs its update blocks' backward on the CPU for
# 21 s at 64x96 (tracing and compiling it take 19 s more); at 32x48 the
# scales are 2x3 to 16x24
H, W = 32, 48


def test_train_step_matches_jax_value_and_grad():
    """One step of ``ms_raft_p`` (2 iterations a scale, 32x48, batch 1):
    all 8 iterations' flows upsampled to the input, held by
    ``tests/test_torch_matchflow_train.py::assert_whole_step_matches``
    (GroupNorm: no statistics); the feature encoder's finest up layer gets
    its gradient through the 1/2 scale's on-the-fly correlation.

    The random 4-scale step is ill-conditioned per tensor: the port's input
    one rounding off moves the port's worst tensor by 1.6 to 13 times 1e-3
    of that tensor's largest element (batch seeds 143-145) and, on seeds
    143 and 144, the whole gradient by 4.0e-4 to 2.4e-3.  On this seed it
    moves the whole gradient by 1.0e-4 (largest element) and 7.5e-5
    (norm); the port and the JAX package are 2.5e-7 and 6.3e-7 apart.
    At 64x96, batch 2 and two blocks a layer the worst tensor moves by
    9.5 to 37 times 1e-3 (seeds 143, 144)."""
    jmodel, tmodel, _ = build("ms_raft_p", 142, shallow=True, iters=ITERS)
    batch = synthetic_batch(145, b=1, h=H, w=W)
    named, _ = assert_whole_step_matches(tmodel, batch, jmodel, sum(ITERS))
    for name in ("fnet.up_layer0.0.conv2.weight", "fnet.conv1.weight",
                 "cnet.up_layer0.0.norm1.weight",
                 "update_block.mask.2.weight"):
        assert named[name].abs().max() > 0, name
