"""The PyTorch port's MemFlow training step against ``jax.value_and_grad``
of the JAX package's pure forward, on the CPU.

Its compilation sets it apart from ``tests/test_torch_memflow.py``; the
weights are drawn and conditioned as ``tests/test_torch_skflow.py`` says.
"""

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_lcv_train import assert_step_matches, jax_step
from tests.test_torch_skflow import H, W, build
from tests.test_torch_train import synthetic_batch

DEPTH = 2


def test_train_step_matches_jax_value_and_grad():
    """One step of ``memflow`` (2 decoder steps, 64x96, batch 2; the
    training forward reads an empty memory, as the JAX train step's pure
    ``forward``): every step's flow, the loss, the BatchNorm statistics
    and every gradient, the memory path's ``to_qk``, ``to_v`` and
    ``gamma`` among them, as ``assert_step_matches`` holds them.

    One step's gradient is ill-conditioned at this size with random
    weights (``tests/test_torch_train.py``): on seed 140 the feature
    encoder's first convolutions are 1.8e-3 off the JAX package's, and the
    port with its input one rounding off moves them by 2.0e-3.  This seed
    agrees within 4.5e-6 per tensor."""
    jmodel, tmodel, _ = build("memflow", 141, decoder_depth=DEPTH)
    batch = synthetic_batch(141)
    (jloss, (jstate, jpreds)), jgrads = jax_step(jmodel, batch)
    assert jpreds.shape == (DEPTH, 2, H, W, 2)
    tparams, grads = assert_step_matches(tmodel, batch, jloss, jgrads,
                                         jstate, jpreds)
    named = dict(zip(tparams, grads))
    for name in ("network.att.to_qk.weight",
                 "network.update_block.aggregator.to_v.weight",
                 "network.update_block.aggregator.gamma"):
        assert named[name].abs().max() > 0, name
