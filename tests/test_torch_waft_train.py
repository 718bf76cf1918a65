"""The PyTorch port's ``waft_twins_a2``: its training step against
``jax.value_and_grad`` of the JAX package's, on the CPU.

The model is built as ``tests/test_torch_waft.py`` builds it (small ViTs,
the Twins third stage shallow, conditioned weights); its compilation sets
it apart from that file, and from ``tests/test_torch_waft_twins.py``, which
holds its eval forward.  The step leaves out the frozen Twins backbone
(``frozen_prefixes``), in both packages; the fusion head over it, the
ResNet18-deconv net, the refine ViT and the heads train.
"""

import numpy as np

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_lcv_train import assert_step_matches, jax_step
from tests.test_torch_train import synthetic_batch
from tests.test_torch_waft import build, small_vits  # noqa: F401

ITERS = 2


def test_train_step_matches_jax_value_and_grad(small_vits):  # noqa: F811
    """One step (2 refinements, 64x96, batch 2): both refinements' flows,
    the loss (the Laplace-mixture NLL's finite, valid mean) and every
    trainable tensor's gradient, as ``assert_step_matches`` holds them;
    the backbone gets none, the Twins fusion and the refine ViT do.

    As ``tests/test_torch_train.py`` says of ``raft``, one step's gradient
    is ill-conditioned at this size with random weights: a ReLU input of
    the fusion head's residual units within rounding of 0 takes either
    side in two float32 implementations.  A float64 run of the port
    decides which one flipped: at one torch thread, batch seeds 42, 46 and
    47 flip the port's float32 step (worst tensors ``encoder.scratch.0``
    and ``encoder.refine.0``, 1.1e-3 to 8.8e-3 of their largest from
    float64, where the JAX package's is within 1e-6), seeds 45 and 49 the
    JAX package's or both (``upsample_weight.0``, 3.7e-3).  This seed
    flips neither: every tensor agrees within 2.6e-6 of its largest."""
    jmodel, tmodel, _ = build("waft_twins_a2", 40, iters=ITERS)
    frozen = tmodel.frozen_prefixes
    batch = synthetic_batch(48)
    (jloss, (_, jpreds)), jgrads = jax_step(jmodel, batch, frozen)
    assert jpreds.shape == (ITERS, 2, 64, 96, 2)
    tparams, grads = assert_step_matches(tmodel, batch, jloss, jgrads,
                                         jpreds=jpreds, frozen=frozen)
    named = dict(zip(tparams, grads))
    assert not any(n.startswith("encoder.backbone.") for n in named)
    for name in ("encoder.final.weight", "encoder.scratch.0.weight",
                 "refine_net.blks.0.attn.qkv.weight",
                 "refine_net.pos_embed", "fnet.ds1.conv.1.weight",
                 "flow_head.2.weight"):
        assert named[name].abs().max() > 0, name
    assert np.isfinite(float(jloss))
