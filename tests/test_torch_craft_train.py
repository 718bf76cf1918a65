"""The PyTorch port's CRAFT training step against ``jax.value_and_grad`` of
the JAX package's, on the CPU.

Its compilation sets it apart from ``tests/test_torch_craft.py``, whose
docstring says how the weights are drawn.  The lookup's gradient flows
into the inter-frame attention that builds the cost volume, and the tied
``query``/``key`` layer of that attention is one parameter.
"""

import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

from ptlflow_tpu_torch.parallel import train as ttrain
from tests.test_torch_craft import H, ITERS, W, build
from tests.test_torch_lcv_train import assert_step_matches, jax_step
from tests.test_torch_train import synthetic_batch


def test_train_step_matches_jax_value_and_grad():
    """One step of ``craft`` (2 iterations, 64x96, batch 2): every
    iteration's flow, the loss, the BatchNorm statistics and every
    gradient, the attention's among them, as ``assert_step_matches`` holds
    them; then an optimizer step moves ``query`` and ``key`` together."""
    jmodel, tmodel, _ = build(200, iters=ITERS)
    batch = synthetic_batch(200)
    (jloss, (jstate, jpreds)), jgrads = jax_step(jmodel, batch)
    assert jpreds.shape == (ITERS, 2, H, W, 2)
    assert "key" not in jgrads["corr_fn"]["setrans"]
    tparams, grads = assert_step_matches(tmodel, batch, jloss, jgrads,
                                         jstate, jpreds)
    named = dict(zip(tparams, grads))
    assert "corr_fn.setrans.key.weight" not in named
    for name in ("corr_fn.setrans.query.weight",
                 "corr_fn.vispos_encoder.pos_coder.biases",
                 "corr_fn.setrans.attn_softaggr.feat2score.weight",
                 "f2_trans.setrans.key.weight",
                 "att.setrans.query.weight",
                 "update_block.aggregator.first_linear.weight"):
        assert named[name].abs().max() > 0, name

    st = tmodel.corr_fn.setrans
    before = st.query.weight.detach().clone()
    tx = ttrain.make_optimizer(lr=1e-3, wdecay=1e-4, total_steps=10,
                               pct_start=0.05, grad_clip=1.0)
    step = ttrain.build_train_step(tmodel, tx)
    state = ttrain.create_train_state(tmodel, tx)
    step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert st.key.weight is st.query.weight
    assert not torch.equal(st.query.weight.detach(), before)
    sd = tmodel.state_dict()
    torch.testing.assert_close(sd["corr_fn.setrans.key.weight"],
                               sd["corr_fn.setrans.query.weight"],
                               rtol=0, atol=0)
    assert np.isfinite(sd["corr_fn.setrans.key.weight"].numpy()).all()
