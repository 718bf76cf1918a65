"""The PyTorch port's MatchFlow training step against
``jax.value_and_grad`` of the JAX package's, on the CPU.

Its compilation sets it apart from ``tests/test_torch_matchflow.py``,
whose docstring says how the weights are made; both matching encoders have
one self/cross layer pair here (``shallow``: the JAX compile of the step
takes 27 s with the registered 4 and 13 s with one).  The gradient reaches
the quadtree attention through the lookup's pyramid; its top-k selections
carry none.

``assert_whole_step_matches`` holds a step as ``chip_smoke.py`` holds a
train step card against CPU, and as ``tests/test_torch_memfof_train.py``
holds MEMFOF's: the gradient of the whole model as one vector.  Tensor by
tensor, 1e-3 of each tensor's largest element does not hold between two
float32 implementations of these steps with random weights: a ReLU input
within rounding of 0 takes either side, and moves a small tensor's
gradient by percents.  The docstrings give the numbers.
"""

import jax
import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

from ptlflow_tpu_torch import nn as tnn
from ptlflow_tpu_torch.parallel import train as ttrain
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_lcv_train import jax_step
from tests.test_torch_matchflow import build
from tests.test_torch_train import bn_stats, nhwc, synthetic_batch

ITERS = 2


def assert_whole_step_matches(tmodel, batch, jmodel, iters):
    """One train step of ``tmodel`` against ``jax.value_and_grad`` of
    ``jmodel`` on ``batch``: every iteration's flow (``iters`` of them)
    within 5e-3 px, the loss within 1e-5 relative, the BatchNorm
    statistics within 1e-5, and the gradient of the whole model, as one
    vector, within 1e-3 of the JAX package's by its largest element and by
    its norm.  Returns the port's gradients by name and the two ratios."""
    (jloss, (jstate, jpreds)), jgrads = jax_step(jmodel, batch)
    b, _, _, h, w = batch["images"].shape
    assert jpreds.shape == (iters, b, h, w, 2)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tparams, _ = tnn.split_trainable(tmodel)
    # the predictions are the step's own forward's, caught by a hook: the
    # training forward runs once
    seen = []
    hook = tmodel.register_forward_hook(lambda m, a, out: seen.append(out))
    try:
        loss, grads = ttrain.loss_and_grads(tmodel, tparams, tbatch)
    finally:
        hook.remove()
    assert len(seen) == 1
    np.testing.assert_allclose(nhwc(seen[0]["flow_preds"]),
                               np.asarray(jpreds), atol=5e-3)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                               tmodel)
    got = torch.cat([g.flatten() for g in grads])
    ref = torch.cat([want[n].flatten() for n in tparams])
    diff = got - ref
    ratios = (diff.abs().max().item() / ref.abs().max().item(),
              (diff.norm() / ref.norm()).item())
    assert ratios[0] <= 1e-3 and ratios[1] <= 1e-3, ratios
    want_stats = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), tmodel)
    for name, v in bn_stats(tmodel).items():
        torch.testing.assert_close(v, want_stats[name], rtol=0, atol=1e-5,
                                   msg=name)
    return dict(zip(tparams, grads)), ratios


def test_train_step_matches_jax_value_and_grad():
    """One step of ``matchflow`` (2 iterations, 64x96, batch 2), held by
    ``assert_whole_step_matches``; the quadtree attention's projections
    and level blend and GMA's attention get a gradient.

    Per tensor the step is ill-conditioned in the matching encoder's
    BatchNorm backbone: over batch seeds 117-130 the worst tensor of the
    JAX package's float32 step is 0.5 to 13 times 1e-3 of that tensor's
    largest element off a float64 run of the port, and the port's own
    0.05 to 7 times (``fnet.backbone.conv1.weight`` most often).  On this
    seed the port is 0.12 of it off float64 and the JAX package 0.94; the
    whole gradient parts them by 1.0e-4 (largest element) and 9.4e-5
    (norm), and the port's input one rounding off moves the port's by
    5.4e-6 and 1.4e-5."""
    jmodel, tmodel, _ = build("matchflow", 116, jit_eval=False,
                              shallow=True, iters=ITERS)
    named, _ = assert_whole_step_matches(tmodel, synthetic_batch(119),
                                         jmodel, ITERS)
    for name in ("fnet.loftr_coarse.layers.1.attn.py_att.weight",
                 "fnet.loftr_coarse.layers.0.attn.q_proj.weight",
                 "fnet.backbone.conv1.weight", "att.to_qk.weight",
                 "cnet.conv1.weight"):
        assert named[name].abs().max() > 0, name
