"""The port's DICL against the JAX package's, on the CPU: the learned
matching volume (``compute_cost``: 49 shifted pairs through the shared
matching network, the holes removed), the eval forward at 128x256 (DICL
pads to a multiple of 128), and one train step at 128x256, batch 1,
against ``jax.value_and_grad``.

Weights are ``random_params`` (BatchNorm statistics random, the
displacement-aware projections drawn far from their identity init); the
projections and the context networks' output convolutions are damped by
0.1 (``HEADS``).  Undamped, a random projection sharpens the soft argmax
so that each level's error grows ~20x at the next through its warp: one
float32 rounding of the images moves the train step's 1/4 flow by 4.7 px
(by 1.9e-4 px damped).
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu.models.dicl.dicl import DICL as JDICL
from ptlflow_tpu.models.dicl.dicl import DICLMatch as JDICLMatch
from ptlflow_tpu_torch.models.dicl.dicl import DICL, DICLMatch
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_flownet import build, port_model
from tests.test_torch_flownet_train import compiled_step
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_pwcnet_train import assert_list_step_matches
from tests.test_torch_train import random_params, synthetic_batch

HEADS = ("context_net2.6", "context_net3.6", "context_net4.5",
         "context_net5.4", "context_net6.3", "dap_layer*.dap_layer.conv")


@pytest.mark.parametrize("h,w,holes", [(6, 10, True), (2, 6, False)])
def test_compute_cost_matches_jax(h, w, holes):
    """The (B, 7, 7, H, W) scores within 1e-4 of the JAX package's: both
    halves of each pair zero where the moved features leave the map (a
    2x6 map is smaller than the 7x7 window: whole displacements read
    nothing) or, with ``remove_warp_hole``, sum to 0 (``holes``: some
    pixels of the second map zeroed, as a warp's holes are)."""
    rng = np.random.RandomState(600 + h)
    x = rng.randn(2, 32, h, w).astype(np.float32)
    y = rng.randn(2, 32, h, w).astype(np.float32)
    if holes:
        y[:, :, 1:3, 2:4] = 0.0
    jmatch = JDICLMatch()
    params = random_params(jax.eval_shape(jmatch.init, jax.random.PRNGKey(0)),
                           rng)
    tmatch = DICLMatch().eval()
    tmatch.load_state_dict(state_dict_from_jax(params, tmatch), strict=True)
    jdicl = JDICL(remove_warp_hole=holes)
    tdicl = DICL(remove_warp_hole=holes)
    args = [jnp.asarray(np.moveaxis(a, 1, -1)) for a in (x, y)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = compile_o0(lambda p, a, b: jdicl.compute_cost(
        p, a, b, jmatch, 3, 3), jp, *args)(jp, *args)
    with torch.no_grad():
        got = tdicl.compute_cost(torch.from_numpy(x), torch.from_numpy(y),
                                 tmatch, 3, 3)
    assert got.shape == (2, 7, 7, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_eval_forward_matches_jax():
    """``flows`` within 5e-3 px of the JAX package's at 120x250, which
    both pad (replicate, bottom and right) to 128x256: five levels of
    warps, learned volumes, projections, soft argmaxes, entropies and
    context networks; no autograd graph."""
    jmodel, tmodel, _ = build("dicl", 610, HEADS)
    images = np.random.RandomState(611).rand(1, 2, 3, 120, 250).astype(
        np.float32)
    x = jnp.asarray(images)
    want = compile_o0(lambda p, x: jmodel.forward(p, {"images": x}),
                      jmodel.params, x)(jmodel.params, x)["flows"]
    got = tmodel({"images": torch.from_numpy(images)})["flows"]
    assert got.shape == want.shape == (1, 1, 2, 120, 250)
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)
    assert 1.0 < np.abs(np.asarray(want)).max() < 100.0


@pytest.fixture(scope="module")
def dicl_step():
    jmodel, tmodel, params = build("dicl", 628, HEADS)
    batch = synthetic_batch(629, b=1, h=128, w=256)
    return jmodel, tmodel, params, batch, compiled_step(jmodel, batch)


def test_train_step_matches_jax_value_and_grad(dicl_step):
    """The five levels' flows within 5e-3 px, the multiscale L1 loss
    within 1e-5, the whole gradient within 1e-3 (by its largest element
    and by its norm) and the BatchNorm statistics (the matching networks'
    over the 49 displacements folded into the batch among them) within
    1e-5 of the JAX package's; the flows and entropies reach the context
    networks detached, as the upsampled flows reach the next level.

    The step is ill-conditioned in float32 per tensor and, at larger
    batches, whole: each BatchNorm's backward sums ~1e5 terms that cancel
    (the 49 displacements folded into the batch), and DICL's deepest
    feature maps are 1x2 a frame.  Against the port in float64 the whole
    gradient of the JAX package is 4.1e-4 off here and the port's 8.8e-5
    (by the largest element); at batch 2 they are 3.1e-3 and 1.3e-3, at
    256x256, batch 2, 2.3e-3 and 3.2e-4 (XLA sums a reduction in order)."""
    jmodel, tmodel, _, batch, run = dicl_step

    def step(jm, b):
        (loss, (state, out)), grads = run(jm, b)
        return (loss, (state, out["flow_preds"])), grads

    named = assert_list_step_matches(tmodel, batch, jmodel, step=step,
                                     whole=True)
    for name in ("feature.conv_start.0.conv.weight", "matching2.match.5.bias",
                 "matching6.match.0.bn.weight", "dap_layer3.dap_layer.conv.weight",
                 "context_net4.0.conv.weight", "feature.deconv2b.conv2.bn.bias"):
        assert named[name].abs().max() > 0, name


def test_state_dict_reads_back_into_jax(dicl_step):
    """The port's ``state_dict`` read by the JAX package's ``from_torch``
    is the JAX tree it came from, leaf for leaf."""
    jmodel, _, params, _, _ = dicl_step
    tmodel = port_model("dicl", params)
    back = jmodel.from_torch({k: v.numpy()
                              for k, v in tmodel.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)
