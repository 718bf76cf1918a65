"""The port's VCN (``vcn``, ``vcn_small``) against the JAX package's, on
the CPU: the per-channel shifted-product volume (``corrf``), the
truncated soft winner-take-all (``flow_reg``, a planted tie among them),
the masked warp, the butterfly U-Net of separable 4-D convolutions (its
5-D ``Conv3d`` weights converted from the JAX package's 2-D ones), both
names' eval forwards of frames of 100x120, which both packages resize to
128x128 (the 1/64 level 2x2), and one train step.

Weights are ``random_params``; the hypotheses' fusion heads (``dc*_conv7``,
whose softmax picks among the hypotheses) are damped by 0.1.  ``vcn_small``
takes ``vcn``'s draw without the modules it lacks, and one compilation runs
both JAX forwards.

The train step is ``vcn_small``'s two coarsest levels (1/64 and 1/32: the
volume, the butterfly, the winner-take-all, the warp, the hypotheses of
both levels and every term of the loss), batch 1: the JAX package's
full-depth step takes ~50 s to trace and compile, and its frames pair
across samples where the batch holds more than one (the port pairs each
sample's own, ``test_batched_forward_pairs_each_samples_own_frames``).
``chip_smoke.py`` holds the full-depth steps card against CPU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import ptlflow_tpu
from ptlflow_tpu.models.vcn import conv4d as jconv4d
from ptlflow_tpu_torch.models.vcn import conv4d as tconv4d
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_flownet import build, damp_modules, port_model
from tests.test_torch_flownet_train import compiled_step
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_pwcnet_train import assert_list_step_matches
from tests.test_torch_train import random_params, synthetic_batch

# the packages re-export the class ``vcn`` under the module's name
jvcn = importlib.import_module("ptlflow_tpu.models.vcn.vcn")
tvcn = importlib.import_module("ptlflow_tpu_torch.models.vcn.vcn")

HEADS = ("dc*_conv7",)


def subtree(params, shapes):
    """The leaves of the numpy tree ``params`` that the shape tree
    ``shapes`` also holds."""
    return {k: subtree(v, shapes[k]) if isinstance(v, dict) else v
            for k, v in params.items() if k in shapes}


def to_nhwc6(t):
    """(B, C, U, V, H, W) -> (B, U, V, H, W, C), the JAX package's
    layout."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.mark.parametrize("maxdisp,fac", [(4, 1), (3, 2)])
def test_corrf_matches_jax(maxdisp, fac):
    """(B, C, U, V, H, W) products of each pixel with the other map
    shifted by (u, v), zero outside the map, leaky ReLU (0.1): equal to
    the JAX package's (B, U, V, H, W, C), the y shifts fewer by ``fac``."""
    rng = np.random.RandomState(700 + maxdisp)
    ref = rng.randn(2, 5, 6, 7).astype(np.float32)
    tgt = rng.randn(2, 5, 6, 7).astype(np.float32)
    want = jax.jit(lambda a, b: jvcn.corrf(a, b, maxdisp, fac))(
        *(jnp.asarray(np.moveaxis(a, 1, -1)) for a in (ref, tgt)))
    got = tvcn.corrf(torch.from_numpy(ref), torch.from_numpy(tgt), maxdisp,
                     fac)
    v = 2 * (maxdisp // fac) + 1
    assert got.shape == (2, 5, 2 * maxdisp + 1, v, 6, 7)
    np.testing.assert_allclose(to_nhwc6(got), np.asarray(want), atol=1e-6)


def test_flow_reg_matches_jax_on_a_planted_tie():
    """The flow and both entropies within 1e-4 of the JAX package's, on
    volumes where one pixel's two largest scores tie exactly far apart
    (the first, in (u, v) order, sets the 7x7 window, as ``jnp.argmax``
    does) and another's tie inside one window."""
    rng = np.random.RandomState(710)
    x = rng.randn(3, 9, 9, 4, 5).astype(np.float32)
    top = x.max() + 1.0
    x[0, 1, 2, 1, 1] = x[0, 8, 7, 1, 1] = top
    x[1, 4, 4, 2, 3] = x[1, 5, 3, 2, 3] = top
    jreg = jvcn.flow_reg(ent=True, maxdisp=4)
    jflow, jent = jax.jit(lambda a: jreg({}, a))(jnp.asarray(x))
    flow, ent = tvcn.flow_reg(maxdisp=4)(torch.from_numpy(x))
    assert flow.shape == ent.shape == (3, 2, 4, 5)
    np.testing.assert_allclose(flow.numpy(), np.asarray(jflow), atol=1e-4)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), atol=1e-4)
    # the window around (u, v) = (1, 2) reaches u = 4 at most: the tied
    # peak at u = 8 gets no weight, so the flow stays left of 0
    assert flow[0, 0, 1, 1] < 0


def test_warp_with_mask_matches_jax():
    """The bilinear warp and its strict in-map mask, zero outside: equal
    to the JAX package's, with flows that push pixels across every edge
    and onto it."""
    rng = np.random.RandomState(720)
    x = rng.randn(2, 3, 6, 8).astype(np.float32)
    flow = (4 * rng.randn(2, 2, 6, 8)).astype(np.float32)
    flow[0, :, 0, 0] = 0.0  # on the edge: masked, as the strict test says
    jx, jf = (jnp.asarray(np.moveaxis(a, 1, -1)) for a in (x, flow))
    jout, jmask = jax.jit(jvcn.warp_with_mask)(jx, jf)
    out, mask = tvcn.warp_with_mask(torch.from_numpy(x),
                                    torch.from_numpy(flow))
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1),
                               np.asarray(jout), atol=1e-5)
    np.testing.assert_array_equal(np.moveaxis(mask.numpy(), 1, -1),
                                  np.asarray(jmask))
    assert mask[0, 0, 0, 0] == 0 and 0 < mask.mean() < 1


@pytest.mark.parametrize("training", [False, True])
def test_butterfly4D_matches_jax(training):
    """The butterfly U-Net over a (B, 24, 9, 9, 5, 6) volume (projection
    to 8 channels, two (U, V)-strided blocks down to 3 x 3, two up through
    the trilinear (U, V) resize) within 1e-4 of the JAX package's, with
    running statistics (eval) or batch statistics (training); its
    ``Conv3d`` weights are the JAX package's 2-D kernels reshaped."""
    rng = np.random.RandomState(730)
    jmod = jconv4d.butterfly4D(24, 8)
    params = random_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0)),
                           rng)
    tmod = tconv4d.butterfly4D(24, 8)
    state = state_dict_from_jax(params, tmod)
    assert state["conva1.conv1.conv2.0.weight"].shape == (8, 8, 3, 3, 1)
    assert state["conva1.conv1.conv1.0.weight"].shape == (8, 8, 1, 3, 3)
    assert state["proj.0.conv1.weight"].shape == (8, 24, 1, 1, 1)
    tmod.load_state_dict(state, strict=True)
    tmod.train(training)
    x = rng.randn(2, 24, 9, 9, 5, 6).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = jax.jit(lambda p, a: jmod(p, a, training=training))(
        jp, jnp.asarray(np.moveaxis(x, 1, -1)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (2, 8, 9, 9, 5, 6)
    np.testing.assert_allclose(to_nhwc6(got), np.asarray(want), atol=1e-4)


@pytest.fixture(scope="module")
def both_forwards():
    """(the port's models and the JAX package's flows by name, the
    images): ``vcn_small`` takes ``vcn``'s draw without the modules it
    lacks, and one compilation runs both JAX forwards."""
    jvcn_model, tvcn_model, params = build("vcn", 740, HEADS)
    jsmall = ptlflow_tpu.get_model_reference("vcn_small")()
    small = subtree(params, jax.eval_shape(jsmall.init,
                                           jax.random.PRNGKey(0)))
    tsmall = port_model("vcn_small", small)
    images = np.random.RandomState(741).rand(1, 2, 3, 100, 120).astype(
        np.float32)
    x = jnp.asarray(images)
    jsp = jax.tree_util.tree_map(jnp.asarray, small)

    def forwards(p, ps, x):
        return (jvcn_model.forward(p, {"images": x})["flows"],
                jsmall.forward(ps, {"images": x})["flows"])

    want = compile_o0(forwards, jvcn_model.params, jsp, x)(
        jvcn_model.params, jsp, x)
    return ({"vcn": tvcn_model, "vcn_small": tsmall},
            dict(zip(("vcn", "vcn_small"), want)), images)


@pytest.mark.parametrize("name", ["vcn", "vcn_small"])
def test_eval_forward_matches_jax(name, both_forwards):
    """``flows`` within 5e-3 px of the JAX package's after the
    align-corners resize to 128x128 and back: five (four) levels of
    volumes, butterflies, winner-take-alls, warps and fusions; no autograd
    graph."""
    tmodels, wants, images = both_forwards
    want = np.asarray(wants[name])
    got = tmodels[name]({"images": torch.from_numpy(images)})["flows"]
    assert got.shape == want.shape == (1, 1, 2, 100, 120)
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    assert 1.0 < np.abs(want).max() < 200.0


def test_batched_forward_pairs_each_samples_own_frames(both_forwards):
    """A batch of two samples gives each sample's own flow: the port
    stacks the first frames, then the second ones, and matches each
    sample's pair (the JAX package's stacking pairs frames of different
    samples, module docstring)."""
    tmodels, _, images = both_forwards
    other = np.random.RandomState(742).rand(*images.shape).astype(np.float32)
    model = tmodels["vcn_small"]
    batch = model({"images": torch.from_numpy(np.concatenate(
        [images, other]))})["flows"]
    for i, one in enumerate((images, other)):
        alone = model({"images": torch.from_numpy(one)})["flows"]
        np.testing.assert_allclose(batch[i:i + 1].numpy(), alone.numpy(),
                                   atol=1e-4)


class JTwoLevels(jvcn.VCNSmall):
    def forward(self, params, inputs, training=False):
        return self._forward_impl(params, inputs, training, ("6", "5"))


class TTwoLevels(tvcn.VCNSmall):
    def _forward(self, inputs, training):
        return self._forward_levels(inputs, training, ("6", "5"))


def test_two_level_train_step_matches_jax_value_and_grad():
    """One step of ``vcn_small``'s 1/64 and 1/32 levels at 128x128, batch
    1: both levels' flows within 5e-3 px, ``VCNLoss`` (the L2 flow terms
    and the out-of-range logistic terms) within 1e-5, the whole gradient
    within 1e-3 by its largest element and by its norm (the volume's path
    through ``corrf``, the butterflies and the winner-take-all into the
    pyramid among it) and the BatchNorm statistics within 1e-5.

    The step is ill-conditioned in float32: over batch seeds 753-762 each
    package's whole gradient lies 1e-4 to 3.2e-3 from the port's float64
    one (the stem's weight gradient, a sum over every pixel through 30
    BatchNorms, the largest part), and a tensor's own gradient up to 1.2e-3
    of its largest element off the other package's; the BatchNorm
    statistics of the 2x2 level lie 6e-6 to 4e-5 apart.  Seed 754 puts
    both packages 5e-4 from float64 (port against JAX 1.3e-4, statistics
    6.6e-6; a one-off scan)."""
    jmodel = JTwoLevels()
    params = random_params(jax.eval_shape(jmodel.init,
                                          jax.random.PRNGKey(0)),
                           np.random.RandomState(750))
    damp_modules(params, HEADS, 0.1)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = TTwoLevels().eval()
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    batch = synthetic_batch(754, b=1, h=128, w=128)
    run = compiled_step(jmodel, batch)

    def step(jm, b):
        (loss, (state, out)), grads = run(jm, b)
        return (loss, (state, [jnp.moveaxis(f, 1, -1)
                               for f in out["flow_preds"]])), grads

    named = assert_list_step_matches(tmodel, batch, jmodel, step=step,
                                     whole=True)
    for name in ("pspnet.convbnrelu1_1.cbr_unit.0.weight",
                 "f5.conva1.conv1.conv2.0.weight", "p6.conv1.weight",
                 "dc5_conv7.weight", "dc6_convo.6.weight"):
        assert named[name].abs().max() > 0, name
