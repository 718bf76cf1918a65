"""The port's GMFlow (``gmflow``, ``gmflow_refine``) against the JAX
package's, on the CPU: the trident convolution, the split-window attention
with and without Swin's shift (roll, split, mask, merge, roll back), the
flow propagation by attention (global, its key projection chained after
the query's as the reference does, and over zero-padded 3x3 windows) and
the local matching softmax with their gradients, both names' eval
forwards at 128x192 (1/8: 16x24 in 2x2 windows; 1/4: 32x48 in 8x8) and
one train step of ``gmflow``.

Weights are ``random_params``, the backbone's output convolution
(``backbone.conv2``) damped (``DAMPED``): random features make the
softmax matching near an argmax, whose float32 rounding moves the flows
by 2e-2 px undamped (by 1.3e-4 px damped by 0.1, at 128x192).  ``gmflow`` takes
``gmflow_refine``'s draw without the trident convolution (its upsampler,
of 8x8 masks, drawn apart), and one compilation runs both JAX forwards.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import ptlflow_tpu
from ptlflow_tpu.models.gmflow import backbone as jbackbone
from ptlflow_tpu.models.gmflow import transformer as jtransformer
from ptlflow_tpu_torch.models.gmflow import backbone as tbackbone
from ptlflow_tpu_torch.models.gmflow import transformer as ttransformer
from tests.test_torch_flownet import build, port_model
from tests.test_torch_flownet_train import compiled_step
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_pwcnet_train import assert_list_step_matches
from tests.test_torch_train import (carry_random, nhwc, random_params,
                                   synthetic_batch)
from tests.test_torch_vcn import subtree

# the packages re-export the class ``gmflow`` under the module's name
jgmflow = importlib.import_module("ptlflow_tpu.models.gmflow.gmflow")
tgmflow = importlib.import_module("ptlflow_tpu_torch.models.gmflow.gmflow")

H, W = 128, 192
# damped by 0.1 (``build``'s factor)
DAMPED = ("backbone.conv2",)


def tokens_of(rng, b, h, w, c):
    return rng.randn(b, h * w, c).astype(np.float32)


@pytest.mark.parametrize("splits,shift", [(2, False), (2, True), (3, True)])
def test_split_window_attention_matches_jax(splits, shift):
    """Single-head attention within the windows of a K x K split of a 6x12
    map, the windows rolled by half a window and masked (-100) where the
    roll joins regions, within 1e-5 of the JAX package's."""
    rng = np.random.RandomState(800 + splits)
    h, w, c = 6, 12, 8
    q, k, v = (tokens_of(rng, 2, h, w, c) for _ in range(3))
    wh, ww = h // splits, w // splits
    jmask = jtransformer.generate_shift_window_attn_mask(
        h, w, wh, ww, wh // 2, ww // 2)
    tmask = ttransformer.generate_shift_window_attn_mask(
        h, w, wh, ww, wh // 2, ww // 2)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    want = jax.jit(lambda a, b, cc: jtransformer.
                   single_head_split_window_attention(
                       a, b, cc, splits, shift, h, w, jmask))(q, k, v)
    got = ttransformer.single_head_split_window_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), splits, shift, h, w,
        tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def assert_vjp_matches(jfn, tfn, inputs, seed):
    """``jfn`` (NHWC) and ``tfn`` (NCHW) of the NCHW numpy ``inputs``: the
    outputs within 1e-5, and the inputs' gradients of the outputs' dot
    product with a seeded cotangent within 1e-4 of their largest
    element."""
    jin = [nhwc(torch.from_numpy(a)) for a in inputs]
    want, vjp = jax.vjp(jax.jit(jfn), *jin)
    tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = tfn(*tin)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    cot = np.random.RandomState(seed).randn(*want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    tgrads = torch.autograd.grad(got, tin, torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(cot, -1, 1))))
    for g, jg in zip(tgrads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(nhwc(g), jg, atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("radius", [-1, 1])
def test_feature_flow_attention_matches_jax(radius):
    """The flow propagated by attention over a (2, 16, 5, 7) feature map:
    globally (``k_proj`` applied to the projected queries, the reference's
    chain) or over each pixel's zero-padded 3x3 window, and the gradients
    of both inputs, against the JAX package's."""
    rng = np.random.RandomState(810 + radius)
    jmod = jtransformer.FeatureFlowAttention(16)
    tmod = ttransformer.FeatureFlowAttention(16)
    params = carry_random(jmod, tmod, 811)
    feat = rng.randn(2, 16, 5, 7).astype(np.float32)
    flow = (3 * rng.randn(2, 2, 5, 7)).astype(np.float32)
    assert_vjp_matches(
        lambda f, fl: jmod(params, f, fl, local_window_attn=radius > 0,
                           local_window_radius=radius),
        lambda f, fl: tmod(f, fl, local_window_attn=radius > 0,
                           local_window_radius=radius), (feat, flow), 812)


def test_local_correlation_softmax_matches_jax():
    """``gmflow_refine``'s 1/4 matching: the expected displacement under
    the softmax over each pixel's 9x9 window of scaled products (-1e9 on
    the taps outside a 6x7 map), and both maps' gradients, against the
    JAX package's."""
    rng = np.random.RandomState(815)
    f0, f1 = (rng.randn(2, 8, 6, 7).astype(np.float32) for _ in range(2))
    assert_vjp_matches(
        lambda a, b: jgmflow.local_correlation_softmax(a, b, 4)[0],
        lambda a, b: tgmflow.local_correlation_softmax(a, b, 4),
        (f0, f1), 816)


def test_trident_conv_matches_jax():
    """One shared 3x3 weight applied at strides 1 and 2 (padding 1), its
    (O, I, 3, 3) tensor converted from the JAX package's HWIO one."""
    rng = np.random.RandomState(820)
    jmod = jbackbone.MultiScaleTridentConv(8, 6, 3, strides=(1, 2),
                                           paddings=1, num_branch=2)
    tmod = tbackbone.MultiScaleTridentConv(8, 6, 3, strides=(1, 2),
                                           padding=1)
    params = carry_random(jmod, tmod, 821)
    assert tmod.weight.shape == (6, 8, 3, 3)
    x = rng.randn(2, 8, 9, 10).astype(np.float32)
    want = jax.jit(lambda p, a: jmod(p, [a, a]))(params,
                                                 nhwc(torch.from_numpy(x)))
    got = tmod([torch.from_numpy(x)] * 2)
    assert [g.shape[-2:] for g in got] == [(9, 10), (5, 5)]
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(wnt), atol=1e-5)


@pytest.fixture(scope="module")
def both_forwards():
    """(the port's models and the JAX package's flows by name, the
    images)."""
    jrefine, trefine, params = build("gmflow_refine", 830, DAMPED)
    jplain = ptlflow_tpu.get_model_reference("gmflow")()
    shapes = jax.eval_shape(jplain.init, jax.random.PRNGKey(0))
    # the upsampler predicts 8x8 masks here, 4x4 in gmflow_refine
    plain = dict(subtree(params, shapes), upsampler=random_params(
        shapes["upsampler"], np.random.RandomState(832)))
    tplain = port_model("gmflow", plain)
    images = np.random.RandomState(831).rand(1, 2, 3, H, W).astype(
        np.float32)
    x = jnp.asarray(images)
    jpp = jax.tree_util.tree_map(jnp.asarray, plain)

    def forwards(p, pp, x):
        return (jrefine.forward(p, {"images": x})["flows"],
                jplain.forward(pp, {"images": x})["flows"])

    want = compile_o0(forwards, jrefine.params, jpp, x)(jrefine.params,
                                                         jpp, x)
    return ({"gmflow_refine": trefine, "gmflow": tplain},
            dict(zip(("gmflow_refine", "gmflow"), want)), images)


@pytest.mark.parametrize("name", ["gmflow", "gmflow_refine"])
def test_eval_forward_matches_jax(name, both_forwards):
    """``flows`` within 5e-3 px of the JAX package's: the global matching
    at 1/8 and, for ``gmflow_refine``, the trident 1/4 features, the warp,
    the 9x9 local matching and the 3x3 propagation, then the convex
    upsampling by 8 or 4; no autograd graph."""
    tmodels, wants, images = both_forwards
    want = np.asarray(wants[name])
    got = tmodels[name]({"images": torch.from_numpy(images)})["flows"]
    assert got.shape == want.shape == (1, 1, 2, H, W)
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    assert 1.0 < np.abs(want).max() < 100.0


def test_train_step_matches_jax_value_and_grad():
    """One step of ``gmflow`` at 64x96, batch 2 (1/8: 8x12 in 2x2
    windows): the two predictions (the matched flow upsampled bilinearly,
    the propagated one convex-upsampled) within 5e-3 px, the
    gamma-weighted L1 loss within 1e-5 and every gradient within 1e-3 of
    its tensor's largest element.  ``gmflow_refine``'s own pieces (the
    local matching, the windowed propagation, the trident convolution)
    are held with their gradients above, and its whole step card against
    CPU in ``chip_smoke.py``.

    Random-weight GMFlow steps are ill-conditioned in float32 on some
    batches: with these weights both packages' float32 whole gradients lie
    4e-6 to 6e-6 from the port's float64 one at batch seeds 4 and 5 and
    1.3e-3 to 3.7e-3 at seeds 6-9 (each package on some of them); and
    ``gmflow_refine``'s JAX step lies 1e-3 to 7e-3 from it on 8 of 10
    seeds at 64x96 and 128x192 (a one-off scan).  Seed 4
    is held."""
    jmodel, tmodel, _ = build("gmflow", 840, DAMPED)
    batch = synthetic_batch(4, b=2, h=64, w=96)
    run = compiled_step(jmodel, batch)

    def step(jm, b):
        (loss, (state, out)), grads = run(jm, b)
        return (loss, (state, out["flow_preds"])), grads

    named = assert_list_step_matches(tmodel, batch, jmodel, step=step)
    for name in ("backbone.conv1.weight", "backbone.layer3.0.conv1.weight",
                 "transformer.layers.5.cross_attn_ffn.mlp.2.weight",
                 "transformer.layers.1.self_attn.q_proj.weight",
                 "feature_flow_attn.k_proj.weight", "upsampler.2.bias"):
        assert named[name].abs().max() > 0, name
