"""The port's UniMatch (``unimatch``, ``unimatch_sc2``,
``unimatch_sc2_ref6``) and GMFlow+ (``gmflow_p``, ``_sc2``, ``_sc2_ref6``)
against the JAX package's, on the CPU: the flow-centred correlation and
the volume route that the refinement reads it by (the all-pairs volume,
the lookup, the window axes swapped), the refinement's update block with
its gradients, and the three architectures' eval forwards at 128x192
(1/8: 16x24 in 2x2 windows; 1/4: 32x48 in 8x8, 6 refinement steps there).
Each ``gmflow_p*`` name is its ``unimatch*`` twin's class.

Weights are ``random_params``, conditioned as ``tests/test_torch_gmflow.py``
conditions GMFlow (``DAMPED``: the backbone's output convolution by 0.1)
and the refinement's flow head damped by 0.1 (random refinement steps
otherwise add tens of pixels each).  ``unimatch_sc2`` and ``unimatch``
take ``unimatch_sc2_ref6``'s draw (``unimatch`` without the trident
convolution), each with an upsampler drawn apart (4x4 and 8x8 masks), and
one compilation runs the three JAX forwards.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu_torch.ops.correlation import (build_corr_pyramid,
                                               coords_grid,
                                               corr_pyramid_lookup_plain)
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_gmflow import DAMPED, build, compile_o0, subtree
from tests.test_torch_flownet import port_model
from tests.test_torch_train import (carry_random, nchw, nhwc,
                                   random_params)

# the packages re-export the class ``unimatch`` under the module's name
junimatch = importlib.import_module("ptlflow_tpu.models.unimatch.unimatch")
tunimatch = importlib.import_module(
    "ptlflow_tpu_torch.models.unimatch.unimatch")

H, W = 128, 192
NAMES = ("unimatch", "unimatch_sc2", "unimatch_sc2_ref6")
# damped by 0.1 (``build``'s factor)
REFINE_DAMPED = DAMPED + ("refine.flow_head.conv2",)
# how far each case's flows push the 9x9 windows of a 6x7 map: inside it,
# across its edges, and wholly off it
FLOW_CASES = {"inside": (0.0, 1.0), "across the edges": (0.0, 4.0),
              "off the map": (15.0, 1.0)}


def flow_case(rng, case, b, h, w):
    shift, spread = FLOW_CASES[case]
    sign = np.where(rng.rand(b, 2, h, w) < 0.5, -1.0, 1.0)
    return (sign * shift + spread * rng.randn(b, 2, h, w)).astype(np.float32)


@pytest.mark.parametrize("case", list(FLOW_CASES))
def test_volume_route_is_the_flow_centred_correlation(case):
    """The refinement's route, the one-level all-pairs volume
    (``build_corr_pyramid``) read by the plain lookup at coords + flow and
    its window axes swapped from x-major to y-major, gives the flow-centred
    correlation (``local_correlation_with_flow``) within 1e-5, on windows
    inside the map, across its edges and wholly off it (zeros)."""
    rng = np.random.RandomState(900 + len(case))
    b, c, h, w, r = 2, 8, 6, 7, 4
    f0, f1 = (torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32))
              for _ in range(2))
    flow = torch.from_numpy(flow_case(rng, case, b, h, w))
    want = tunimatch.local_correlation_with_flow(f0, f1, flow, r)
    vol = build_corr_pyramid(f0, f1, num_levels=1)
    got = corr_pyramid_lookup_plain(vol, coords_grid(b, h, w) + flow, r)
    n = 2 * r + 1
    got = got.view(b, n, n, h, w).transpose(1, 2).reshape(b, n * n, h, w)
    assert got.shape == want.shape == (b, n * n, h, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    if case == "off the map":
        assert (want.abs().amax(1) == 0).float().mean() > 0.5
    else:
        assert want.abs().max() > 1.0


@pytest.mark.parametrize("dilation", [1, 2])
def test_local_correlation_with_flow_matches_jax(dilation):
    """The flow-centred correlation, windows across the map's edges,
    y-major, within 1e-5 of the JAX package's."""
    rng = np.random.RandomState(910 + dilation)
    f0, f1 = (rng.randn(2, 8, 6, 7).astype(np.float32) for _ in range(2))
    flow = flow_case(rng, "across the edges", 2, 6, 7)
    want = jax.jit(lambda a, bb, fl: junimatch.local_correlation_with_flow(
        a, bb, fl, 4, dilation))(*(nhwc(torch.from_numpy(t))
                                   for t in (f0, f1, flow)))
    got = tunimatch.local_correlation_with_flow(
        *(torch.from_numpy(t) for t in (f0, f1, flow)), 4, dilation)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


def test_update_block_matches_jax():
    """The refinement's update block (81 correlation channels, masks for
    4x4 upsampling) on a (2, ., 5, 7) map: the new hidden state, the mask
    logits and the flow's residual within 1e-4 of the JAX package's, and
    the gradients of their dot product with a seeded cotangent, for the
    four inputs and every parameter, within 1e-3 of each tensor's largest
    element."""
    rng = np.random.RandomState(920)
    jmod = junimatch.BasicUpdateBlock(corr_channels=81, downsample_factor=4)
    tmod = tunimatch.BasicUpdateBlock(corr_channels=81, downsample_factor=4)
    params = carry_random(jmod, tmod, 921)
    inputs = [rng.randn(2, ch, 5, 7).astype(np.float32)
              for ch in (128, 128, 81, 2)]
    inputs[0] = np.tanh(inputs[0])
    inputs[1] = np.maximum(inputs[1], 0)

    def jfn(p, *xs):
        return jnp.concatenate(jmod(p, *xs), axis=-1)

    want, vjp = jax.vjp(jax.jit(jfn), params,
                        *(jnp.asarray(nhwc(torch.from_numpy(a)))
                          for a in inputs))
    tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = torch.cat(tmod(*tin), dim=1)
    assert got.shape[1] == 128 + 144 + 2
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4)
    cot = rng.randn(*want.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    tparams = dict(tmod.named_parameters())
    tgrads = torch.autograd.grad(got, tin + list(tparams.values()),
                                 nchw(cot))
    jparam_grads = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads[0]), tmod)
    pairs = [(nhwc(g), np.asarray(jg)) for g, jg in zip(tgrads, jgrads[1:])]
    pairs += [(g.numpy(), jparam_grads[name].numpy())
              for g, name in zip(tgrads[len(tin):], tparams)]
    assert len(pairs) == 4 + len(tparams) == 4 + 30
    for g, jg in pairs:
        np.testing.assert_allclose(g, jg, atol=1e-3 * np.abs(jg).max())


@pytest.fixture(scope="module")
def three_forwards():
    """(the port's models and the JAX package's ``flows`` and
    ``flow_small`` by name, the images)."""
    jref6, tref6, params = build("unimatch_sc2_ref6", 930, REFINE_DAMPED)
    jmodels, tmodels, trees = {}, {"unimatch_sc2_ref6": tref6}, {}
    for k, name in enumerate(("unimatch_sc2", "unimatch")):
        jmodels[name] = ptlflow_tpu.get_model_reference(name)()
        shapes = jax.eval_shape(jmodels[name].init, jax.random.PRNGKey(0))
        # the upsampler predicts 4x4 masks in unimatch_sc2, 8x8 in unimatch
        trees[name] = dict(subtree(params, shapes), upsampler=random_params(
            shapes["upsampler"], np.random.RandomState(931 + k)))
        tmodels[name] = port_model(name, trees[name])
    images = np.random.RandomState(933).rand(1, 2, 3, H, W).astype(
        np.float32)
    x = jnp.asarray(images)
    jtrees = [jax.tree_util.tree_map(jnp.asarray, trees[name])
              for name in ("unimatch_sc2", "unimatch")]

    def forwards(p, p_sc2, p_plain, x):
        return [m.forward(pp, {"images": x})
                for m, pp in ((jref6, p), (jmodels["unimatch_sc2"], p_sc2),
                              (jmodels["unimatch"], p_plain))]

    want = compile_o0(forwards, jref6.params, *jtrees, x)(jref6.params,
                                                          *jtrees, x)
    return tmodels, dict(zip(("unimatch_sc2_ref6", "unimatch_sc2",
                              "unimatch"), want)), images


@pytest.mark.parametrize("key", ["flows", "flow_small"])
@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(name, key, three_forwards):
    """``flows`` and ``flow_small`` within 5e-3 px of the JAX package's:
    the global matching at 1/8 and, for the sc2 names, the warp, the 9x9
    local matching and the 3x3 propagation at 1/4, then GMFlow's convex
    upsampling by 8 or 4, or 6 refinement steps on the 1/4 volume, each
    convex-upsampled by 4 (``flows`` the last, ``flow_small`` the last
    1/4 flow); no autograd graph."""
    tmodels, wants, images = three_forwards
    want = np.asarray(wants[name][key])
    got = tmodels[name]({"images": torch.from_numpy(images)})[key]
    assert got.grad_fn is None
    if key == "flows":
        assert got.shape == want.shape == (1, 1, 2, H, W)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    else:
        scale = 8 if name == "unimatch" else 4
        assert got.shape == (1, 2, H // scale, W // scale)
        np.testing.assert_allclose(nhwc(got), want, atol=5e-3)
    assert 1.0 < np.abs(want).max() < 100.0


@pytest.mark.parametrize("name", ["gmflow_p", "gmflow_p_sc2",
                                  "gmflow_p_sc2_ref6"])
def test_gmflow_p_is_its_unimatch_twin(name):
    """Each GMFlow+ name is its UniMatch twin's architecture: on the same
    ``state_dict`` the two give the same ``flows`` and ``flow_small``,
    bit for bit."""
    twin = name.replace("gmflow_p", "unimatch")
    assert (ptlflow_tpu_torch.get_model_reference(name).__mro__[1]
            is ptlflow_tpu_torch.get_model_reference(twin).__mro__[1])
    model = ptlflow_tpu_torch.get_model(name, device="cpu")
    other = ptlflow_tpu_torch.get_model(twin, device="cpu")
    other.load_state_dict(model.state_dict(), strict=True)
    images = torch.from_numpy(np.random.RandomState(940).rand(
        1, 2, 3, 64, 96).astype(np.float32))
    got, want = model({"images": images}), other({"images": images})
    assert set(got) == set(want) == {"flows", "flow_small"}
    for key in got:
        assert torch.equal(got[key], want[key]), key
