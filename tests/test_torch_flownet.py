"""The port's FlowNetS and FlowNetSD and the FlowNet2 fusion network
against the JAX package's, on the CPU: the eval forward of frames of
112x136, which both packages resize by interpolation to 128x192 (1/64:
2x3), and the fusion network's flows at its three scales.  FlowNetC's
eval forward is held in ``tests/test_torch_flownet_train.py``, to its
compiled train step.

Weights are ``random_params`` of the JAX tree, carried into the port by
``state_dict_from_jax`` and loaded strictly into a model built on the meta
device (no weights of its own drawn).  Random encoder-decoders grow their
flows level after level: ``build`` damps the flow heads (``HEADS``, every
``predict_flow*`` at any depth) by 0.1, which leaves flows of a few
pixels (SD's output is divided by ``div_flow``, so a few hundredths).
``build`` and ``damp_modules`` serve the other FlowNet, LiteFlowNet and
FastFlowNet test files too.
"""

import fnmatch

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu.models.flownet import FlowNetFusion as JFusion
from ptlflow_tpu_torch.models.flownet import FlowNetFusion as TFusion
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_train import nhwc, random_params

H, W = 112, 136
HEADS = ("*predict_flow*",)


def damp_modules(params, patterns, factor):
    """Scale in place every leaf of a numpy parameter tree whose module's
    dotted path matches one of the ``fnmatch`` ``patterns``."""
    def walk(node, path):
        for key, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}{key}.")
            elif any(fnmatch.fnmatch(path[:-1], p) for p in patterns):
                node[key] = v * factor

    walk(params, "")


def build(name, seed, patterns=HEADS, factor=0.1, params=None, meta=True,
          **args):
    """(JAX model, port model, numpy params) of ``name`` with seeded
    ``random_params`` (or ``params``, used as given), the modules matching
    ``patterns`` damped by ``factor``, the port's model built on the meta
    device (or, where ``meta`` is false, on the CPU with its own init,
    for a model with a non-persistent buffer) and loaded strictly."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    if params is None:
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        params = random_params(shapes, np.random.RandomState(seed))
        damp_modules(params, patterns, factor)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    return jmodel, port_model(name, params, meta, **args), params


def port_model(name, params, meta=True, **args):
    """The port's ``name`` on the CPU with the numpy JAX tree ``params``,
    loaded strictly; built on the meta device unless ``meta`` is false."""
    if meta:
        with torch.device("meta"):
            tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args)
        tmodel = tmodel.to_empty(device="cpu").eval()
    else:
        tmodel = ptlflow_tpu_torch.get_model(name, args=args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return tmodel


def images_of(seed, h=H, w=W, b=1):
    return np.random.RandomState(seed).rand(b, 2, 3, h, w).astype(np.float32)


def assert_forward_matches(jmodel, tmodel, images, tolerances=None,
                           want=None):
    """The eval forward of ``images``: each output of ``tolerances`` ({key:
    atol}, ``flows`` within 5e-3 px by default) within its tolerance of
    the JAX package's (compiled by ``compile_o0``; or of ``want``, its
    outputs computed elsewhere), of the input's size, with no autograd
    graph.  Returns the JAX package's outputs."""
    if want is None:
        x = jnp.asarray(images)
        want = compile_o0(lambda p, x: jmodel.forward(p, {"images": x}),
                          jmodel.params, x)(jmodel.params, x)
    got = tmodel({"images": torch.from_numpy(images)})
    for key, atol in (tolerances or {"flows": 5e-3}).items():
        assert got[key].shape == want[key].shape, key
        assert got[key].shape[-2:] == images.shape[-2:], key
        assert got[key].grad_fn is None, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, err_msg=key)
    return want


@pytest.mark.parametrize("name,low", [("flownets", 1.0), ("flownetsd", 1e-3)])
def test_eval_forward_matches_jax(name, low):
    """``flows`` within 5e-3 px of the JAX package's after the per-frame
    mean subtraction and the align-corners resize to 128x192 and back;
    flows of a few pixels (SD's of a few hundredths)."""
    jmodel, tmodel, _ = build(name, 110)
    want = assert_forward_matches(jmodel, tmodel, images_of(111))
    assert low < np.abs(np.asarray(want["flows"])).max() < 100.0


def test_fusion_network_matches_jax():
    """FlowNet2's fusion network on 11 stacked maps at 64x96: its flows at
    full size, 1/2 and 1/4, eval and training forward, within 5e-3 px of
    the JAX package's."""
    jmodel, tmodel = JFusion(), TFusion()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(112))
    damp_modules(params, HEADS, 0.1)
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    x = torch.from_numpy(
        np.random.RandomState(113).randn(2, 11, 64, 96).astype(np.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jx = jnp.asarray(nhwc(x))
    want = compile_o0(
        lambda p, x: jmodel.forward(p, {"images": x}, training=True),
        jparams, jx)(jparams, jx)
    got = tmodel({"images": x}, training=True)
    np.testing.assert_allclose(got["flows"].detach().numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    assert [tuple(p.shape[-2:]) for p in got["flow_preds"]] == [
        (64, 96), (32, 48), (16, 24)]
    for g, w in zip(got["flow_preds"], want["flow_preds"]):
        np.testing.assert_allclose(nhwc(g), np.asarray(w),
                                   atol=5e-3)
    assert np.abs(np.asarray(want["flows"])).max() > 0.1
