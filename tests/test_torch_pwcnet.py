"""The port's PWC-Net (``pwcnet``, with the dilated-context refinement, and
``pwcnet_nodc``) against the JAX package's, on the CPU: the eval forward at
64x96 (resized to 64x128 by interpolation: pyramid levels 32x64 to 1x2).

Weights are ``random_params``, carried into the port by
``state_dict_from_jax`` and loaded strictly.  Random DenseNet decoders grow
their flows level after level (mean 150 px at 64x96): ``build`` damps the
flow predictors (``predict_flow2``-``6``, ``dc_conv7``) by 0.1, which
leaves flows of a few pixels.
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_train import random_params

H, W = 64, 96


def compile_o0(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` by XLA at backend optimisation
    level 0: the same operations in the same order, compiled in about two
    thirds of the time (the CPU tests' clock is the JAX compiles)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def damp(params, prefixes, factor):
    """Scale every leaf of the top-level subtrees named ``prefixes`` (a
    name ending in '*' is a prefix) of a numpy parameter tree in place."""
    for key, sub in params.items():
        if any(key == p or (p.endswith("*") and key.startswith(p[:-1]))
               for p in prefixes):
            for leaf, v in jax.tree_util.tree_flatten_with_path(sub)[0]:
                node = sub
                for k in leaf[:-1]:
                    node = node[k.key]
                node[leaf[-1].key] = v * factor


def build(name, seed, damped=("predict_flow*", "dc_conv7"), factor=0.1,
          prepare=None):
    """(JAX model, port model, numpy params) of ``name`` with seeded
    ``random_params``, the ``damped`` subtrees scaled by ``factor`` and
    ``prepare(params)`` applied, the port loaded strictly."""
    jmodel = ptlflow_tpu.get_model_reference(name)()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    damp(params, damped, factor)
    if prepare is not None:
        prepare(params)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model(name, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


@pytest.fixture(scope="module")
def both_forwards():
    """(the port's models and the JAX package's flows by name, the images):
    ``pwcnet_nodc`` takes ``pwcnet``'s draw without the dilated-context
    refinement, and one compilation runs both JAX forwards, whose common
    pyramid and decoders XLA computes once."""
    jdc, tdc, params = build("pwcnet", 100)
    jnodc = ptlflow_tpu.get_model_reference("pwcnet_nodc")()

    def nodc(p):
        return {k: v for k, v in p.items() if not k.startswith("dc_conv")}

    tnodc = ptlflow_tpu_torch.get_model("pwcnet_nodc", device="cpu")
    tnodc.load_state_dict(state_dict_from_jax(nodc(params), tnodc),
                          strict=True)
    images = np.random.RandomState(101).rand(1, 2, 3, H, W).astype(
        np.float32)
    x = jnp.asarray(images)

    def forwards(p, x):
        return (jdc.forward(p, {"images": x})["flows"],
                jnodc.forward(nodc(p), {"images": x})["flows"])

    want = compile_o0(forwards, jdc.params, x)(jdc.params, x)
    return ({"pwcnet": tdc, "pwcnet_nodc": tnodc},
            dict(zip(("pwcnet", "pwcnet_nodc"), want)), images)


@pytest.mark.parametrize("name", ["pwcnet", "pwcnet_nodc"])
def test_eval_forward_matches_jax(name, both_forwards):
    """``flows`` at 64x96 within 5e-3 px of the JAX package's, no autograd
    graph, flows of a few pixels."""
    tmodels, wants, images = both_forwards
    want = np.asarray(wants[name])
    got = tmodels[name]({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(), want, atol=5e-3)
    assert 1.0 < np.abs(want).max() < 100.0
