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


@pytest.mark.parametrize("name", ["pwcnet", "pwcnet_nodc"])
def test_eval_forward_matches_jax(name):
    """``flows`` at 64x96 within 5e-3 px of the JAX package's, no autograd
    graph, flows of a few pixels."""
    jmodel, tmodel, _ = build(name, 100)
    images = np.random.RandomState(101).rand(1, 2, 3, H, W).astype(
        np.float32)
    x = jnp.asarray(images)
    want = compile_o0(lambda p, x: jmodel.forward(p, {"images": x}),
                      jmodel.params, x)(jmodel.params, x)
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    assert 1.0 < np.abs(np.asarray(want["flows"])).max() < 100.0
