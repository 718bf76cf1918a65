"""The PyTorch port's CSFlow against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``), the flow
head's last convolution is damped by 0.1 and the BatchNorms of the second
frame's strip convolutions by 1e-3 (``build``): random strip descriptors
correlate to ~1e3 px initial flows (the initialisation sums a whole strip
of raw products), damped ones to a few px.  ``state_dict_from_jax`` carries
the weights into the port, which loads them with ``strict=True``.  Inputs
come from numpy seeds; the port is NCHW, the JAX package NHWC.  The JAX
model's eval forward is always given a ``prev_preds`` (a zero
``flow_small`` for a cold forward), so cold and warm forwards share one
compilation.
"""

import importlib

import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_train import carry_random, nchw, random_params

jcs = importlib.import_module("ptlflow_tpu.models.csflow.csflow")
tcs = importlib.import_module("ptlflow_tpu_torch.models.csflow.csflow")

H, W = 64, 96
ITERS = 2


def damp(node, factor):
    for leaf in ("weight", "bias"):
        node[leaf] = node[leaf] * factor


def build(name, seed, **args):
    """(JAX ``csflow`` with seeded weights, the port's on the CPU with the
    same weights, numpy params), conditioned as the module docstring
    says."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    damp(params["update_block"]["flow_head"]["conv2"], 0.1)
    for k in ("conv2_1", "conv2_2"):
        damp(params["strip_corr_block_v2"][k]["bn"], 1e-3)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model(name, args=args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


def test_strip_cross_corr_matches_jax():
    """The strip volume of two 32-channel 6x10 maps and its column and row
    correlations: within 1e-4 of the JAX package's, and the volume is
    their sum, pair by pair."""
    jmod = jcs.StripCrossCorrMap_v2(32, 32)
    tmod = tcs.StripCrossCorrMap_v2(32, 32)
    params = carry_random(jmod, tmod, 100)
    rng = np.random.RandomState(100)
    f1, f2 = (rng.randn(2, 6, 10, 32).astype(np.float32) for _ in range(2))
    want = jax.jit(jmod)(params, jnp.asarray(f1), jnp.asarray(f2))
    with torch.no_grad():
        got = tmod(nchw(f1), nchw(f2))
    for g, w, shape in zip(got, want, [(2, 6, 10, 1, 6, 10),
                                       (2, 6, 10, 1, 10), (2, 6, 10, 6, 1)]):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    strip, corr_w, corr_h = got
    torch.testing.assert_close(strip[:, 2, 3, 0, 4, 7],
                               corr_w[:, 2, 3, 0, 7] + corr_h[:, 2, 3, 4, 0])


def test_eval_forward_and_warm_start_match_jax():
    """2 iterations at 64x96 after the strip initialisation, cold and
    warm-started from a ``flow_small``: flows and ``flow_small`` within
    5e-3 px of the JAX package's, no autograd graph, and the warm start
    moves the flow."""
    jmodel, tmodel, _ = build("csflow", 101, iters=ITERS)
    images = np.random.RandomState(101).rand(1, 2, 3, H, W).astype(
        np.float32)
    prev = (2.0 + np.random.RandomState(102).uniform(
        -0.2, 0.2, (1, 2, H // 8, W // 8))).astype(np.float32)
    forward = jax.jit(lambda p, x, fs: jmodel.forward(
        p, {"images": x, "prev_preds": {"flow_small": fs}}))
    outs = {}
    for warm in (False, True):
        want = forward(jmodel.params, jnp.asarray(images),
                       jnp.asarray(prev if warm else np.zeros_like(prev)))
        inputs = {"images": torch.from_numpy(images)}
        if warm:
            inputs["prev_preds"] = {"flow_small": torch.from_numpy(prev)}
        got = tmodel(inputs)
        assert got["flows"].shape == (1, 1, 2, H, W)
        assert got["flows"].grad_fn is None
        for k in ("flows", "flow_small"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=5e-3)
        assert np.abs(np.asarray(want["flows"])).max() > 1.0
        outs[warm] = got["flows"]
    assert (outs[True] - outs[False]).abs().max() > 0.5
