"""The PyTorch port's LLA-Flow (``llaflow``, ``llaflow_raft``) against the
JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``: the three
``gamma`` blends, zero at init, drawn in [0.1, 1], so that the ShiftLSA
volume, the LSA enhancement and GMA's aggregation count), and the flow
head's last convolution is damped by 0.1 (``build``), as
``tests/test_torch_train.py`` does for RAFT: random GRU steps are chaotic.
``state_dict_from_jax`` carries the weights into the port, which loads them
with ``strict=True``.  Inputs come from numpy seeds; the port is NCHW, the
JAX package NHWC.  The JAX model's eval forward is always given a
``prev_preds`` (a zero ``flow_small`` for a cold forward), so cold and warm
forwards share one compilation.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_train import carry_random, nchw, nhwc, random_params

jlla = importlib.import_module("ptlflow_tpu.models.llaflow.llaflow")
tlla = importlib.import_module("ptlflow_tpu_torch.models.llaflow.llaflow")

H, W = 64, 96
ITERS = 2


def build(name, seed, **args):
    """(JAX ``name`` with seeded weights, the port's on the CPU with the
    same weights, numpy params); the flow head damped by 0.1."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    head = params["update_block"]["flow_head"]["conv2"]
    for leaf in ("weight", "bias"):
        head[leaf] = head[leaf] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model(name, args=args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


# ---------------------------------------------------------------- blocks
def test_patch_extra_matches_jax():
    """Edge-padded 5x5 windows of a 6x7 map, row-major: equal to the JAX
    package's, bit for bit."""
    x = np.random.RandomState(90).randn(2, 6, 7, 3).astype(np.float32)
    want = np.asarray(jlla.patch_extra(jnp.asarray(x), 5))  # B H W L C
    got = tlla.patch_extra(nchw(x), 5)  # B C L H W
    assert got.shape == (2, 3, 25, 6, 7)
    np.testing.assert_array_equal(got.permute(0, 3, 4, 2, 1).numpy(), want)


def test_local_similar_and_lsa_match_jax():
    """The 5x5 softmax similarity of 32 channels over a 6x7 map, and LSA's
    aggregation of a 32-channel map by it (``gamma`` drawn): within 1e-5
    and 1e-4 of the JAX package's."""
    jls, tls = jlla.LocalSimilar(32), tlla.LocalSimilar(32)
    jlsa, tlsa = jlla.LSA(32), tlla.LSA(32)
    pls = carry_random(jls, tls, 91)
    plsa = carry_random(jlsa, tlsa, 92)
    assert float(plsa["gamma"][0]) >= 0.1
    rng = np.random.RandomState(91)
    ctx, fmap = (rng.randn(2, 6, 7, 32).astype(np.float32) for _ in range(2))
    want_attn = jax.jit(jls)(pls, jnp.asarray(ctx))
    want = np.asarray(jax.jit(jlsa)(plsa, want_attn, jnp.asarray(fmap)))
    with torch.no_grad():
        attn = tls(nchw(ctx))
        got = tlsa(attn, nchw(fmap))
    assert attn.shape == (2, 25, 6, 7)
    np.testing.assert_allclose(np.moveaxis(attn.numpy(), 1, -1),
                               np.asarray(want_attn), atol=1e-5)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_shift_lsa_matches_jax():
    """The shift-aggregated volume of two 64-channel 6x7 maps: one
    (HW x 25C) by (25C x HW) product in the port, 25 window-shifted
    products summed in the JAX package, the same 1600 terms a pair in
    another order: within 1e-5 of the volume's largest entry."""
    jmod, tmod = jlla.ShiftLSA(64), tlla.ShiftLSA(64)
    params = carry_random(jmod, tmod, 93)
    rng = np.random.RandomState(93)
    f1, f2 = (rng.randn(2, 6, 7, 64).astype(np.float32) for _ in range(2))
    attn = rng.rand(2, 6, 7, 25).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    want = np.asarray(jax.jit(jmod)(params, jnp.asarray(attn),
                                    jnp.asarray(f1), jnp.asarray(f2)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(np.moveaxis(attn, -1, 1).copy()),
                   nchw(f1), nchw(f2)).numpy()
    assert got.shape == want.shape == (2, 42, 6, 7)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_corr_block_blends_and_pools_the_volume():
    """``LLACorrBlock``: the all-pairs volume plus ``gamma`` times ShiftLSA's,
    pooled into 4 levels of a 6x10 map (the last one empty), within 1e-5
    of the JAX package's pyramid."""
    rng = np.random.RandomState(94)
    f1, f2 = (rng.randn(1, 6, 10, 32).astype(np.float32) for _ in range(2))
    corr2 = rng.randn(1, 60, 6, 10).astype(np.float32)
    gamma = np.array([0.7], np.float32)
    jblk = jlla.LLACorrBlock(jnp.asarray(f1), jnp.asarray(f2),
                             jnp.asarray(gamma), jnp.asarray(corr2))
    tblk = tlla.LLACorrBlock(nchw(f1), nchw(f2), torch.from_numpy(gamma),
                             torch.from_numpy(corr2))
    assert [tuple(p.shape) for p in tblk.pyramid] == [
        (60, 6, 10), (60, 3, 5), (60, 1, 2), (60, 0, 1)]
    for t, j in zip(tblk.pyramid, jblk.pyramid):
        np.testing.assert_allclose(t.numpy(), np.asarray(j)[..., 0],
                                   atol=1e-5)


# ----------------------------------------------------------- full models
@pytest.mark.parametrize("name", ["llaflow", "llaflow_raft"])
def test_eval_forward_and_warm_start_match_jax(name):
    """2 iterations at 64x96, cold and warm-started from a ``flow_small``:
    flows and ``flow_small`` within 5e-3 px of the JAX package's, no
    autograd graph, and the warm start moves the flow.  ``llaflow`` runs
    GMA's update block, ``llaflow_raft`` RAFT's."""
    jmodel, tmodel, _ = build(name, 95, iters=ITERS)
    assert (tmodel.att is None) == (name == "llaflow_raft")
    images = np.random.RandomState(95).rand(1, 2, 3, H, W).astype(np.float32)
    prev = (2.0 + np.random.RandomState(96).uniform(
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
        np.testing.assert_allclose(got["flows"].numpy(),
                                   np.asarray(want["flows"]), atol=5e-3)
        np.testing.assert_allclose(nhwc(got["flow_small"]),
                                   np.asarray(want["flow_small"]), atol=5e-3)
        assert np.abs(np.asarray(want["flows"])).max() > 1.0
        outs[warm] = got["flows"]
    assert (outs[True] - outs[False]).abs().max() > 0.5


def test_gamma_leaves_in_the_state_dict():
    """The model's blend ``gamma`` and LSA's and GMA's aggregator's are
    parameters named as the JAX tree's leaves, zero at init."""
    model = ptlflow_tpu_torch.get_model("llaflow", args={"iters": 1},
                                        device="cpu")
    sd = model.state_dict()
    for name in ("gamma", "lsa.gamma", "update_block.aggregator.gamma"):
        assert sd[name].shape == (1,) and sd[name].item() == 0.0, name
