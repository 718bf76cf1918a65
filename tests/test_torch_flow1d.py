"""The PyTorch port's Flow1D against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``) with the
flow head's last convolution damped by 0.1, as ``tests/test_torch_train.py``
does for RAFT: random GRU steps are chaotic.  ``state_dict_from_jax``
carries them into the port, which loads them with ``strict=True``.  The
model keeps its registered widths and radius (32) at 64x96 (8x12 feature
maps: most of each 65-wide window lies outside its row).  The JAX model's
eval forward is always given a ``prev_preds`` (a zero ``flow_small`` for a
cold forward), so cold and warm forwards share one compilation.
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
from tests.test_torch_lcv_train import assert_step_matches, jax_step
from tests.test_torch_train import (carry_random, nchw, nhwc, random_params,
                                    synthetic_batch)

jf1 = importlib.import_module("ptlflow_tpu.models.flow1d.flow1d")
tf1 = importlib.import_module("ptlflow_tpu_torch.models.flow1d.flow1d")
jtr = importlib.import_module("ptlflow_tpu.models.gmflow.transformer")
ttr = importlib.import_module("ptlflow_tpu_torch.models.gmflow.transformer")

H, W = 64, 96
ITERS = 3


def test_lookup_1d_matches_jax():
    """Windows of radius 4 of 11-long rows at coords from 6 before the row
    to 5 past it: tap a at coords + a - 4, zero outside the row, equal to
    the JAX package's one-hot product within 1e-6."""
    rng = np.random.RandomState(60)
    rows = rng.randn(2, 3, 5, 11).astype(np.float32)
    coords = rng.uniform(-6, 16, (2, 3, 5)).astype(np.float32)
    coords[0, 0, :2] = [4.0, 7.0]  # whole pixels
    want = np.asarray(jax.jit(lambda r, c: jf1.lookup_1d(r, c, 4))(
        jnp.asarray(rows), jnp.asarray(coords)))
    got = tf1.lookup_1d(torch.from_numpy(rows), torch.from_numpy(coords), 4)
    assert got.shape == (2, 9, 3, 5)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)
    np.testing.assert_array_equal(got[0, :, 0, 0].numpy(), rows[0, 0, 0, :9])
    np.testing.assert_array_equal(got[0, :, 0, 1].numpy(),
                                  np.r_[rows[0, 0, 1, 3:], 0.0])


def test_position_embedding_matches_jax():
    want = np.asarray(jtr.position_embedding_sine(6, 9, 16))
    got = ttr.position_embedding_sine(6, 9, 16)
    assert got.shape == (32, 6, 9)
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), want)


@pytest.mark.parametrize("y_attention", [False, True])
def test_attention_and_corr_match_jax(y_attention):
    """Attention1D (self attention along the other axis first) of two
    32-channel 6x7 maps with the position embedding, and the 1-D
    correlation of the first map with its output: within 1e-5 of the JAX
    package's."""
    jmod = jf1.Attention1D(32, y_attention=y_attention,
                           double_cross_attn=True)
    tmod = tf1.Attention1D(32, y_attention=y_attention,
                           double_cross_attn=True)
    params = carry_random(jmod, tmod, 61)
    rng = np.random.RandomState(61)
    f1, f2 = (rng.randn(2, 6, 7, 32).astype(np.float32) for _ in range(2))
    pos = np.asarray(jtr.position_embedding_sine(6, 7, 16))
    jcorr = jf1.corr_1d_x if y_attention else jf1.corr_1d_y
    tcorr = tf1.corr_1d_x if y_attention else tf1.corr_1d_y

    def jax_fn(p, a, b, q):
        out, attn = jmod(p, a, b, q)
        return out, attn, jcorr(a, out)

    want = jax.jit(jax_fn)(params, jnp.asarray(f1), jnp.asarray(f2),
                           jnp.asarray(pos))
    with torch.no_grad():
        out, attn = tmod(nchw(f1), nchw(f2), nchw(pos[None]))
        rows = tcorr(nchw(f1), out)
    np.testing.assert_allclose(nhwc(out), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want[1]), atol=1e-6)
    np.testing.assert_allclose(rows.numpy(), np.asarray(want[2]), atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jmodel = ptlflow_tpu.get_model_reference("flow1d")(iters=ITERS)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(62))
    head = params["update_block"]["flow_head"]["conv2"]
    for leaf in ("weight", "bias"):
        head[leaf] = head[leaf] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model("flow1d", args={"iters": ITERS},
                                         device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel


def test_eval_forward_and_warm_start_match_jax(models):
    """3 iterations at 64x96, cold and warm-started from a ``flow_small``:
    flows and ``flow_small`` within 5e-3 px of the JAX package's, no
    autograd graph, and the warm start moves the flow."""
    jmodel, tmodel = models
    images = np.random.RandomState(63).rand(1, 2, 3, H, W).astype(np.float32)
    prev = (2.0 + np.random.RandomState(64).uniform(
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
        np.testing.assert_allclose(got["flow_small"].numpy(),
                                   np.asarray(want["flow_small"]), atol=5e-3)
        assert np.abs(np.asarray(want["flows"])).max() > 1.0
        outs[warm] = got["flows"]
    assert (outs[True] - outs[False]).abs().max() > 0.5


def test_train_step_matches_jax_value_and_grad(models):
    """One step (3 iterations, 64x96, batch 2): every iteration's flow, the
    loss, the context encoder's BatchNorm statistics and every gradient,
    as ``tests/test_torch_lcv_train.py::assert_step_matches`` holds them;
    both attentions and the first encoder get a gradient through the 1-D
    lookups."""
    jmodel, tmodel = models
    batch = synthetic_batch(65)
    (jloss, (jstate, jpreds)), jgrads = jax_step(jmodel, batch)
    assert jpreds.shape == (ITERS, 2, H, W, 2)
    tparams, grads = assert_step_matches(tmodel, batch, jloss, jgrads,
                                         jstate, jpreds)
    named = dict(zip(tparams, grads))
    for name in ("attn_x.query_conv.weight", "attn_y.self_attn.key_conv.weight",
                 "fnet.conv1.weight", "cnet.conv1.weight"):
        assert named[name].abs().max() > 0, name
