"""The PyTorch port's StreamFlow against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``: the
temporal transformer's parameters, zero at init, drawn as any other) and
are conditioned as ``tests/test_torch_skflow.py`` does (each super-kernel
block's last convolution scaled by 0.2, the flow head's by 0.03 more).
``state_dict_from_jax`` carries them into the port, which loads them with
``strict=True``.  The JAX blocks and the model's forward are jitted.
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
from tests.test_torch_gma import random_attention
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_skflow import carry, condition
from tests.test_torch_train import nchw, nhwc, random_params

jsf = importlib.import_module("ptlflow_tpu.models.streamflow.streamflow")
tsf = importlib.import_module(
    "ptlflow_tpu_torch.models.streamflow.streamflow")

H, W = 64, 64


def build(seed, **args):
    """(JAX ``streamflow`` with conditioned seeded weights, the port's on
    the CPU with the same weights, numpy params)."""
    jmodel = ptlflow_tpu.get_model_reference("streamflow")(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    condition(params)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model("streamflow", args=args,
                                         device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


def batch_of(seed, b=2, h=H, w=W):
    """4 frames, the 3 pairs' ground-truth flows (a few above max_flow)
    and valids, as numpy arrays in the model contract's layout."""
    rng = np.random.RandomState(seed)
    flows = (3 * rng.randn(b, 3, 2, h, w)).astype(np.float32)
    flows[:, :, :, :4, :4] = 500.0
    return {"images": rng.rand(b, 4, 3, h, w).astype(np.float32),
            "flows": flows,
            "valids": (rng.rand(b, 3, 1, h, w) > 0.2).astype(np.float32)}


# ---------------------------------------------------------------- blocks
def test_twins_on_stacked_frames_matches_jax():
    """Twins-SVT over 3 frames of 40x48 stacked to 120x48 (a frame is 10
    rows at 1/4, so the 7-row windows straddle frames): within 1e-4 of the
    JAX package's, (B, T, 256, H/8, W/8)."""
    jmod, tmod = jsf.Twins_CSC(), tsf.Twins_CSC()
    params = carry(jmod, tmod, 220)
    x = np.random.RandomState(220).rand(1, 3, 40, 48, 3).astype(np.float32)
    want = np.asarray(jax.jit(jmod)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(nchw(x))
    assert got.shape == (1, 3, 256, 5, 6)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_transformer_block_matches_jax():
    """The temporal transformer over 3 tokens of 128 channels a pixel,
    with drawn weights (zero at init): within 1e-4 of the JAX package's,
    and not the identity."""
    jmod, tmod = jsf.TransformerBlock(128), tsf.TransformerBlock(128)
    params = carry(jmod, tmod, 221)
    x = np.random.RandomState(221).randn(30, 3, 128).astype(np.float32)
    want = np.asarray(jax.jit(jmod)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got - x).max() > 0.1


def test_update_block_matches_jax():
    """The temporal super-kernel update block over a batch of 2 x 3 pairs
    on 6x8: the hidden state, the masks and the 3 pairs' steps within 1e-4
    of the JAX package's."""
    args = dict(decoder_dim=256, num_heads=1, use_gma=True,
                pcupdater_conv=[1, 7], corr_levels=4, corr_radius=4, T=4,
                k_conv=[1, 15])
    jblk, tblk = jsf.SKUpdateBlock_TAM_v3(**args), \
        tsf.SKUpdateBlock_TAM_v3(**args)
    params = carry(jblk, tblk, 222)
    rng = np.random.RandomState(222)
    nets, inps, corrs, flows = [rng.randn(6, 6, 8, c).astype(np.float32)
                                for c in (128, 128, 324, 2)]
    attn = random_attention(rng, 6, 1, 48)
    want = jax.jit(jblk, static_argnames="t_pairs")(
        params, *map(jnp.asarray, (nets, inps, corrs, flows, attn)),
        t_pairs=3)
    with torch.no_grad():
        got = tblk(*map(nchw, (nets, inps, corrs, flows)),
                   torch.from_numpy(attn), t_pairs=3)
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(want[0]), atol=1e-4)
    assert got[1].shape == (2, 3, 576, 6, 8)
    for g, w in zip(got[1:], want[1:]):  # (B, T', C, H, W) / (B, T', H, W, C)
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


# ----------------------------------------------------------- full model
def test_eval_forward_matches_jax():
    """4 frames at 64x64, 2 iterations: the 3 pairs' flows (1, 3, 2, H, W)
    within 5e-3 px of the JAX package's, ``flow_small`` within 1e-4, no
    autograd graph."""
    jmodel, tmodel, _ = build(223, iters=2)
    images = np.random.RandomState(223).rand(1, 4, 3, H, W).astype(
        np.float32)
    want = jax.jit(lambda p, x: jmodel.forward(p, x))(
        jmodel.params, {"images": jnp.asarray(images)})
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 3, 2, H, W)
    assert got["flow_small"].shape == (1, 3, 2, H // 8, W // 8)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=1e-4)
    assert np.abs(np.asarray(want["flows"])).max() > 1.0


def test_state_dict_and_init_match_jax():
    """The port's keys are the JAX tree's; ``init_params`` starts the
    temporal transformer at zero, as the JAX package's init does, and the
    model takes 4 frames."""
    jmodel = jsf.StreamFlow(iters=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model("streamflow", args={"iters": 1},
                                         device="cpu")
    assert set(tmodel.state_dict()) == jax_state_keys(shapes)
    assert tmodel.required_images == 4
    tb = tmodel.update_block.transformer_block
    assert all(torch.all(p == 0) for p in tb.parameters())
    assert tmodel.update_block.gru.ffn1[0].weight.abs().max() > 0
