"""The PyTorch port's SKFlow against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``: BatchNorm
statistics randomised, the aggregator's ``gamma`` in [0.1, 1]) and are
conditioned by ``condition``: with random weights each super-kernel block
multiplies its input's scale by ~4, so that two iterations at 64x96 step
~5e6 px and fp32 rounding alone moves the flow by whole pixels.  Each
block's last convolution scaled by 0.2, and the flow head's by 0.03 more,
gives steps of 10-40 px that agree within 1e-4 px when the input moves by
one rounding.  ``state_dict_from_jax`` carries the weights into the port,
given the port's module (GMA's ``rel_ind``); the port loads them with
``strict=True``.  Inputs come from numpy seeds; the port is NCHW, the JAX
package NHWC.

The JAX blocks and models are jitted (an eager SKFlow block runs op by op
for seconds); the JAX model's eval forward is jitted once and always given a
``prev_preds``: a cold forward gets a zero ``flow_small``, whose forward
projection is exactly 0, so cold and warm-started forwards share one
compilation (the port's cold forward gets none).
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
from tests.test_torch_gma import random_attention
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_train import nchw, nhwc, random_params, synthetic_batch

# the modules, not the classes that the packages re-export under their names
jsk = importlib.import_module("ptlflow_tpu.models.skflow.skflow")
tsk = importlib.import_module("ptlflow_tpu_torch.models.skflow.skflow")

H, W = 64, 96
ITERS = 2


def condition(params, block_scale=0.2, head_scale=0.03):
    """Every super-kernel block's last convolution (``ffn2.2``) scaled by
    ``block_scale``, the flow head's by ``head_scale`` more."""
    for k, v in params.items():
        if not isinstance(v, dict):
            continue
        if k == "ffn2":
            for leaf in ("weight", "bias"):
                v["2"][leaf] = v["2"][leaf] * block_scale
        else:
            condition(v, block_scale, 1.0)
    head = params.get("update_block", {}).get("flow_head")
    if head is not None:
        for leaf in ("weight", "bias"):
            head["ffn2"]["2"][leaf] = head["ffn2"]["2"][leaf] * head_scale


def carry(jmod, tmod, seed):
    """Conditioned ``random_params`` for the JAX module ``jmod``, loaded
    into the port's ``tmod``.  Returns the JAX params."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    condition(params)
    tmod.load_state_dict(state_dict_from_jax(params, tmod), strict=True)
    return jax.tree_util.tree_map(jnp.asarray, params)


def build(name, seed, **args):
    """(JAX model with conditioned seeded weights, port model on the CPU
    with the same weights, numpy params)."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    condition(params)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args)
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel.eval(), params


@pytest.fixture(scope="module")
def sk():
    return build("skflow", 110, iters=ITERS)


def images_of(seed, b=1, h=H, w=W):
    return np.random.RandomState(seed).rand(b, 2, 3, h, w).astype(np.float32)


def zero_prev(images):
    b, _, _, h, w = images.shape
    return {"flow_small": jnp.zeros((b, 2, h // 8, w // 8), jnp.float32)}


# ---------------------------------------------------------------- blocks
@pytest.mark.parametrize("k_conv", [(1, 15), (1, 7)])
def test_pcblock_matches_jax(k_conv):
    """The super-kernel block over 48 channels of a 17x21 map (wider than
    the 15x15 depthwise kernel), 48 -> 32 channels, conditioned weights:
    within 1e-4."""
    jblk = jsk.PCBlock4_Deep_nopool_res(48, 32, k_conv)
    tblk = tsk.PCBlock4_Deep_nopool_res(48, 32, k_conv)
    params = carry(jblk, tblk, 111)
    assert tblk.conv_list[1].weight.shape == (48, 1, k_conv[1], k_conv[1])
    x = np.random.RandomState(111).randn(2, 17, 21, 48).astype(np.float32)
    want = np.asarray(jax.jit(jblk)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tblk(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_motion_encoder_matches_jax():
    """324 correlation channels (4 levels, r = 4) and the flow -> 126
    motion channels and the flow, last, conditioned weights: within
    1e-4."""
    jenc = jsk.SKMotionEncoder6_Deep_nopool_res(4, 4, (1, 15))
    tenc = tsk.SKMotionEncoder6_Deep_nopool_res(4, 4, (1, 15))
    params = carry(jenc, tenc, 112)
    rng = np.random.RandomState(112)
    flow = rng.randn(2, 10, 12, 2).astype(np.float32)
    corr = rng.randn(2, 10, 12, 324).astype(np.float32)
    want = np.asarray(jax.jit(jenc)(params, jnp.asarray(flow),
                                    jnp.asarray(corr)))
    with torch.no_grad():
        got = nhwc(tenc(nchw(flow), nchw(corr)))
    assert got.shape == (2, 10, 12, 128)
    np.testing.assert_array_equal(got[..., -2:], flow)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_update_block_matches_jax():
    jblk = jsk.SKUpdateBlock6_Deep_nopoolres_AllDecoder(
        4, 4, (1, 15), (1, 7), num_heads=1, hidden_dim=128)
    tblk = tsk.SKUpdateBlock6_Deep_nopoolres_AllDecoder(
        4, 4, (1, 15), (1, 7), num_heads=1, hidden_dim=128)
    params = carry(jblk, tblk, 113)
    rng = np.random.RandomState(113)
    args = [rng.randn(2, 6, 8, c).astype(np.float32)
            for c in (128, 128, 324, 2)]  # net, inp, corr, flow
    attn = random_attention(rng, 2, 1, 48)
    want = jax.jit(jblk)(params, *map(jnp.asarray, args), jnp.asarray(attn))
    with torch.no_grad():
        got = tblk(*map(nchw, args), torch.from_numpy(attn))
    for g, w in zip(got, want):  # net, mask, delta_flow
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(g), w, atol=1e-4)


# ----------------------------------------------------------- full model
@pytest.mark.parametrize("warm", [False, True])
def test_eval_forward_matches_jax(sk, warm):
    """2 iterations at 64x96, cold or warm-started from a ``flow_small``
    forward-projected into the coords: flows and ``flow_small`` within
    5e-3 px of the JAX package's, no autograd graph, and the warm start
    moves the flow."""
    jmodel, tmodel, _ = sk
    images = images_of(114)
    rng = np.random.RandomState(115)
    prev = (2.0 + rng.uniform(-0.2, 0.2, (1, 2, 8, 12))).astype(np.float32)
    jprev = {"flow_small": jnp.asarray(prev)} if warm else zero_prev(images)
    want = jmodel({"images": images, "prev_preds": jprev})
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
    if warm:
        cold = tmodel({"images": torch.from_numpy(images)})
        assert (cold["flows"] - got["flows"]).abs().max() > 0.5


def test_training_forward_matches_jax(sk):
    """``flow_preds`` of 2 iterations at 64x96, batch 2 (BatchNorm on
    batch statistics in the context encoder), within 5e-3 px of the JAX
    package's; ``flows`` is the last, and ``SequenceLoss`` within 1e-5."""
    jmodel, tmodel, _ = sk
    batch = synthetic_batch(116)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, x: jmodel.forward(p, x, training=True))(
        jmodel.params, {"images": jbatch["images"]})
    got = tmodel({"images": torch.from_numpy(batch["images"])},
                 training=True)
    preds = got["flow_preds"]
    assert preds.shape == (ITERS, 2, 2, H, W) and preds.requires_grad
    np.testing.assert_allclose(nhwc(preds), np.asarray(want["flow_preds"]),
                               atol=5e-3)
    torch.testing.assert_close(got["flows"], preds[-1][:, None], rtol=0,
                               atol=0)
    want_loss = jmodel.loss_fn({"flow_preds": want["flow_preds"]}, jbatch)
    got_loss = tmodel.loss_fn(
        got, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)


# -------------------------------------------------- weights and names
def test_state_dict_matches_jax_params():
    """The port's keys are the JAX tree's, plus torch's BatchNorm counters
    and the reference's ``rel_ind``; the depthwise kernels are (C, 1, k,
    k), one per entry of ``k_conv``."""
    jmodel = jsk.SKFlow(iters=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model("skflow", args={"iters": 1},
                                         device="cpu")
    keys = set(tmodel.state_dict())
    assert keys == jax_state_keys(shapes) | {"att.pos_emb.rel_ind"}
    sd = tmodel.state_dict()
    assert sd["update_block.encoder.convc1.conv_list.1.weight"].shape == (
        324, 1, 15, 15)
    assert sd["update_block.gru.conv_list.1.weight"].shape == (512, 1, 7, 7)
    assert tmodel.update_block.aggregator.gamma.item() == 0.0
    with pytest.raises(ValueError, match="fp32 only"):
        ptlflow_tpu_torch.get_model("skflow", args={"mixed_precision": True},
                                    device="cpu")
