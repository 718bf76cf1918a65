"""The PyTorch port's GMA against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``: BatchNorm
statistics randomised, the aggregator's ``gamma`` in [0.1, 1]: at its init
of 0 the aggregator adds nothing and a wrong one would pass) and the flow
head's last conv damped by 0.1, as the RAFT tests do.  ``state_dict_from_jax``
carries them into the port, given the port's module so that it leaves the
embedding tables untransposed and adds ``rel_ind``; the port loads them
with ``strict=True``.  Inputs come from numpy seeds; the port is NCHW, the
JAX package NHWC.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu_torch
from ptlflow_tpu.models.gma import gma_utils as jutils
from ptlflow_tpu_torch.models.gma import gma_utils as tutils
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_train import (carry_random, jax_and_port, nchw, nhwc,
                                    random_params, synthetic_batch)

# the modules, not the classes that the packages re-export under their names
jgma = importlib.import_module("ptlflow_tpu.models.gma.gma")
tgma = importlib.import_module("ptlflow_tpu_torch.models.gma.gma")


def random_attention(rng, b, heads, n):
    """Rows of a softmax over n positions: an attention of GMA's layout."""
    logits = 3 * rng.randn(b, heads, n, n)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("mode", ["content", "position_only",
                                  "position_and_content"])
def test_attention_matches_jax(mode):
    """Two heads over a 6x8 map, by content (GMA's default), by relative
    position alone, or by both: within 1e-5 of the JAX package's."""
    kw = dict(position_only=mode == "position_only",
              position_and_content=mode == "position_and_content",
              max_pos_size=20, heads=2, dim_head=16)
    jatt = jutils.Attention(32, **kw)
    tatt = tutils.Attention(32, **kw)
    params = carry_random(jatt, tatt, 80)
    x = np.random.RandomState(80).randn(2, 6, 8, 32).astype(np.float32)
    want = np.asarray(jatt(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tatt(nchw(x))
    assert got.shape == (2, 2, 48, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("heads", [1, 2])
def test_aggregate_matches_jax(heads):
    """fmap + gamma * (attention @ v), with the projection back to the
    input width where two heads make the inner width differ."""
    jagg = jutils.Aggregate(32, heads=heads, dim_head=32)
    tagg = tutils.Aggregate(32, heads=heads, dim_head=32)
    params = carry_random(jagg, tagg, 81)
    assert (tagg.project is None) == (heads == 1)
    assert float(params["gamma"][0]) >= 0.1
    rng = np.random.RandomState(81)
    attn = random_attention(rng, 2, heads, 48)
    x = rng.randn(2, 6, 8, 32).astype(np.float32)
    want = np.asarray(jagg(params, jnp.asarray(attn), jnp.asarray(x)))
    with torch.no_grad():
        got = tagg(torch.from_numpy(attn), nchw(x))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_update_block_matches_jax():
    jblk = jgma.GMAUpdateBlock(4, 4, num_heads=1)
    tblk = tgma.GMAUpdateBlock(4, 4, num_heads=1)
    shapes = jax.eval_shape(jblk.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(82))
    params["flow_head"]["conv2"]["weight"] *= 0.1
    tblk.load_state_dict(state_dict_from_jax(params, tblk), strict=True)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    rng = np.random.RandomState(82)
    args = [rng.randn(2, 6, 8, c).astype(np.float32)
            for c in (128, 128, 324, 2)]  # net, inp, corr, flow
    attn = random_attention(rng, 2, 1, 48)
    j_net, j_mask, j_delta = jblk(params, *map(jnp.asarray, args),
                                  jnp.asarray(attn))
    with torch.no_grad():
        t_net, t_mask, t_delta = tblk(*map(nchw, args),
                                      torch.from_numpy(attn))
    np.testing.assert_allclose(nhwc(t_net), np.asarray(j_net), atol=1e-4)
    np.testing.assert_allclose(nhwc(t_delta), np.asarray(j_delta), atol=1e-4)
    np.testing.assert_allclose(nhwc(t_mask), np.asarray(j_mask), atol=1e-4)


# ----------------------------------------------------------- full model
def test_eval_forward_matches_jax():
    """2 GRU iterations, 61x83 padded to 64x88: flows and flow_small
    within 5e-3 px of the JAX package's, with no autograd graph."""
    jmodel, tmodel, _ = jax_and_port("gma", 83, 2)
    images = np.random.RandomState(83).rand(1, 2, 3, 61, 83).astype(
        np.float32)
    want = jmodel({"images": images})
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, 61, 83)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)


def test_warm_start_forward_matches_jax():
    """``prev_preds["flow_small"]`` forward-projected into the coords, 2
    iterations: within 5e-3 px of the JAX package's, and the warm start
    moves the flow."""
    jmodel, tmodel, _ = jax_and_port("gma", 84, 2)
    rng = np.random.RandomState(84)
    images = rng.rand(1, 2, 3, 64, 96).astype(np.float32)
    prev = (2.0 + rng.uniform(-0.2, 0.2, (1, 2, 8, 12))).astype(np.float32)
    want = jmodel({"images": images,
                   "prev_preds": {"flow_small": jnp.asarray(prev)}})
    got = tmodel({"images": torch.from_numpy(images),
                  "prev_preds": {"flow_small": torch.from_numpy(prev)}})
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)
    cold = tmodel({"images": torch.from_numpy(images)})
    assert (cold["flows"] - got["flows"]).abs().max() > 0.5


def test_training_forward_matches_jax():
    """``flow_preds`` of 2 iterations at 64x96, batch 2 (BatchNorm on batch
    statistics in the context encoder): within 5e-3 px of the JAX
    package's; ``flows`` is the last, and ``loss_fn`` is RAFT's."""
    jmodel, tmodel, _ = jax_and_port("gma", 85, 2)
    batch = synthetic_batch(85)
    want = jmodel.infer({"images": batch["images"]}, training=True)
    got = tmodel({"images": torch.from_numpy(batch["images"])},
                 training=True)
    preds = got["flow_preds"]
    assert preds.shape == (2, 2, 2, 64, 96) and preds.requires_grad
    np.testing.assert_allclose(nhwc(preds), np.asarray(want["flow_preds"]),
                               atol=5e-3)
    torch.testing.assert_close(got["flows"], preds[-1][:, None], rtol=0,
                               atol=0)
    want_loss = jmodel.loss_fn(
        {"flow_preds": want["flow_preds"]},
        {k: jnp.asarray(v) for k, v in batch.items()})
    got_loss = tmodel.loss_fn(
        got, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("args", [{"mixed_precision": True},
                                  {"corr_dtype": "bfloat16"}])
def test_refuses_reduced_precision(args):
    """The JAX package's GMA computes in fp32 whatever it is given, so the
    port refuses RAFT's precision options rather than compute otherwise;
    their fp32 values are accepted."""
    with pytest.raises(ValueError, match="fp32 only"):
        ptlflow_tpu_torch.get_model("gma", args=dict(args, iters=1),
                                    device="cpu")
    model = ptlflow_tpu_torch.get_model(
        "gma", args={"iters": 1, "mixed_precision": False,
                     "corr_dtype": None}, device="cpu")
    assert model.att.to_qk.weight.dtype == torch.float32
    assert not model.mixed_precision and model.corr_dtype is None


# -------------------------------------------------- weights and names
def test_state_dict_matches_jax_params():
    """The port's keys are the JAX tree's, plus torch's BatchNorm counters
    and the reference's ``rel_ind`` buffer, which the converter takes from
    the port; the (319, 128) embedding tables load untransposed."""
    jmodel = jgma.GMA(iters=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model("gma", args={"iters": 1},
                                         device="cpu")
    keys = set(tmodel.state_dict())
    assert keys == jax_state_keys(shapes) | {"att.pos_emb.rel_ind"}
    params = random_params(shapes, np.random.RandomState(87))
    converted = state_dict_from_jax(params, tmodel)
    assert set(converted) == keys
    tmodel.load_state_dict(converted, strict=True)
    table = params["att"]["pos_emb"]["rel_height"]["weight"]
    assert table.shape == (319, 128)
    np.testing.assert_array_equal(
        tmodel.att.pos_emb.rel_height.weight.detach().numpy(), table)
    rel_ind = tmodel.att.pos_emb.rel_ind
    assert rel_ind.shape == (160, 160) and rel_ind[3, 5] == 5 - 3 + 159
    # without the target, a 2-D weight is a linear layer's: transposed
    assert state_dict_from_jax(params)[
        "att.pos_emb.rel_height.weight"].shape == (128, 319)
