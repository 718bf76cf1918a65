"""The PyTorch port's VideoFlow (BOF and MOF) against the JAX package's, on
the CPU.

JAX parameter trees get seeded numpy weights (``random_params``: MOF's
``init_hidden_state`` drawn uniform in +-0.1, GMA's aggregator ``gamma``
in [0.1, 1]) and are conditioned as ``tests/test_torch_skflow.py`` does
(each super-kernel block's last convolution scaled by 0.2, the flow head's
by 0.03 more); MOF's mask convolution is scaled by 0.01 more, since its
forward multiplies the mask by 100: with random weights its logits reach
~100, and the sharp softmax over them parts the port and the JAX package
by 3.8e-3 px at this size.
``state_dict_from_jax`` carries the weights into the port, MOF's initial
state transposed to the reference's (1, 1, 48, 1, 1); the port loads them
with ``strict=True``.  The JAX models' eval forwards are jitted.
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
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_skflow import condition
from tests.test_torch_train import random_params

H, W = 64, 96
DEPTH = 2


def build(name, seed, **args):
    """(JAX model with conditioned seeded weights, its jitted eval forward,
    the port's model on the CPU with the same weights, numpy params)."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    condition(params)
    if name == "videoflow_mof":
        last = params["update_block"]["mask"]["2"]
        for leaf in ("weight", "bias"):
            last[leaf] = last[leaf] * 0.01
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model(name, args=args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    forward = jax.jit(lambda p, x: jmodel.forward(p, x))
    return jmodel, forward, tmodel, params


@pytest.fixture(scope="module")
def bof():
    return build("videoflow_bof", 190, decoder_depth=DEPTH)


@pytest.fixture(scope="module")
def mof():
    return build("videoflow_mof", 191, decoder_depth=DEPTH)


def frames_of(seed, n):
    return np.random.RandomState(seed).rand(1, n, 3, H, W).astype(np.float32)


def check_eval(built, images):
    """Both directions' flows within 5e-3 px of the JAX package's, their
    1/8 flows within 1e-4, no autograd graph; returns the outputs."""
    jmodel, forward, tmodel, _ = built
    want = forward(jmodel.params, {"images": jnp.asarray(images)})
    got = tmodel({"images": torch.from_numpy(images)})
    for key in ("flows", "flows_bw"):
        assert got[key].shape == (1, 1, 2, H, W)
        assert got[key].grad_fn is None
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=5e-3)
        assert np.abs(np.asarray(want[key])).max() > 1.0
    for key in ("flow_small", "flow_bw_small"):
        np.testing.assert_allclose(
            got[key].numpy(), np.moveaxis(np.asarray(want[key]), -1, 1),
            atol=1e-4)
    return got


@pytest.mark.parametrize("n", [3, 2])
def test_bof_eval_forward_matches_jax(bof, n):
    """3 frames, or 2 padded to 3 by repeating the first (what
    ``validate`` hands it from a pair dataset), 2 decoder steps at
    64x96."""
    got = check_eval(bof, frames_of(192, n))
    assert (got["flows"] - got["flows_bw"]).abs().max() > 0.1


def test_mof_eval_forward_matches_jax(mof):
    """5 frames, 2 decoder steps at 64x96: the middle inner frame's flows,
    and the 1/8 flows of all 3 inner frames."""
    got = check_eval(mof, frames_of(193, 5))
    assert got["flow_small"].shape == (3, 2, H // 8, W // 8)


@pytest.mark.parametrize("name", ["videoflow_bof", "videoflow_mof"])
def test_training_forward_gives_every_step(bof, mof, name):
    """Eval models (no loss, not trainable, as in the JAX package) whose
    ``training=True`` forward gives ``flow_preds`` (depth, B, 2, 2, H, W),
    the (forward, backward) pair of every decoder step; they hold no
    BatchNorm, so the last step's pair is the eval forward's flows."""
    tmodel = (bof if name == "videoflow_bof" else mof)[2]
    assert tmodel.loss_fn is None
    assert name not in ptlflow_tpu_torch.get_trainable_model_names()
    images = torch.from_numpy(frames_of(194, 3 if name.endswith("bof")
                                        else 5))
    out = tmodel({"images": images}, training=True)
    preds = out["flow_preds"]
    assert preds.shape == (DEPTH, 1, 2, 2, H, W) and preds.requires_grad
    with torch.no_grad():
        ev = tmodel({"images": images})
    torch.testing.assert_close(preds[-1][:, :1].detach(), ev["flows"],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(preds[-1][:, 1:].detach(), ev["flows_bw"],
                               rtol=0, atol=1e-4)


def test_init_hidden_state_layout(mof):
    """MOF's initial motion state: (1, 1, 48, 1, 1) in the port and the
    reference, (1, 1, 1, 1, 48) in the JAX tree, the same 48 numbers;
    tiled over the inner frames of a batch, each pixel starts from them."""
    _, _, tmodel, params = mof
    enc = tmodel.update_block.encoder
    want = np.asarray(params["update_block"]["encoder"]["init_hidden_state"])
    assert want.shape == (1, 1, 1, 1, 48)
    assert enc.init_hidden_state.shape == (1, 1, 48, 1, 1)
    np.testing.assert_array_equal(
        enc.init_hidden_state.detach().numpy()[0, 0, :, 0, 0], want.ravel())
    state = enc.initial_state(2, 3, 4, 5)
    assert state.shape == (6, 48, 4, 5)
    np.testing.assert_array_equal(state[4, :, 3, 2].detach().numpy(),
                                  want.ravel())


@pytest.mark.parametrize("name", ["videoflow_bof", "videoflow_mof"])
def test_state_dict_matches_jax_params(name):
    """The port's keys are the JAX tree's plus GMA's ``rel_ind``; MOF's
    holds the unused ``VelocityUpdateBlock``, as the reference's
    checkpoints do."""
    jmodel = ptlflow_tpu.get_model_reference(name)(decoder_depth=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model(name, args={"decoder_depth": 1},
                                         device="cpu")
    keys = set(tmodel.state_dict())
    assert keys == jax_state_keys(shapes) | {"att.pos_emb.rel_ind"}
    velocity = {k for k in keys if ".velocity_update_block." in k}
    if name == "videoflow_mof":
        assert velocity == {
            f"update_block.encoder.velocity_update_block.mlp.{i}.{leaf}"
            for i in (0, 2, 4) for leaf in ("weight", "bias")}
    else:
        assert not velocity
