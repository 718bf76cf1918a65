"""The PyTorch port's RPKNet against the JAX package's, on the CPU.

Weights are drawn and conditioned as ``tests/test_torch_rapidflow.py``
says (``build``: seeded ``random_params``, the SLK layer scales in [0.1,
1], the flow head's last convolution damped by 0.1: undamped, random
RPKNet flows reach ~730 px at 64x96).  The partial-kernel blocks are
checked where the slicing bites: on inputs narrower than the stored
kernel.
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
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_rapidflow import (H, W, assert_flows_match, build,
                                        carry, images_of)
from tests.test_torch_train import nchw, nhwc

jpk = importlib.import_module("ptlflow_tpu.models.rpknet.pkconv_slk")
tpk = importlib.import_module("ptlflow_tpu_torch.models.rpknet.pkconv_slk")


# ----------------------------------------------------------------- norms
@pytest.mark.parametrize("norm", ["group", "layer"])
def test_affine_free_norms_match_jax(norm):
    """``group_norm`` (8 groups) and ``layer_norm2d`` over 32 channels of
    an input off zero mean: the population variance with eps 1e-6, within
    1e-5 (an unbiased variance would be 3% off here)."""
    x = (3.0 + 2.0 * np.random.RandomState(20).randn(2, 5, 7, 32)).astype(
        np.float32)
    jfn = jpk.make_norm(norm, 8)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    got = nhwc(tpk.make_norm(norm, 8)(nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert list(tpk.make_norm(norm, 8).parameters()) == []


# ---------------------------------------------------------- partial convs
@pytest.mark.parametrize("kind", ["dense", "depthwise"])
def test_pkconv_slices_match_jax(kind):
    """A partial convolution stored at 48 -> 64 channels (dense) or 48
    depthwise 23x1 kernels, called on a 32-channel input for 40 (dense) or
    32 (depthwise) outputs: the kernel and bias sliced as the JAX package
    slices them, within 1e-4; the ``state_dict`` keeps the full kernel."""
    if kind == "dense":
        args, call, out_ch = (48, 64, 3), dict(padding=1), 40
        full = (64, 48, 3, 3)
    else:
        args, call, out_ch = (48, 48, (23, 1)), dict(padding=(11, 0),
                                                     groups=48), 32
        full = (48, 1, 23, 1)
    jconv = jpk.PKConv2d(*args, **call)
    tconv = tpk.PKConv2d(*args, **call)
    params = carry(jconv, tconv, 21)
    params["bias"] = jnp.asarray(np.random.RandomState(21).uniform(
        -0.5, 0.5, params["bias"].shape).astype(np.float32))
    with torch.no_grad():
        tconv.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    assert tuple(tconv.state_dict()["weight"].shape) == full
    x = np.random.RandomState(22).randn(2, 27, 13, 32).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jconv(p, x, out_ch=out_ch))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tconv(nchw(x), out_ch=out_ch))
    assert got.shape == (2, 27, 13, out_ch)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_slk_matches_jax():
    """An SLK block stored at 48 channels (the 23x1 and 1x23 depthwise
    kernels, the MLP's 3x3 one), run on 32 channels of a 25x27 map, so
    every kernel and layer scale is sliced: within 1e-4."""
    jblk = jpk.SLK(48)
    tblk = tpk.SLK(48)
    params = carry(jblk, tblk, 23)
    x = np.random.RandomState(23).randn(2, 25, 27, 32).astype(np.float32)
    want = np.asarray(jax.jit(jblk)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tblk(nchw(x)))
    assert np.abs(got - x).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def rpk():
    return build("rpknet", 24, iters=6)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_eval_forward_matches_jax(rpk, warm):
    """``rpknet`` (3 levels, 2 steps a level) at 64x96: flows and
    ``flow_small`` within 5e-3 px of the JAX package's, cold or warm-started
    from a ``flow_small`` in the coarsest level's pixels; no autograd
    graph, and the warm start moves the flow."""
    jmodel, tmodel, _ = rpk
    images = images_of(25)
    rng = np.random.RandomState(26)
    prev = (0.3 + rng.uniform(-0.05, 0.05, (1, 2, 2, 3))).astype(np.float32)
    jprev = prev if warm else np.zeros_like(prev)
    want = jmodel({"images": images,
                   "prev_preds": {"flow_small": jnp.asarray(jprev)}})
    inputs = {"images": torch.from_numpy(images)}
    if warm:
        inputs["prev_preds"] = {"flow_small": torch.from_numpy(prev)}
    got = tmodel(inputs)
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flow_small"].shape == (1, 2, 2, 3)
    assert all(v.grad_fn is None for v in got.values())
    assert_flows_match(got, want)
    np.testing.assert_allclose(nhwc(got["flow_small"]),
                               np.asarray(want["flow_small"]), atol=5e-3)
    assert np.abs(np.asarray(want["flows"])).max() > 1.0
    if warm:
        cold = tmodel({"images": torch.from_numpy(images)})
        assert (cold["flows"] - got["flows"]).abs().max() > 0.5


def test_state_dict_matches_jax_params():
    jmodel = ptlflow_tpu.get_model_reference("rpknet")()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model("rpknet", device="cpu")
    assert set(tmodel.state_dict()) == jax_state_keys(shapes)
    assert tmodel.fnet.rec_stage.blocks[0].attn.spatial_gating_unit \
        .conv1_branches[0].weight.shape == (96, 1, 23, 1)


def test_flagged_forward_matches_jax():
    """``input_pad_one_side`` and ``input_bgr_to_rgb`` on, 2 steps, a 40x50
    input that pads to 64x64 on the right and bottom only (encoder and
    GRU stages one block deep, one GRU): flows within 5e-3 px of the JAX
    package's, and off the unflagged forward of the same weights."""
    small = {"iters": 2, "enc_depth": 1, "dec_gru_depth": 1,
             "dec_gru_iters": 1}
    args = dict(small, input_pad_one_side=True, input_bgr_to_rgb=True)
    jmodel, tmodel, params = build("rpknet", 28, **args)
    images = images_of(28, h=40, w=50)
    want = jax.jit(lambda p, x: jmodel.forward(p, x))(
        jmodel.params, {"images": jnp.asarray(images)})
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, 40, 50)
    assert_flows_match(got, want)
    plain = ptlflow_tpu_torch.get_model("rpknet", args=small, device="cpu")
    plain.load_state_dict(tmodel.state_dict())
    other = plain({"images": torch.from_numpy(images)})["flows"]
    assert (other - got["flows"]).abs().max() > 0.5
