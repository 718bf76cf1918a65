"""The PyTorch port's DPFlow against the JAX package's, on the CPU.

Weights are drawn and conditioned as ``tests/test_torch_rapidflow.py``
says (``build``: seeded ``random_params``, the CGU layer scales in [0.1,
1], the flow head's last convolution, flow and info channels, damped by
0.1: undamped, random DPFlow flows reach ~340 px at 64x96).  The model
tests run at the registered widths with the encoder's and the GRU's CGU
stages one block deep and 2 steps a level, so that the JAX twin compiles
in seconds.
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
from ptlflow_tpu import nn as jnn
from ptlflow_tpu_torch import nn as tnn
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_rapidflow import (H, W, assert_flows_match, build,
                                        carry, images_of)
from tests.test_torch_train import nchw, nhwc

jcgu = importlib.import_module("ptlflow_tpu.models.dpflow.cgu")
tcgu = importlib.import_module("ptlflow_tpu_torch.models.dpflow.cgu")
jdp = importlib.import_module("ptlflow_tpu.models.dpflow.dpflow")
tdp = importlib.import_module("ptlflow_tpu_torch.models.dpflow.dpflow")

# the model tests' depths (the registered widths)
SMALL = {"enc_depth": 1, "dec_gru_depth": 1, "iters_per_level": 2}


# ---------------------------------------------------------------- blocks
def test_cgu_with_cross_matches_jax():
    """A cross-gated unit over 32 channels of two 11x13 streams: both
    outputs within 1e-4; ``y`` reads the updated ``x`` (a ``y`` computed
    from the old one is off by more than that)."""
    jblk = jcgu.CGU(32, norm=jcgu.group_norm, use_cross=True)
    tblk = tcgu.CGU(32, norm=None, use_cross=True)
    params = carry(jblk, tblk, 30)
    rng = np.random.RandomState(30)
    x, y = (rng.randn(2, 11, 13, 32).astype(np.float32) for _ in range(2))
    want = jax.jit(jblk)(params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = tblk(nchw(x), nchw(y))
        # the cross call on the old x, for contrast
        xs = tblk.conv_self(tblk.norm_fn(nchw(x)))
        ys = tblk.conv_self(tblk.norm_fn(nchw(y)))
        y_old = nchw(y) + tblk._scale(tblk.conv_cross(ys, xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)
    assert np.abs(nhwc(y_old) - np.asarray(want[1])).max() > 1e-2


@pytest.mark.parametrize("cross", [True, False], ids=["cross", "self"])
def test_cgu_stage_matches_jax(cross):
    """A CGU stage, 24 -> 32 channels, stride 2 with cross (the encoder's
    ``rec_stage``) or stride 1 on channel LayerNorm without (the GRU's
    gates), two blocks: within 1e-4."""
    norm = jcgu.group_norm if cross else jcgu.layer_norm2d
    tnorm = None if cross else tdp.LayerNorm2dNoAffine()
    stride = 2 if cross else 1
    jst = jcgu.CGUStage(24, 32, stride=stride, norm=norm, depth=2,
                        use_cross=cross)
    tst = tcgu.CGUStage(24, 32, stride=stride, norm=tnorm, depth=2,
                        use_cross=cross)
    params = carry(jst, tst, 31)
    rng = np.random.RandomState(31)
    x, y = (rng.randn(2, 14, 18, 24).astype(np.float32) for _ in range(2))
    if cross:
        want = jax.jit(jst)(params, jnp.asarray(x), jnp.asarray(y))
        with torch.no_grad():
            got = tst(nchw(x), nchw(y))
    else:
        want = (jax.jit(jst)(params, jnp.asarray(x)),)
        with torch.no_grad():
            got = (tst(nchw(x)),)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


def test_up_gru_transpose_matches_jax():
    """``up_gru``'s 4x4 stride-2 transposed convolution: the JAX (kh, kw,
    O, I) kernel, carried by ``state_dict_from_jax``'s generic 4-D
    transpose into torch's (I, O, kh, kw), gives the JAX output within
    1e-5."""
    jconv = jnn.ConvTranspose2d(16, 24, 4, stride=2, padding=1)
    tconv = tnn.CastConvTranspose2d(16, 24, 4, stride=2, padding=1)
    params = carry(jconv, tconv, 32)
    assert tconv.weight.shape == (16, 24, 4, 4)
    x = np.random.RandomState(32).randn(2, 5, 7, 16).astype(np.float32)
    want = np.asarray(jax.jit(jconv)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tconv(nchw(x)))
    assert got.shape == (2, 10, 14, 24)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dual_encoder_matches_jax():
    """The bidirectional dual encoder at a narrow width (hidden 16, 24,
    32; one CGU block a stage; 96 output channels) on two 64x96 frames, 3
    levels: both frames' levels, coarsest first, within 1e-4."""
    kw = dict(hidden_chs=(16, 24, 32), out_1x1_abs_chs=96,
              out_1x1_factor=None, depth=1)
    jenc = jdp.CGUBidirDualEncoder(**kw)
    tenc = tdp.CGUBidirDualEncoder(**kw)
    params = carry(jenc, tenc, 33)
    rng = np.random.RandomState(33)
    x, y = (rng.randn(1, H, W, 3).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda p, a, b: jenc(p, a, b, pyr_levels=3))(
        params, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = tenc(nchw(x), nchw(y), pyr_levels=3)
    assert [tuple(g.shape) for g in got[0]] == [(1, 96, 2, 3), (1, 96, 4, 6),
                                                (1, 96, 8, 12)]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("size,levels", [((436, 1024), 3),
                                         ((1080, 1920), 4),
                                         ((2160, 3840), 5)])
def test_compute_pyramid_levels_matches_jax(size, levels):
    shape = (1, 2, 3) + size
    assert tdp.compute_pyramid_levels(shape) == levels
    assert jdp.compute_pyramid_levels(shape) == levels


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def models():
    return {lv: build("dpflow", 34 + (lv or 0), pyramid_levels=lv, **SMALL)
            for lv in (None, 4)}


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("levels", [None, 4], ids=["3 levels", "4 levels"])
def test_eval_forward_matches_jax(models, levels, warm):
    """``dpflow`` at 64x96: the 3 levels its size gives (stride 32), and an
    explicit ``pyramid_levels=4`` (stride 64: padded to 64x128, a 1x2
    coarsest level): flows and ``flow_small`` within 5e-3 px of the JAX
    package's, cold or warm-started from a ``flow_small`` at the finest
    level; no autograd graph.  At 3 levels the warm start moves the flow;
    at 4 the 1x2 coarsest level has no cell strictly inside the map for the
    forward projection to land on, so both packages start it at zero."""
    jmodel, tmodel, _ = models[levels]
    images = images_of(36)
    fine = (8, 12) if levels is None else (8, 16)
    rng = np.random.RandomState(37)
    prev = (2.0 + rng.uniform(-0.2, 0.2, (1, 2) + fine)).astype(np.float32)
    jprev = prev if warm else np.zeros_like(prev)
    want = jmodel({"images": images,
                   "prev_preds": {"flow_small": jnp.asarray(jprev)}})
    inputs = {"images": torch.from_numpy(images)}
    if warm:
        inputs["prev_preds"] = {"flow_small": torch.from_numpy(prev)}
    got = tmodel(inputs)
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flow_small"].shape == (1, 2) + fine
    assert all(v.grad_fn is None for v in got.values())
    assert_flows_match(got, want)
    np.testing.assert_allclose(nhwc(got["flow_small"]),
                               np.asarray(want["flow_small"]), atol=5e-3)
    assert np.abs(np.asarray(want["flows"])).max() > 1.0
    if warm and levels is None:
        cold = tmodel({"images": torch.from_numpy(images)})
        assert (cold["flows"] - got["flows"]).abs().max() > 0.5


def test_state_dict_matches_jax_params():
    """The port's keys are the JAX tree's, ``up_gru`` a transposed
    convolution, the residual shortcut under ``downsample.0``."""
    jmodel = ptlflow_tpu.get_model_reference("dpflow")()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model("dpflow", device="cpu")
    keys = set(tmodel.state_dict())
    assert keys == jax_state_keys(shapes)
    assert "fnet.stem.layer2.0.downsample.0.weight" in keys
    assert isinstance(tmodel.fnet.up_gru, tnn.CastConvTranspose2d)
    assert tmodel.update_block.flow_head.conv2.out_channels == 6
    assert tmodel.output_stride == 32
    assert ptlflow_tpu_torch.get_model_reference("dpflow")(
        pyramid_levels=4).output_stride == 64
