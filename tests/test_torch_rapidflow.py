"""The PyTorch port's RAPIDFlow against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``) and
``draw_factors``: NeXt1D's depthwise factors ``weight_h`` and ``weight_v``,
which the JAX package and the reference initialise to zero (a zero factor
tests nothing), drawn so that their product has a convolution's He-normal
scale, and every layer scale (``gamma``, ``layer_scale*``) in [0.1, 1].
``condition`` damps the flow head's last convolution by 0.1: with random
weights RAPIDFlow's steps reach ~340 px at 64x96 and one fp32 rounding of
the input moves the flow by 0.7 px; damped, the flows stay under ~60 px and
that rounding moves them by ~3e-4 px.  ``tests/test_torch_rpknet.py`` and
``tests/test_torch_dpflow.py`` draw their weights the same way
(``build``).  ``state_dict_from_jax`` carries the weights into the port,
which loads them with ``strict=True``.  Inputs come from numpy seeds; the
port is NCHW, the JAX package NHWC.

The JAX blocks and models are jitted; the JAX model's eval forward is
always given a ``prev_preds``: a cold forward gets zero ``flows``, whose
forward projection is exactly 0, so cold and warm-started forwards share
one compilation (the port's cold forward gets none).
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
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_train import nchw, nhwc, random_params

jnx = importlib.import_module("ptlflow_tpu.models.rapidflow.next1d")
tnx = importlib.import_module("ptlflow_tpu_torch.models.rapidflow.next1d")
jrf = importlib.import_module("ptlflow_tpu.models.rapidflow.rapidflow")
trf = importlib.import_module("ptlflow_tpu_torch.models.rapidflow.rapidflow")

H, W = 64, 96
HEAD_SCALE = 0.1


def draw_factors(params, rng):
    """In place: every NeXt1D factor (k x 1 or 1 x k) normal with std
    (2 / k^2)^(1/4), so that their product has std sqrt(2) / k, and every
    layer scale uniform in [0.1, 1]."""
    for k, v in params.items():
        if isinstance(v, dict):
            draw_factors(v, rng)
        elif k in ("weight_h", "weight_v"):
            size = max(v.shape[:2])
            params[k] = ((2.0 / size ** 2) ** 0.25
                         * rng.randn(*v.shape)).astype(np.float32)
        elif k == "gamma" or k.startswith("layer_scale"):
            params[k] = rng.uniform(0.1, 1.0, v.shape).astype(np.float32)


def seeded_params(jmod, seed):
    """``random_params`` and ``draw_factors`` for the JAX module ``jmod``,
    as a numpy tree."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = random_params(shapes, rng)
    draw_factors(params, rng)
    return params


def carry(jmod, tmod, seed):
    """Seeded weights for the JAX module ``jmod``, loaded into the port's
    ``tmod``.  Returns the JAX params."""
    params = seeded_params(jmod, seed)
    tmod.load_state_dict(state_dict_from_jax(params, tmod), strict=True)
    return jax.tree_util.tree_map(jnp.asarray, params)


def condition(params, scale=HEAD_SCALE):
    head = params["update_block"]["flow_head"]["conv2"]
    for leaf in ("weight", "bias"):
        head[leaf] = head[leaf] * scale


def build(name, seed, **args):
    """(JAX model with seeded, conditioned weights, the port's model on the
    CPU in eval mode with the same weights, numpy params)."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    params = seeded_params(jmodel, seed)
    condition(params)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args)
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel.eval(), params


def images_of(seed, b=1, h=H, w=W):
    return np.random.RandomState(seed).rand(b, 2, 3, h, w).astype(np.float32)


def assert_flows_match(got, want, key="flows"):
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               atol=5e-3)


# ---------------------------------------------------------------- blocks
@pytest.mark.parametrize("mode", ["factors", "fused", "factors bf16"])
def test_next1d_conv_matches_jax(mode):
    """The 7x7 depthwise NeXt1D convolution over 24 channels of a 13x17
    map: from its two drawn factors (the kernel their outer product), from
    a dense ``weight``, and from bf16 factors on an fp32 input (the product
    taken in bf16, then cast to the input's dtype, as the JAX source
    says): within 1e-4.  The bf16 case runs the JAX block eagerly: jitted
    on the CPU, XLA keeps the bf16 product in fp32 (its
    ``xla_allow_excess_precision``), which moves this output by 0.018."""
    fuse = mode == "fused"
    jconv = jnx.Next1dConv(24, 24, 7, padding=3, groups=24, fuse_weights=fuse)
    tconv = tnx.Next1dConv(24, 24, 7, padding=3, groups=24, fuse_weights=fuse)
    params = carry(jconv, tconv, 1)
    if mode == "factors bf16":
        params = jnn.cast_params(params, jnp.bfloat16)
        tconv.to(torch.bfloat16)
        assert tconv.kernel().dtype == torch.bfloat16
    x = np.random.RandomState(1).randn(2, 13, 17, 24).astype(np.float32)
    run = jconv if mode == "factors bf16" else jax.jit(jconv)
    want = np.asarray(run(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tconv(nchw(x))
    assert got.dtype == torch.float32
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_next1d_conv_gradient_reaches_both_factors():
    conv = tnx.Next1dConv(8, 8, 7, padding=3, groups=8)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        conv.weight_h.copy_(torch.randn(conv.weight_h.shape, generator=gen))
        conv.weight_v.copy_(torch.randn(conv.weight_v.shape, generator=gen))
    conv(torch.randn(1, 8, 9, 9, generator=gen)).square().sum().backward()
    assert conv.weight_h.grad.abs().min() > 0
    assert conv.weight_v.grad.abs().min() > 0


def test_next1d_encoder_matches_jax():
    """The recurrent encoder at a narrow width (stem stride 4, one shared
    stage of depth 1, levels 1/8 to 1/32): the three levels, coarsest
    first, within 1e-4."""
    kw = dict(max_pyr_range=(8, 32), stem_stride=4, num_recurrent_layers=4,
              hidden_chs=16, out_chs=24, depth=1)
    jenc = jnx.Next1dEncoder(**kw)
    tenc = tnx.Next1dEncoder(**kw)
    params = carry(jenc, tenc, 3)
    x = np.random.RandomState(3).randn(2, H, W, 3).astype(np.float32)
    want = jax.jit(jenc)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tenc(nchw(x))
    assert [tuple(g.shape) for g in got] == [(2, 24, 2, 3), (2, 24, 4, 6),
                                             (2, 24, 8, 12)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


def test_update_block_matches_jax():
    """The registered update block (81 correlation channels, net 64, input
    64, motion 128, decoder depth 2) on a 6x8 map: the flow's change, the
    new hidden state and the 8x mask within 1e-4."""
    kw = dict(pyramid_ranges=(32, 8), corr_levels=1, corr_range=4,
              dec_net_chs=64, dec_inp_chs=64, dec_motion_chs=128,
              dec_depth=2, dec_mlp_ratio=4.0, fuse_next1d_weights=False,
              use_upsample_mask=True)
    jblk = jrf.UpdateBlock(**kw)
    tblk = trf.UpdateBlock(**kw)
    params = carry(jblk, tblk, 4)
    rng = np.random.RandomState(4)
    args = [rng.randn(2, 6, 8, c).astype(np.float32)
            for c in (64, 64, 81, 2)]  # net, inp, corr, flow
    want = jax.jit(lambda p, *a: jblk(p, *a, get_mask=True))(
        params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tblk(*map(nchw, args), get_mask=True)
    assert got[2].shape == (2, 576, 6, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


# ----------------------------------------------------------- full models
@pytest.fixture(scope="module")
def models():
    return {name: build(name, seed, **args) for name, seed, args in (
        ("rapidflow", 5, {"iters": 6}), ("rapidflow_it1", 6, {}))}


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("name", ["rapidflow", "rapidflow_it1"])
def test_eval_forward_matches_jax(models, name, warm):
    """``rapidflow`` (3 levels, 2 steps a level) and ``rapidflow_it1`` (the
    1/32 level, one step, its 8x mask and a 4x bilinear resize) at 64x96:
    flows within 5e-3 px of the JAX package's, cold or warm-started from the
    previous pair's full-size ``prev_preds["flows"]``; no autograd graph,
    no ``flow_small``, and the warm start moves the flow."""
    jmodel, tmodel, _ = models[name]
    images = images_of(7)
    rng = np.random.RandomState(8)
    prev = (2.0 + rng.uniform(-0.2, 0.2, (1, 1, 2, H, W))).astype(np.float32)
    jprev = prev if warm else np.zeros_like(prev)
    want = jmodel({"images": images,
                   "prev_preds": {"flows": jnp.asarray(jprev)}})
    inputs = {"images": torch.from_numpy(images)}
    if warm:
        inputs["prev_preds"] = {"flows": torch.from_numpy(prev)}
    got = tmodel(inputs)
    assert set(got) == {"flows"}
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flows"].grad_fn is None
    assert_flows_match(got, want)
    assert np.abs(np.asarray(want["flows"])).max() > 1.0
    if warm:
        cold = tmodel({"images": torch.from_numpy(images)})
        assert (cold["flows"] - got["flows"]).abs().max() > 0.5


def test_training_forward_matches_jax(models):
    """``flow_preds`` of ``rapidflow`` (6 steps over 3 levels, the last
    level's through the convex mask) at 64x96, batch 2, within 5e-3 px;
    ``flows`` is the last."""
    jmodel, tmodel, _ = models["rapidflow"]
    images = images_of(9, b=2)
    want = jax.jit(lambda p, x: jmodel.forward(p, x, training=True))(
        jmodel.params, {"images": jnp.asarray(images)})
    got = tmodel({"images": torch.from_numpy(images)}, training=True)
    preds = got["flow_preds"]
    assert preds.shape == (6, 2, 2, H, W) and preds.requires_grad
    np.testing.assert_allclose(nhwc(preds), np.asarray(want["flow_preds"]),
                               atol=5e-3)
    torch.testing.assert_close(got["flows"], preds[-1][:, None], rtol=0,
                               atol=0)


# -------------------------------------------------- weights and names
@pytest.mark.parametrize("fuse", [False, True], ids=["factors", "fused"])
def test_state_dict_matches_jax_params(fuse):
    """The port's keys are the JAX tree's in both ``fuse_next1d_weights``
    modes (the factors or the dense kernel), a seeded JAX tree loads
    strictly, and the port's seeded init starts the factors at zero and
    the layer scales at 1, as the JAX package."""
    args = {"fuse_next1d_weights": fuse}
    jmodel = ptlflow_tpu.get_model_reference("rapidflow")(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model("rapidflow", args=args,
                                         device="cpu")
    assert set(tmodel.state_dict()) == jax_state_keys(shapes)
    other = ptlflow_tpu_torch.get_model_reference("rapidflow")(**args)
    carry(jmodel, other, 10)
    assert other.fnet.rec_stage.blocks[0].conv_dw.kernel().abs().max() > 0
    conv = tmodel.fnet.rec_stage.blocks[0].conv_dw
    names = ("weight",) if fuse else ("weight_h", "weight_v")
    for n in names:
        assert torch.all(getattr(conv, n) == 0)
    assert torch.all(tmodel.fnet.rec_stage.blocks[0].gamma == 1)
    assert tmodel.update_block.mask[2].out_channels == 576
