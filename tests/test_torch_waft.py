"""The PyTorch port's WAFT (``waft_twins_a2``, ``waft_dav2_a2``,
``waft_dav2_a1``; ``waft_dinov3_a2`` raises, as in JAX) and its new ops
(the border ``grid_sample``, ``interpolate_bicubic``) against the JAX
package's, on the CPU.

The ViTs run at a small configuration (``small_vits``: width 96, 2 heads,
4 blocks all tapped, DPT widths 24-192), set in both packages' config
tables for the module's tests, and the Twins backbone's third stage keeps 2
of its 18 blocks (``shallow_twins``), in both packages' models; widths are
the registered ones.  JAX parameter trees get seeded numpy weights (``random_params``:
LayerScales in [0.1, 1]) and are conditioned (``condition``): random ViT
and DPT stacks amplify their inputs by 10-100 a head, and the refine loop
feeds the flow back, so the feature heads' last convolutions are damped to
maps of unit size and the flow head to steps of a few pixels.
``state_dict_from_jax`` carries the weights into the port, which loads
them with ``strict=True``.  Inputs come from numpy seeds; the port is
NCHW, the JAX package NHWC.
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
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_train import carry_random, nchw, nhwc, random_params

jgs = importlib.import_module("ptlflow_tpu.ops.grid_sample")
tgs = importlib.import_module("ptlflow_tpu_torch.ops.grid_sample")
jbb = importlib.import_module("ptlflow_tpu.models.waft.backbones")
tbb = importlib.import_module("ptlflow_tpu_torch.models.waft.backbones")
jdino = importlib.import_module("ptlflow_tpu.models.waft.dinov2")
tdino = importlib.import_module("ptlflow_tpu_torch.models.waft.dinov2")
jdpt = importlib.import_module("ptlflow_tpu.models.waft.dpt")
tdpt = importlib.import_module("ptlflow_tpu_torch.models.waft.dpt")

SMALL_VIT = dict(features=32, out_channels=(24, 48, 96, 192), embed_dim=96,
                 depth=4, num_heads=2, idx=(0, 1, 2, 3))
# the frame sizes: a multiple of Twins' 64 and of DepthAnything's 112
SIZES = {"waft_twins_a2": (64, 96), "waft_dav2_a2": (112, 112),
         "waft_dav2_a1": (112, 112)}


@pytest.fixture(scope="module")
def small_vits():
    """The ``vits``/``vitb`` configurations of both packages' ViTs at
    ``SMALL_VIT`` while the module runs (the packages share nothing, so
    each table is set)."""
    saved = []
    for table in (jbb.VIT_CONFIGS, tbb.VIT_CONFIGS):
        for key in ("vits", "vitb"):
            saved.append((table, key, table[key]))
            table[key] = dict(SMALL_VIT)
    for cls in (jdino.DinoVisionTransformer, tdino.DinoVisionTransformer):
        for key in ("vits", "vitb"):
            saved.append((cls.CONFIGS, key, cls.CONFIGS[key]))
            cls.CONFIGS[key] = {k: SMALL_VIT[k] for k in
                                ("embed_dim", "depth", "num_heads")}
    yield
    for table, key, value in saved:
        table[key] = value


def damp(module_params, factor):
    for leaf in ("weight", "bias"):
        if leaf in module_params:
            module_params[leaf] = module_params[leaf] * factor


def condition(params):
    """Damp a WAFT tree: each feature head's last conv to maps of unit
    size, the refine network's output conv by 0.01 and the hidden state's
    update by 0.5 (the loop then keeps the state's size) and the flow
    head's last conv by 0.01."""
    enc = params.get("encoder", {})
    if "final" in enc:  # Twins
        damp(enc["final"], 1e-3)
    if "dpt_head" in enc:  # DepthAnything a2
        damp(enc["dpt_head"]["refine"]["0"]["out_conv"], 1e-2)
    if "da_feature" in params:  # DepthAnything a1
        damp(params["da_feature"]["depth_anything"]["depth_head"]["scratch"]
             ["output_conv1"], 1e-2)
    damp(params["refine_net"]["dpt_head"]["scratch"]["output_conv1"], 0.01)
    damp(params["refine_transform"], 0.5)
    damp(params["flow_head"]["2"], 0.01)


TWINS_STAGE3 = 2


def shallow_twins(jmodel, tmodel):
    """Keep the first ``TWINS_STAGE3`` blocks of the Twins backbone's third
    stage in the JAX model and the port's (a no-op without Twins)."""
    if not hasattr(tmodel, "encoder") or not hasattr(tmodel.encoder,
                                                     "backbone"):
        return
    jblocks = jmodel.encoder.backbone.blocks
    kept = jnn.ModuleList(list(jblocks[2])[:TWINS_STAGE3])
    setattr(jblocks, "2", kept)
    jblocks.mods[2] = kept
    tblocks = tmodel.encoder.backbone.blocks
    tblocks[2] = torch.nn.ModuleList(list(tblocks[2])[:TWINS_STAGE3])


def build(name, seed, **args):
    """(JAX ``name`` with seeded, conditioned weights, the port's on the
    CPU with the same weights, numpy params), the Twins backbone shallow.
    The port's model is built on the meta device, without its own random
    init, and takes its weights by a strict load."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    with torch.device("meta"):
        tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args)
    shallow_twins(jmodel, tmodel)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    condition(params)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = tmodel.to_empty(device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


def images_of(name, seed, b=1):
    h, w = SIZES[name]
    # an odd size: the padding to the model's stride counts
    return np.random.RandomState(seed).rand(b, 2, 3, h - 6, w - 10).astype(
        np.float32)


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize("padding_mode,align_corners,dtype", [
    ("zeros", False, np.float32), ("zeros", True, np.float32),
    ("border", False, np.float32), ("border", True, np.float32),
    ("border", True, jnp.bfloat16)])
def test_grid_sample_matches_jax(padding_mode, align_corners, dtype):
    """``grid_sample`` of a 7x9 map at normalised points up to 0.4 past
    the border on every side, zero and border padding, both corner
    conventions: within 1e-6 of the JAX package's.  A bfloat16 image is
    sampled in float32 and only the output rounded, in both packages: the
    same bfloat16 values."""
    rng = np.random.RandomState(10)
    img = rng.randn(2, 7, 9, 3).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 5, 6, 2)).astype(np.float32)
    jimg = jnp.asarray(img).astype(dtype)
    want = np.asarray(jax.jit(lambda i, g: jgs.grid_sample(
        i, g, padding_mode=padding_mode,
        align_corners=align_corners).astype(jnp.float32))(
            jimg, jnp.asarray(grid)))
    timg = torch.from_numpy(np.array(jimg.astype(jnp.float32)))
    if dtype is not np.float32:
        timg = timg.to(torch.bfloat16)
    got = tgs.grid_sample(timg.permute(0, 3, 1, 2), torch.from_numpy(grid),
                          padding_mode=padding_mode,
                          align_corners=align_corners)
    assert got.dtype == timg.dtype
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)


def test_border_grid_sample_clamps_to_the_edge():
    """Far past the map, border ``grid_sample`` reads the edge pixel
    (both corner conventions) and zero padding reads 0."""
    img = np.random.RandomState(11).randn(1, 6, 8, 4).astype(np.float32)
    far = torch.full((1, 1, 1, 2), 9.0)
    for align_corners in (False, True):
        edge = tgs.grid_sample(nchw(img), far, padding_mode="border",
                               align_corners=align_corners)
        np.testing.assert_array_equal(edge[0, :, 0, 0].numpy(),
                                      img[0, -1, -1])
        zero = tgs.grid_sample(nchw(img), far, align_corners=align_corners)
        np.testing.assert_array_equal(zero.numpy(), 0.0)


@pytest.mark.parametrize("size,scale", [
    (None, (0.5, 0.7)),  # floor(in * scale), odd sizes
    ((5, 6), ((5 + 0.1) / 37, (6 + 0.1) / 37)),  # DINOv2's 0.1 offset
    ((74, 74), (2.0, 2.0)),
    ((13, 9), (13 / 8, 9 / 8))])  # RefineViT's 8x8 embedding
def test_interpolate_bicubic_matches_jax(size, scale):
    """``interpolate_bicubic`` of a 37x37 map (8x8 for RefineViT's
    factors): the source positions follow the explicit scale even where
    ``size`` sets the output, the taps clamp at the edges; within 1e-4 of
    the JAX package's (jitted, XLA fuses the 16 taps' products into
    multiply-adds: 1.1e-5 apart at most on these unit-sized maps; eagerly
    the two agree bit for bit)."""
    n = 8 if scale[0] == 13 / 8 else 37
    x = np.random.RandomState(12).randn(1, n, n, 5).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jgs.interpolate_bicubic(
        v, scale, size))(jnp.asarray(x)))
    got = tgs.interpolate_bicubic(nchw(x), scale, size)
    assert nhwc(got).shape == want.shape
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


# --------------------------------------------------------------- blocks
def test_dinov2_taps_match_jax(small_vits):
    """DINOv2's tapped, normed tokens and cls tokens of a 70x98 image (5x7
    patches: the 37x37 position embedding resized with the 0.1 offset):
    within 1e-4 of the JAX package's."""
    jvit = jdino.DinoVisionTransformer("vits")
    tvit = tdino.DinoVisionTransformer("vits")
    params = carry_random(jvit, tvit, 20)
    x = np.random.RandomState(20).randn(1, 70, 98, 3).astype(np.float32)
    want = jax.jit(lambda p, v: jvit.get_intermediate_layers(
        p, v, (1, 3)))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tvit.get_intermediate_layers(nchw(x), (1, 3))
    assert len(got) == 2 and got[0][0].shape == (1, 35, 96)
    for (tt, tc), (jt, jc) in zip(got, want):
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)


@pytest.mark.parametrize("head", ["a1", "lvl"])
def test_dpt_heads_match_jax(head):
    """The DepthAnything head (fixed resize layers) and the ``lvl`` = -3
    head of four 4x6 token maps, each output within 1e-6 of its largest
    entry of the JAX package's (the random heads amplify their inputs to
    tens)."""
    if head == "a1":
        jmod = jdpt.DPTHeadA1(32, 16, (8, 16, 24, 24), patch_size=14)
        tmod = tdpt.DPTHeadA1(32, 16, (8, 16, 24, 24), patch_size=14)
    else:
        jmod = jdpt.DPTHeadLvl(32, 16, (8, 16, 24, 32), lvl=-3)
        tmod = tdpt.DPTHeadLvl(32, 16, (8, 16, 24, 32), lvl=-3)
    params = carry_random(jmod, tmod, 21)
    rng = np.random.RandomState(21)
    feats = [rng.randn(2, 24, 32).astype(np.float32) for _ in range(4)]
    want = jax.jit(lambda p, fs: jmod(p, [(f, None) for f in fs], 4, 6))(
        params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tmod([(torch.from_numpy(f), None) for f in feats], 4, 6)
    assert len(got) == len(want) == (5 if head == "a1" else 4)
    for t, j in zip(got, want):
        j = np.asarray(j)
        np.testing.assert_allclose(nhwc(t), j, atol=1e-6 * np.abs(j).max())


def test_twins_drops_the_classifier_on_load():
    """A timm checkpoint of the Twins backbone holds the classifier's
    ``norm``, ``head`` and ``head_drop``; a strict load drops them, as the
    JAX package's ``from_torch`` does, and refuses any other stray key."""
    enc = tbb.TwinsFeatureEncoder()
    sd = enc.state_dict()
    sd["backbone.norm.weight"] = torch.ones(1024)
    sd["backbone.head.weight"] = torch.zeros(1000, 1024)
    sd["backbone.head.bias"] = torch.zeros(1000)
    enc.load_state_dict(sd, strict=True)
    sd["backbone.other.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="other"):
        enc.load_state_dict(sd, strict=True)


# ----------------------------------------------------------- full models
def assert_eval_forward_matches(jmodel, tmodel, name, seed):
    """The refinements of a frame pair of an odd size (padded on both sides
    to /64 or /112): flows within 5e-3 px of the JAX package's, of a few
    pixels, and no autograd graph."""
    images = images_of(name, seed)
    want = np.asarray(jax.jit(lambda p, x: jmodel.forward(
        p, {"images": x})["flows"])(jmodel.params, jnp.asarray(images)))
    got = tmodel({"images": torch.from_numpy(images)})["flows"]
    assert got.shape == want.shape == (1, 1, 2) + images.shape[-2:]
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    assert 0.3 < np.abs(want).max() < 30


@pytest.mark.parametrize("name", ["waft_dav2_a2", "waft_dav2_a1"])
def test_eval_forward_matches_jax(small_vits, name):
    """``assert_eval_forward_matches`` of the DepthAnything variants, one
    refinement: their encoders are what differs from ``waft_twins_a2``,
    whose forward (in ``tests/test_torch_waft_twins.py``) runs the 2
    refinements that warp by a flow."""
    jmodel, tmodel, _ = build(name, 30, iters=1)
    assert_eval_forward_matches(jmodel, tmodel, name, 31)


@pytest.mark.parametrize("name", ["waft_twins_a2", "waft_dav2_a2",
                                  "waft_dav2_a1"])
def test_trainable_names_match_split_trainable(name):
    """The port trains exactly the tensors that the JAX package's
    ``split_trainable`` with the model's ``frozen_prefixes`` puts in its
    trainable tree: the Twins backbone, the DepthAnything encoder or the
    whole a1 DepthAnything branch are frozen, their heads (a2) are not."""
    jmodel = ptlflow_tpu.get_model_reference(name)(iters=1)
    with torch.device("meta"):  # names only: no weights drawn
        tmodel = ptlflow_tpu_torch.get_model_reference(name)(iters=1)
    frozen = {"waft_twins_a2": ("encoder.backbone",),
              "waft_dav2_a2": ("encoder.encoder",),
              "waft_dav2_a1": ("da_feature",)}[name]
    assert tuple(jmodel.frozen_prefixes) == tuple(tmodel.frozen_prefixes)
    assert tuple(tmodel.frozen_prefixes) == frozen
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jtrain, _ = jnn.split_trainable(shapes, jmodel.frozen_prefixes)
    want = set(jnn.flatten_params(jtrain))
    got, state = tnn.split_trainable(tmodel, tmodel.frozen_prefixes)
    assert set(got) == want
    assert not any(p.requires_grad for n, p in state.items()
                   if n.startswith(frozen))
    assert any(n.startswith(frozen) for n in state)


def test_dinov3_raises_as_in_jax():
    """``waft_dinov3_a2`` is registered and trainable, and its constructor
    raises: DINOv3's weights are gated."""
    assert "waft_dinov3_a2" in ptlflow_tpu_torch.get_trainable_model_names()
    with pytest.raises(NotImplementedError, match="DINOv3"):
        ptlflow_tpu.get_model_reference("waft_dinov3_a2")()
    with pytest.raises(NotImplementedError, match="DINOv3"):
        ptlflow_tpu_torch.get_model_reference("waft_dinov3_a2")()
