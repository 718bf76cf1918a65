"""The PyTorch port's FlowFormer and FlowFormer++ against the JAX package's,
on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``; the latent
tokens standard normal, as the JAX package draws them) and are conditioned
by ``condition``: random Twins features give cost maps of ~1700, and fed
straight into the decoder's motion encoder such values turn fp32 rounding
into 1.8e-3 px of flow difference at 1/8 resolution after 2 decoder steps
(0.021 px upsampled) between two correct implementations.  Scaled by 0.1,
the same model agrees to 5e-5 px.  ``state_dict_from_jax`` carries the
weights into the port, given the port's module, so that the reference's
names come back (``ffn.3.``, ``decoder_layer.cross_attend.``) and GMA's
``rel_ind`` is added; the port loads them with ``strict=True``.

The JAX models run their ``_predict`` (encoders and decoder) jitted once per
model, and everything around it (padding, tiles) eagerly: an eager first
call of a whole FlowFormer compiles op by op for ~50 s.  A cold forward
passes a zero ``prev_flow``, whose forward projection is exactly 0, so the
cold, warm-started and tiled forwards share one compilation.
``tests/test_torch_flowformer_pp.py`` (FlowFormer++ and the bf16 weight
cast) and ``tests/test_torch_flowformer_train.py`` (the training step)
compile JAX models of their own, so each file stays well inside a
minute in the tier-1 run.
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
from ptlflow_tpu.models.flowformer import twins_tpu as jtwins
from ptlflow_tpu_torch.models.flowformer import twins as ttwins
from ptlflow_tpu_torch.scripts import validate as tvalidate
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_train import carry_random, nchw, nhwc, random_params

# the modules, not the classes that the packages re-export under their names
jff = importlib.import_module("ptlflow_tpu.models.flowformer.flowformer")
tff = importlib.import_module("ptlflow_tpu_torch.models.flowformer.flowformer")

H, W = 64, 96
DEPTH = 2  # decoder steps


def latent_normal(params, rng):
    """The latent tokens standard normal, as the JAX package draws them."""
    cpe = params["memory_encoder"]["cost_perceiver_encoder"]
    cpe["latent_tokens"] = rng.randn(*cpe["latent_tokens"].shape).astype(
        np.float32)


def condition(params, scale=0.1):
    """The matching features' Twins stage 2 scaled by ``scale`` (its patch
    norm, every residual branch's last layer and the positional conv's
    bias: the stage's LayerNorms make the rest scale-free), so the cost
    maps shrink by scale^2; the flow head's last conv damped by 0.1."""
    svt = params["memory_encoder"]["feat_encoder"]["svt"]
    branches = [svt["patch_embeds"]["1"]["norm"]]
    for blk in svt["blocks"]["1"].values():
        branches += [blk["attn"]["proj"], blk["mlp"]["fc2"]]
    for leaves in branches:
        for k in leaves:
            leaves[k] = leaves[k] * scale
    pos = svt["pos_block"]["1"]["proj"]["0"]
    pos["bias"] = pos["bias"] * scale
    head = params["memory_decoder"]["update_block"]["flow_head"]["conv2"]
    head["weight"] = head["weight"] * 0.1
    head["bias"] = head["bias"] * 0.1


def jitted_predict(jmodel):
    """``jmodel._predict`` for the eval path, jitted once: a missing
    ``prev_flow`` becomes zeros, which forward-project to exactly 0."""
    core = jax.jit(lambda p, a, b, prev: type(jmodel)._predict(
        jmodel, p, a, b, prev))

    def predict(params, image1, image2, prev_flow=None, training=False):
        assert not training
        if prev_flow is None:
            b, h, w, _ = image1.shape
            prev_flow = jnp.zeros((b, h // 8, w // 8, 2), image1.dtype)
        return core(params, image1, image2, prev_flow)

    jmodel._predict = predict
    return jmodel


def build(name, seed, jit_eval=True, **args):
    """(JAX model with conditioned seeded weights, its eval core jitted
    where ``jit_eval``; port model on the CPU with the same weights; numpy
    params).  Call the JAX model's ``forward`` (eager around the jitted
    core), not the model itself, which jits the whole forward anew for
    every input shape."""
    args = dict(decoder_depth=DEPTH, **args)
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = random_params(shapes, rng)
    latent_normal(params, rng)
    condition(params)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args)
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jitted_predict(jmodel) if jit_eval else jmodel, tmodel, params


@pytest.fixture(scope="module")
def ff():
    return build("flowformer", 90)


def images_of(seed, b=2, h=H, w=W):
    return np.random.RandomState(seed).rand(b, 2, 3, h, w).astype(np.float32)


# ----------------------------------------------------------------- twins
@pytest.mark.parametrize("ws,sr", [(7, 1), (1, 4)])
def test_twins_block_matches_jax(ws, sr):
    """A Twins block on a 9x11 map: locally-grouped attention in 7x7
    windows of the zero-padded 14x14 map, or global attention against the
    map sub-sampled by a 4x4 stride-4 convolution (2x2), within 1e-4."""
    jblk = jtwins.Block(64, 4, 4.0, sr_ratio=sr, ws=ws)
    tblk = ttwins.Block(64, 4, 4.0, sr_ratio=sr, ws=ws)
    params = carry_random(jblk, tblk, 92 + ws)
    x = np.random.RandomState(92).randn(2, 99, 64).astype(np.float32)
    want = jax.jit(lambda p, t: jblk(p, t, (9, 11)))(params, jnp.asarray(x))
    with torch.no_grad():
        got = tblk(torch.from_numpy(x), (9, 11))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_twins_backbone_matches_jax():
    """Both stages of twins_svt_large at 64x96: (B, 256, 8, 12), within
    1e-4 of the JAX package's NHWC output."""
    jenc, tenc = jtwins.twins_svt_large(), ttwins.twins_svt_large()
    params = carry_random(jenc, tenc, 93)
    x = np.random.RandomState(93).rand(2, H, W, 3).astype(np.float32)
    want = jax.jit(jenc)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tenc(nchw(x))
    assert got.shape == (2, 256, 8, 12)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4)


# --------------------------------------------------------- cost encoder
def test_cost_patch_embed_matches_jax():
    """13x19 cost maps zero-padded to 16x24, embedded to 2x3 tokens of 128
    channels, within 1e-4."""
    jemb, temb = jff.CostPatchEmbed(), tff.CostPatchEmbed()
    params = carry_random(jemb, temb, 94)
    x = 3 * np.random.RandomState(94).randn(5, 13, 19, 1).astype(np.float32)
    want, want_size = jax.jit(jemb)(params, jnp.asarray(x))
    with torch.no_grad():
        got, size = temb(nchw(x))
    assert size == tuple(want_size) == (2, 3) and got.shape == (5, 6, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_context_is_tiled_over_the_whole_batch():
    """Sequence j of the vertical layers reads image j mod B's context
    (``jnp.tile``, the reference's ``repeat``), not image j // K's."""
    proj = torch.nn.Linear(256, 4)
    ctx = torch.randn(2, 256, 3, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tok = tff.context_tokens(proj, ctx, 6)
        per_image = proj(ctx.flatten(2).transpose(1, 2))
    for j in range(6):
        torch.testing.assert_close(tok[j], per_image[j % 2], rtol=0, atol=0)


def test_cost_perceiver_encoder_matches_jax():
    """Batch 2 of 9x10 pixels (windows and sub-sampling both pad), 2
    layers of token self-attention and vertical attention with context:
    the cost memory within 1e-4.  Batch 2 pins the context tiling: each
    image's latent tokens also read the other image's context."""
    cfg = dict(patch_size=8, cost_latent_input_dim=64, pe="linear",
               encoder_depth=2, cost_latent_dim=128, dropout=0.0,
               vert_c_dim=64, cost_heads_num=1, cost_latent_token_num=8,
               cost_encoder_res=True)
    jenc, tenc = jff.CostPerceiverEncoder(**cfg), tff.CostPerceiverEncoder(
        **cfg)
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(95)
    params = random_params(shapes, rng)
    params["latent_tokens"] = rng.randn(*shapes["latent_tokens"].shape
                                        ).astype(np.float32)
    tenc.load_state_dict(state_dict_from_jax(params, tenc), strict=True)
    b, h1, w1 = 2, 9, 10
    cost = 3 * rng.randn(b, 1, h1, w1, h1, w1).astype(np.float32)
    ctx = rng.randn(b, h1, w1, 256).astype(np.float32)

    def run(p, c, x):
        return jenc(p, c, {}, x)

    want = jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, params),
                        jnp.asarray(cost), jnp.asarray(ctx))
    maps = torch.from_numpy(cost.reshape(b * h1 * w1, 1, h1, w1))
    with torch.no_grad():
        got = tenc(maps, (h1, w1), nchw(ctx))
        alone = tenc(maps[:h1 * w1], (h1, w1), nchw(ctx[:1]))
    assert got.shape == (b * h1 * w1, 8, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # run alone, image 0's tokens no longer see image 1's context
    assert (alone - got[:h1 * w1]).abs().max() > 1e-3


@pytest.mark.parametrize("training", [False, True])
def test_memory_decoder_matches_jax(training):
    """3 decoder steps over batch 2 of 6x8 pixels, from the same memory,
    context and cost maps: every step's upsampled flow in training, the
    last and the low-resolution flow in eval, within 1e-4 (the flow head
    damped by 0.1, as ``condition`` does)."""
    jdec = jff.MemoryDecoder(64, 1, 3, True, False, 8, 128, True, 0.0)
    tdec = tff.MemoryDecoder(64, 1, 3, 128)
    shapes = jax.eval_shape(jdec.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(96)
    params = random_params(shapes, rng)
    head = params["update_block"]["flow_head"]["conv2"]
    head["weight"] = head["weight"] * 0.1
    head["bias"] = head["bias"] * 0.1
    tdec.load_state_dict(state_dict_from_jax(params, tdec), strict=True)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    b, h1, w1 = 2, 6, 8
    memory = rng.randn(b * h1 * w1, 8, 128).astype(np.float32)
    ctx = rng.randn(b, h1, w1, 256).astype(np.float32)
    maps = rng.randn(b * h1 * w1, h1, w1, 1).astype(np.float32)

    def run(p, m, c, cm):
        return jdec(p, m, c, {"cost_maps": cm}, training=training)

    want, want_small = jax.jit(run)(params, *map(jnp.asarray,
                                                 (memory, ctx, maps)))
    with torch.set_grad_enabled(training):
        got, small = tdec(torch.from_numpy(memory), nchw(ctx),
                          nchw(maps), training=training)
    assert got.shape == ((3 if training else 1), b, 2, 8 * h1, 8 * w1)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(nhwc(small), np.asarray(want_small),
                               atol=1e-4)


# ----------------------------------------------------------- full models
def check_eval_forward(built):
    """Batch 2 at 64x96, 2 decoder steps: flows and flow_small within 5e-3
    px, with no autograd graph."""
    jmodel, tmodel, _ = built
    images = images_of(97)
    want = jmodel.forward(jmodel.params, {"images": images})
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (2, 1, 2, H, W)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)


def test_eval_forward_matches_jax(ff):
    check_eval_forward(ff)


def test_warm_start_matches_jax(ff):
    """``prev_preds["flow_small"]`` forward-projected into the coords:
    within 5e-3 px of the JAX package's, and the warm start moves the
    flow."""
    jmodel, tmodel, _ = ff
    rng = np.random.RandomState(98)
    images = images_of(98)
    prev = (2.0 + rng.uniform(-0.2, 0.2, (2, 2, 8, 12))).astype(np.float32)
    want = jmodel.forward(jmodel.params, {
        "images": images, "prev_preds": {"flow_small": jnp.asarray(prev)}})
    got = tmodel({"images": torch.from_numpy(images),
                  "prev_preds": {"flow_small": torch.from_numpy(prev)}})
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)
    cold = tmodel({"images": torch.from_numpy(images)})
    assert (cold["flows"] - got["flows"]).abs().max() > 0.1


def test_tiled_forward_matches_jax(ff):
    """``train_size`` (64, 96) and ``tile_height`` 64 over a 56x192 input:
    8 rows of -1 padding below, 3 tiles across at x = 0, 76, 96 (the last
    flush with the edge), blended by the Gaussian weights: within 5e-3 px,
    one forward per tile."""
    jmodel, tmodel, _ = ff
    for m in (jmodel, tmodel):
        m.train_size, m.tile_height = (64, 96), 64
    try:
        assert tff.compute_grid_indices((64, 192), (64, 96)) == [
            (0, 0), (0, 76), (0, 96)]
        images = images_of(99, h=56, w=192)
        want = jmodel.forward(jmodel.params, {"images": images})
        calls = []
        predict = tmodel._predict
        tmodel._predict = lambda *a, **k: calls.append(1) or predict(*a, **k)
        got = tmodel({"images": torch.from_numpy(images)})
    finally:
        for m in (jmodel, tmodel):
            m.train_size, m.tile_height = None, 432
        del tmodel._predict
    assert len(calls) == 3 and set(got) == {"flows"}
    assert got["flows"].shape == (2, 1, 2, 56, 192)
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)


def test_tile_weights_match_jax():
    """The blending weights, float64 pre-normalised, equal the JAX
    package's bit for bit, and sum to 1 over the tiles everywhere."""
    hws = tff.compute_grid_indices((100, 230), (48, 64))
    assert hws == jff.compute_grid_indices((100, 230), (48, 64))
    got = tff.compute_weight(hws, (100, 230), (48, 64), 0.05)
    np.testing.assert_array_equal(
        got, jff.compute_weight(hws, (100, 230), (48, 64), 0.05))
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-6)


# ---------------------------------------------------- the bf16 weight cast
def test_bf16_cast_refuses_what_the_list_lacks(capsys):
    """A model the allow-list lacks stays float32, with the JAX package's
    notice."""
    model = torch.nn.Linear(2, 2)
    assert not tvalidate.cast_to_bf16(model, "not_a_listed_model")
    assert "not on the bf16 allow-list" in capsys.readouterr().out
    assert model.weight.dtype == torch.float32
    assert tvalidate.has_mixed_mode(
        ptlflow_tpu_torch.get_model_reference("raft"))
    assert not tvalidate.has_mixed_mode(
        ptlflow_tpu_torch.get_model_reference("flowformer"))


# -------------------------------------------------- weights and names
def check_reference_names(name, built):
    """The port's keys are the reference's: the JAX tree's with its two
    renames undone (``ffn.2.`` -> ``ffn.3.``,
    ``decoder_layer_cross_attend.`` -> ``decoder_layer.cross_attend.``),
    plus GMA's ``rel_ind``; ``svt.``, the unused 1024-wide Twins norm,
    ``latent_tokens`` (untransposed) and FlowFormer++'s ``pretrain_head``
    are there.  ``state_dict_from_jax`` into the port (as ``build`` loaded
    it) and the JAX ``from_torch`` of the port's ``state_dict`` both load
    strictly."""
    jmodel, tmodel, params = built
    keys = set(tmodel.state_dict())
    ref = {k.replace("decoder_layer_cross_attend.",
                     "decoder_layer.cross_attend.").replace("ffn.2.", "ffn.3.")
           for k in jax_state_keys(params)}
    assert keys == ref | {"memory_decoder.att.pos_emb.rel_ind"}
    assert set(state_dict_from_jax(params, tmodel)) == keys
    assert "context_encoder.svt.norm.weight" in keys
    assert "memory_decoder.decoder_layer.cross_attend.ffn.3.weight" in keys
    assert ("memory_decoder.pretrain_head.4.weight" in keys) == (
        name == "flowformer_pp")
    assert ("memory_encoder.channel_convertor.weight" in keys) == (
        name == "flowformer")
    jmodel.from_torch({k: v.numpy() for k, v in tmodel.state_dict().items()},
                      strict=True)
    latent = params["memory_encoder"]["cost_perceiver_encoder"][
        "latent_tokens"]
    assert latent.shape == (1, 8, 128)
    np.testing.assert_array_equal(
        tmodel.memory_encoder.cost_perceiver_encoder.latent_tokens.detach()
        .numpy(), latent)


def test_state_dict_names_are_the_references(ff):
    check_reference_names("flowformer", ff)


def test_latent_tokens_are_seeded_normal():
    """``init_params`` draws the latent tokens standard normal from its
    seed, as the JAX package's init does."""
    model = ptlflow_tpu_torch.get_model_reference("flowformer")(
        decoder_depth=1)
    a = model.init_params(3).memory_encoder.cost_perceiver_encoder\
        .latent_tokens.clone()
    b = model.init_params(3).memory_encoder.cost_perceiver_encoder\
        .latent_tokens
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0.5 < a.std().item() < 1.5
