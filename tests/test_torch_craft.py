"""The PyTorch port's CRAFT against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``: the
sliding positional biases, zero at init, drawn uniform in +-0.1 as every
other non-convolution leaf; the input-skip coefficients too), and the flow
head's last convolution is damped by 0.1 (``build``), as
``tests/test_torch_train.py`` does for RAFT: random GRU steps are chaotic.
``state_dict_from_jax`` carries the weights into the port, whose tied
``query``/``key`` layer it writes under both names; the port loads them
with ``strict=True``.  Inputs come from numpy seeds; the port is NCHW, the
JAX package NHWC.

The JAX blocks and models are jitted; the JAX model's eval forward is
always given a ``prev_preds`` (a zero ``flow_small`` for a cold forward,
whose forward projection is exactly 0), so cold and warm forwards share
one compilation.
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
from tests.test_torch_train import nchw, nhwc, random_params

jst = importlib.import_module("ptlflow_tpu.models.craft.setrans")
tst = importlib.import_module("ptlflow_tpu_torch.models.craft.setrans")
jcr = importlib.import_module("ptlflow_tpu.models.craft.craft")
tcr = importlib.import_module("ptlflow_tpu_torch.models.craft.craft")

H, W = 64, 96
ITERS = 2


def carry(jmod, tmod, seed, scale=None):
    """``random_params`` for the JAX module ``jmod`` (every leaf named in
    ``scale`` multiplied by its factor), loaded into the port's ``tmod``.
    Returns the JAX params."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    for path, factor in (scale or {}).items():
        node = params
        *heads, leaf = path.split(".")
        for h in heads:
            node = node[h]
        node[leaf] = node[leaf] * factor
    tmod.load_state_dict(state_dict_from_jax(params, tmod), strict=True)
    tmod.eval()
    return jax.tree_util.tree_map(jnp.asarray, params)


def build(seed, **args):
    """(JAX ``craft`` with seeded weights, the port's on the CPU with the
    same weights, numpy params); the flow head damped by 0.1."""
    jmodel = ptlflow_tpu.get_model_reference("craft")(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    head = params["update_block"]["flow_head"]["conv2"]
    for leaf in ("weight", "bias"):
        head[leaf] = head[leaf] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model("craft", args=args, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


@pytest.fixture(scope="module")
def cr():
    return build(170, iters=ITERS)


def config(**kw):
    base = dict(in_feat_dim=32, feat_dim=32, num_modes=4, has_FFN=False,
                pos_bias_radius=2)
    base.update(kw)
    return base


# ---------------------------------------------------------------- blocks
def test_sliding_pos_biases_match_jax():
    """Drawn biases (zero at init) over a 5x7 map at radius 2: within 1e-6
    of the JAX package's one-hot contraction, zero outside the window."""
    jmod, tmod = jst.SlidingPosBiases2D(2, 2), tst.SlidingPosBiases2D(2, 2)
    params = carry(jmod, tmod, 171)
    assert np.abs(np.asarray(params["biases"])).min() > 0
    want = np.asarray(jmod(params, 5, 7))
    with torch.no_grad():
        got = tmod(5, 7).numpy()
    assert got.shape == (1, 1, 35, 35)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # (0, 0) against (4, 6): both offsets beyond the radius
    assert got[0, 0, 0, 34] == 0.0
    assert got[0, 0, 0, 8] == np.asarray(params["biases"])[3, 3]


@pytest.mark.parametrize("tied", [True, False])
def test_cross_attention_matches_jax(tied):
    """Multi-mode cross attention, tied or untied query/key, the query
    and key weights scaled by 30 so that the scores reach the +-100 clip: the
    aggregated scores of 30 tokens against 35 (the inter-frame
    configuration) and the attended values with the input skip of 30
    against 30 (the f2 configuration, whose skip adds the key tokens),
    within 1e-4 of the JAX package's."""
    rng = np.random.RandomState(172)
    q = rng.randn(2, 30, 32).astype(np.float32)
    k = rng.randn(2, 35, 32).astype(np.float32)
    pos = rng.randn(1, 1, 30, 35).astype(np.float32)
    for extra in (dict(out_attn_scores_only=True), dict(has_input_skip=True)):
        if extra.get("has_input_skip"):
            k, pos = k[:, :30], pos[..., :30]
        cfg = config(tie_qk_scheme="shared" if tied else None,
                     qk_have_bias=tied, pos_code_weight=0.5, **extra)
        jmod = jst.CrossAttFeatTrans(jst.SETransConfig(**cfg))
        tmod = tst.CrossAttFeatTrans(tst.SETransConfig(**cfg))
        scale = {f"{n}.weight": 30.0 for n in
                 (("query",) if tied else ("query", "key"))}
        params = carry(jmod, tmod, 173, scale)
        assert (tmod.key is tmod.query) == tied
        want = np.asarray(jax.jit(jmod)(params, jnp.asarray(q),
                                        jnp.asarray(k), jnp.asarray(pos)))
        with torch.no_grad():
            got = tmod(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(pos))
            scores = torch.matmul(
                tmod._split_modes(tmod.query(torch.from_numpy(q))),
                tmod._split_modes(tmod.key(torch.from_numpy(k))
                                  ).transpose(-1, -2)) / np.sqrt(8.0)
        assert scores.abs().max() > 100.0  # the clip bites
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("mask_radius", [-1, 2])
def test_self_attention_matches_jax(mask_radius):
    """The f2 transformer's configuration on a 32-channel 5x6 map (input
    skip, positional biases at radius 2), with CRAFT's default no mask or
    ``attn_mask_radius`` 2: within 1e-4 of the JAX package's."""
    cfg = config(tie_qk_scheme=None, pos_code_weight=0.5, has_input_skip=True,
                 attn_mask_radius=mask_radius)
    jmod = jst.SelfAttVisPosTrans(jst.SETransConfig(**cfg))
    tmod = tst.SelfAttVisPosTrans(tst.SETransConfig(**cfg))
    params = carry(jmod, tmod, 186)
    x = np.random.RandomState(186).randn(2, 5, 6, 32).astype(np.float32)
    want = np.asarray(jax.jit(jmod)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(nchw(x))
    assert got.shape == (2, 32, 5, 6)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-4)


def test_expanded_feat_trans_matches_jax():
    """The motion aggregator's configuration (input skip, LayerNorm eps
    1e-12 without affine) over 4 modes of a random attention: within 1e-4
    of the JAX package's."""
    cfg = config(has_input_skip=True)
    jmod = jst.ExpandedFeatTrans(jst.SETransConfig(**cfg))
    tmod = tst.ExpandedFeatTrans(tst.SETransConfig(**cfg))
    params = carry(jmod, tmod, 174)
    assert np.abs(np.asarray(params["input_skip_coeff"])).min() > 0
    rng = np.random.RandomState(174)
    x = rng.randn(2, 24, 32).astype(np.float32)
    attn = random_attention(rng, 2, 4, 24)
    want = np.asarray(jax.jit(jmod)(params, jnp.asarray(x),
                                    jnp.asarray(attn)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(attn))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_trans_corr_pyramid_matches_jax():
    """The inter-frame attention's pyramid over two 256-channel 8x12 maps:
    4 levels (8x12 ... 1x1), each map normalised over the whole volume by
    its mean and population variance, within 1e-4 of the JAX package's."""
    cfg = dict(in_feat_dim=256, feat_dim=256, num_modes=4,
               tie_qk_scheme="shared", qk_have_bias=True,
               pos_code_weight=0.5, out_attn_scores_only=True, has_FFN=False)
    jmod = jcr.TransCorrBlock(jst.SETransConfig(**cfg))
    tmod = tcr.TransCorrBlock(tst.SETransConfig(**cfg))
    params = carry(jmod, tmod, 175)
    rng = np.random.RandomState(175)
    f1, f2 = (rng.randn(1, 8, 12, 256).astype(np.float32) for _ in range(2))
    want = jax.jit(jmod.build_pyramid)(params, jnp.asarray(f1),
                                       jnp.asarray(f2))
    with torch.no_grad():
        got = tmod.build_pyramid(nchw(f1), nchw(f2))
    assert [tuple(g.shape) for g in got] == [(96, 8, 12), (96, 4, 6),
                                             (96, 2, 3), (96, 1, 1)]
    lvl0 = got[0].double()
    assert abs(lvl0.mean().item()) < 1e-5
    assert abs(lvl0.var(correction=0).item() - 1) < 1e-4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[..., 0],
                                   atol=1e-4)


def test_update_block_matches_jax():
    cfg = dict(in_feat_dim=128, feat_dim=128, num_modes=4, has_FFN=False,
               has_input_skip=True)
    jblk = jcr.GMAUpdateBlock(4, 1, 4, jst.SETransConfig(**cfg))
    tblk = tcr.GMAUpdateBlock(4, 1, 4, tst.SETransConfig(**cfg))
    params = carry(jblk, tblk, 176)
    rng = np.random.RandomState(176)
    args = [rng.randn(2, 6, 8, c).astype(np.float32)
            for c in (128, 128, 324, 2)]  # net, inp, corr, flow
    attn = random_attention(rng, 2, 4, 48)
    want = jax.jit(jblk)(params, *map(jnp.asarray, args), jnp.asarray(attn))
    with torch.no_grad():
        got = tblk(*map(nchw, args), torch.from_numpy(attn))
    for g, w in zip(got, want):  # net, mask, delta_flow
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


# ----------------------------------------------------------- full model
@pytest.mark.parametrize("warm", [False, True])
def test_eval_forward_matches_jax(cr, warm):
    """2 iterations at 64x96, cold or warm-started from a ``flow_small``:
    flows and ``flow_small`` within 5e-3 px of the JAX package's, no
    autograd graph, and the warm start moves the flow."""
    jmodel, tmodel, _ = cr
    images = np.random.RandomState(177).rand(1, 2, 3, H, W).astype(
        np.float32)
    prev = (2.0 + np.random.RandomState(178).uniform(
        -0.2, 0.2, (1, 2, H // 8, W // 8))).astype(np.float32)
    jprev = prev if warm else np.zeros_like(prev)
    want = jmodel({"images": images,
                   "prev_preds": {"flow_small": jnp.asarray(jprev)}})
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


# -------------------------------------------------- weights and names
def test_tied_query_key_in_the_state_dict(tmp_path):
    """The inter-frame transformer's tied layer: one Parameter under both
    reference names, counted once by ``parameters()`` as the JAX tree
    stores it once; a converted JAX tree loads strictly with ``key.*``
    written from ``query.*``, through a checkpoint too; the trainable count
    is the JAX package's."""
    jmodel = jcr.CRAFT(iters=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    assert "key" not in shapes["corr_fn"]["setrans"]
    model = ptlflow_tpu_torch.get_model("craft", args={"iters": 1},
                                        device="cpu")
    st = model.corr_fn.setrans
    assert st.key.weight is st.query.weight
    sd = model.state_dict()
    for leaf in ("weight", "bias"):
        assert f"corr_fn.setrans.key.{leaf}" in sd
    n_jax = sum(int(np.prod(v.shape))
                for v in jax.tree_util.tree_leaves(shapes))
    n_bn = sum(v.numel() for k, v in sd.items()
               if k.endswith(("running_mean", "running_var")))
    assert sum(p.numel() for p in model.parameters()) == n_jax - n_bn
    state = state_dict_from_jax(
        random_params(shapes, np.random.RandomState(179)), model)
    torch.testing.assert_close(state["corr_fn.setrans.key.weight"],
                               state["corr_fn.setrans.query.weight"])
    path = tmp_path / "craft.ckpt"
    torch.save({"state_dict": state, "hyper_parameters": {}}, path)
    loaded = ptlflow_tpu_torch.get_model("craft", ckpt_path=str(path),
                                         device="cpu")
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0, msg=k)
    assert not loaded.corr_fn.vispos_encoder.pos_coder.biases.eq(0).any()
