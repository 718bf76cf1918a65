"""The PyTorch port's RAFT against the JAX package's, on the CPU.

The JAX modules get random weights (norm statistics randomised too, so
BatchNorm is not the identity); ``state_dict_from_jax`` carries them into
the port, which must load them with ``strict=True``.  Inputs come from
numpy seeds; the port is NCHW, the JAX package NHWC.  The JAX blocks run
jitted (one compilation in place of one per primitive): XLA's fusions move
their outputs by float32 roundings, ~1e-6 of these unit-sized maps, far
inside the 1e-4 and 2e-3 tolerances.
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
from ptlflow_tpu.models.raft import extractor as jext
from ptlflow_tpu.models.raft import update as jupd
from ptlflow_tpu.nn.module import flatten_params
from ptlflow_tpu_torch.models.raft import extractor as text
from ptlflow_tpu_torch.models.raft import update as tupd
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_train import random_params


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def damp_flow_head(block_params, factor=0.1):
    """Scale the flow head's last conv so that random weights take steps of
    a few pixels, as trained ones do.  Undamped, random RAFT steps ~20-30 px
    and fp32 rounding in either package reaches the 1e-4 tolerance."""
    head = block_params["flow_head"]["conv2"]
    head["weight"] = head["weight"] * factor
    head["bias"] = head["bias"] * factor


def carry(jmod, tmod, seed, damp=False):
    """Seeded ``random_params`` for ``jmod`` (drawn in numpy from the JAX
    tree's shapes: the JAX init runs op by op, 2.5-9 s a block); the same
    weights loaded into ``tmod``.  Returns the JAX params."""
    params = random_params(jax.eval_shape(jmod.init, jax.random.PRNGKey(0)),
                           np.random.RandomState(seed))
    if damp:
        damp_flow_head(params)
    tmod.load_state_dict(state_dict_from_jax(params), strict=True)
    tmod.eval()
    return jax.tree_util.tree_map(jnp.asarray, params)


def jax_state_keys(params):
    """Flattened JAX names, plus the BatchNorm counters torch adds."""
    keys = set(flatten_params(params))
    keys |= {k[:-len("running_mean")] + "num_batches_tracked"
             for k in keys if k.endswith("running_mean")}
    return keys


# -------------------------------------------------------------- encoders
@pytest.mark.parametrize("norm_fn", ["instance", "batch", "none"])
def test_basic_encoder_matches_jax(norm_fn):
    jenc = jext.BasicEncoder(output_dim=64, norm_fn=norm_fn)
    tenc = text.BasicEncoder(output_dim=64, norm_fn=norm_fn)
    params = carry(jenc, tenc, 0)
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jenc(p, v))(params,
                                                       jnp.asarray(x)))
    with torch.no_grad():
        got = tenc(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, atol=2e-3)


def test_small_encoder_matches_jax():
    jenc = jext.SmallEncoder(output_dim=128, norm_fn="instance")
    tenc = text.SmallEncoder(output_dim=128, norm_fn="instance")
    params = carry(jenc, tenc, 1)
    x = np.random.RandomState(1).randn(1, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jenc(p, v))(params,
                                                       jnp.asarray(x)))
    with torch.no_grad():
        got = tenc(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, atol=2e-3)


# --------------------------------------------------------- update blocks
@pytest.mark.parametrize("small", [False, True])
def test_update_block_matches_jax(small):
    if small:
        radius, hidden, ctx, (b, h, w) = 3, 96, 64, (1, 6, 9)
        jblk = jupd.SmallUpdateBlock(4, radius, hidden_dim=hidden)
        tblk = tupd.SmallUpdateBlock(4, radius, hidden_dim=hidden)
    else:
        radius, hidden, ctx, (b, h, w) = 4, 128, 128, (2, 8, 12)
        jblk = jupd.BasicUpdateBlock(4, radius, hidden_dim=hidden)
        tblk = tupd.BasicUpdateBlock(4, radius, hidden_dim=hidden)
    params = carry(jblk, tblk, 2, damp=True)
    rng = np.random.RandomState(2)
    cor_planes = 4 * (2 * radius + 1) ** 2
    args = [rng.randn(b, h, w, c).astype(np.float32)
            for c in (hidden, ctx, cor_planes, 2)]  # net, inp, corr, flow
    j_net, j_mask, j_delta = jax.jit(lambda p, *a: jblk(p, *a))(
        params, *map(jnp.asarray, args))
    with torch.no_grad():
        t_net, t_mask, t_delta = tblk(*map(nchw, args))
    np.testing.assert_allclose(nhwc(t_net), np.asarray(j_net), atol=1e-4)
    np.testing.assert_allclose(nhwc(t_delta), np.asarray(j_delta), atol=1e-4)
    if small:
        assert j_mask is None and t_mask is None
    else:
        np.testing.assert_allclose(nhwc(t_mask), np.asarray(j_mask),
                                   atol=1e-4)


@pytest.mark.parametrize("small", [False, True])
def test_motion_encoder_bf16_corr_matches_jax(small):
    """A bf16 correlation runs the correlation convolutions in bf16, as in
    the JAX package, and is promoted to fp32 where it meets the fp32 flow
    features.  The corr branch agrees with the JAX package's to one bf16
    rounding (rtol 1e-2, and 1e-2 of the largest value where the bias sum
    cancels); the fp32 output, which carries those roundings through one
    more convolution, to 2e-2 of its largest value."""
    radius = 3 if small else 4
    cls = "SmallMotionEncoder" if small else "BasicMotionEncoder"
    jenc = getattr(jupd, cls)(4, radius)
    tenc = getattr(tupd, cls)(4, radius)
    params = carry(jenc, tenc, 6)
    rng = np.random.RandomState(6)
    corr = rng.randn(1, 6, 8, 4 * (2 * radius + 1) ** 2).astype(np.float32)
    flow = rng.randn(1, 6, 8, 2).astype(np.float32)
    jcorr_bf16 = jnp.asarray(corr).astype(jnp.bfloat16)
    tcorr_bf16 = nchw(corr).to(torch.bfloat16)

    jcor = jax.nn.relu(jenc.convc1(params["convc1"], jcorr_bf16))
    if not small:
        jcor = jax.nn.relu(jenc.convc2(params["convc2"], jcor))
    seen = []
    tenc.conv.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].dtype))
    with torch.no_grad():
        tcor = torch.relu(tenc.convc1(tcorr_bf16))
        if not small:
            tcor = torch.relu(tenc.convc2(tcor))
        got = tenc(nchw(flow), tcorr_bf16)
    assert jcor.dtype == jnp.bfloat16 and tcor.dtype == torch.bfloat16
    want_cor = np.asarray(jcor.astype(jnp.float32))
    np.testing.assert_allclose(nhwc(tcor), want_cor, rtol=1e-2,
                               atol=1e-2 * np.abs(want_cor).max())

    want = jenc(params, jnp.asarray(flow), jcorr_bf16)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert seen == [torch.float32]  # torch.cat promoted the bf16 branch
    want = np.asarray(want)
    np.testing.assert_allclose(nhwc(got), want, atol=2e-2 * np.abs(want).max())


# ----------------------------------------------------------- full model
@pytest.fixture(scope="module")
def jax_twins():
    """``get(name, **args)``: the JAX package's model, built once per
    (name, args) for the whole module and without weights (its
    ``get_model`` would draw seed-0 weights op by op, which every test
    replaces); one instance also keeps its jitted forwards for the next
    test."""
    cache = {}

    def get(name, **args):
        key = (name, tuple(sorted(args.items())))
        if key not in cache:
            cache[key] = ptlflow_tpu.get_model_reference(name)(**args)
        return cache[key]
    return get


@pytest.mark.parametrize("name", ["raft", "raft_small"])
def test_eval_forward_matches_jax(jax_twins, name):
    """Same weights, same images, 3 GRU iterations: flows within 5e-3 px
    (the JAX package's own oracle tolerance), flow_small too.

    The flow head is damped (``damp_flow_head``): undamped, fp32 rounding
    grows ~5x per iteration, and the JAX package's own grouped and
    ungrouped lookups differ by 1.4e-3 px after 3 iterations."""
    jmodel = jax_twins(name, iters=3)
    params = random_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)),
                           np.random.RandomState(3))
    damp_flow_head(params["update_block"])
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model(name, args={"iters": 3},
                                         device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)

    images = np.random.RandomState(3).rand(1, 2, 3, 64, 96).astype(
        np.float32)
    want = jmodel({"images": images})
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, 64, 96)
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)


def _jax_and_port(jax_twins, name, seed, iters, **args):
    """The JAX model with seeded ``random_params`` (flow head damped) and
    the port's model on the CPU with the same weights."""
    jmodel = jax_twins(name, iters=iters, **args)
    params = random_params(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)),
                           np.random.RandomState(seed))
    damp_flow_head(params["update_block"])
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model(name, args={"iters": iters, **args},
                                         device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, tmodel, params


@pytest.mark.parametrize("name", ["raft", "raft_small"])
def test_eval_forward_on_tiny_maps_matches_jax(jax_twins, name):
    """40x40 gives 5x5 feature maps, whose pyramid ends in a 1x1 and an
    empty level: the port answers as the JAX package does, to 5e-3 px."""
    jmodel, tmodel, _ = _jax_and_port(jax_twins, name, 10, 3)
    images = np.random.RandomState(10).rand(1, 2, 3, 40, 40).astype(
        np.float32)
    want = jmodel({"images": images})
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, 40, 40)
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)


@pytest.mark.parametrize("name", ["raft", "raft_small"])
def test_mixed_precision_forward_matches_jax(jax_twins, name):
    """One GRU iteration in mixed precision: the port's bf16 weights are
    stored once, the JAX package casts its fp32 ones on every forward, and
    the flows agree as closely as the JAX package's own fp32 and mixed
    forwards do: mean |port - JAX mixed| is at most 1.5x mean |JAX fp32 -
    JAX mixed| on the same inputs.  The fp32 twin is the module's shared
    ``jax_twins(name, iters=1)``."""
    jmixed, tmixed, _ = _jax_and_port(jax_twins, name, 11, 1,
                                      mixed_precision=True)
    jfp32 = jax_twins(name, iters=1)
    jfp32.params = jmixed.params
    assert tmixed.fnet.conv1.weight.dtype == torch.bfloat16
    images = np.random.RandomState(11).rand(1, 2, 3, 64, 96).astype(
        np.float32)
    want = np.asarray(jmixed({"images": images})["flows"])
    own = np.abs(np.asarray(jfp32({"images": images})["flows"]) - want)
    got = tmixed({"images": torch.from_numpy(images)})["flows"].numpy()
    assert np.isfinite(got).all() and own.mean() > 0
    assert np.abs(got - want).mean() <= 1.5 * own.mean()


@pytest.mark.parametrize("name", ["raft", "raft_small"])
def test_state_dict_keys_match_jax_params(jax_twins, name):
    jmodel = jax_twins(name, iters=1)
    tmodel = ptlflow_tpu_torch.get_model(name, args={"iters": 1},
                                         device="cpu")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    assert set(tmodel.state_dict()) == jax_state_keys(shapes)
    # stride-2 blocks keep their unused norm, as the checkpoints do
    if name == "raft":
        assert "cnet.layer2.0.norm3.running_mean" in tmodel.state_dict()


def test_padded_forward_unpads_to_input_size():
    """1024x436-like aspect at a small size: 61x83 pads to 64x88 and the
    flow comes back at 61x83."""
    model = ptlflow_tpu_torch.get_model("raft_small", args={"iters": 2},
                                        device="cpu")
    images = torch.from_numpy(
        np.random.RandomState(4).rand(1, 2, 3, 61, 83).astype(np.float32))
    out = model({"images": images})
    assert out["flows"].shape == (1, 1, 2, 61, 83)
    assert out["flow_small"].shape == (1, 2, 8, 11)
    assert torch.isfinite(out["flows"]).all()


@pytest.mark.parametrize("args", [{"mixed_precision": True},
                                  {"corr_dtype": "bfloat16"}])
def test_reduced_precision_forward(args):
    """bf16 paths emit finite fp32 flow; under mixed precision the weights
    are bf16 and the norm statistics stay fp32."""
    model = ptlflow_tpu_torch.get_model("raft", args={"iters": 2, **args},
                                        device="cpu")
    images = torch.from_numpy(
        np.random.RandomState(5).rand(1, 2, 3, 64, 96).astype(np.float32))
    out = model({"images": images})
    assert out["flows"].dtype == torch.float32
    assert torch.isfinite(out["flows"]).all()
    if args.get("mixed_precision"):
        assert model.fnet.conv1.weight.dtype == torch.bfloat16
        assert model.cnet.norm1.weight.dtype == torch.bfloat16
        assert model.cnet.norm1.running_var.dtype == torch.float32


def test_forward_prepares_the_lookup_once(monkeypatch):
    """Like the JAX package, the forward builds the lookup once per
    forward and calls it once per GRU iteration."""
    # the module, not the class that the package re-exports under its name
    traft = importlib.import_module("ptlflow_tpu_torch.models.raft.raft")
    built, calls = [], []
    make = traft.make_corr_lookup

    def counting_make(pyramid, radius):
        built.append(radius)
        inner = make(pyramid, radius)

        def lookup(coords):
            calls.append(coords.shape)
            return inner(coords)
        return lookup

    monkeypatch.setattr(traft, "make_corr_lookup", counting_make)
    model = ptlflow_tpu_torch.get_model("raft_small", args={"iters": 3},
                                        device="cpu")
    model({"images": torch.zeros(1, 2, 3, 32, 48)})
    assert built == [3] and len(calls) == 3

