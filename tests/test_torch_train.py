"""The PyTorch port's warm start and training against the JAX package's, on
the CPU.

JAX parameter trees get seeded numpy weights (norm statistics randomised,
so BatchNorm is not the identity, and the flow head damped, so random RAFT
steps are of trained size); ``state_dict_from_jax`` carries them into the
port, which loads them with ``strict=True``.  Inputs come from numpy seeds;
the port is NCHW, the JAX package NHWC.  On the CPU the port's lookup is its
plain version, which autograd differentiates; ``test_torch_kernels.py``
holds the backward kernel against its plain version on a card.
"""

import math

import numpy as np
import optax
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu import nn as jnn
from ptlflow_tpu.models.raft.raft import SequenceLoss as JSequenceLoss
from ptlflow_tpu.ops import correlation as jcorr
from ptlflow_tpu.ops.warp import forward_interpolate as jforward_interpolate
from ptlflow_tpu.parallel import train as jtrain
from ptlflow_tpu_torch import nn as tnn
from ptlflow_tpu_torch.models.raft.raft import SequenceLoss
from ptlflow_tpu_torch.ops import correlation as tcorr
from ptlflow_tpu_torch.ops.warp import forward_interpolate
from ptlflow_tpu_torch.parallel import train as ttrain
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def random_params(shapes, rng):
    """Seeded numpy leaves for a JAX parameter tree of shapes: convolutions
    He-normal over their fan-out, biases, linear weights and embeddings
    uniform in +-0.1, BatchNorm and LayerNorm weights, biases and running
    statistics randomised, and layer scales (``gamma``) uniform in [0.1, 1]
    so that the blocks they scale count."""
    out = {k: random_params(v, rng) for k, v in shapes.items()
           if isinstance(v, dict)}
    leaves = {k: v.shape for k, v in shapes.items() if not isinstance(v, dict)}
    for k, shape in leaves.items():
        if "running_mean" in leaves:  # a BatchNorm
            val = {"running_mean": 0.1 * rng.randn(*shape),
                   "running_var": 1 + 0.5 * rng.rand(*shape),
                   "weight": 1 + 0.1 * rng.randn(*shape),
                   "bias": 0.1 * rng.randn(*shape)}[k]
        elif k == "gamma":
            val = rng.uniform(0.1, 1.0, shape)
        elif len(leaves.get("weight", ())) == 1:  # a LayerNorm
            val = {"weight": 1 + 0.1 * rng.randn(*shape),
                   "bias": 0.1 * rng.randn(*shape)}[k]
        elif k == "weight" and len(shape) == 4:  # HWIO
            std = math.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
            val = std * rng.randn(*shape)
        else:
            val = rng.uniform(-0.1, 0.1, shape)
        out[k] = val.astype(np.float32)
    return out


def carry_random(jmod, tmod, seed):
    """``random_params`` for the JAX module ``jmod``, loaded into the
    port's ``tmod`` (in eval mode).  Returns the JAX params."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    tmod.load_state_dict(state_dict_from_jax(params, tmod), strict=True)
    tmod.eval()
    return jax.tree_util.tree_map(jnp.asarray, params)


def jax_and_port(name, seed, iters, **args):
    """The JAX model with seeded weights and the port's model on the CPU
    with the same weights.  Returns (JAX model, port model, numpy params).
    The JAX tree's shapes come from ``jax.eval_shape``: its own random
    initialisation runs op by op and takes tens of seconds."""
    jmodel = ptlflow_tpu.get_model_reference(name)(iters=iters, **args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    head = params["update_block"]["flow_head"]["conv2"]
    head["weight"] = head["weight"] * 0.1
    head["bias"] = head["bias"] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model(name, args={"iters": iters, **args},
                                         device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


def synthetic_batch(seed, b=2, h=64, w=96):
    """images, ground-truth flows (a few above max_flow = 400) and valids
    (some below 0.5), as numpy arrays in the model contract's layout."""
    rng = np.random.RandomState(seed)
    flows = (3 * rng.randn(b, 1, 2, h, w)).astype(np.float32)
    flows[:, :, :, :4, :4] = 500.0
    return {"images": rng.rand(b, 2, 3, h, w).astype(np.float32),
            "flows": flows,
            "valids": (rng.rand(b, 1, 1, h, w) > 0.2).astype(np.float32)}


def bn_stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


# ---------------------------------------------------------- warm start
@pytest.mark.parametrize("fill_iters", [0, 12])
def test_forward_interpolate_matches_jax(fill_iters):
    """A constant shift plus noise under +-0.2 px sends no two pixels to
    one cell, so the splat's winner is never in question: the port matches
    the JAX package exactly, out-of-frame targets dropped and the holes
    filled by the same dilation."""
    rng = np.random.RandomState(40 + fill_iters)
    b, h, w = 2, 13, 19
    flow = np.empty((b, 2, h, w), np.float32)
    flow[:, 0], flow[:, 1] = 2.3, -1.6
    flow += rng.uniform(-0.2, 0.2, flow.shape).astype(np.float32)
    tgt_x = np.arange(w)[None, None] + flow[:, 0]
    assert (tgt_x >= w - 1).any()  # some targets leave the frame
    want = np.asarray(jforward_interpolate(
        jnp.asarray(np.moveaxis(flow, 1, -1)), fill_iters))
    got = forward_interpolate(torch.from_numpy(flow), fill_iters)
    np.testing.assert_array_equal(nhwc(got), want)
    assert (want == 0).any() == (fill_iters == 0)


@pytest.mark.parametrize("name", ["raft_small", "raft"])
def test_warm_start_forward_matches_jax(name):
    """``prev_preds["flow_small"]`` forward-projected into the coords, 2
    GRU iterations: flows and flow_small within 5e-3 px of the JAX
    package's, and the warm start moves the flow."""
    jmodel, tmodel, _ = jax_and_port(name, 41, 2)
    rng = np.random.RandomState(41)
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


# ------------------------------------------------------ lookup gradient
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius", [1, 4])
def test_lookup_gradient_matches_jax(radius, dtype):
    """The gradient with respect to every level, an empty one included:
    autograd through the plain lookup and the plain backward against
    ``jax.vjp`` of the JAX package's ungrouped XLA lookup.  fp32 within
    1e-5; bf16 within 1e-2 of each level's largest gradient, since the JAX
    package rounds its bilinear weights and its y-contraction to bf16 on
    the way, one bf16 rounding (2^-8) each."""
    rng = np.random.RandomState(50 + radius)
    b, h1, w1, h2, w2 = 2, 4, 5, 5, 7  # levels 5x7, 2x3, 1x1, 0x0
    jdt = None if dtype == "float32" else jnp.bfloat16
    f1 = jnp.asarray(rng.randn(b, h1, w1, 16).astype(np.float32))
    f2 = jnp.asarray(rng.randn(b, h2, w2, 16).astype(np.float32))
    jpyr = jcorr.build_corr_pyramid(f1, f2, 4, dtype=jdt)
    assert jpyr[-1].size == 0
    coords = (rng.rand(b, h1, w1, 2) * np.array([w2 + 4, h2 + 4])
              - 2).astype(np.float32)
    n2 = 4 * (2 * radius + 1) ** 2
    grad = rng.randn(b, h1, w1, n2).astype(np.float32)

    def lookup(*levels):
        return jcorr.corr_pyramid_lookup(list(levels), jnp.asarray(coords),
                                         radius, group=0)

    out, vjp = jax.vjp(lookup, *jpyr)
    want = vjp(jnp.asarray(grad).astype(out.dtype))
    want = [np.asarray(g[..., 0].astype(jnp.float32)) for g in want]

    tdt = getattr(torch, dtype)
    levels = [torch.from_numpy(np.array(p[..., 0].astype(jnp.float32)))
              .to(tdt).requires_grad_() for p in jpyr]
    tcoords, tgrad = nchw(coords), nchw(grad).to(tdt)
    out = tcorr.make_corr_lookup(levels, radius)(tcoords)
    autograd = torch.autograd.grad(out, levels, tgrad, allow_unused=True)
    plain = tcorr.corr_pyramid_lookup_backward_plain(
        tgrad, tcoords, [tuple(p.shape[1:]) for p in levels], radius)
    for i, w in enumerate(want):
        assert plain[i].shape == w.shape and plain[i].dtype == tdt
        tol = 1e-5 if dtype == "float32" else 1e-2 * np.abs(w).max(initial=0)
        np.testing.assert_allclose(plain[i].float().numpy(), w, rtol=0,
                                   atol=tol)
        if autograd[i] is not None:  # the empty level is never read
            np.testing.assert_allclose(autograd[i].float().numpy(), w,
                                       rtol=0, atol=tol)
    assert autograd[-1] is None and plain[-1].numel() == 0


def test_lookup_refuses_coords_that_need_a_gradient():
    """The lookup gives the coords no gradient, so coords that need one
    raise while grad mode is on, rather than get a silent zero."""
    pyr = tcorr.build_corr_pyramid(torch.randn(1, 8, 4, 5),
                                   torch.randn(1, 8, 4, 5), 2)
    coords = (torch.rand(1, 2, 4, 5) * 4).requires_grad_()
    lookup = tcorr.make_corr_lookup(pyr, 2)
    with pytest.raises(ValueError, match="detach the coords"):
        lookup(coords)
    with torch.no_grad():
        assert lookup(coords).shape == (1, 2 * 25, 4, 5)
    assert lookup(coords.detach()).shape == (1, 2 * 25, 4, 5)


# ------------------------------------------------------------ training
@pytest.mark.parametrize("name", ["raft_small", "raft"])
def test_training_forward_matches_jax(name):
    """``flow_preds`` of 2 GRU iterations at 64x96, batch 2 (BatchNorm on
    batch statistics in raft's context encoder): within 5e-3 px of the
    JAX package's ``forward(training=True)``; ``flows`` is the last."""
    jmodel, tmodel, _ = jax_and_port(name, 42, 2)
    batch = synthetic_batch(42)
    want = jmodel.infer({"images": batch["images"]}, training=True)
    got = tmodel({"images": torch.from_numpy(batch["images"])},
                 training=True)
    preds = got["flow_preds"]
    assert preds.shape == (2, 2, 2, 64, 96) and preds.requires_grad
    np.testing.assert_allclose(nhwc(preds), np.asarray(want["flow_preds"]),
                               atol=5e-3)
    torch.testing.assert_close(got["flows"], preds[-1][:, None], rtol=0,
                               atol=0)


def test_sequence_loss_matches_jax():
    """Some valids zero, some |gt| over max_flow: within 1e-5 relative."""
    rng = np.random.RandomState(43)
    preds = (3 * rng.randn(3, 2, 2, 16, 20)).astype(np.float32)
    batch = synthetic_batch(43, h=16, w=20)
    want = JSequenceLoss(0.8, 400.0)(
        {"flow_preds": jnp.asarray(np.moveaxis(preds, 2, -1))},
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = SequenceLoss(0.8, 400.0)(
        {"flow_preds": torch.from_numpy(preds)},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    masked = dict(batch, valids=np.zeros_like(batch["valids"]))
    zero = SequenceLoss(0.8, 400.0)(
        {"flow_preds": torch.from_numpy(preds)},
        {k: torch.from_numpy(v) for k, v in masked.items()})
    assert zero.item() == 0.0


def test_train_step_matches_jax_value_and_grad():
    """One step of raft (2 iterations, 64x96, batch 2) against
    ``jax.value_and_grad`` of the JAX package's ``loss_and_updates``: the
    loss within 1e-5 relative, the BatchNorm running statistics within
    1e-5, and every parameter's gradient within 1e-3 of its tensor's
    largest, or within 1e-6 of the model's largest gradient where both hold
    only rounding (a conv bias that feeds a norm on batch or instance
    statistics has a zero gradient in exact arithmetic, and the norms the
    forward never reads get zeros); the train step's loss and grad_norm
    agree too.

    One step's gradient is ill-conditioned at this size with random
    weights: a ReLU input within rounding of 0 takes either side in two
    fp32 implementations, and behind a batch-statistics norm one such flip
    moves a layer's gradient by percents (on other seeds the JAX package's
    fp32 gradients and those with x64 enabled differ by up to 7%, and the
    port's move by up to 9% when its input is scaled by 1 + 1e-6).  This
    seed's step meets no such input, whether XLA runs on 1, 3 or 8 cores:
    the two agree within 3e-4 per tensor."""
    jmodel, tmodel, params = jax_and_port("raft", 55, 2)
    batch = synthetic_batch(55)

    def loss_and_updates(trainable, bn_state, jbatch):
        # ptlflow_tpu/parallel/train.py: build_train_step.loss_and_updates
        full = jnn.merge_params(jnn.tree_copy(trainable),
                                jnn.tree_copy(bn_state))
        outputs = jmodel.forward(full, jbatch, training=True)
        loss = jmodel.loss_fn(outputs, jbatch)
        _, new_state = jnn.split_trainable(full, ())
        return loss, new_state

    trainable, state = jnn.split_trainable(jmodel.params, ())
    (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(
        loss_and_updates, has_aux=True))(
            trainable, state, {k: jnp.asarray(v) for k, v in batch.items()})
    want_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jgrads))
    want_stats = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jstate))

    tparams, _ = tnn.split_trainable(tmodel)
    assert set(tparams) == set(want_grads)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = ttrain.loss_and_grads(tmodel, tparams, tbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    gmax = max(w.abs().max().item() for w in want_grads.values())
    for name, g in zip(tparams, grads):
        w = want_grads[name]
        tol = max(1e-3 * w.abs().max().item(), 1e-6 * gmax)
        assert (g - w).abs().max().item() <= tol, name
    for name, v in bn_stats(tmodel).items():
        torch.testing.assert_close(v, want_stats[name], rtol=0, atol=1e-5,
                                   msg=name)

    # the train step on a fresh copy of the weights
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    tx = ttrain.make_optimizer(lr=4e-4, wdecay=1e-4, total_steps=100)
    step = ttrain.build_train_step(tmodel, tx)
    tstate = ttrain.create_train_state(tmodel, tx)
    tstate, metrics = step(tstate, tbatch)
    assert tstate.step == 1 and tstate.opt_state.count == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(optax.global_norm(jgrads)), rtol=1e-4)
    for name, v in bn_stats(tmodel).items():
        torch.testing.assert_close(v, want_stats[name], rtol=0, atol=1e-5,
                                   msg=name)


@pytest.mark.parametrize("pct_start", [0.05, 0.3])
def test_onecycle_linear_matches_optax(pct_start):
    """Every step of a 100-step schedule, and past its end, within 1e-12
    of the JAX package's optax schedule."""
    want = jtrain.onecycle_linear(4e-4, 100, pct_start)
    got = ttrain.onecycle_linear(4e-4, 100, pct_start)
    steps = np.arange(0, 103)
    want = np.asarray(want(jnp.asarray(steps, jnp.int32)), np.float64)
    np.testing.assert_allclose([got(int(s)) for s in steps], want, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("grad_clip", [1.0, None])
def test_optimizer_matches_optax(grad_clip):
    """Three AdamW steps on the same synthetic gradients, the second large
    enough that clipping bites: the parameters within 1e-6 of optax's,
    through the JAX package's ``make_optimizer``."""
    rng = np.random.RandomState(45)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.randn(*s)).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.1, 30.0, 0.5)]
    kw = dict(lr=1e-2, wdecay=1e-1, total_steps=10, pct_start=0.3,
              grad_clip=grad_clip)
    jtx = jtrain.make_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jtx.init(jparams)
    ttx = ttrain.make_optimizer(**kw)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = ttx.init(tparams)
    norms = []
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        norms.append(float(optax.global_norm(jg)))
        updates, jopt = jtx.update(jg, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = [torch.from_numpy(g[k]) for k in tparams]
        np.testing.assert_allclose(ttrain.global_norm(tg).item(), norms[-1],
                                   rtol=1e-6)
        topt = ttx.update(tg, topt, tparams.values())
        for k, v in tparams.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6)
    assert topt.count == 3 and norms[1] > 1.0 > norms[0]


def test_split_trainable_matches_jax():
    """Parameters are trainable and norm statistics state, by the JAX
    package's names; a frozen prefix moves its subtree to state and stops
    its gradient."""
    jmodel = ptlflow_tpu.get_model_reference("raft")(iters=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    model = ptlflow_tpu_torch.get_model("raft", args={"iters": 1},
                                        device="cpu")
    for frozen in ((), ("fnet",)):
        jtrain_tree, jstate_tree = jnn.split_trainable(shapes, frozen)
        trainable, state = tnn.split_trainable(model, frozen)
        assert set(trainable) == set(jnn.flatten_params(jtrain_tree))
        jstate_names = set(jnn.flatten_params(jstate_tree))
        assert set(state) - jstate_names == {
            k for k in state if k.endswith("num_batches_tracked")}
    assert not model.fnet.conv1.weight.requires_grad
    assert model.cnet.conv1.weight.requires_grad


def test_modes_follow_the_training_argument():
    """The eval forward builds no autograd graph and leaves the BatchNorm
    statistics as they are, even under ``model.train()`` and grad mode;
    ``training=True`` moves them under ``model.eval()``, and the module's
    own flags are restored after either call."""
    model = ptlflow_tpu_torch.get_model("raft", args={"iters": 1},
                                        device="cpu")
    images = torch.from_numpy(synthetic_batch(46, h=32, w=48)["images"])
    before = bn_stats(model)
    model.train()
    with torch.enable_grad():
        out = model({"images": images})
    assert out["flows"].grad_fn is None and model.training
    for k, v in bn_stats(model).items():
        assert torch.equal(v, before[k]), k
    model.eval()
    out = model({"images": images}, training=True)
    assert out["flows"].grad_fn is not None and not model.training
    moved = [k for k, v in bn_stats(model).items()
             if not torch.equal(v, before[k])]
    # all but the norm3 of each stride-2 block, which the forward skips
    assert len(moved) == len(before) - 4


def test_mixed_precision_model_refuses_to_train():
    model = ptlflow_tpu_torch.get_model(
        "raft_small", args={"iters": 1, "mixed_precision": True},
        device="cpu")
    with pytest.raises(ValueError, match="bf16 weights"):
        model({"images": torch.zeros(1, 2, 3, 32, 32)}, training=True)


def test_train_step_refuses_a_mesh():
    model = ptlflow_tpu_torch.get_model("raft_small", args={"iters": 1},
                                        device="cpu")
    with pytest.raises(NotImplementedError, match="DDP"):
        ttrain.build_train_step(model, ttrain.make_optimizer(),
                                mesh=object())
