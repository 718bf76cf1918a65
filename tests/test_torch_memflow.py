"""The PyTorch port's MemFlow against the JAX package's, on the CPU: the
memory functions, the update block, the pure forward, a stream with
``meta`` frame by frame, and the reference's ``network.`` names.

Weights are drawn and conditioned as ``tests/test_torch_skflow.py`` says
(MemFlow's update block is built of SKFlow's super-kernel blocks), with
the aggregator's ``gamma`` in [0.1, 1], so that the memory readout moves
the flow.  The JAX model's stateful ``infer`` jits its step once for the
frames that write the memory and once for those that do not; the pure
forward is ``infer`` on an empty memory without ``meta``, which writes
nothing, so it shares the second compilation.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu_torch
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_raft import jax_state_keys
from tests.test_torch_skflow import H, W, build, carry, images_of
from tests.test_torch_train import nchw, nhwc, random_params

# the modules, not the classes that the packages re-export under their names
jmem = importlib.import_module("ptlflow_tpu.models.memflow.memflow")
tmem = importlib.import_module("ptlflow_tpu_torch.models.memflow.memflow")

DEPTH = 2  # decoder steps
CAP = 2  # max_mid_term_frames
SCALE = 128 ** -0.5  # att.scale
AVG = 6750  # train_avg_length's default


@pytest.fixture(scope="module")
def mf():
    return build("memflow", 130, decoder_depth=DEPTH)


def tokens(rng, b, h, w, c=128):
    return rng.randn(b, h, w, c).astype(np.float32)


def memories(rng, n_frames, b=2, h=6, w=8):
    """The JAX and the port's memory after writing ``n_frames`` seeded
    frames of keys and values."""
    jm = jmem.empty_memory(b, h * w, CAP)
    tm = tmem.empty_memory(b, h * w, CAP)
    for _ in range(n_frames):
        key, value = tokens(rng, b, h, w), tokens(rng, b, h, w)
        jm = jmem.add_memory(jm, jnp.asarray(key), jnp.asarray(value))
        tm = tmem.add_memory(tm, nchw(key), nchw(value))
    return jm, tm


# ---------------------------------------------------------------- memory
@pytest.mark.parametrize("stored", [0, 1, 2])
def test_match_affinity_and_memory_match_jax(stored):
    """The affinity of a 6x8 query to ``stored`` frames and the current
    one: the port's rows are the JAX package's filled ones, within 1e-6,
    its unfilled ring slots exact zeros; each column a softmax over the
    keys; the readout within 1e-5."""
    rng = np.random.RandomState(131 + stored)
    jm, tm = memories(rng, stored)
    assert int(jm["count"]) == tm["count"] == stored
    query, key, value = (tokens(rng, 2, 6, 8) for _ in range(3))
    want = np.asarray(jmem.match_affinity(
        jnp.asarray(query), jnp.asarray(key), jm, SCALE, AVG))
    got = tmem.match_affinity(nchw(query), nchw(key), tm, SCALE, AVG)
    hw = 48
    assert want.shape == (2, (CAP + 1) * hw, hw)
    assert got.shape == (2, (stored + 1) * hw, hw)
    assert np.all(want[:, :(CAP - stored) * hw] == 0)
    np.testing.assert_allclose(got.numpy(), want[:, (CAP - stored) * hw:],
                               atol=1e-6)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)
    want_out = np.asarray(jmem.match_memory(
        jnp.asarray(query), jnp.asarray(key), jnp.asarray(value), jm, SCALE,
        AVG))
    got_out = tmem.match_memory(nchw(query), nchw(key), nchw(value), tm,
                                SCALE, AVG)
    np.testing.assert_allclose(nhwc(got_out), want_out, atol=1e-5)


def test_add_memory_rolls_past_capacity():
    """Three writes into a ring of 2: the count saturates at 2, the first
    frame rolls out and the last two stay, newest last, as in JAX."""
    rng = np.random.RandomState(134)
    frames = [tokens(rng, 1, 3, 4) for _ in range(3)]
    jm = jmem.empty_memory(1, 12, CAP)
    tm = tmem.empty_memory(1, 12, CAP)
    counts = []
    for f in frames:
        jm = jmem.add_memory(jm, jnp.asarray(f), jnp.asarray(2 * f))
        tm = tmem.add_memory(tm, nchw(f), nchw(2 * f))
        counts.append((int(jm["count"]), tm["count"]))
    assert counts == [(1, 1), (2, 2), (2, 2)]
    for k in ("key", "value"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    np.testing.assert_array_equal(tm["key"][0, 0].numpy(),
                                  frames[1].reshape(12, 128))
    np.testing.assert_array_equal(tm["value"][0, 1].numpy(),
                                  2 * frames[2].reshape(12, 128))


def test_update_block_matches_jax():
    """``get_motion_and_value`` (SKFlow's motion encoder and ``to_v``) and
    the update (the super-kernel GRU, flow head and mask): within 1e-4."""
    jblk = jmem.SKUpdateBlockMem()
    tblk = tmem.SKUpdateBlockMem()
    params = carry(jblk, tblk, 135)
    rng = np.random.RandomState(135)
    flow, corr, net, inp, glob = (rng.randn(2, 6, 8, c).astype(np.float32)
                                  for c in (2, 324, 128, 128, 128))
    jmf, jval = jax.jit(jblk.get_motion_and_value)(
        params, jnp.asarray(flow), jnp.asarray(corr))
    want = jax.jit(jblk)(params, jnp.asarray(net), jnp.asarray(inp), jmf,
                         jnp.asarray(glob))
    with torch.no_grad():
        tmf, tval = tblk.get_motion_and_value(nchw(flow), nchw(corr))
        got = tblk(nchw(net), nchw(inp), tmf, nchw(glob))
    for g, w in zip((tmf, tval) + got, (jmf, jval) + want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4)


# ----------------------------------------------------------- full model
def test_pure_forward_matches_jax(mf):
    """2 decoder steps at 64x96 on an empty memory (the JAX package's pure
    ``forward``): flows and ``flow_small`` within 5e-3 px, no autograd
    graph, nothing written."""
    jmodel, tmodel, _ = mf
    jmodel.clear_memory()
    tmodel.clear_memory()
    images = images_of(136)
    want = jmodel({"images": images})
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, H, W)
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)
    assert np.abs(np.asarray(want["flows"])).max() > 1.0
    assert tmodel._memory["count"] == 0 and int(jmodel._memory["count"]) == 0


def test_stream_with_meta_matches_jax_infer(mf):
    """Four consecutive pairs of one sequence with ``meta``, frame by frame
    through the JAX package's ``MemFlow.infer`` and the port's stateful
    forward: the flows within 5e-3 px; the count after each frame 1, 2, 2
    (the third write rolls the ring) and 2 (the last frame is the
    sequence's end and writes nothing), as in JAX; the memory moves the
    flow (frame 2 against the pure forward of the same pair); then a new
    sequence clears it (count 1).  The training forward reads none of it:
    the same with the memory full and cleared."""
    jmodel, tmodel, _ = mf
    jmodel.clear_memory()
    tmodel.clear_memory()
    frames = np.random.RandomState(137).rand(6, 3, H, W).astype(np.float32)
    metas = [{"is_seq_start": k == 0, "is_seq_end": k == 3}
             for k in range(4)] + [{"is_seq_start": True,
                                    "is_seq_end": False}]
    counts, flows = [], []
    for k, meta in enumerate(metas):
        images = frames[None, k:k + 2]
        want = jmodel({"images": images, "meta": meta})
        got = tmodel({"images": torch.from_numpy(images), "meta": meta})
        np.testing.assert_allclose(got["flows"].numpy(),
                                   np.asarray(want["flows"]), atol=5e-3,
                                   err_msg=f"frame {k}")
        assert got["flows"].grad_fn is None
        counts.append((tmodel._memory["count"],
                       int(jmodel._memory["count"])))
        flows.append(got["flows"])
    assert counts == [(1, 1), (2, 2), (2, 2), (2, 2), (1, 1)]
    assert tmodel._memory["key"].device.type == "cpu"
    x = {"images": torch.from_numpy(frames[None, 2:4])}
    with torch.no_grad():
        trained = tmodel(x, training=True)["flows"]
    tmodel.clear_memory()
    alone = tmodel(x)
    assert (alone["flows"] - flows[2]).abs().max() > 1e-3
    with torch.no_grad():
        torch.testing.assert_close(tmodel(x, training=True)["flows"],
                                   trained, rtol=0, atol=0)


# -------------------------------------------------- weights and names
def test_state_dict_loads_with_the_network_prefix():
    """The port's keys are the reference's: the JAX tree's under
    ``network.``, plus torch's BatchNorm counters and ``rel_ind``; a
    ``network.``-prefixed reference-layout ``state_dict`` loads strictly,
    the JAX package's ``from_torch`` reads the port's, and one without the
    prefix does not load."""
    jmodel = jmem.MemFlow(decoder_depth=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    tmodel = ptlflow_tpu_torch.get_model("memflow",
                                         args={"decoder_depth": 1},
                                         device="cpu")
    keys = set(tmodel.state_dict())
    assert keys == {"network." + k for k in jax_state_keys(shapes)} | {
        "network.att.pos_emb.rel_ind"}
    params = random_params(shapes, np.random.RandomState(138))
    converted = state_dict_from_jax(params, tmodel)
    assert set(converted) == keys
    tmodel.load_state_dict(converted, strict=True)
    table = params["att"]["pos_emb"]["rel_height"]["weight"]
    np.testing.assert_array_equal(
        tmodel.network.att.pos_emb.rel_height.weight.detach().numpy(), table)
    back = jmodel.from_torch({k: v.numpy() for k, v in
                              tmodel.state_dict().items()})
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    flat = {k[len("network."):]: v for k, v in converted.items()}
    with pytest.raises(RuntimeError, match="network"):
        tmodel.load_state_dict(flat, strict=True)
