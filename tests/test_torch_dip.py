"""The PyTorch port's DIP against the JAX package's, on the CPU.

DIP's flow starts random.  The port draws it from a ``torch.Generator``
seeded 20 (``init_flow``), the JAX package from ``PRNGKey(20)``: the same
distribution, other numbers, by design (ROADMAP.md, section 3).  The
parity tests replace the port's ``init_flow`` by one that returns the JAX
package's draw (``jax_init_flow``), so both models start from one flow.

JAX parameter trees get seeded numpy weights (``random_params``) with both
update blocks' flow heads damped by 0.1, as RAFT's tests damp theirs;
``state_dict_from_jax`` carries them into the port, which loads them with
``strict=True``.  The model keeps its registered widths at 64x96 (a 4x6
map at 1/16, 16x24 at 1/4), with 2 rounds a stage.
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
from tests.test_torch_lcv_train import assert_step_matches, jax_step
from tests.test_torch_train import (nchw, nhwc, random_params,
                                    synthetic_batch)

jdip = importlib.import_module("ptlflow_tpu.models.dip.dip")
tdip = importlib.import_module("ptlflow_tpu_torch.models.dip.dip")

H, W = 64, 96
ITERS = 2


def jax_init_flow(batch, h, w, scale, generator):
    """The JAX package's initial flow (``dip.py:262-265``), NCHW."""
    u = jax.random.uniform(jax.random.PRNGKey(20), (batch, h, w, 2),
                           dtype=jnp.float32)
    return nchw((u - 0.5) * 2 * scale)


def test_init_flow_is_seeded_and_uniform():
    """A fresh generator seeded 20 gives the same draw every time, within
    [-scale, scale), and leaves torch's global generator alone."""
    torch.manual_seed(1)
    want_global = torch.rand(3)
    torch.manual_seed(1)
    a = tdip.init_flow(2, 30, 40, 16, torch.Generator().manual_seed(20))
    b = tdip.init_flow(2, 30, 40, 16, torch.Generator().manual_seed(20))
    assert torch.equal(torch.rand(3), want_global)
    assert torch.equal(a, b) and a.shape == (2, 2, 30, 40)
    assert a.min() >= -16 and a.max() < 16 and a.abs().mean() > 6


@pytest.mark.parametrize("search", [False, True])
def test_path_match_matches_jax(search):
    """The inverse propagation (10 channels: the second frame and its four
    diagonal shifts, edge-padded, warped with border padding) and the 5x5
    search (25) of two 32-channel 6x9 maps at a flow reaching past the
    border: within 1e-5 of the JAX package's."""
    rng = np.random.RandomState(70)
    f1, f2 = (rng.randn(2, 6, 9, 32).astype(np.float32) for _ in range(2))
    flow = rng.uniform(-4, 4, (2, 6, 9, 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, f: jdip.PathMatch(a, b)(
        f, is_search=search))(jnp.asarray(f1), jnp.asarray(f2),
                              jnp.asarray(flow)))
    got = tdip.PathMatch(nchw(f1), nchw(f2))(nchw(flow), is_search=search)
    assert got.shape == (2, 25 if search else 10, 6, 9)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jmodel = ptlflow_tpu.get_model_reference("dip")(iters=ITERS)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(71))
    for block in ("update_block", "update_block_s"):
        head = params[block]["flow_head"]["conv2"]
        for leaf in ("weight", "bias"):
            head[leaf] = head[leaf] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model("dip", args={"iters": ITERS},
                                         device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel


def test_eval_forward_matches_jax(models, monkeypatch):
    """2 rounds at 1/16 then 2 at 1/4, of an odd-sized pair (padded with -1
    to /16) from the JAX package's initial flow: flows and ``flow_small``
    within 5e-3 px of the JAX package's; from the port's own draw they
    differ."""
    jmodel, tmodel = models
    images = np.random.RandomState(72).rand(1, 2, 3, H - 4, W - 6).astype(
        np.float32)
    want = jax.jit(lambda p, x: jmodel.forward(p, {"images": x}))(
        jmodel.params, jnp.asarray(images))
    own = tmodel({"images": torch.from_numpy(images)})["flows"]
    monkeypatch.setattr(tdip, "init_flow", jax_init_flow)
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].shape == (1, 1, 2, H - 4, W - 6)
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(nhwc(got["flow_small"]),
                               np.asarray(want["flow_small"]), atol=5e-3)
    assert np.abs(np.asarray(want["flows"])).max() > 1.0
    assert (own - got["flows"]).abs().max() > 0.1


def test_train_step_matches_jax_value_and_grad(models, monkeypatch):
    """One step from the JAX package's initial flow (2 + 2 rounds, 64x96,
    batch 2): all 8 half-rounds' flows (the 1/16 ones convex-upsampled x4,
    then bilinearly x4), the loss and every gradient, as
    ``assert_step_matches`` holds them; both update blocks and the encoder
    get a gradient.

    As ``tests/test_torch_train.py`` says of ``raft``, one step's gradient
    is ill-conditioned at this size with random weights, DIP's more than
    most (the flow starts up to 256 px off, and instance norms over 16x24
    maps follow every encoder conv): a ReLU input within rounding of 0
    takes either side in two float32 implementations.  A float64 run of
    the port decides which one flipped: batch seeds 73-76 and 78-81 flip
    the port's float32 step (73, 75, 78, 81; up to 30 times the tolerance
    in ``update_block.encoder.convc1`` and ``fnet.layer3``) or the JAX
    package's (74-76, 78-81; up to 71 times it in ``fnet``).  This seed
    flips neither: every tensor is within 0.47 of its tolerance."""
    monkeypatch.setattr(tdip, "init_flow", jax_init_flow)
    jmodel, tmodel = models
    batch = synthetic_batch(77)
    (jloss, (_, jpreds)), jgrads = jax_step(jmodel, batch)
    assert jpreds.shape == (4 * ITERS, 2, H, W, 2)
    tparams, grads = assert_step_matches(tmodel, batch, jloss, jgrads,
                                         jpreds=jpreds)
    named = dict(zip(tparams, grads))
    for name in ("fnet.conv1.weight", "update_block_s.gru.convz.weight",
                 "update_block.gru.convz1.weight",
                 "update_block.encoder.convc1.weight"):
        assert named[name].abs().max() > 0, name
