"""The PyTorch port's SCV (``scv4``, ``scv8``) and its sparse volume against
the JAX package's, on the CPU: the exact top-k matches, their splat into
multi-scale windows, and the eval forward with the warm start
(``tests/test_torch_scv_train.py`` holds ``scv4``'s training step).

JAX parameter trees get seeded numpy weights (``random_params``) with the
flow head's last convolution damped by 0.1, as RAFT's tests damp theirs;
``state_dict_from_jax`` carries them into the port, which loads them with
``strict=True``.  The models keep their registered widths at 64x96 (16x24
maps for ``scv4``, 8x12 for ``scv8``), 3 iterations.
The JAX forward is jitted once a model with the previous ``flow_small``
as an input: zeros for the cold start, which forward-project to exactly 0.
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu.models.scv import scv as jscv
from ptlflow_tpu_torch.models.scv import scv as tscv
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_train import random_params

H, W = 64, 96
ITERS = 3


def test_sparse_corr_matches_jax():
    """A 65x64 map (N = 4160, past the 4096 columns where the JAX package
    switches to its block-max selection), 32 channels, top 32: the scores
    within 1e-5 of the JAX package's, and the same set of matches in every
    row whose 32nd and 33rd scores (float64) are more than 1e-4 apart (all
    but a few rows: a nearer tie may be broken either way; within the top
    32 equal scores may come in either order, which no later step reads)."""
    rng = np.random.RandomState(130)
    f1 = rng.randn(1, 32, 65, 64).astype(np.float32)
    f2 = rng.randn(1, 32, 65, 64).astype(np.float32)
    want = jax.jit(jscv.compute_sparse_corr)(
        jnp.asarray(np.moveaxis(f1, 1, -1)), jnp.asarray(np.moveaxis(f2, 1,
                                                                     -1)))
    got = tscv.compute_sparse_corr(torch.from_numpy(f1), torch.from_numpy(f2))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    full = np.sort(f1.reshape(32, -1).T.astype(np.float64)
                   @ f2.reshape(32, -1).astype(np.float64), axis=1)[:, ::-1]
    clear = full[:, 31] - full[:, 32] > 1e-4
    assert clear.mean() > 0.98

    def match_sets(coords1):  # (N, k, 2) displacements -> sorted indices
        pos = np.rint(coords1 + got[1].numpy()[:, None]).astype(np.int64)
        return np.sort(pos[..., 0] * 64 + pos[..., 1], axis=1)

    np.testing.assert_array_equal(match_sets(got[2].numpy()[0])[clear],
                                  match_sets(np.asarray(want[2])[0])[clear])


def test_sparse_windows_match_jax():
    """Matches displaced up to 7 px (so some corners fall outside the 9x9
    window at the first scales and are dropped) splatted at 5 scales:
    within 1e-5 of the JAX package's; a displacement of exactly 4 px
    fills the window's last slot."""
    rng = np.random.RandomState(131)
    b, h, w, k = 2, 5, 6, 8
    corr = rng.randn(b, h * w, k).astype(np.float32)
    coords = rng.uniform(-7, 7, (b, h * w, k, 2)).astype(np.float32)
    coords[0, 0, 0] = [4.0, -4.0]
    want = np.moveaxis(np.asarray(jax.jit(
        lambda c, x: jscv.sparse_windows(c, x, h, w))(
        jnp.asarray(corr), jnp.asarray(coords))), -1, 1)
    got = tscv.sparse_windows(torch.from_numpy(corr),
                              torch.from_numpy(coords), h, w)
    assert got.shape == (b, 405, h, w)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert (got[:, :81] == 0).float().mean() > 0.5  # sparse at scale 1


def build(name, seed, **args):
    """(JAX model, port model on the CPU), the same seeded weights, the
    flow head damped by 0.1."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    head = params["update_block"]["flow_head"]["conv2"]
    for leaf in ("weight", "bias"):
        head[leaf] = head[leaf] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args).eval()
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel


def check_eval_and_warm_start(jmodel, tmodel, seed, stride):
    """Cold, then warm-started from a ``flow_small`` of ~2 px: flows and
    ``flow_small`` within 5e-3 px of the JAX package's (whose cold start is
    a warm start from zeros), and the warm start moves the flow."""
    rng = np.random.RandomState(seed)
    images = rng.rand(1, 2, 3, H, W).astype(np.float32)
    small = (1, 2, H // stride, W // stride)
    prev = (2.0 + rng.uniform(-0.2, 0.2, small)).astype(np.float32)
    forward = jax.jit(lambda p, x, fs: jmodel.forward(
        p, {"images": x, "prev_preds": {"flow_small": fs}}))
    flows = []
    for warm in (False, True):
        want = forward(jmodel.params, jnp.asarray(images),
                       jnp.asarray(prev if warm else np.zeros(small,
                                                              np.float32)))
        inputs = {"images": torch.from_numpy(images)}
        if warm:
            inputs["prev_preds"] = {"flow_small": torch.from_numpy(prev)}
        got = tmodel(inputs)
        for key in ("flows", "flow_small"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=5e-3)
        flows.append(got["flows"])
    assert np.abs(np.asarray(want["flows"])).max() > 1.0
    assert (flows[1] - flows[0]).abs().max() > 0.5


@pytest.mark.parametrize("name,stride", [("scv4", 4), ("scv8", 8)])
def test_eval_forward_and_warm_start_match_jax(name, stride):
    jmodel, tmodel = build(name, 132, iters=ITERS)
    check_eval_and_warm_start(jmodel, tmodel, 133, stride)
