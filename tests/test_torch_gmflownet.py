"""The PyTorch port's GMFlowNet (``gmflownet``, ``gmflownet_mix``) and its
POLA blocks against the JAX package's, on the CPU.

JAX parameter trees get seeded numpy weights (``random_params``) with the
flow head's last convolution damped by 0.1, as RAFT's tests damp theirs;
``state_dict_from_jax`` carries them into the port, which loads them with
``strict=True``.  The models keep their registered widths and depths at
64x96 (an 8x12 map at 1/8: two 7x7 windows a row, padded).

Without a warm start the flow starts at the mutual best matches of the
soft correlation map, tested by exact equality: a product summed in
another order can flip a near tie.  The frames are therefore smooth and
the second is the first shifted by whole feature pixels
(``shifted_pair``), which gives every pixel a clear winner.
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
from tests.test_torch_train import carry_random, random_params

jgm = importlib.import_module("ptlflow_tpu.models.gmflownet.gmflownet")
tgm = importlib.import_module("ptlflow_tpu_torch.models.gmflownet.gmflownet")
jpola = importlib.import_module("ptlflow_tpu.models.gmflownet.pola")
tpola = importlib.import_module("ptlflow_tpu_torch.models.gmflownet.pola")

H, W = 64, 96
ITERS = 3


def shifted_pair(seed, b=1, h=H, w=W, shift=(8, 16)):
    """(B, 2, 3, H, W) frames in [0, 1]: a smooth random image (a sum of
    random low-frequency waves) and the same image shifted by ``shift``
    (dy, dx) pixels, whole feature pixels at 1/8."""
    rng = np.random.RandomState(seed)
    pad = max(shift)
    yy, xx = np.mgrid[0:h + pad, 0:w + pad].astype(np.float32)
    img = np.zeros((b, 3, h + pad, w + pad), np.float32)
    for _ in range(12):
        fy, fx = rng.uniform(0.02, 0.12, 2)
        phase = rng.uniform(0, 2 * np.pi, (b, 3, 1, 1))
        img += np.sin(fy * yy + fx * xx + phase).astype(np.float32)
    img = (img - img.min()) / (img.max() - img.min())
    dy, dx = shift
    first = img[..., pad - dy:pad - dy + h, pad - dx:pad - dx + w]
    second = img[..., pad:pad + h, pad:pad + w]
    return np.stack([first, second], axis=1).astype(np.float32)


# --------------------------------------------------------------- blocks
def test_neighbor_windows_match_jax():
    """``F.unfold``'s 21x21 stride-7 neighbourhoods of a 14x21 map (zero
    padded by a window) equal the JAX package's shifted partitions, and
    the -100 mask of a 10x16 map's padded keys equals its mask."""
    x = np.random.RandomState(80).randn(2, 14, 21, 5).astype(np.float32)
    want = np.asarray(jpola.gather_neighbor_windows(jnp.asarray(x), 7, 3))
    got = tpola.gather_neighbor_windows(torch.from_numpy(x), 7, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpola._pola_attn_mask(10, 16, 7, 1).numpy(),
        np.asarray(jpola._pola_attn_mask(10, 16, 7, 1)))


@pytest.mark.parametrize("block", ["pola", "mix"])
def test_pola_blocks_match_jax(block):
    """A POLA block (with the padded keys' mask) and a mixed axial-POLA
    block of width 32 over a 10x16 map (padded to 14x21 windows): within
    1e-5 of the JAX package's."""
    if block == "pola":
        jmod = jpola.POLATransBlock(32, 4, 7, 1)
        tmod = tpola.POLATransBlock(32, 4, 7, 1)
    else:
        jmod = jpola.MixAxialPOLABlock(32, 8, 7)
        tmod = tpola.MixAxialPOLABlock(32, 8, 7)
    params = carry_random(jmod, tmod, 81)
    x = np.random.RandomState(81).randn(2, 10, 16, 32).astype(np.float32)
    mask = jpola._pola_attn_mask(10, 16, 7, 1) if block == "pola" else None
    want = np.asarray(jax.jit(lambda p, v: jmod(p, v, attn_mask=mask))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        if block == "pola":
            got = tmod(torch.from_numpy(x),
                       attn_mask=tpola._pola_attn_mask(10, 16, 7, 1))
        else:
            got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_matching_loss_matches_jax():
    """The coarse match supervision of a flow at 1/8 (targets rounded,
    out-of-map and occluded pixels without a match) and the balanced
    cross entropy of a soft map against it, whose clipped log keeps the
    peaked rows finite: equal to the JAX package's, the loss within
    1e-5."""
    rng = np.random.RandomState(82)
    flow = (6 * rng.randn(2, 2, 32, 40)).astype(np.float32)
    occ = (rng.rand(2, 1, 32, 40) > 0.8).astype(np.float32)
    want_gt = np.asarray(jax.jit(lambda f, o: jgm.compute_supervision_coarse(
        f, o, 8))(jnp.asarray(flow), jnp.asarray(occ)))
    got_gt = tgm.compute_supervision_coarse(torch.from_numpy(flow),
                                            torch.from_numpy(occ), 8)
    np.testing.assert_array_equal(got_gt.numpy(), want_gt)
    assert 0 < want_gt.sum() < 40
    corr = (8 * rng.randn(2, 20, 4, 5)).astype(np.float32)
    soft = tgm.soft_correlation(torch.from_numpy(corr))
    assert soft.min() < 1e-6  # peaked rows
    want = float(jax.jit(jgm.compute_coarse_loss)(jnp.asarray(soft.numpy()),
                                                  jnp.asarray(want_gt)))
    got = tgm.compute_coarse_loss(soft, got_gt).item()
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ----------------------------------------------------------- full models
def build(name, seed, **args):
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    head = params["update_block"]["flow_head"]["conv2"]
    for leaf in ("weight", "bias"):
        head[leaf] = head[leaf] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    # built without the port's seeded init, which the strict load replaces
    tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args).eval()
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel


@pytest.mark.parametrize("name,warm_too", [("gmflownet", True),
                                           ("gmflownet_mix", False)])
def test_eval_forward_and_warm_start_match_jax(name, warm_too):
    """3 iterations at 64x96 from the mutual-match initialisation (and,
    for ``gmflownet``, warm started from a ``flow_small``: the mixed
    variant shares that code): flows and ``flow_small`` within 5e-3 px of
    the JAX package's, and the warm start moves the flow."""
    jmodel, tmodel = build(name, 83, iters=ITERS)
    images = shifted_pair(84)
    prev = (2.0 + np.random.RandomState(85).uniform(
        -0.2, 0.2, (1, 2, H // 8, W // 8))).astype(np.float32)
    with torch.no_grad():
        tmodel.iters = 0
        matched = tmodel({"images": torch.from_numpy(images)})["flow_small"]
        tmodel.iters = ITERS
    assert (matched != 0).float().mean() > 0.3  # most pixels matched
    forward = jax.jit(lambda p, x: jmodel.forward(p, {"images": x}))
    warm_forward = jax.jit(lambda p, x, fs: jmodel.forward(
        p, {"images": x, "prev_preds": {"flow_small": fs}}))
    outs = {}
    for warm in (False, True)[:2 if warm_too else 1]:
        if warm:
            want = warm_forward(jmodel.params, jnp.asarray(images),
                                jnp.asarray(prev))
        else:
            want = forward(jmodel.params, jnp.asarray(images))
        inputs = {"images": torch.from_numpy(images)}
        if warm:
            inputs["prev_preds"] = {"flow_small": torch.from_numpy(prev)}
        got = tmodel(inputs)
        np.testing.assert_allclose(got["flows"].numpy(),
                                   np.asarray(want["flows"]), atol=5e-3)
        np.testing.assert_allclose(got["flow_small"].numpy(),
                                   np.asarray(want["flow_small"]), atol=5e-3)
        outs[warm] = got["flows"]
    if warm_too:
        assert (outs[True] - outs[False]).abs().max() > 0.5
