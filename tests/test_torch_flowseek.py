"""The PyTorch port's FlowSeek (``flowseek_t``, ``flowseek_m``) against the
JAX package's, on the CPU.

The DepthAnything ViT runs at ``tests/test_torch_waft.py``'s small
configuration (``small_vits``); the ResNet-FPNs and the update block keep
their registered widths.  JAX parameter trees get seeded numpy weights
(``random_params``) conditioned as SEA-RAFT's are
(``tests/test_torch_sea_raft.py::condition``: the flow head's flow
channels by 0.01, its info channels by 0.1, each ConvNeXt ``final`` conv
by 0.1), and ``merge_head``'s last conv damped by 0.05: the random depth
head's path reaches ~200, and correlating features that size gives 1e5
motion features and 3000 px steps.  Conditioned, the flows are a few to
tens of pixels.  ``flowseek_m``'s ResNet34s do not normalise their
activations with random BatchNorm statistics (127 px flows), so its norms
get the statistics of the test's images from the JAX package's training
forward (``calibrate_norms``, as SEA-RAFT's tests calibrate theirs).
``state_dict_from_jax`` carries the weights into the port, which loads
them with ``strict=True``.
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
from ptlflow_tpu_torch.ops import correlation as tcorr
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from ptlflow_tpu import nn as jnn
from tests.test_torch_sea_raft import condition as condition_sea_raft
from tests.test_torch_sea_raft import jax_modules
from tests.test_torch_train import nchw, nhwc, random_params
from tests.test_torch_waft import damp, small_vits  # noqa: F401

jfs = importlib.import_module("ptlflow_tpu.models.flowseek.flowseek")
tfs = importlib.import_module("ptlflow_tpu_torch.models.flowseek.flowseek")

H, W = 60, 90
ITERS = 2


def calibrate_norms(jmodel, params, images):
    """``params`` with every BatchNorm's running statistics those of
    ``images``: the JAX package's training forward (which needs a ground
    truth: zeros) with momentum 1."""
    norms = [m for m in jax_modules(jmodel)
             if isinstance(m, jnn.BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0

    def new_params(p, x):
        p = jnn.tree_copy(p)
        gt = jnp.zeros((x.shape[0], 1, 2) + x.shape[-2:], x.dtype)
        jmodel.forward(p, {"images": x, "flows": gt}, training=True)
        return p

    try:
        full = jax.jit(new_params)(params, jnp.asarray(images))
    finally:
        for m in norms:
            m.momentum = 0.1
    return jax.tree_util.tree_map(np.asarray, full)


def build(name, seed, images=None, **args):
    """(JAX ``name``, the port's on the CPU) with the same seeded,
    conditioned weights, the norms calibrated on ``images`` where given."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    condition_sea_raft(params)
    damp(params["merge_head"]["4"], 0.05)
    if images is not None:
        params = calibrate_norms(jmodel, params, images)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    with torch.device("meta"):
        tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args)
    tmodel = tmodel.to_empty(device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel


def test_create_bases_matches_jax():
    """The 8 basis fields of a 2-image disparity batch of 9x14, each
    normalised over its image: within 1e-6 of the JAX package's; a
    bfloat16 disparity gives float32 fields."""
    disp = np.random.RandomState(50).rand(2, 9, 14, 1).astype(np.float32)
    want = np.asarray(jax.jit(jfs.create_bases)(jnp.asarray(disp)))
    got = tfs.create_bases(nchw(disp))
    assert got.shape == (2, 16, 9, 14) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6)
    norms = got.reshape(2, 8, 2, -1).pow(2).sum(dim=(2, 3))
    np.testing.assert_allclose(norms[:, 3:].numpy(), 1.0, rtol=1e-5)
    assert tfs.create_bases(nchw(disp).bfloat16()).dtype == torch.float32


@pytest.mark.parametrize("name", ["flowseek_t", "flowseek_m"])
def test_eval_forward_matches_jax(small_vits, monkeypatch, name):
    """2 iterations at 60x90 (padded to 64x96; the depth branch at
    518x518): flows and ``flow_small`` within 5e-3 px of the JAX
    package's, and the lookup prepared once and called once an
    iteration."""
    images = np.random.RandomState(52).rand(1, 2, 3, H, W).astype(np.float32)
    jmodel, tmodel = build(name, 51, images if name == "flowseek_m" else None,
                           iters=ITERS)
    calls = []

    def counted(pyramid, radius):
        lookup = tcorr.make_corr_lookup(pyramid, radius)

        def call(coords):
            calls.append(coords.shape)
            return lookup(coords)
        return call

    monkeypatch.setattr(tfs, "make_corr_lookup", counted)
    want = jax.jit(lambda p, x: jmodel.forward(p, {"images": x}))(
        jmodel.params, jnp.asarray(images))
    got = tmodel({"images": torch.from_numpy(images)})
    assert len(calls) == ITERS
    assert got["flows"].shape == (1, 1, 2, H, W)
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    np.testing.assert_allclose(got["flow_small"].numpy(),
                               np.asarray(want["flow_small"]), atol=5e-3)
    assert 1.0 < np.abs(np.asarray(want["flows"])).max() < 100
