"""The PyTorch port's ReCoVEr (``recover_mn``, ``recover_rn``,
``recover_cx``) and Flow-Anything against the JAX package's, on the CPU.

They are SEA-RAFT with another context network, so their weights are drawn,
conditioned and calibrated as ``tests/test_torch_sea_raft.py`` says
(``jax_and_port``); ``random_params`` also draws ConvNeXt's
``layer_scale`` (1e-6 at init) uniform in +-0.1.  ``state_dict_from_jax``
carries the JAX trees into the port, whose ConvNeXt blocks keep
torchvision's names (``block.0`` ... ``block.5``, ``layer_scale`` of shape
(dim, 1, 1)); the port loads them with ``strict=True``.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from tests.test_torch_sea_raft import jax_and_port
from tests.test_torch_train import carry_random, nchw, nhwc

jbb = importlib.import_module("ptlflow_tpu.models.recover.backbones")
tbb = importlib.import_module("ptlflow_tpu_torch.models.recover.backbones")

H, W = 64, 96


@pytest.mark.parametrize("kind", ["mn", "cx"])
def test_extractor_matches_jax(kind):
    """MobileNetV3-L (hardswish, squeeze-excitation, BatchNorm eps 1e-3)
    and ConvNeXt-T (7x7 depthwise convolutions, LayerNorms, layer scales)
    on a 6-channel 64x96 input, eval mode: the 256-channel 8x12 output
    within 1e-4 of its largest entry of the JAX package's."""
    if kind == "mn":
        jmod = jbb.MobileNetV3Extractor("l", 6, 256)
        tmod = tbb.MobileNetV3Extractor("l", 6, 256)
    else:
        jmod = jbb.ConvNeXtExtractor("t", 6, 256)
        tmod = tbb.ConvNeXtExtractor("t", 6, 256)
    params = carry_random(jmod, tmod, 130)
    x = np.random.RandomState(130).randn(2, H, W, 6).astype(np.float32)
    want = np.asarray(jax.jit(jmod)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    assert got.shape == (2, H // 8, W // 8, 256)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_convnext_block_keeps_torchvision_names():
    """A CNBlock's ``state_dict`` is torchvision's, and the JAX tree's
    ``conv``/``norm``/``fc1``/``fc2`` and flat ``layer_scale`` land there."""
    jblk, tblk = jbb.CNBlock(8), tbb.CNBlock(8)
    params = carry_random(jblk, tblk, 131)
    sd = tblk.state_dict()
    assert sorted(sd) == sorted(
        ["layer_scale"] + [f"block.{i}.{leaf}" for i in (0, 2, 3, 5)
                           for leaf in ("weight", "bias")])
    assert sd["layer_scale"].shape == (8, 1, 1)
    np.testing.assert_array_equal(sd["layer_scale"].reshape(-1).numpy(),
                                  np.asarray(params["layer_scale"]))
    np.testing.assert_array_equal(sd["block.3.weight"].numpy(),
                                  np.asarray(params["fc1"]["weight"]).T)


@pytest.mark.parametrize("name", ["recover_rn", "flow_anything"])
def test_eval_forward_matches_jax(name):
    """2 refinements at 64x96: flows within 5e-3 px of the JAX package's,
    no autograd graph (``recover_mn`` and ``recover_cx``:
    ``tests/test_torch_recover_mixed.py``)."""
    images = np.random.RandomState(132).rand(1, 2, 3, H, W).astype(
        np.float32)
    jmodel, tmodel, _ = jax_and_port(name, 132, images, iters=2)
    want = np.asarray(jax.jit(lambda p, x: jmodel.forward(
        p, {"images": x})["flows"])(jmodel.params, jnp.asarray(images)))
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].grad_fn is None
    np.testing.assert_allclose(got["flows"].numpy(), want, atol=5e-3)
    assert np.abs(want).max() > 1.0
