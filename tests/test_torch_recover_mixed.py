"""The PyTorch port's ReCoVEr-MN and -CX eval forwards, in fp32 and in
SEA-RAFT's mixed-precision mode, against the JAX package's, on the CPU.

``mixed_precision=True`` stores bf16 weights, the replaced context network
(MobileNetV3-L, ConvNeXt-T) too, and keeps the norms' statistics and the
flow in fp32.  Weights as ``tests/test_torch_recover.py`` says; one JAX
tree serves both precisions.
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_sea_raft import jax_and_port


@pytest.mark.parametrize("name", ["recover_mn", "recover_cx"])
def test_fp32_and_mixed_forwards_match_jax(name):
    """1 refinement at 64x96.  fp32: flows within 5e-3 px of the JAX
    package's, no autograd graph.  Mixed precision: the context network's
    weights bf16 and its norms' statistics fp32; mean |port - JAX mixed|
    at most 1.5x mean |JAX fp32 - JAX mixed| on the same inputs (the
    port's weights are rounded once, the JAX package casts its fp32 ones
    on every forward), and the flow fp32."""
    images = np.random.RandomState(134).rand(1, 2, 3, 64, 96).astype(
        np.float32)
    jmixed, tmixed, params = jax_and_port(name, 134, images, iters=1,
                                          mixed_precision=True)
    jfp32 = ptlflow_tpu.get_model_reference(name)(iters=1)
    jfp32.params = jmixed.params
    tfp32 = ptlflow_tpu_torch.get_model(name, args={"iters": 1},
                                        device="cpu")
    tfp32.load_state_dict(state_dict_from_jax(params, tfp32), strict=True)
    fp32 = np.asarray(jfp32({"images": images})["flows"])
    got32 = tfp32({"images": torch.from_numpy(images)})["flows"]
    assert got32.grad_fn is None
    np.testing.assert_allclose(got32.numpy(), fp32, atol=5e-3)
    assert np.abs(fp32).max() > 1.0
    cnet_weights = [p for n, p in tmixed.cnet.named_parameters()
                    if n.endswith("weight")]
    assert all(p.dtype == torch.bfloat16 for p in cnet_weights)
    assert all(b.dtype == torch.float32 for n, b in tmixed.named_buffers()
               if n.endswith("running_var"))
    want = np.asarray(jmixed({"images": images})["flows"])
    own = np.abs(fp32 - want)
    got = tmixed({"images": torch.from_numpy(images)})["flows"]
    assert got.dtype == torch.float32
    got = got.numpy()
    assert np.isfinite(got).all() and own.mean() > 0
    assert np.abs(got - want).mean() <= 1.5 * own.mean()
