"""``validate --bf16``'s cast of MEMFOF and CSFlow against the JAX
package's, on the CPU.

``validate --bf16`` casts the allow-listed models' weights to bfloat16
(``scripts/validate.py::cast_to_bf16``); each layer computes in its fp32
input's dtype, so both lookups keep float32 volumes and coords.  Weights
are drawn and conditioned as ``tests/test_torch_memfof.py`` and
``tests/test_torch_csflow.py`` say.
"""

import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu import nn as jnn
from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
from tests import test_torch_csflow, test_torch_memfof


def check_validate_cast(name, jmodel, tmodel, images):
    """The allow-listed cast: weights bf16, flows float32, within 5e-3 px
    of the JAX package's cast forward and off its float32 forward."""
    x = {"images": jnp.asarray(images)}
    forward = jax.jit(lambda p, x: jmodel.forward(p, x)["flows"])
    want = np.asarray(forward(jnn.cast_params(jmodel.params, jnp.bfloat16),
                              x))
    fp32 = np.asarray(forward(jmodel.params, x))
    assert cast_to_bf16(tmodel, name)
    got = tmodel({"images": torch.from_numpy(images)})["flows"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    assert np.abs(got.numpy() - fp32).max() > 5e-3
    return tmodel


def test_validate_bf16_cast_of_memfof_matches_jax():
    """``validate --bf16`` of ``memfof`` (``dim=64``, 2 refinements,
    128x160, a pair): its ``gamma`` and ConvNeXt layer scales cast too."""
    images = test_torch_memfof.images_of(142, frames=2)
    jmodel, tmodel, _ = test_torch_memfof.build(142, images)
    tmodel = check_validate_cast("memfof", jmodel, tmodel, images)
    assert tmodel.update_block.aggregator.gamma.dtype == torch.bfloat16
    assert tmodel.update_block.refine[0].gamma.dtype == torch.bfloat16


def test_validate_bf16_cast_of_csflow_matches_jax():
    """``validate --bf16`` of ``csflow`` (2 iterations, 64x96): the strip
    block's weights cast too; both lookups take float32 volumes and
    coords."""
    jmodel, tmodel, _ = test_torch_csflow.build("csflow", 143, iters=2)
    images = np.random.RandomState(143).rand(1, 2, 3, 64, 96).astype(
        np.float32)
    tmodel = check_validate_cast("csflow", jmodel, tmodel, images)
    assert tmodel.strip_corr_block_v2.conv1_1.conv.weight.dtype == \
        torch.bfloat16
