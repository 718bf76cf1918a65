"""The PyTorch port's CCMR (``ccmr``, 3 scales) against the JAX package's,
on the CPU: the Fourier positions, the XCiT blocks (self and separate) and
the eval forward with the warm start (``tests/test_torch_ccmr_plus.py``
holds CCMR+, ``ccmr_p``).

Weights are ``random_params`` (the layer scales ``gamma1-3`` in [0.1, 1],
the temperatures uniform in +-0.1) carried by ``state_dict_from_jax``; the
models keep their registered widths at 64x96, 2 iterations a scale, the
flow head damped by 0.1 (``tests/test_torch_ms_raft_plus.py::build``), the
JAX forward jitted once with the previous ``flow_small`` as an input.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from tests.test_torch_ms_raft_plus import build, check_eval_and_warm_start
from tests.test_torch_train import carry_random

# the packages re-export the class ``ccmr`` under the module's name
jccmr = importlib.import_module("ptlflow_tpu.models.ccmr.ccmr")
tccmr = importlib.import_module("ptlflow_tpu_torch.models.ccmr.ccmr")


def test_fourier_positions_match_jax():
    """(1, 64, 28, 64): within 1e-5 of the JAX package's (NHWC there)."""
    got = tccmr.fourier_pos_encoding(28, 64)
    want = np.asarray(jccmr.fourier_pos_encoding(1, 28, 64))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 1),
                               atol=1e-5)


@pytest.mark.parametrize("separate", [False, True])
def test_xcit_matches_jax(separate):
    """XCiT at width 128, 8 heads, over a 6x10 map: the self block, or the
    separate block whose values are a second map: within 1e-5 of the JAX
    package's."""
    jmod = jccmr.XCiT(128, separate=separate)
    tmod = tccmr.XCiT(128, separate=separate)
    params = carry_random(jmod, tmod, 150)
    rng = np.random.RandomState(151)
    x = rng.randn(2, 128, 6, 10).astype(np.float32)
    v = rng.randn(2, 128, 6, 10).astype(np.float32) if separate else None

    def nhwc(a):
        return None if a is None else jnp.asarray(np.moveaxis(a, 1, -1))

    want = np.asarray(jax.jit(lambda p, a, b: jmod(p, a, x_v=b))(
        params, nhwc(x), nhwc(v)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x),
                   x_v=None if v is None else torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(want, -1, 1),
                               atol=1e-5)
    assert np.abs(want - np.moveaxis(x, 1, -1)).max() > 0.1


def test_eval_forward_and_warm_start_match_jax():
    jmodel, tmodel, _ = build("ccmr", 152, iters=(2, 2, 2))
    check_eval_and_warm_start(jmodel, tmodel, 153)
