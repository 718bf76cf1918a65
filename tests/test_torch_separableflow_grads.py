"""The gradients of the port's SeparableFlow ``CostAggregation`` against
``jax.grad`` of the JAX package's, on the CPU, tensor by tensor: the
banded shift extraction (``Corr2Cost``), the 3-D U-Nets, the SGA blocks and
the shift regression.  Its two compilations set it apart from
``tests/test_torch_separableflow.py``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_ganet import rolled_sga_scans  # noqa: F401
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_train import carry_random

jca = importlib.import_module("ptlflow_tpu.models.separableflow.cost_agg")
tca = importlib.import_module(
    "ptlflow_tpu_torch.models.separableflow.cost_agg")

GRADS = {}


def cost_aggregation_grad(jmod, is_ux, *args):
    """``jax.grad`` of a weighted sum of the JAX package's
    ``CostAggregation`` eval outputs with respect to the parameters, the
    volume and the guidance maps, compiled (``compile_o0``) once a
    direction for these shapes."""
    if is_ux not in GRADS:
        def loss(p, x, g, cots):
            outs = jmod(p, x, g, max_shift=384, is_ux=is_ux, training=False)
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

        GRADS[is_ux] = compile_o0(jax.grad(loss, argnums=(0, 1, 2)), *args)
    return GRADS[is_ux](*args)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cost_aggregation_gradients_match_jax_grad(seed):
    """The gradients of a weighted sum of ``CostAggregation``'s eval
    outputs (the shift map and the volume; the U-Net of x on even seeds, of
    y on odd) with respect to the (2, 8, 8, 8, 8) volume, the five guidance
    maps and every parameter: within 1e-3 of the largest element of
    ``jax.grad``'s, by tensor.  This holds ``Corr2Cost``'s banded
    extraction, the 3-D U-Nets, the SGA blocks and the shift regression's
    backward at a size where float32 is well-conditioned: over seeds 0-5
    the worst tensor is 1.4e-5 to 3.0e-5 apart, each package's float32
    gradients are within 5e-5 of a float64 run of both packages, and the
    two float64 runs are within 1e-13 of each other.  The shift regression's
    last bias gets none in exact arithmetic (a softmax does not see one
    shift of all its logits): both are rounding, within 1e-4 of the
    largest gradient of the module."""
    is_ux = seed % 2 == 0
    jmod, tmod = jca.CostAggregation(in_channel=8), tca.CostAggregation(
        in_channel=8)
    params = carry_random(jmod, tmod, 190 + seed)
    rng = np.random.RandomState(200 + seed)
    x = rng.randn(2, 8, 8, 8, 8).astype(np.float32)
    g = {k: rng.randn(2, 20, 8 // s, 8 // s).astype(np.float32)
         for k, s in (("sg1", 1), ("sg2", 1), ("sg3", 1), ("sg11", 2),
                      ("sg12", 2))}
    cots = [rng.randn(2, 1, 64, 64).astype(np.float32),
            rng.randn(2, 1, 8, 8, 8).astype(np.float32)]
    jp, jx, jg = cost_aggregation_grad(
        jmod, is_ux, params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
        {k: jnp.asarray(v.transpose(0, 2, 3, 1)) for k, v in g.items()},
        [jnp.asarray(cots[0]), jnp.asarray(np.moveaxis(cots[1], 1, -1))])
    tx = torch.from_numpy(x).requires_grad_()
    tg = {k: torch.from_numpy(v).requires_grad_() for k, v in g.items()}
    outs = tmod(tx, tg, max_shift=384, is_ux=is_ux, training=False)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    names = [n for n, p in tmod.named_parameters()
             if not n.startswith(("shift0.", "shift1."))]  # training only
    got = torch.autograd.grad(
        loss, [tx, *tg.values(), *(tmod.get_parameter(n) for n in names)])
    jnamed = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 tmod)
    want = ([np.moveaxis(np.asarray(jx), -1, 1)]
            + [np.moveaxis(np.asarray(jg[k]), -1, 1) for k in tg]
            + [jnamed[n].numpy() for n in names])
    labels = ["x", *tg, *names]
    top = max(np.abs(b).max() for b in want)
    for label, a, b in zip(labels, got, want):
        if label.endswith("conv3d_2d.bias"):
            assert max(np.abs(a.numpy()).max(), np.abs(b).max()) <= 1e-4 * top
            continue
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-3 * np.abs(b).max(),
                                   err_msg=label)
