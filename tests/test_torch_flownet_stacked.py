"""The port's stacked FlowNets (``flownetcs``, ``flownetcss``, ``flownet2``)
against the JAX package's, on the CPU: the eval forward of frames of
128x128 (1/64: 2x2), each S network fed the frames, the second warped by
the flow before it (PWC's warp), that flow over ``div_flow`` and the
brightness error; FlowNet2's fusion network fed SD's flow (divided by
``div_flow`` twice), CSS's, their norms and their brightness errors.

One draw of ``flownet2``'s weights serves all three: CS's tree is its
``flownetc`` and ``flownets_1``, CSS's those and ``flownets_2``; and one
compilation of the three JAX forwards, whose common stages XLA computes
once.  Every ``predict_flow*`` of every sub-network is damped by 0.1
(``tests/test_torch_flownet.py::build``): undamped, the chain's flows grow
to 300-4000 px, which the warps then read far outside the frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import ptlflow_tpu
from tests.test_torch_flownet import (HEADS, assert_forward_matches,
                                      damp_modules, images_of, port_model)
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_train import random_params

PARTS = {"flownetcs": ("flownetc", "flownets_1"),
         "flownetcss": ("flownetc", "flownets_1", "flownets_2"),
         "flownet2": None}


def sub_tree(params, name):
    parts = PARTS[name]
    return params if parts is None else {k: params[k] for k in parts}


@pytest.fixture(scope="module")
def stacked():
    """(``flownet2``'s numpy params, the JAX package's outputs by name, the
    images, the port's models by name as the tests build them)."""
    jmodels = {n: ptlflow_tpu.get_model_reference(n)() for n in PARTS}
    shapes = jax.eval_shape(jmodels["flownet2"].init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(120))
    damp_modules(params, HEADS, 0.1)
    images = images_of(121, h=128, w=128)

    def forwards(p, x):
        return {n: m.forward(sub_tree(p, n), {"images": x})
                for n, m in jmodels.items()}

    args = (jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(images))
    return params, compile_o0(forwards, *args)(*args), images, {}


def port(stacked, name):
    params, _, _, models = stacked
    if name not in models:
        models[name] = port_model(name, sub_tree(params, name))
    return models[name]


@pytest.mark.parametrize("name", list(PARTS))
def test_eval_forward_matches_jax(name, stacked):
    """``flows`` within 5e-3 px of the JAX package's, flows of a few
    pixels."""
    _, wants, images, _ = stacked
    tmodel = port(stacked, name)
    want = assert_forward_matches(None, tmodel, images, want=wants[name])
    assert 1.0 < np.abs(np.asarray(want["flows"])).max() < 100.0


def test_flownet2_trains_with_its_fusion_scales(stacked):
    """FlowNet2's ``flow_preds`` are the fusion network's (full size, 1/2,
    1/4): the registered loss, which pools the ground truth from 1/4 on,
    fails on their shapes, as the JAX package's does (ROADMAP.md, section
    3); with ``loss_start_scale=1`` the step gives a finite loss and a
    gradient that reaches every sub-network."""
    from ptlflow_tpu_torch.nn import split_trainable
    from ptlflow_tpu_torch.parallel import train as ttrain
    from tests.test_torch_train import synthetic_batch

    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(122, b=1, h=64, w=64).items()}
    tmodel = port(stacked, "flownet2")
    with pytest.raises(RuntimeError, match="size of tensor"):
        tmodel.loss_fn(tmodel(batch, training=True), batch)
    tmodel.loss_fn.start_scale = 1
    params, _ = split_trainable(tmodel)
    loss, grads = ttrain.loss_and_grads(tmodel, params, batch)
    assert torch.isfinite(loss)
    named = dict(zip(params, grads))
    for sub in ("flownetc.conv1", "flownets_1.conv1", "flownets_2.conv1",
                "flownets_d.conv0", "flownetfusion.conv0"):
        assert named[f"{sub}.0.weight"].abs().max() > 0, sub
