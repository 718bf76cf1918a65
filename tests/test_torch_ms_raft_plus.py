"""The PyTorch port's MS-RAFT+ (``ms_raft_p``) against the JAX package's, on
the CPU: the eval forward with the warm start, on its default on-the-fly
correlation (``AltCorrBlock``), and the same flows through ``CorrBlock``
(``alternate_corr=False``), the route whose lookup is the CUDA kernel on the
card.

JAX parameter trees get seeded numpy weights (``random_params``) with the
flow head's last convolution damped by 0.1, as RAFT's tests damp theirs;
``state_dict_from_jax`` carries them into the port, which loads them with
``strict=True``.  The model keeps its registered widths at 64x96 (4x6 to
32x48 maps), 2 iterations a scale.  The JAX forward is jitted once with the
previous ``flow_small`` as an input: zeros for the cold start, which
forward-project to exactly 0.
"""

import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
import ptlflow_tpu_torch
from ptlflow_tpu import nn as jnn
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_train import random_params

H, W = 64, 96
ITERS = (2, 2, 2, 2)


LAYERS = ("layer1", "layer2", "layer3", "layer4", "up_layer2", "up_layer1",
          "up_layer0")


def build(name, seed, shallow=False, **args):
    """(JAX model, port model on the CPU, numpy params), the same seeded
    weights, the flow head damped by 0.1.  ``shallow`` keeps the first of
    the two residual blocks of each encoder layer, in both twins (the JAX
    train step's compile)."""
    jmodel = ptlflow_tpu.get_model_reference(name)(**args)
    tmodel = ptlflow_tpu_torch.get_model_reference(name)(**args).eval()
    if shallow:
        for jenc, tenc in ((jmodel.fnet, tmodel.fnet),
                           (jmodel.cnet, tmodel.cnet)):
            for layer in LAYERS:
                setattr(jenc, layer,
                        jnn.Sequential(getattr(jenc, layer).mods[0]))
                setattr(tenc, layer, torch.nn.Sequential(
                    getattr(tenc, layer)[0]))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.RandomState(seed))
    head = params["update_block"]["flow_head"]["conv2"]
    for leaf in ("weight", "bias"):
        head[leaf] = head[leaf] * 0.1
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, params)
    tmodel.load_state_dict(state_dict_from_jax(params, tmodel), strict=True)
    return jmodel, tmodel, params


def check_eval_and_warm_start(jmodel, tmodel, seed):
    """Cold, then warm-started from a 1/16 ``flow_small`` of ~0.5 px:
    flows and ``flow_small`` within 5e-3 px of the JAX package's, and the
    warm start moves the flow.  Returns the port's inputs and outputs."""
    rng = np.random.RandomState(seed)
    images = rng.rand(1, 2, 3, H, W).astype(np.float32)
    small = (1, 2, H // 16, W // 16)
    prev = (0.5 + rng.uniform(-0.1, 0.1, small)).astype(np.float32)
    forward = jax.jit(lambda p, x, fs: jmodel.forward(
        p, {"images": x, "prev_preds": {"flow_small": fs}}))
    outs = []
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
        outs.append((inputs, got))
    assert np.abs(np.asarray(want["flows"])).max() > 1.0
    assert (outs[1][1]["flows"] - outs[0][1]["flows"]).abs().max() > 0.5
    return outs


def test_eval_forward_and_warm_start_match_jax():
    """``ms_raft_p`` on ``AltCorrBlock`` as the JAX package runs it, then
    the same weights with ``alternate_corr=False`` (``CorrBlock``): the
    same flows within 1e-4 px, cold and warm."""
    jmodel, tmodel, params = build("ms_raft_p", 140, iters=ITERS)
    outs = check_eval_and_warm_start(jmodel, tmodel, 141)
    dense = ptlflow_tpu_torch.get_model_reference("ms_raft_p")(
        iters=ITERS, alternate_corr=False).eval()
    dense.load_state_dict(tmodel.state_dict(), strict=True)
    for inputs, got in outs:
        np.testing.assert_allclose(dense(inputs)["flows"].numpy(),
                                   got["flows"].numpy(), atol=1e-4)


def test_warm_start_at_a_size_that_pads():
    """At 72x96 (padded to 80x96) ``flow_small`` is the padded frames'
    5x6 flow at 1/16, the coords' grid, and the next pair warm-starts from
    it; the JAX package gives the unpadded 4x6 one, which its warm start
    cannot add to the 5x6 coords (ROADMAP.md, section 3).  Equal to the
    JAX package's where nothing is padded (the test above)."""
    model = ptlflow_tpu_torch.get_model("ms_raft_p", device="cpu",
                                        args={"iters": (1, 1, 1, 1)})
    rng = np.random.RandomState(144)
    images = torch.from_numpy(rng.rand(1, 2, 3, 72, 96).astype(np.float32))
    first = model({"images": images})
    assert first["flow_small"].shape == (1, 2, 5, 6)
    second = model({"images": images, "prev_preds": first})
    assert second["flows"].shape == (1, 1, 2, 72, 96)
    assert torch.isfinite(second["flows"]).all()
    assert (second["flows"] - first["flows"]).abs().max() > 1e-3
