"""The port's MaskFlowNet (``maskflownet_s``, ``maskflownet``) against the
JAX package's, on the CPU: the triangular-kernel up- and downsampling and
the masked warp; one train step of ``maskflownet`` at 128x192, batch 2,
against ``jax.value_and_grad``; ``maskflownet``'s eval forward and
``maskflownet_s``'s ``flows`` and ``occs``, all from that one compilation.

``maskflownet`` holds ``maskflownet_s`` (``MaskFlownet_S.`` in its
``state_dict``), and the JAX package's full forward calls its first stage
with ``skip_preprocess`` on the preprocessed frames: at a size that is a
multiple of 64 those are the frames ``maskflownet_s`` itself would
preprocess to, so the first stage's ``flows`` and ``occs``, caught inside
the compiled step (``caught_first_stage``), are ``maskflownet_s``'s eval
outputs for the first-stage weights; neither network holds a BatchNorm,
so the training forward's ``flows`` are the eval forward's.  The JAX step
traces and compiles for ~45 s (its nine deformable convolutions, each
nine bilinear samplers and their scatters in the backward), so this file
compiles nothing else of that size.  While it is traced, the JAX
package's ``deform_conv2d`` and the ``bilinear_sampler`` that it and
``mfn_warp`` call are jitted on their own (``jitted_pieces``): a tap's
sampler and a level's deformable convolution (both stages run one at
each level's shapes) are then traced once, not nine or two times, and
XLA inlines them into the one compiled step.  The arithmetic is the JAX
package's, op for op.

Weights are ``random_params``; the flow and mask heads and the context
network's last convolution are damped by 0.1 (``HEADS``), which leaves
flows of up to a few hundred pixels (the second stage adds its own to the
first's).
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu import nn as jnn
from tests.test_torch_flownet import build, port_model
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_pwcnet_train import assert_list_step_matches
from tests.test_torch_train import nchw, synthetic_batch

# the packages re-export the registered class under the module's name
jmfn = importlib.import_module("ptlflow_tpu.models.maskflownet.maskflownet")
jdcn = importlib.import_module("ptlflow_tpu.ops.deform_conv")
tmfn = importlib.import_module(
    "ptlflow_tpu_torch.models.maskflownet.maskflownet")

HEADS = ("*pred_flow*", "*pred_mask*", "*dc_conv7")
# (module, function, static arguments) jitted while the step is traced
JITTED = ((jdcn, "deform_conv2d", ("padding",)),
          (jdcn, "bilinear_sampler", ("mask", "padding_mode")),
          (jmfn, "bilinear_sampler", ("mask", "padding_mode")))


@pytest.fixture(scope="module")
def jitted_pieces():
    """The JAX package's deformable convolution and sampler jitted while
    this file's tests run."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in JITTED]
    for mod, name, static in JITTED:
        setattr(mod, name, jax.jit(getattr(mod, name),
                                   static_argnames=static))
    yield
    for mod, name, fn in saved:
        setattr(mod, name, fn)


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_and_downsample_match_jax(factor):
    """``mfn_upsample`` (edge pad, channel-wise transposed convolution with
    the triangular kernel, crop) and ``mfn_downsample`` (the normalised
    triangular kernel, stride ``factor``) within 1e-5 of the JAX
    package's, on 3 channels of 9x13 (a size no factor divides)."""
    x = np.random.RandomState(310 + factor).randn(2, 3, 9, 13).astype(
        np.float32)
    jx = jnp.asarray(np.moveaxis(x, 1, -1))
    for tfn, jfn in ((tmfn.mfn_upsample, jmfn.mfn_upsample),
                     (tmfn.mfn_downsample, jmfn.mfn_downsample)):
        got = tfn(torch.from_numpy(x), factor)
        want = nchw(compile_o0(lambda a: jfn(a, factor), jx)(jx))
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("clamp", [False, True])
def test_warp_matches_jax(clamp):
    """``mfn_warp`` of (y, x) flows, 20 px apart, some past the edges: the
    samples and the ``>= 0.9999`` coverage mask within 1e-5 of the JAX
    package's (the clamp's round trip through normalised coordinates
    rounds a coordinate differently under XLA by ~1e-6 px), the clamp to
    [-1.1, 1.1] included."""
    rng = np.random.RandomState(320 + clamp)
    x = rng.randn(2, 3, 10, 14).astype(np.float32)
    flow = (6 * rng.randn(2, 2, 10, 14)).astype(np.float32)
    got = tmfn.mfn_warp(torch.from_numpy(x), torch.from_numpy(flow), clamp)
    args = [jnp.asarray(np.moveaxis(a, 1, -1)) for a in (x, flow)]
    want = nchw(compile_o0(lambda a, f: jmfn.mfn_warp(a, f, clamp),
                           *args)(*args))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert (got == 0).all(1).any() and not (got == 0).all()


def caught_first_stage(jmodel):
    """Wrap the first stage's forward on the instance so that its outputs
    of the last call are kept in the returned dict, under ``flows`` and
    ``occs``."""
    inner = jmodel.MaskFlownet_S
    forward = inner.forward
    caught = {}

    def catching(params, inputs, training=False, skip_preprocess=False):
        out = forward(params, inputs, training=training,
                      skip_preprocess=skip_preprocess)
        caught.update(flows=out["flows"], occs=out["occs"])
        return out

    inner.forward = catching
    return caught


@pytest.fixture(scope="module")
def step_result(jitted_pieces):
    """``maskflownet``'s models and batch, and the JAX package's compiled
    step run once: (loss, BatchNorm state, outputs, gradient), the outputs
    holding ``flow_preds``, ``flows`` and the first stage's ``s_flows``
    and ``s_occs``."""
    jmodel, tmodel, params = build("maskflownet", 330, HEADS)
    batch = synthetic_batch(331, h=128, w=192)
    caught = caught_first_stage(jmodel)

    def loss_and_outputs(trainable, bn_state, jbatch):
        full = jnn.merge_params(jnn.tree_copy(trainable),
                                jnn.tree_copy(bn_state))
        out = jmodel.forward(full, jbatch, training=True)
        _, new_state = jnn.split_trainable(full)
        return jmodel.loss_fn(out, jbatch), (new_state, {
            "flow_preds": out["flow_preds"], "flows": out["flows"],
            "s_flows": caught["flows"], "s_occs": caught["occs"]})

    trainable, state = jnn.split_trainable(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = compile_o0(jax.value_and_grad(loss_and_outputs, has_aux=True),
                      trainable, state, jbatch)
    (loss, (new_state, out)), grads = step(trainable, state, jbatch)
    return jmodel, tmodel, params, batch, (loss, new_state, out, grads)


def test_train_step_matches_jax_value_and_grad(step_result):
    """The five flows of the second stage within 5e-3 px, the multiscale
    EPE (each level's flow upsampled by the triangular kernel to full
    size) within 1e-5, and the whole gradient within 1e-3 of the JAX
    package's, by its largest element and by its norm; both stages', the
    deformable convolutions' weights and biases, the occlusion mask
    heads' and the first stage's context network's reach the loss.  The
    step is ill-conditioned per tensor: the port's own gradient with the
    images one float32 rounding off (x (1 + 2^-23)) moves ``conv1y``'s
    weight by 1.3e-3 of its largest element, the whole gradient by 6e-5."""
    jmodel, tmodel, _, batch, (loss, state, out, grads) = step_result
    named = assert_list_step_matches(
        tmodel, batch, jmodel, whole=True,
        step=lambda jm, b: ((loss, (state, out["flow_preds"])), grads))
    for name in ("deform6.weight", "deform2.bias",
                 "MaskFlownet_S.deform5.weight", "MaskFlownet_S.conv2f.0.bias",
                 "MaskFlownet_S.pred_mask3.weight",
                 "MaskFlownet_S.dc_conv1.0.weight", "conv1x.0.weight",
                 "dc_conv7.weight"):
        assert named[name].abs().max() > 0, name


def test_eval_forwards_match_jax(step_result):
    """``maskflownet``'s eval ``flows`` and ``maskflownet_s``'s (loaded
    with the first-stage weights) ``flows`` within 5e-3 px and ``occs``
    within 1e-4 of the JAX package's, with no autograd graph; flows of
    up to a few hundred pixels and occlusions spread over (0, 1)."""
    _, tmodel, params, batch, (_, _, out, _) = step_result
    x = {"images": torch.from_numpy(batch["images"])}
    got = tmodel(x)["flows"]
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(out["flows"]),
                               atol=5e-3)
    smodel = port_model("maskflownet_s", params["MaskFlownet_S"])
    sgot = smodel(x)
    for key, atol in (("flows", 5e-3), ("occs", 1e-4)):
        want = np.asarray(out[f"s_{key}"])
        assert sgot[key].shape == want.shape and sgot[key].grad_fn is None
        np.testing.assert_allclose(sgot[key].numpy(), want, atol=atol,
                                   err_msg=key)
    assert 1.0 < np.abs(np.asarray(out["flows"])).max() < 500.0
    occs = np.asarray(out["s_occs"])
    assert 0.0 < occs.min() and occs.max() < 1.0 and occs.std() > 1e-3


def test_state_dict_reads_back_into_jax(step_result):
    """The port's ``state_dict`` (the first stage under ``MaskFlownet_S.``)
    read by the JAX package's ``from_torch`` is the JAX tree it came
    from, leaf for leaf."""
    jmodel, _, params, _, _ = step_result
    tmodel = port_model("maskflownet", params)
    back = jmodel.from_torch({k: v.numpy()
                              for k, v in tmodel.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)
