"""The port's HD3 (``hd3``, ``hd3_ctxt``) against the JAX package's, on the
CPU: ``vector2density`` and ``density2vector`` (an exact tie between two
2x2 cells included), the DLA-34 encoder with its IDA upsampling, the eval
forwards of both names at 128x192, and ``hd3``'s train step in two parts:
the DLA encoder's backward against ``jax.vjp`` and the rest of the step
against ``jax.value_and_grad``.

``hd3`` and ``hd3_ctxt`` differ only in the finest level's decoder: one
draw of ``hd3``'s tree serves both, ``hd3_ctxt`` taking a drawn context
head as its ``Decoder_4``, and one compilation computes both forwards
(XLA computes the shared trunk once); the encoder's pyramid is caught
inside it (``caught_encoder``).  The JAX package's grouped transposed
convolutions trace one convolution per channel (1,824 in DLA-34's IDA
upsampling at ``hd3``'s widths), and a train step through them compiles
for ~3 minutes.  So the DLA encoder's training forward and backward are
held alone at an eighth of its widths, and the step runs ``hd3`` with the
``encoder="vgg"`` option: the VGG pyramid takes the same decoders,
densities, warps, ``cost_bn`` and KL loss through ``jax.value_and_grad``
in ~20 s.

Weights are ``random_params``; the density heads are damped by 0.1
(``HEADS``).  BatchNorm statistics are random, so the eval forwards use
them as a trained model's would.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

import ptlflow_tpu
from ptlflow_tpu import nn as jnn
from ptlflow_tpu.models.hd3.dla import DLAEncoder as JDLAEncoder
from ptlflow_tpu_torch.models.hd3.dla import DLAEncoder
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_flownet import build, port_model
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_pwcnet_train import assert_list_step_matches
from tests.test_torch_train import nchw, nhwc, random_params, synthetic_batch

jhd3 = importlib.import_module("ptlflow_tpu.models.hd3.hd3")
thd3 = importlib.import_module("ptlflow_tpu_torch.models.hd3.hd3")

HEADS = ("*cls.2",)
# DLA-34's widths, an eighth of ``hd3``'s (16, 32, 64, 128, 256, 512, 512)
NARROW_PLANES = (2, 4, 8, 16, 32, 64, 64)


@pytest.mark.parametrize("c", [4, 1])
def test_vector2density_matches_jax(c):
    """Flows inside, on and past the support's edge (+-c, whole cells
    included) scattered into the (2c+1)^2 cells within 1e-6 of the JAX
    package's one-hot sums; each pixel's density sums to 1."""
    rng = np.random.RandomState(400 + c)
    flow = (1.5 * c * rng.randn(2, 2, 6, 7)).astype(np.float32)
    flow[:, :, 0, :3] = np.array([-c, 0, c], np.float32)
    flow[:, :, 1, :2] = np.array([c + 3, -c - 0.5], np.float32)
    flow[:, :, 2, :2] = np.round(flow[:, :, 2, :2])
    got = thd3.vector2density(torch.from_numpy(flow), c)
    jf = jnp.asarray(np.moveaxis(flow, 1, -1))
    want = nchw(compile_o0(lambda f: jhd3.vector2density(f, c), jf)(jf))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got.sum(1), torch.ones(2, 6, 7), rtol=0,
                               atol=1e-6)


def test_density2vector_matches_jax_with_an_exact_tie():
    """Random logits (softmax) and probabilities given as they are
    (``normalize=False``): flows within 1e-6 of the JAX package's.  Two
    pixels hold an exact tie between two 2x2 cells (and a uniform density,
    where every cell ties): both packages take the first cell, the
    argmax's first index, so the flow is that cell's."""
    d = 9
    rng = np.random.RandomState(410)
    logits = (3 * rng.randn(2, d * d, 5, 6)).astype(np.float32)
    probs = np.zeros((1, d * d, 1, 3), np.float32)
    # pixel 0: 1/4 at (2, 2), (2, 3), (6, 5) and (7, 5): the 2x2 cells
    # whose top-left corner is (1, 2), (2, 2), (6, 4) or (6, 5) each sum to
    # exactly 1/2; pixel 1: a uniform density; pixel 2: all at (0, 7)
    for y, x in ((2, 2), (2, 3), (6, 5), (7, 5)):
        probs[0, y * d + x, 0, 0] = 0.25
    probs[0, :, 0, 1] = 1.0 / (d * d)
    probs[0, 0 * d + 7, 0, 2] = 1.0
    for arr, normalize in ((logits, True), (probs, False)):
        got = thd3.density2vector(torch.from_numpy(arr), normalize)
        ja = jnp.asarray(np.moveaxis(arr, 1, -1))
        want = nchw(compile_o0(
            lambda p: jhd3.density2vector(p, normalize), ja)(ja))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # the first cell of the tie, top-left (1, 2): its right column is x =
    # 3 - 4, less the left corners' 1/2; its bottom row y = 2 - 4, less the
    # top corners' 0; the uniform density: the first cell, (0, 0)
    flows = got[0, :, 0].numpy()
    np.testing.assert_allclose(flows[:, 0], [-1.5, -2.0], atol=1e-6)
    np.testing.assert_allclose(flows[:, 1], [-3.5, -3.5], atol=1e-6)


def caught_encoder(jmodel):
    """Wrap the encoder's call on the JAX model so that its last pyramid is
    kept in the returned list."""
    encoder = jmodel.encoder
    call = type(encoder).__call__
    caught = []

    class Catching(type(encoder)):
        def __call__(self, params, x, **kw):
            caught[:] = call(self, params, x, **kw)
            return caught[:]

    encoder.__class__ = Catching
    return caught


@pytest.fixture(scope="module")
def both_names():
    """``hd3`` and ``hd3_ctxt`` from one draw, their eval forwards of one
    128x192 pair and the DLA pyramid computed by one compilation."""
    jmodel, tmodel, params = build("hd3", 420, HEADS)
    jctxt = ptlflow_tpu.get_model_reference("hd3_ctxt")()
    head = random_params(jax.eval_shape(jctxt.Decoder_4.init,
                                        jax.random.PRNGKey(0)),
                         np.random.RandomState(421))
    head["cls"] = {k: v * 0.1 for k, v in head["cls"].items()}
    ctxt_params = dict(params, Decoder_4=head)
    caught = caught_encoder(jmodel)
    images = np.random.RandomState(422).rand(1, 2, 3, 128, 192).astype(
        np.float32)

    def forwards(p, ctxt_head, x):
        inputs = {"images": x}
        out = jmodel.forward(p, inputs)["flows"]
        pyramid = list(caught)
        return (out, jctxt.forward(dict(p, Decoder_4=ctxt_head),
                                   inputs)["flows"], pyramid)

    args = (jmodel.params, jax.tree_util.tree_map(jnp.asarray, head),
            jnp.asarray(images))
    want = compile_o0(forwards, *args)(*args)
    tctxt = port_model("hd3_ctxt", ctxt_params)
    return tmodel, tctxt, images, want


def test_dla_encoder_matches_jax(both_names):
    """DLA-34's trees and IDA upsampling (the channel-wise transposed
    convolutions among them): the six maps, 1/2 to 1/64 of both frames,
    within 1e-4 of the largest element of each of the JAX package's."""
    tmodel, _, images, (_, _, pyramid) = both_names
    x = torch.from_numpy(images)
    frames, _ = tmodel.preprocess(x)
    with torch.no_grad():
        got = tmodel.encoder(torch.cat([frames[:, 0], frames[:, 1]]))
    assert [tuple(g.shape[1:]) for g in got] == [
        (32, 64, 96), (64, 32, 48), (128, 16, 24), (256, 8, 12),
        (512, 4, 6), (512, 2, 3)]
    for g, w in zip(got, pyramid):
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(g), w, atol=1e-4 * np.abs(w).max())


def test_eval_forwards_match_jax(both_names):
    """``hd3``'s and ``hd3_ctxt``'s ``flows`` within 5e-3 px of the JAX
    package's, with no autograd graph: five levels of densities, warps
    with border padding, the argmax's cells and the x4 upsampling."""
    tmodel, tctxt, images, (want, want_ctxt, _) = both_names
    for model, w in ((tmodel, want), (tctxt, want_ctxt)):
        got = model({"images": torch.from_numpy(images)})["flows"]
        assert got.shape == w.shape and got.grad_fn is None
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-3)
    assert np.abs(np.asarray(want) - np.asarray(want_ctxt)).max() > 0.1


def test_dla_encoder_backward_matches_jax_vjp():
    """DLA-34 with its IDA upsampling in training mode, at an eighth of
    ``hd3``'s widths, one 128x192 pair: the six maps within 1e-4 of each
    one's largest element, the input's and every parameter's gradient
    (Tree, Root, the BatchNorms, the grouped transposed convolutions, from
    a random cotangent on each map) within 1e-3 of each tensor's largest
    element, and the BatchNorm statistics within 1e-4 of each tensor's
    largest (the 1/64 level's variance is over 12 values: the two
    packages' float32 sums put it 1.5e-5 apart), against ``jax.vjp`` of the
    JAX package's encoder, compiled once.  Narrow, since the JAX package's grouped transposed convolutions
    trace one convolution per channel and their backward compiles ~20 ms
    a channel (1,824 channels at ``hd3``'s widths).  At a quarter of the
    widths this draw is ill-conditioned: the port's own float32 gradient
    is 9.1e-2 of its largest element off its float64 one in one tensor."""
    rng = np.random.RandomState(440)
    jenc = JDLAEncoder(NARROW_PLANES)
    params = random_params(jax.eval_shape(jenc.init, jax.random.PRNGKey(0)),
                           rng)
    x = rng.randn(2, 128, 192, 3).astype(np.float32)
    trainable, state = jnn.split_trainable(
        jax.tree_util.tree_map(jnp.asarray, params))

    def encode(trainable, x):
        full = jnn.merge_params(jnn.tree_copy(trainable),
                                jnn.tree_copy(state))
        pyramid = jenc(full, x, training=True)
        return pyramid, jnn.split_trainable(full)[1]

    shapes = jax.eval_shape(encode, trainable, x)[0]
    cotangents = [rng.randn(*m.shape).astype(np.float32) for m in shapes]

    def forward_and_vjp(trainable, x, cotangents):
        pyramid, vjp, new_state = jax.vjp(encode, trainable, x,
                                          has_aux=True)
        return pyramid, vjp(cotangents), new_state

    args = (trainable, jnp.asarray(x), [jnp.asarray(c) for c in cotangents])
    pyramid, (jgrads, jgx), jstate = compile_o0(forward_and_vjp,
                                                *args)(*args)
    tenc = DLAEncoder(NARROW_PLANES).train()
    tenc.load_state_dict(state_dict_from_jax(params, tenc), strict=True)
    tx = nchw(x).requires_grad_()
    got = tenc(tx)
    for g, w in zip(got, pyramid):
        w = np.asarray(w)
        np.testing.assert_allclose(nhwc(g.detach()), w,
                                   atol=1e-4 * np.abs(w).max())
    names, tparams = zip(*tenc.named_parameters())
    grads = torch.autograd.grad(got, (tx, *tparams),
                                [nchw(c) for c in cotangents],
                                allow_unused=True)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads),
                               tenc)
    want["input"] = nchw(np.asarray(jgx))
    # levels 3 and 4 project their input for a residual that their first
    # subtree is not given, in the reference as in both packages
    unused = {f"base.level{i}.project.{leaf}" for i in (3, 4)
              for leaf in ("0.weight", "1.weight", "1.bias")}
    for name, p, g in zip(("input", *names), (tx, *tparams), grads):
        assert (g is None) == (name in unused), name
        g = torch.zeros_like(p) if g is None else g
        w = want[name]
        assert (w.abs().max() > 0) == (name not in unused), name
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-3 * w.abs().max().item(),
                                   msg=lambda m, n=name: f"{n}: {m}")
    want_stats = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), tenc)
    for name, v in tenc.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            w = want_stats[name]
            torch.testing.assert_close(v, w, rtol=0,
                                       atol=1e-4 * w.abs().max().item(),
                                       msg=lambda m, n=name: f"{n}: {m}")


@pytest.fixture(scope="module")
def vgg_step():
    """``hd3`` with ``encoder="vgg"`` and a 128x192 batch of 2."""
    jmodel, tmodel, params = build("hd3", 430, HEADS, encoder="vgg")
    return jmodel, tmodel, params, synthetic_batch(431, h=128, w=192)


def test_train_step_matches_jax_value_and_grad(vgg_step):
    """The five levels' densities (``ms_prob``) and flows (``ms_pred``)
    within 5e-3, the KL loss within 1e-5, the whole gradient within 1e-3
    (by its largest element and by its norm) and the BatchNorm statistics
    within 1e-5 of the JAX package's; the encoder's, each level's decoder
    and ``cost_bn``, the upsampling features' transposed convolutions
    reach the loss.  The step is ill-conditioned per tensor: the port's
    own gradient with the images one float32 rounding off (x (1 +
    2^-23)) moves ``Decoder_2.up.2``'s weight by 4.0e-3 of its largest
    element, the whole gradient by 8.8e-5."""
    jmodel, tmodel, _, batch = vgg_step

    def loss_and_outputs(trainable, bn_state, jbatch):
        full = jnn.merge_params(jnn.tree_copy(trainable),
                                jnn.tree_copy(bn_state))
        out = jmodel.forward(full, jbatch, training=True)
        _, new_state = jnn.split_trainable(full)
        return jmodel.loss_fn(out, jbatch), (new_state, (out["ms_prob"],
                                                         out["ms_pred"]))

    trainable, state = jnn.split_trainable(jmodel.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, (new_state, preds)), grads = compile_o0(
        jax.value_and_grad(loss_and_outputs, has_aux=True), trainable,
        state, jbatch)(trainable, state, jbatch)
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with torch.no_grad():
        out = tmodel({k: torch.from_numpy(v) for k, v in batch.items()},
                     training=True)
    tmodel.load_state_dict(start, strict=True)
    for key, want in zip(("ms_prob", "ms_pred"), preds):
        for g, w in zip(out[key], want):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=5e-3,
                                       err_msg=key)
    named = assert_list_step_matches(
        tmodel, batch, jmodel, keys=(), whole=True,
        step=lambda jm, b: ((loss, (new_state, None)), grads))
    for name in ("encoder.block_0.conv1.weight", "cost_bn_0.weight",
                 "Decoder_0.up.2.weight", "Decoder_4.mapping.root.2.weight",
                 "Decoder_2.cls.2.bias", "encoder.block_5.bn3.bias"):
        assert named[name].abs().max() > 0, name


def test_state_dict_reads_back_into_jax(vgg_step):
    """The port's ``state_dict`` read by the JAX package's ``from_torch``
    is the JAX tree it came from, leaf for leaf."""
    jmodel, _, params, _ = vgg_step
    tmodel = port_model("hd3", params, encoder="vgg")
    back = jmodel.from_torch({k: v.numpy()
                              for k, v in tmodel.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)
