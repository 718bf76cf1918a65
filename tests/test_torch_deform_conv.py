"""The port's deformable convolution (``ptlflow_tpu_torch/ops/deform_conv.py``)
against the JAX package's, on the CPU: random per-tap offsets (some of
them sending samples past the map's edges, where they read zeros), its
output and the gradients of the input, the offsets, the weight and the
bias, a bfloat16 input, and torchvision's semantics where the offsets are
zero (a plain convolution)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu.ops.deform_conv import DeformConv2d as JDeformConv2d
from ptlflow_tpu.ops.deform_conv import deform_conv2d as jdeform_conv2d
from ptlflow_tpu_torch.ops.deform_conv import DeformConv2d, deform_conv2d
from ptlflow_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_train import nhwc

B, C, O, H, W = 2, 8, 6, 9, 11


def inputs(seed, k=3):
    """x, offsets (std 1.5 px; a few 20 px, past the edges), weight (O, C,
    k, k), bias and a cotangent, as numpy arrays (NCHW)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, H, W).astype(np.float32)
    off = (1.5 * rng.randn(B, 2 * k * k, H, W)).astype(np.float32)
    off[:, :, :2, :3] = 20.0 * np.sign(off[:, :, :2, :3])
    weight = (rng.randn(O, C, k, k) / np.sqrt(C * k * k)).astype(np.float32)
    bias = rng.randn(O).astype(np.float32)
    cot = rng.randn(B, O, H, W).astype(np.float32)
    return x, off, weight, bias, cot


def jax_fn(padding):
    def fn(x, off, w, b):
        return jdeform_conv2d(x, off, w, b, padding=padding)
    return fn


def to_jax(x, off, weight, bias):
    return (jnp.asarray(np.moveaxis(x, 1, -1)),
            jnp.asarray(np.moveaxis(off, 1, -1)),
            jnp.asarray(np.transpose(weight, (2, 3, 1, 0))),
            jnp.asarray(bias))


@pytest.mark.parametrize("padding", [1, 0])
def test_deform_conv_and_its_gradients_match_jax(padding):
    """3x3 taps about the pixel (padding 1, MaskFlowNet's) or below and
    right of it (padding 0): the output within 1e-4 and the gradients of x,
    the offsets, the weight and the bias under a random cotangent within
    1e-3 of each one's largest element, of the JAX package's (its per-tap
    gathers and products, differentiated by JAX)."""
    x, off, weight, bias, cot = inputs(200 + padding)
    args = to_jax(x, off, weight, bias)
    fn = jax_fn(padding)

    def vjp(*a):
        out, pull = jax.vjp(fn, *a)
        return out, pull(jnp.asarray(np.moveaxis(cot, 1, -1)))

    want, wgrads = compile_o0(vjp, *args)(*args)
    tx, toff, tw, tb = (torch.from_numpy(a).requires_grad_()
                        for a in (x, off, weight, bias))
    got = deform_conv2d(tx, toff, tw, tb, padding=padding)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4)
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                (tx, toff, tw, tb))
    wx, woff, ww, wb = (np.asarray(g) for g in wgrads)
    for g, w in ((grads[0], np.moveaxis(wx, -1, 1)),
                 (grads[1], np.moveaxis(woff, -1, 1)),
                 (grads[2], np.transpose(ww, (3, 2, 0, 1))), (grads[3], wb)):
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=1e-3 * np.abs(w).max())
    assert np.abs(np.asarray(wgrads[1])).max() > 0


def test_bf16_input_matches_jax():
    """A bfloat16 map (float32 offsets): sampled in float32, the output in
    bfloat16, within 1% of the largest output of the JAX package's
    (bfloat16 rounds to 2^-8 relative: the port sums the taps in one
    float32 product and rounds once, the JAX package rounds each tap's
    product and sums them in bfloat16)."""
    x, off, weight, bias, _ = inputs(210)
    xb = torch.from_numpy(x).bfloat16()
    args = to_jax(xb.float().numpy(), off, weight, bias)
    args = (args[0].astype(jnp.bfloat16),) + args[1:]
    want = np.asarray(compile_o0(jax_fn(1), *args)(*args)).astype(np.float32)
    got = deform_conv2d(xb, torch.from_numpy(off), torch.from_numpy(weight),
                        torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), want, atol=1e-2 * np.abs(want).max())


def test_zero_offsets_are_a_convolution():
    """torchvision's semantics: with zero offsets every tap samples its
    own pixel, zero outside, which is ``F.conv2d`` with zero padding."""
    x, off, weight, bias, _ = inputs(220)
    got = deform_conv2d(torch.from_numpy(x), torch.zeros_like(
        torch.from_numpy(off)), torch.from_numpy(weight),
        torch.from_numpy(bias))
    want = F.conv2d(torch.from_numpy(x), torch.from_numpy(weight),
                    torch.from_numpy(bias), padding=1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_module_layout_is_torchvisions():
    """``DeformConv2d`` holds torchvision's (O, C, k, k) ``weight`` and
    ``bias``: a JAX tree converts to it, the JAX package's ``from_torch``
    reads it back, and the module computes ``deform_conv2d`` with them."""
    jmod = JDeformConv2d(C, O)
    rng = np.random.RandomState(3)
    params = {"weight": rng.randn(3, 3, C, O).astype(np.float32),
              "bias": rng.randn(O).astype(np.float32)}
    tmod = DeformConv2d(C, O)
    tmod.load_state_dict(state_dict_from_jax(params, tmod), strict=True)
    assert tuple(tmod.weight.shape) == (O, C, 3, 3)
    back = jmod.from_torch({k: v.numpy() for k, v in
                            tmod.state_dict().items()})
    for key in ("weight", "bias"):
        np.testing.assert_array_equal(np.asarray(back[key]), params[key])
    x, off, *_ = inputs(230)
    x, off = torch.from_numpy(x), torch.from_numpy(off)
    torch.testing.assert_close(
        tmod(x, off), deform_conv2d(x, off, tmod.weight, tmod.bias),
        rtol=0, atol=0)
