"""The port's GANet aggregations (``models/separableflow/ganet.py``) against
the JAX package's on the CPU, at odd sizes: ``sga`` and the four NLF
directions and their chain, their gradients against ``jax.grad``, a near
tie of the SGA's maximum term, and one tiny case against literal numpy
transcriptions of the reference's CUDA kernels (GANet_kernel.cu
sga_down/up_forward, NLF_kernel.cu nlf_*_forward; copied here so that this
file stands alone).

The guidance is drawn signed and L1-normalised as the model's is, so the
transfer matrices of the NLF rows hold products of coefficients of both
signs and of size under 1."""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

jg = importlib.import_module("ptlflow_tpu.models.separableflow.ganet")
tg = importlib.import_module("ptlflow_tpu_torch.models.separableflow.ganet")


@pytest.fixture(scope="module", autouse=True)
def rolled_sga_scans():
    """The JAX package's SGA scans rolled (``unroll`` 1, not 8) while a
    module's tests compile them: the same steps in the same order,
    compiled in 27 s instead of 43 s for SeparableFlow's train step.  The
    default comes back after the module."""
    fn = jg._sga_scan_down
    before = fn.__defaults__
    fn.__defaults__ = (1,)
    yield
    fn.__defaults__ = before


# ------------------------------------------ numpy transcriptions of the CUDA
def np_sga_down(x, f):
    # x: (B, C, D, H, W); f: (B, 5, H, W)
    b, c, d_, h, w = x.shape
    out = x.copy()
    for bb in range(b):
        for cc in range(c):
            for col in range(w):
                kp = 0
                for row in range(h):
                    k = kp
                    kp = 0
                    for d in range(d_):
                        t = out[bb, cc, d, row, col] * f[bb, 0, row, col]
                        def prev(dd):
                            return out[bb, cc, dd, row - 1, col]
                        cur = x[bb, cc, d, row, col]
                        t += (prev(d) if row > 0 else cur) * f[bb, 1, row, col]
                        t += (prev(d - 1) if row > 0 and d > 0 else cur) * \
                            f[bb, 2, row, col]
                        t += (prev(d + 1) if row > 0 and d + 1 < d_ else
                              cur) * f[bb, 3, row, col]
                        t += (prev(k) if row > 0 else cur) * f[bb, 4, row, col]
                        out[bb, cc, d, row, col] = t
                        if out[bb, cc, kp, row, col] < t:
                            kp = d
    return out


def np_sga_up(x, f):
    b, c, d_, h, w = x.shape
    out = x.copy()
    for bb in range(b):
        for cc in range(c):
            for col in range(w):
                kp = 0
                for row in range(h - 1, -1, -1):
                    k = kp
                    kp = 0
                    for d in range(d_):
                        t = out[bb, cc, d, row, col] * f[bb, 0, row, col]
                        def prev(dd):
                            return out[bb, cc, dd, row + 1, col]
                        cur = x[bb, cc, d, row, col]
                        t += (prev(d) if row + 1 < h else cur) * \
                            f[bb, 1, row, col]
                        t += (prev(d - 1) if row + 1 < h and d > 0 else cur) \
                            * f[bb, 2, row, col]
                        t += (prev(d + 1) if row + 1 < h and d + 1 < d_ else
                              cur) * f[bb, 3, row, col]
                        t += (prev(k) if row + 1 < h else cur) * \
                            f[bb, 4, row, col]
                        out[bb, cc, d, row, col] = t
                        if out[bb, cc, kp, row, col] < t:
                            kp = d
    return out


def np_nlf_down(x, f):
    # x: (B, C, H, W); f: (B, 5, H, W); NLF_kernel.cu:22-78
    b, c, h, w = x.shape
    out = x.copy()
    for bb in range(b):
        for cc in range(c):
            for row in range(h):
                for col in range(w):
                    cur = out[bb, cc, row, col]
                    t = cur * f[bb, 0, row, col]
                    t += (out[bb, cc, row - 1, col] if row > 0 else cur) * \
                        f[bb, 1, row, col]
                    t += (out[bb, cc, row - 1, col - 1]
                          if row > 0 and col > 0 else cur) * \
                        f[bb, 2, row, col]
                    t += (out[bb, cc, row - 1, col + 1]
                          if row > 0 and col + 1 < w else cur) * \
                        f[bb, 3, row, col]
                    t += (out[bb, cc, row, col - 1] if col > 0 else cur) * \
                        f[bb, 4, row, col]
                    out[bb, cc, row, col] = t
    return out


def np_nlf_up(x, f):
    b, c, h, w = x.shape
    out = x.copy()
    for bb in range(b):
        for cc in range(c):
            for row in range(h - 1, -1, -1):
                for col in range(w - 1, -1, -1):
                    cur = out[bb, cc, row, col]
                    t = cur * f[bb, 0, row, col]
                    t += (out[bb, cc, row + 1, col] if row + 1 < h else cur) \
                        * f[bb, 1, row, col]
                    t += (out[bb, cc, row + 1, col - 1]
                          if row + 1 < h and col > 0 else cur) * \
                        f[bb, 2, row, col]
                    t += (out[bb, cc, row + 1, col + 1]
                          if row + 1 < h and col + 1 < w else cur) * \
                        f[bb, 3, row, col]
                    t += (out[bb, cc, row, col + 1] if col + 1 < w else cur) \
                        * f[bb, 4, row, col]
                    out[bb, cc, row, col] = t
    return out


def np_nlf_right(x, f):
    b, c, h, w = x.shape
    out = x.copy()
    for bb in range(b):
        for cc in range(c):
            for col in range(w):
                for row in range(h):
                    cur = out[bb, cc, row, col]
                    t = cur * f[bb, 0, row, col]
                    t += (out[bb, cc, row, col - 1] if col > 0 else cur) * \
                        f[bb, 1, row, col]
                    t += (out[bb, cc, row - 1, col - 1]
                          if col > 0 and row > 0 else cur) * \
                        f[bb, 2, row, col]
                    t += (out[bb, cc, row + 1, col - 1]
                          if col > 0 and row + 1 < h else cur) * \
                        f[bb, 3, row, col]
                    t += (out[bb, cc, row - 1, col] if row > 0 else cur) * \
                        f[bb, 4, row, col]
                    out[bb, cc, row, col] = t
    return out


def np_nlf_left(x, f):
    b, c, h, w = x.shape
    out = x.copy()
    for bb in range(b):
        for cc in range(c):
            for col in range(w - 1, -1, -1):
                for row in range(h - 1, -1, -1):
                    cur = out[bb, cc, row, col]
                    t = cur * f[bb, 0, row, col]
                    t += (out[bb, cc, row, col + 1] if col + 1 < w else cur) \
                        * f[bb, 1, row, col]
                    t += (out[bb, cc, row - 1, col + 1]
                          if col + 1 < w and row > 0 else cur) * \
                        f[bb, 2, row, col]
                    t += (out[bb, cc, row + 1, col + 1]
                          if col + 1 < w and row + 1 < h else cur) * \
                        f[bb, 3, row, col]
                    t += (out[bb, cc, row + 1, col] if row + 1 < h else cur) \
                        * f[bb, 4, row, col]
                    out[bb, cc, row, col] = t
    return out


def guidance(rng, b, h, w):
    """(b, 5, h, w) signed weights, L1-normalised over the 5."""
    g = rng.randn(b, 5, h, w).astype(np.float32)
    return g / np.abs(g).sum(1, keepdims=True)


def positive_guidance(rng, b, h, w):
    g = rng.rand(b, 5, h, w).astype(np.float32) + 0.1
    return g / g.sum(1, keepdims=True)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["nlf_down", "nlf_up", "nlf_right",
                                  "nlf_left"])
def test_nlf_directions_match_jax(name):
    """(2, 3, 5, 7) volumes: within 1e-5 of the JAX package's direction."""
    rng = np.random.RandomState(70 + len(name))
    x = rng.randn(2, 3, 5, 7).astype(np.float32)
    g = guidance(rng, 2, 5, 7)
    want = np.asarray(jax.jit(getattr(jg, name))(jnp.asarray(x),
                                                 jnp.asarray(g)))
    got = getattr(tg, name)(t(x), t(g))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_nlf_iter_and_sga_match_jax():
    """The NLF chain on (2, 4, 6, 9) and SGA on (2, 3, 7, 5, 6): within
    1e-5 of the JAX package's."""
    rng = np.random.RandomState(75)
    gs = [guidance(rng, 2, 6, 9) for _ in range(4)]
    x = rng.randn(2, 4, 6, 9).astype(np.float32)
    want = np.asarray(jax.jit(jg.nlf_iter)(jnp.asarray(x),
                                           *map(jnp.asarray, gs)))
    got = tg.nlf_iter(t(x), *map(t, gs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    gs = [guidance(rng, 2, 5, 6) for _ in range(4)]
    x = rng.randn(2, 3, 7, 5, 6).astype(np.float32)
    want = np.asarray(jax.jit(jg.sga)(jnp.asarray(x), *map(jnp.asarray, gs)))
    got = tg.sga(t(x), *map(t, gs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_transfer_matrices_are_the_recurrence():
    """M[t, s] = prod_{s<u<=t} f4[u] below the diagonal, 1 on it, 0 above;
    with zeros and negatives among the coefficients, no division."""
    f4 = torch.tensor([[0.5, -0.25, 0.0, 0.75, -1.0]])
    m = tg.transfer_matrices(f4)[0]
    for i in range(5):
        for j in range(5):
            want = float(np.prod(f4[0, j + 1:i + 1].numpy())) if j <= i \
                else 0.0
            assert m[i, j].item() == pytest.approx(want, abs=1e-7), (i, j)


def test_ganet_matches_cuda_transcriptions():
    """One tiny case of each against the numpy transcriptions of the
    reference's kernels: the four NLF directions, their chain and SGA."""
    rng = np.random.RandomState(76)
    x = rng.randn(1, 2, 4, 5).astype(np.float32)
    gs = [positive_guidance(rng, 1, 4, 5) for _ in range(4)]
    for fn, oracle in ((tg.nlf_down, np_nlf_down), (tg.nlf_up, np_nlf_up),
                       (tg.nlf_right, np_nlf_right),
                       (tg.nlf_left, np_nlf_left)):
        np.testing.assert_allclose(fn(t(x), t(gs[0])).numpy(),
                                   oracle(x, gs[0]), atol=1e-5)
    want = np_nlf_left(np_nlf_right(np_nlf_up(np_nlf_down(
        x, gs[0]), gs[1]), gs[2]), gs[3])
    np.testing.assert_allclose(tg.nlf_iter(t(x), *map(t, gs)).numpy(), want,
                               atol=1e-5)
    x5 = rng.randn(1, 2, 5, 4, 5).astype(np.float32)
    down, up = np_sga_down(x5, gs[0]), np_sga_up(x5, gs[1])
    xt = x5.transpose(0, 1, 2, 4, 3)
    right = np_sga_down(xt, gs[2].transpose(0, 1, 3, 2))
    left = np_sga_up(xt, gs[3].transpose(0, 1, 3, 2))
    want = np.maximum(np.maximum(down, up), np.maximum(
        right, left).transpose(0, 1, 2, 4, 3))
    np.testing.assert_allclose(tg.sga(t(x5), *map(t, gs)).numpy(), want,
                               atol=1e-5)


def sga_and_nlf_grads_jax(x5, x4, gs, w5, w4):
    def loss(x5, x4, g0, g1, g2, g3):
        return (jnp.sum(jg.sga(x5, g0, g1, g2, g3) * w5)
                + jnp.sum(jg.nlf_iter(x4, g0, g1, g2, g3) * w4))

    return jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        jnp.asarray(x5), jnp.asarray(x4), *map(jnp.asarray, gs))


def test_gradients_match_jax_grad():
    """The gradients of a weighted sum of ``sga`` (2, 3, 6, 5, 7) and
    ``nlf_iter`` (2, 4, 5, 7) outputs with respect to both volumes and all
    four guidance maps: within 1e-4 of ``jax.grad``'s largest element, by
    tensor.  Row 2 of the SGA volume holds a near tie of its maximum term
    (two bins 1e-4 apart): the gradient goes to the larger bin alone, as
    the JAX package's argmax gather sends it."""
    rng = np.random.RandomState(77)
    gs = [guidance(rng, 2, 5, 7) for _ in range(4)]
    x5 = rng.randn(2, 3, 6, 5, 7).astype(np.float32)
    x5[:, :, 2, 1] = 3.0
    x5[:, :, 4, 1] = 3.0 + 1e-4
    x4 = rng.randn(2, 4, 5, 7).astype(np.float32)
    w5 = rng.randn(*x5.shape).astype(np.float32)
    w4 = rng.randn(*x4.shape).astype(np.float32)
    want = sga_and_nlf_grads_jax(x5, x4, gs, w5, w4)
    leaves = [t(a).requires_grad_() for a in (x5, x4, *gs)]
    loss = ((tg.sga(leaves[0], *leaves[2:]) * t(w5)).sum()
            + (tg.nlf_iter(leaves[1], *leaves[2:]) * t(w4)).sum())
    got = torch.autograd.grad(loss, leaves)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-4 * np.abs(b).max(), err_msg=i)


def test_sga_maximum_sends_its_gradient_to_one_bin():
    """An exact tie of the maximum term in one row: the gradient of the
    next row's value reaches the first tied bin only (``torch.max``'s
    index), not half of it each (``amax``'s split)."""
    x = torch.zeros(1, 1, 3, 2, 1)
    x[0, 0, :, 0, 0] = torch.tensor([1.0, 1.0, 0.0])
    x.requires_grad_()
    g = torch.zeros(1, 5, 2, 1)
    g[:, 4] = 1.0  # only the maximum term
    up = torch.zeros(1, 5, 2, 1)
    up[:, 0] = 1.0  # only the value itself
    out = tg.sga(x, g, up, up, up)
    out[0, 0, 2, 1, 0].backward()
    assert x.grad[0, 0, :, 0, 0].tolist() == [1.0, 0.0, 0.0]
