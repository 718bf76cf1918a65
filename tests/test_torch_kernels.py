"""The lookup kernels' wrappers and build, without JAX.

The tests marked ``cuda`` hold the hand-written kernels (the lookup and its
backward) against their plain PyTorch versions, and ``softsplat_average``
on the card against the CPU, and skip where there is no card.  This file
imports
nothing of JAX, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

from ptlflow_tpu_torch.models.csflow.csflow import CSFlowCorrBlock
from ptlflow_tpu_torch.models.memfof.memfof import MemfofCorrBlock
from ptlflow_tpu_torch.ops import correlation as corr
from ptlflow_tpu_torch.ops.warp import softsplat_average
from ptlflow_tpu_torch.utils import cuda_build


def _inputs(seed, b, h1, w1, h2, w2, c=16, levels=4, lo=-0.3, hi=1.3):
    """Pyramid from random features, and coords from ``lo`` to ``hi`` of
    the map's size: in-range, fractional and out-of-range points."""
    rng = np.random.RandomState(seed)
    f1 = torch.from_numpy(rng.randn(b, c, h1, w1).astype(np.float32))
    f2 = torch.from_numpy(rng.randn(b, c, h2, w2).astype(np.float32))
    u = torch.from_numpy(rng.rand(b, 2, h1, w1).astype(np.float32))
    size = torch.tensor([w2, h2], dtype=torch.float32).view(1, 2, 1, 1)
    return (corr.build_corr_pyramid(f1, f2, levels),
            (lo + (hi - lo) * u) * size)


def test_lookup_on_cpu_takes_plain_path():
    pyr, coords = _inputs(23, 1, 4, 6, 8, 12, levels=3)
    before = corr.corr_lookup_kernel.launches
    out = corr.corr_pyramid_lookup(pyr, coords, 3)
    torch.testing.assert_close(
        out, corr.corr_pyramid_lookup_plain(pyr, coords, 3), rtol=0, atol=0)
    assert corr.corr_lookup_kernel.launches == before
    with pytest.raises(ValueError):
        corr.corr_lookup_kernel(pyr, coords, 3)  # the kernel wants CUDA


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepared_lookup_on_cpu_is_plain(dtype):
    """make_corr_lookup on a CPU pyramid is the plain version, exactly, on
    every call, and launches no kernel."""
    pyr, coords = _inputs(26, 2, 3, 5, 7, 9, levels=4)
    pyr = [p.to(dtype) for p in pyr]
    before = corr.corr_lookup_kernel.launches
    lookup = corr.make_corr_lookup(pyr, 4)
    for shift in (0.0, 1.25, -3.5):
        c = coords + shift
        torch.testing.assert_close(
            lookup(c), corr.corr_pyramid_lookup_plain(pyr, c, 4),
            rtol=0, atol=0)
    assert corr.corr_lookup_kernel.launches == before
    with pytest.raises(ValueError):  # coords of another query count
        lookup(coords[:, :, :2])


def test_lookup_rejects_bad_inputs():
    pyr, coords = _inputs(24, 1, 4, 6, 8, 12, levels=3)
    with pytest.raises(TypeError):
        corr.corr_pyramid_lookup(pyr, coords.double(), 3)
    with pytest.raises(TypeError):
        corr.corr_pyramid_lookup([p.half() for p in pyr], coords, 3)
    with pytest.raises(ValueError):
        corr.corr_pyramid_lookup(pyr, coords[:, :, :2], 3)
    with pytest.raises(ValueError):
        corr.corr_pyramid_lookup(pyr, coords, corr.MAX_RADIUS + 1)
    with pytest.raises(ValueError):
        corr.make_corr_lookup(pyr * 3, 3)  # 9 levels


def test_plain_lookup_window_order():
    """Channel a*n + b samples (x + a - r, y + b - r): on a map whose value
    is 100*y + x, an integer query reads back its window's coordinates."""
    h2, w2, r = 6, 8, 1
    ys, xs = torch.meshgrid(torch.arange(h2), torch.arange(w2),
                            indexing="ij")
    lvl = (100 * ys + xs).float()[None]  # Q = 1
    coords = torch.tensor([3.0, 2.0]).view(1, 2, 1, 1)  # x = 3, y = 2
    out = corr.corr_pyramid_lookup_plain([lvl], coords, r).view(3, 3)
    want = torch.tensor([[100 * (2 + b) + (3 + a) for b in (-1, 0, 1)]
                         for a in (-1, 0, 1)], dtype=torch.float32)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_build_needs_nvcc():
    """Where the toolkit is missing, building says so instead of failing
    later on a missing library."""
    assert cuda_build.sources() == ["corr_lookup", "corr_lookup_backward"]
    try:
        cuda_build._nvcc()
    except RuntimeError as e:
        assert "nvcc" in str(e)
    else:
        pytest.skip("this machine has nvcc")


def _card_cases(radius):
    """(label, pyramid, coords) on the CPU for the kernel-vs-plain test:
    ragged tiles, odd map widths (bf16 rows at odd 2-byte offsets), an
    empty level, one query, a prime Q, and coords far outside the map."""
    cases = [("Q=77, odd W2", _inputs(25, 1, 7, 11, 14, 23)),
             ("Q=37, W2=125", _inputs(27, 1, 1, 37, 9, 125, levels=3)),
             ("Q=1", _inputs(28, 1, 1, 1, 8, 13)),
             ("batch 2, 5x5 maps, empty level", _inputs(29, 2, 5, 5, 5, 5))]
    pyr, coords = _inputs(30, 1, 3, 6, 10, 15)
    far = torch.tensor([1e7, -1e7, 3.5, -2.5e6, 2.5])
    coords[0, 0, 0, :5] = far  # x of the first row of queries
    coords[0, 1, 1, :5] = far.flip(0)  # y of the second
    cases.append(("coords at +-1e7", (pyr, coords)))
    assert cases[3][1][0][-1].numel() == 0
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [0, 1, 3, 4, 8])
def test_lookup_kernel_matches_plain_on_card(radius, dtype):
    """Hand-written kernel against its plain version, on the card: fp32 to
    1e-5; bf16 compared in fp32 to one bf16 rounding (rtol 1e-2).  The
    one-shot call and the prepared lookup both launch the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, (pyr, coords) in _card_cases(radius):
        pyr = [p.to("cuda", dtype) for p in pyr]
        coords = coords.cuda()
        before = corr.corr_lookup_kernel.launches
        got = corr.corr_pyramid_lookup(pyr, coords, radius)
        again = corr.make_corr_lookup(pyr, radius)(coords)
        torch.cuda.synchronize()
        assert corr.corr_lookup_kernel.launches == before + 2, label
        torch.testing.assert_close(again, got, rtol=0, atol=0)
        want = corr.corr_pyramid_lookup_plain(pyr, coords, radius)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5,
                                       msg=label)
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                       atol=1e-5, msg=label)


def _shapes(pyr):
    return [tuple(p.shape[1:]) for p in pyr]


def test_lookup_backward_plain_is_the_transpose():
    """The backward's plain version is the transpose of the plain lookup:
    it matches autograd through it (fp32, 1e-5) and launches no kernel;
    the kernel's wrapper refuses CPU tensors."""
    pyr, coords = _inputs(31, 2, 4, 5, 9, 11, levels=4)
    levels = [p.clone().requires_grad_() for p in pyr]
    out = corr.corr_pyramid_lookup_plain(levels, coords, 3)
    grad = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(out, levels, grad, allow_unused=True,
                               materialize_grads=True)
    before = corr.corr_lookup_backward_kernel.launches
    got = corr.corr_pyramid_lookup_backward_plain(grad, coords, _shapes(pyr),
                                                  3)
    assert corr.corr_lookup_backward_kernel.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        corr.corr_lookup_backward_kernel(grad, coords, _shapes(pyr), 3)
    with pytest.raises(ValueError):  # grad_out of another radius
        corr.corr_pyramid_lookup_backward_plain(grad, coords, _shapes(pyr), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("radius", [0, 1, 3, 4, 8])
def test_lookup_backward_kernel_matches_plain_on_card(radius, dtype):
    """The backward kernel against its plain version, on the card: fp32 to
    1e-5 of the largest gradient; bf16 compared in fp32 to one bf16
    rounding (rtol 1e-2).  Two launches give the same bits, and autograd
    through a prepared lookup launches the forward and backward kernels
    once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(radius)
    for label, (pyr, coords) in _card_cases(radius):
        pyr = [p.to("cuda", dtype) for p in pyr]
        coords = coords.cuda()
        n = len(pyr) * (2 * radius + 1) ** 2
        b, _, h1, w1 = coords.shape
        grad = torch.randn(b, n, h1, w1, generator=gen).to("cuda", dtype)
        before = corr.corr_lookup_backward_kernel.launches
        got = corr.corr_lookup_backward_kernel(grad, coords, _shapes(pyr),
                                               radius)
        again = corr.corr_lookup_backward_kernel(grad, coords, _shapes(pyr),
                                                 radius)
        torch.cuda.synchronize()
        assert corr.corr_lookup_backward_kernel.launches == before + 2
        want = corr.corr_pyramid_lookup_backward_plain(grad, coords,
                                                       _shapes(pyr), radius)
        for g, a, w in zip(got, again, want):
            assert g.dtype == dtype and g.shape == w.shape, label
            torch.testing.assert_close(a, g, rtol=0, atol=0)
            if dtype == torch.float32:
                wmax = w.abs().max().item() if w.numel() else 0.0
                tol = 1e-5 * max(wmax, 1.0)
                torch.testing.assert_close(g, w, rtol=0, atol=tol, msg=label)
            else:
                torch.testing.assert_close(g.float(), w.float(), rtol=1e-2,
                                           atol=1e-5, msg=label)
        levels = [p.detach().requires_grad_() for p in pyr]
        fwd = corr.corr_lookup_kernel.launches
        bwd = corr.corr_lookup_backward_kernel.launches
        out = corr.make_corr_lookup(levels, radius)(coords)
        auto = torch.autograd.grad(out, levels, grad)
        assert corr.corr_lookup_kernel.launches == fwd + 1
        assert corr.corr_lookup_backward_kernel.launches == bwd + 1
        for g, a in zip(got, auto):
            torch.testing.assert_close(a, g, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(1, 55, 128), (2, 46, 62)])
def test_flowformer_shaped_lookup_on_card(b, h, w):
    """FlowFormer's lookup: one level holding each pixel's whole (H1, W1)
    cost map, r = 4, at the eval shape of a 1024x436 pair (Q = 55*128) and
    the training shape of two 368x496 crops (Q = 2*46*62).  The kernel
    within 1e-5 of its plain version; the backward within 1e-5 of the
    largest gradient, bitwise repeatable, and autograd through the
    prepared lookup launches each kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    pyr, coords = _inputs(40 + h, b, h, w, h, w, c=256, levels=1, lo=-0.1,
                          hi=1.1)
    pyr = [p.cuda() for p in pyr]
    coords = coords.cuda()
    got = corr.make_corr_lookup(pyr, 4)(coords)
    assert got.shape == (b, 81, h, w)
    torch.testing.assert_close(
        got, corr.corr_pyramid_lookup_plain(pyr, coords, 4), rtol=0,
        atol=1e-5)
    grad = torch.randn(got.shape, generator=torch.Generator().manual_seed(h)
                       ).cuda()
    first = corr.corr_lookup_backward_kernel(grad, coords, _shapes(pyr), 4)
    again = corr.corr_lookup_backward_kernel(grad, coords, _shapes(pyr), 4)
    want = corr.corr_pyramid_lookup_backward_plain(grad, coords,
                                                   _shapes(pyr), 4)
    torch.testing.assert_close(again[0], first[0], rtol=0, atol=0)
    tol = 1e-5 * max(want[0].abs().max().item(), 1.0)
    torch.testing.assert_close(first[0], want[0], rtol=0, atol=tol)
    levels = [pyr[0].detach().requires_grad_()]
    fwd = corr.corr_lookup_kernel.launches
    bwd = corr.corr_lookup_backward_kernel.launches
    auto = torch.autograd.grad(corr.make_corr_lookup(levels, 4)(coords),
                               levels, grad)
    assert corr.corr_lookup_kernel.launches == fwd + 1
    assert corr.corr_lookup_backward_kernel.launches == bwd + 1
    torch.testing.assert_close(auto[0], first[0], rtol=0, atol=0)


@pytest.mark.parametrize("radius", [1, 4])
def test_coords_gradient_on_cpu_is_autograd_of_plain(radius):
    """``make_corr_lookup(..., coords_grad=True)`` on the CPU: autograd of
    the plain version gives the coords a gradient, and
    :func:`lookup_coords_grad` (four one-level lookups a level, the card's
    way) gives the same within 1e-5 of its largest element; without
    ``coords_grad`` coords that need a gradient raise."""
    pyr, coords = _inputs(50 + radius, 2, 5, 7, 6, 9, levels=3)
    coords.requires_grad_()
    out = corr.make_corr_lookup(pyr, radius, coords_grad=True)(coords)
    grad = torch.randn(out.shape,
                       generator=torch.Generator().manual_seed(radius))
    (want,) = torch.autograd.grad(out, coords, grad)
    got = corr.lookup_coords_grad(
        lambda lv, c: corr.corr_pyramid_lookup_plain(lv, c, radius), pyr,
        coords.detach(), grad, radius)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * want.abs().max().item())
    with pytest.raises(ValueError, match="detach the coords"):
        corr.make_corr_lookup(pyr, radius)(coords)


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [1, 4])
def test_coords_gradient_on_card_matches_plain(radius):
    """On the card, a lookup prepared with ``coords_grad`` gives the coords
    and the levels the gradients of autograd through the plain version on
    the CPU (1e-5 of the largest), launching the backward kernel once and
    the forward kernel once plus four times a level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    pyr, coords = _inputs(60 + radius, 2, 5, 7, 6, 9, levels=3)
    grad = torch.randn(2, 3 * (2 * radius + 1) ** 2, 5, 7,
                       generator=torch.Generator().manual_seed(radius))
    want = []
    for dev in ("cpu", "cuda"):
        levels = [p.to(dev).requires_grad_() for p in pyr]
        c = coords.to(dev).requires_grad_()
        fwd = corr.corr_lookup_kernel.launches
        bwd = corr.corr_lookup_backward_kernel.launches
        out = corr.make_corr_lookup(levels, radius, coords_grad=True)(c)
        got = [g.cpu() for g in torch.autograd.grad(out, [c] + levels,
                                                    grad.to(dev))]
        if dev == "cpu":
            want = got
            continue
        assert corr.corr_lookup_kernel.launches == fwd + 1 + 4 * 3
        assert corr.corr_lookup_backward_kernel.launches == bwd + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(
                g, w, rtol=0, atol=1e-5 * max(w.abs().max().item(), 1.0))


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_at_memfof_and_csflow_shapes_on_card():
    """Both kernels on MEMFOF's re-correlated levels (a 17x30 map: 17x30,
    8x15, 4x7, 2x3) and on CSFlow's two pyramids (the product and a strip
    volume of a 6x10 map, down to an empty level), on the card, against
    their plain versions: the lookup within 1e-5, its backward within 1e-5
    of the largest gradient."""
    dev = _card_or_skip()
    rng = np.random.RandomState(86)

    def maps(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)

    def coords(b, h, w):
        c = (rng.rand(b, 2, h, w) * 1.6 - 0.3) * np.array(
            [w, h])[None, :, None, None]
        return torch.from_numpy(c.astype(np.float32)).to(dev)

    memfof = MemfofCorrBlock(maps(1, 64, 17, 30), maps(1, 64, 17, 30), 4, 4)
    cs = CSFlowCorrBlock(maps(2, 32, 6, 10), maps(2, 32, 6, 10),
                         maps(2, 6, 10, 1, 6, 10), 4, 4)
    cases = [(memfof.pyramid, coords(1, 17, 30))]
    cases += [(p, coords(2, 6, 10)) for p in cs.pyramids]
    for pyr, c in cases:
        got = corr.corr_lookup_kernel(pyr, c, 4)
        want = corr.corr_pyramid_lookup_plain(pyr, c, 4)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        shapes = _shapes(pyr)
        grad = torch.randn_like(got)
        live = [(a, b) for a, b in zip(
            corr.corr_lookup_backward_kernel(grad, c, shapes, 4),
            corr.corr_pyramid_lookup_backward_plain(grad, c, shapes, 4))
            if b.numel()]
        gmax = max(b.abs().max().item() for _, b in live)
        for a, b in live:
            assert (a - b).abs().max().item() <= 1e-5 * gmax


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flowseek_t", "gmflownet"])
def test_lookup_at_flowseek_and_gmflownet_calls_on_card(name):
    """The lookup as FlowSeek and GMFlowNet prepare it, on their pyramids
    of a 1024x436 pair (a 55x128 map, Q = 7040, 4 levels, r = 4): FlowSeek
    builds the levels from 384-channel features pooled (``CorrBlock``'s
    pyramid), GMFlowNet pools its float32 all-pairs volume
    (``pool_volume_pyramid``).  The kernel within 1e-5 of its plain
    version, the backward (GMFlowNet's train step) within 1e-5 of the
    largest gradient."""
    dev = _card_or_skip()
    rng = np.random.RandomState(87)
    f1, f2 = (torch.from_numpy(rng.randn(1, 384, 55, 128).astype(
        np.float32) / 20).to(dev) for _ in range(2))
    if name == "flowseek_t":
        pyr = corr.build_corr_pyramid(f1, f2, 4)
    else:
        volume = corr.all_pairs_correlation(f1, f2)
        pyr = corr.pool_volume_pyramid(volume.reshape(55 * 128, 55, 128), 4)
    c = torch.from_numpy(((rng.rand(1, 2, 55, 128) * 1.4 - 0.2) * np.array(
        [128, 55])[None, :, None, None]).astype(np.float32)).to(dev)
    before = corr.corr_lookup_kernel.launches
    got = corr.make_corr_lookup(pyr, 4)(c)
    assert corr.corr_lookup_kernel.launches == before + 1
    assert got.shape == (1, 324, 55, 128)
    torch.testing.assert_close(got, corr.corr_pyramid_lookup_plain(pyr, c, 4),
                               rtol=0, atol=1e-5)
    grad = torch.randn_like(got)
    shapes = _shapes(pyr)
    want = corr.corr_pyramid_lookup_backward_plain(grad, c, shapes, 4)
    gmax = max(w.abs().max().item() for w in want)
    for a, b in zip(corr.corr_lookup_backward_kernel(grad, c, shapes, 4),
                    want):
        assert (a - b).abs().max().item() <= 1e-5 * gmax


@pytest.mark.cuda
def test_softsplat_average_on_card_matches_cpu():
    """SplatFlow's splat of 128 channels at its 1/8 KITTI shape (47x156)
    on the card against the CPU: within 1e-5 (float atomics add in no
    fixed order)."""
    dev = _card_or_skip()
    rng = np.random.RandomState(88)
    x = torch.from_numpy(rng.randn(1, 128, 47, 156).astype(np.float32))
    flow = torch.from_numpy((3 * rng.randn(1, 2, 47, 156)).astype(
        np.float32))
    want = softsplat_average(x, flow)
    got = softsplat_average(x.to(dev), flow.to(dev)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
