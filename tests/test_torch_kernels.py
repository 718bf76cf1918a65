"""The lookup kernel's wrapper and build, without JAX.

The tests marked ``cuda`` hold the hand-written kernel against its plain
PyTorch version and skip where there is no card.  This file imports
nothing of JAX, so on a machine without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from ptlflow_tpu_torch.ops import correlation as corr
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
    assert cuda_build.sources() == ["corr_lookup"]
    try:
        cuda_build._nvcc()
    except RuntimeError as e:
        assert "nvcc" in str(e)
    else:
        pytest.skip("this machine has nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("radius,dtype", [(3, torch.float32),
                                          (4, torch.float32),
                                          (4, torch.bfloat16)])
def test_lookup_kernel_matches_plain_on_card(radius, dtype):
    """Hand-written kernel against its plain version, on the card: fp32 to
    1e-5; bf16 compared in fp32 to one bf16 rounding (rtol 1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    pyr, coords = _inputs(25, 1, 7, 11, 14, 22)  # Q = 77: a ragged tile
    pyr = [p.to("cuda", dtype) for p in pyr]
    coords = coords.cuda()
    before = corr.corr_lookup_kernel.launches
    got = corr.corr_pyramid_lookup(pyr, coords, radius)
    torch.cuda.synchronize()
    assert corr.corr_lookup_kernel.launches == before + 1
    want = corr.corr_pyramid_lookup_plain(pyr, coords, radius)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-5)
