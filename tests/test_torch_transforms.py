"""The PyTorch port's augmentations against the JAX package's, on the CPU:
the numpy pipeline (a copy) equal to the bit under the same ``random`` and
``np.random`` seeds, the warping ops within 1e-5, the forward-backward
occlusion masks equal wherever the check is not within 1e-5 of its
threshold, and ``DeviceCompose`` on the CPU (torch) against the JAX
package's jitted ``DeviceCompose`` fed the same ``random`` seed: images
within 1e-5, flows within 1e-4 px, binary masks equal.  The noise field is
drawn from another generator in each package, so the noise step is
compared by its statistics.
"""

import random

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu.data import device_transforms as jdt
from ptlflow_tpu.data import transforms as jft
from ptlflow_tpu.ops import warp as jwarp
from ptlflow_tpu_torch.data import device_transforms as tdt
from ptlflow_tpu_torch.data import transforms as tft
from ptlflow_tpu_torch.ops import warp as twarp


def sample(seed, n=2, h=32, w=40, sparse=False, backward=False):
    """A sample in the datasets' layout (``tests/data/test_transforms.py``):
    images in [0, 1], flows of a few px, binary valids and occlusions."""
    rng = np.random.RandomState(seed)
    d = {"images": rng.rand(n, 3, h, w).astype(np.float32),
         "flows": (5 * rng.randn(n - 1, 2, h, w)).astype(np.float32),
         "valids": np.ones((n - 1, 1, h, w), np.float32),
         "occs": np.zeros((n - 1, 1, h, w), np.float32)}
    if sparse:
        d["valids"] = (rng.rand(n - 1, 1, h, w) > 0.5).astype(np.float32)
    if backward:
        d["flows_b"] = (5 * rng.randn(n - 1, 2, h, w)).astype(np.float32)
    return d


def nhwc(a):
    return jnp.asarray(np.moveaxis(np.asarray(a), 1, -1))


# ------------------------------------------------------ numpy pipeline
# (name, builder over a transforms module, sample kwargs): every class of
# the copy, the cases of tests/data/test_transforms.py
TRANSFORMS = [
    ("resize", lambda T: T.Compose([T.ToTensor(), T.Resize((48, 56))]), {}),
    ("resize_sparse", lambda T: T.Resize((48, 56), sparse=True),
     {"sparse": True}),
    ("scale_crop", lambda T: T.RandomScaleAndCrop(
        (24, 32), (-0.2, 0.5), (-0.1, 0.1)), {}),
    ("scale_crop_sparse", lambda T: T.RandomScaleAndCrop(
        (24, 32), (0.0, 0.3), (0.0, 0.0), sparse=True), {"sparse": True}),
    ("center_crop", lambda T: T.CenterCrop((20, 30)), {}),
    ("flip", lambda T: T.RandomFlip(0.5, 0.5), {}),
    ("jitter", lambda T: T.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.5), {}),
    ("noise", lambda T: T.GaussianNoise(0.05), {}),
    ("eraser_mean", lambda T: T.RandomPatchEraser(
        1.0, ((5, 15), (5, 15)), 3, "mean"), {}),
    ("eraser_random", lambda T: T.RandomPatchEraser(
        1.0, ((5, 15), (5, 15)), 3, "random"), {}),
    ("translate", lambda T: T.RandomTranslate(5), {"n": 3}),
    ("rotate", lambda T: T.RandomRotate(10.0, 3.0), {"n": 3}),
    ("rotate_sparse", lambda T: T.RandomRotate(10.0, 3.0, sparse=True),
     {"n": 3}),
]


@pytest.mark.parametrize("name,build,kw", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transform_matches_jax(name, build, kw):
    """Three draws of each transform, the same seeds in both packages:
    every output array equal to the bit."""
    jt, tt = build(jft), build(tft)
    for trial in range(3):
        outs = []
        for t in (jt, tt):
            random.seed(trial)
            np.random.seed(trial)
            outs.append(t(sample(trial, **kw)))
        want, got = outs
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------ warping
def test_backward_warp_and_fb_check_match_jax():
    """Flows reaching past every border: the warped image and its mask
    within 1e-5 of the JAX package's, the occlusion check equal where the
    check is not within 1e-5 of its threshold."""
    rng = np.random.RandomState(7)
    img = rng.rand(2, 3, 21, 34).astype(np.float32)
    fw = (6 * rng.randn(2, 2, 21, 34)).astype(np.float32)
    bw = (6 * rng.randn(2, 2, 21, 34)).astype(np.float32)
    want, want_mask = jax.jit(jwarp.backward_warp, static_argnums=2)(
        nhwc(img), nhwc(fw), True)
    got, mask = twarp.backward_warp(torch.from_numpy(img),
                                    torch.from_numpy(fw), return_mask=True)
    assert got.shape == img.shape and mask.shape == (2, 1, 21, 34)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1),
                               np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mask[:, 0].numpy(), np.asarray(want_mask))
    assert 0 < mask.mean() < 1
    occ = twarp.fb_check(torch.from_numpy(fw), torch.from_numpy(bw))
    np.testing.assert_allclose(
        occ[:, 0].numpy(),
        np.asarray(jax.jit(jwarp.fb_check)(nhwc(fw), nhwc(bw)))[..., 0],
        rtol=0, atol=1e-5)
    assert 0 < occ.mean() < 1


def test_fb_check_occlusion_matches_jax():
    """``GenerateFBCheckFlowOcclusion``: a backward flow that undoes the
    forward one up to noise, so the check lands on both sides of its
    threshold; both masks equal the JAX package's wherever
    |fw + bw(warped)| is more than 1e-5 from the threshold."""
    d = sample(8, h=24, w=32, backward=True)
    rng = np.random.RandomState(8)
    d["flows"] = (2 * rng.randn(1, 2, 24, 32)).astype(np.float32)
    d["flows_b"] = -d["flows"] + rng.uniform(-1, 1, (1, 2, 24, 32)).astype(
        np.float32)
    want = jft.GenerateFBCheckFlowOcclusion(1.0)(dict(d))
    got = tft.GenerateFBCheckFlowOcclusion(1.0)(dict(d))
    for occ_key, f, b in (("occs", "flows", "flows_b"),
                          ("occs_b", "flows_b", "flows")):
        warped = jax.jit(jwarp.backward_warp)(nhwc(d[b]), nhwc(d[f]))
        diff = np.linalg.norm(np.asarray(nhwc(d[f]) + warped), axis=-1)
        clear = np.abs(diff - 1.0) > 1e-5
        assert got[occ_key].shape == want[occ_key].shape == (1, 1, 24, 32)
        assert got[occ_key].dtype == np.float32
        np.testing.assert_array_equal(got[occ_key][:, 0][clear],
                                      want[occ_key][:, 0][clear])
        assert 0 < got[occ_key].mean() < 1


# ------------------------------------------------------ DeviceCompose
def pipeline(T, recipe):
    """The datamodule's chairs and sintel_finetune (dense part) recipes
    without their noise step, patch sizes cut to the small test frames."""
    major = {"chairs": (-0.1, 1.0), "sintel_finetune": (-0.2, 0.6)}[recipe]
    return T.Compose([
        T.RandomScaleAndCrop((64, 96), major, (-0.2, 0.2)),
        T.ColorJitter(0.4, 0.4, 0.4, 0.5 / 3.14, 0.2),
        T.RandomPatchEraser(0.5, ((10, 30), (10, 30)), 3, "mean"),
        T.RandomFlip(0.5, 0.1)])


@pytest.mark.parametrize("recipe", ["chairs", "sintel_finetune"])
def test_device_compose_matches_jax(recipe):
    """Eight samples at 96x128 cropped to 64x96, whose draws take every
    branch (asymmetric jitter, the eraser, both flips): images within 1e-5,
    flows within 1e-4 px, valids and occlusions equal."""
    jdev = jdt.DeviceCompose.from_compose(pipeline(jft, recipe))
    tdev = tdt.DeviceCompose.from_compose(pipeline(tft, recipe),
                                          device="cpu")
    assert tdev.steps == jdev.steps
    taken = set()
    for trial in range(8):
        d = sample(trial, h=96, w=128)
        random.seed(trial)
        rnd = tdev._draw_randoms(d)
        taken |= {"asym"} if rnd[5] < 0.2 else set()
        taken |= {"eraser"} if rnd[5 + 13] < 0.5 else set()
        taken |= {"hflip"} if rnd[-2] < 0.5 else set()
        taken |= {"vflip"} if rnd[-1] < 0.1 else set()
        random.seed(trial)
        want = jdev(dict(d))
        random.seed(trial)
        got = tdev(dict(d))
        assert sorted(got) == sorted(want)
        for k in want:
            g = got[k].numpy()
            assert g.shape == want[k].shape and g.dtype == want[k].dtype, k
            if k == "images":
                np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-5)
            elif k == "flows":
                np.testing.assert_allclose(g, want[k], rtol=0, atol=1e-4)
            else:
                np.testing.assert_array_equal(g, want[k], err_msg=k)
    assert taken == {"asym", "eraser", "hflip", "vflip"}, taken


def test_device_compose_noise_statistics():
    """The noise step alone after an identity-sized crop: on a flat 0.5
    image the noise's empirical std is within 5% of the drawn scale times
    the stdev, and near the ends of [0, 1] the output stays clamped to
    it."""
    compose = tft.Compose([tft.RandomScaleAndCrop((64, 96), (0.0, 0.0),
                                                  (0.0, 0.0)),
                           tft.GaussianNoise(0.02)])
    dev = tdt.DeviceCompose.from_compose(compose, device="cpu")
    d = sample(9, h=64, w=96)
    d["images"][:] = 0.5
    random.seed(9)
    draw = dev._draw_randoms(d)[5]
    random.seed(9)
    out = dev(dict(d))["images"]
    want = float(draw) * 0.02
    assert want > 1e-3
    np.testing.assert_allclose((out - 0.5).std().item(), want, rtol=0.05)
    loud = tdt.DeviceCompose.from_compose(tft.Compose([
        tft.RandomScaleAndCrop((64, 96), (0.0, 0.0), (0.0, 0.0)),
        tft.GaussianNoise(5.0)]), device="cpu")
    d["images"][:, :, :32] = 0.02
    d["images"][:, :, 32:] = 0.98
    random.seed(1)
    out = loud(dict(d))["images"]
    assert out.min() == 0.0 and out.max() == 1.0
    assert ((out > 0) & (out < 1)).any()


REFUSALS = [
    ("sparse", lambda T: [T.RandomScaleAndCrop((32, 32), (0, 0), (0, 0),
                                               sparse=True)]),
    ("fbocc", lambda T: [T.RandomScaleAndCrop((32, 32), (0, 0), (0, 0)),
                         T.GenerateFBCheckFlowOcclusion(1.0)]),
    ("random_eraser", lambda T: [
        T.RandomScaleAndCrop((32, 32), (0, 0), (0, 0)),
        T.RandomPatchEraser(0.5, ((5, 9), (5, 9)), 3, "random")]),
    ("many_patches", lambda T: [
        T.RandomScaleAndCrop((32, 32), (0, 0), (0, 0)),
        T.RandomPatchEraser(0.5, ((5, 9), (5, 9)), 9, "mean")]),
    ("no_crop", lambda T: [T.Resize((32, 32))]),
    ("chairs", lambda T: [T.ToTensor()] + pipeline(T, "chairs").transforms
     + [T.GaussianNoise(0.02)]),
]


@pytest.mark.parametrize("name,members", REFUSALS,
                         ids=[r[0] for r in REFUSALS])
def test_from_compose_refuses_what_jax_refuses(name, members):
    want = jdt.DeviceCompose.from_compose(jft.Compose(members(jft)))
    got = tdt.DeviceCompose.from_compose(tft.Compose(members(tft)),
                                         device="cpu")
    assert (got is None) == (want is None) == (name != "chairs")
    if got is not None:
        assert got.steps == want.steps and got.crop == want.crop


def test_device_compose_bf16_images():
    """``out_dtype`` (the datamodule's train_transform_fp16) makes the
    images bfloat16 and leaves flows and masks in float32."""
    dev = tdt.DeviceCompose.from_compose(pipeline(tft, "chairs"),
                                         out_dtype=torch.bfloat16,
                                         device="cpu")
    random.seed(0)
    out = dev(sample(0, h=96, w=128))
    assert out["images"].dtype == torch.bfloat16
    assert out["flows"].dtype == out["valids"].dtype == torch.float32
