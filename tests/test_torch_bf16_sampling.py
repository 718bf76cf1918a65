"""The port's bilinear sampling of reduced-precision images, and the bf16
casts that reach it, against the JAX package's, on the CPU.

``ops/grid_sample.py::bilinear_sampler`` normalises the coords in float32
and samples a bfloat16 image in float32, casting only the output, as the
JAX package's ``grid_sample`` does.  ``infer --bf16`` casts every weight
(VideoFlow-MOF's motion state among them, which it samples each step);
``validate --bf16`` casts the allow-listed models' weights
(``scripts/validate.py::cast_to_bf16``), each layer computing in its fp32
input's dtype.  Weights are drawn and conditioned as
``tests/test_torch_videoflow.py``, ``tests/test_torch_memfof.py`` and
``tests/test_torch_csflow.py`` say.
"""

import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax.numpy as jnp

from ptlflow_tpu import nn as jnn
from ptlflow_tpu.ops.grid_sample import bilinear_sampler as jsampler
from ptlflow_tpu_torch.ops.grid_sample import bilinear_sampler
from ptlflow_tpu_torch.scripts import infer as tinfer
from ptlflow_tpu_torch.utils import flow_io, image_io
from ptlflow_tpu_torch.utils.io_adapter import IOAdapter
from tests import test_torch_videoflow
from tests.test_torch_train import nhwc


def test_bilinear_sampler_of_a_bf16_image_matches_jax():
    """A 4-channel 436x1024 bf16 image sampled at 4,096 random in-range
    float32 coords (with the in-frame mask): bf16 out, no NaN, within one
    bf16 rounding (2^-8 relative) of the JAX package's sampler, and the
    mask equal to its."""
    rng = np.random.RandomState(140)
    img = torch.from_numpy(rng.randn(1, 4, 436, 1024).astype(
        np.float32)).bfloat16()
    coords = (rng.rand(1, 2, 64, 64) * np.array([1023, 435])[
        None, :, None, None]).astype(np.float32)
    got, mask = bilinear_sampler(img, torch.from_numpy(coords), mask=True)
    assert got.dtype == torch.bfloat16 and mask.dtype == torch.float32
    got = got.float()
    assert not torch.isnan(got).any()
    jimg = jnp.asarray(nhwc(img)).astype(jnp.bfloat16)
    want, jmask = jsampler(jimg, jnp.asarray(np.moveaxis(coords, 1, -1)),
                           mask=True)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(nhwc(got), want, rtol=2 ** -8, atol=1e-6)
    np.testing.assert_array_equal(mask.numpy()[:, 0], np.asarray(jmask))


def test_infer_bf16_of_videoflow_mof_matches_jax(tmp_path):
    """``infer --bf16`` of ``videoflow_mof`` (2 decoder steps, 64x96) from a
    checkpoint, on a pair: finite, and within 1e-2 px of the JAX
    package's forward with ``cast_params(params, bfloat16)``, which moves
    the flow by more than 0.1 px off the float32 forward.  The first
    step's motion state is bfloat16 in both, and its bf16 operations
    round in another order: the port is 7.8e-3 px from the JAX package's
    forward, jitted or eager (those two part by 8.5e-4 px), where the cast
    moves the flow by 0.15 px."""
    jmodel, forward, tmodel, _ = test_torch_videoflow.build(
        "videoflow_mof", 141, decoder_depth=2)
    ckpt = tmp_path / "mof.ckpt"
    torch.save({"state_dict": tmodel.state_dict()}, ckpt)
    rng = np.random.RandomState(141)
    frames = [rng.randint(0, 256, (64, 96, 3), dtype=np.uint8)
              for _ in range(2)]
    paths = [tmp_path / f"frame_{k}.png" for k in range(2)]
    for p, f in zip(paths, frames):
        image_io.imwrite(p, f)
    written = tinfer.infer(tinfer._parse_args(
        ["--model", "videoflow_mof", "--device", "cpu", "--ckpt_path",
         str(ckpt), "--set", "model.init_args.decoder_depth=2", "--bf16",
         "--input_path", *map(str, paths), "--output_path",
         str(tmp_path / "out")]))
    got = flow_io.read_flo(written[0])
    images = IOAdapter(device="cpu").prepare_inputs(frames)["images"]
    x = {"images": jnp.asarray(images.numpy())}
    want = np.asarray(forward(jnn.cast_params(jmodel.params, jnp.bfloat16),
                              x)["flows"])[0, 0].transpose(1, 2, 0)
    fp32 = np.asarray(forward(jmodel.params, x)["flows"])[0, 0].transpose(
        1, 2, 0)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert np.abs(want - fp32).max() > 0.1
