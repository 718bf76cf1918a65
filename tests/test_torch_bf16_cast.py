"""The port's bf16 paths for models without a mixed-precision mode, against
the JAX package's scripts, on the CPU.

``infer --bf16`` on such a model casts every weight to bfloat16 and leaves
the images float32, as the JAX ``infer.py`` (:116-124) does with
``cast_params`` (no allow-list); every layer then casts its weights to its
input's dtype, so the forward computes in float32 on bf16-rounded weights.
``model_benchmark --datatypes bf16`` stays the model's mixed-precision
mode in the port and refuses a model without one, where the JAX
``model_benchmark.py`` (:147-152) casts weights and images for every
model: its bfloat16 coords meet the port's lookup, which takes float32
coords only (ROADMAP.md, section 3).  Weights are drawn and conditioned as
``tests/test_torch_skflow.py`` says (``dpflow``'s as
``tests/test_torch_rapidflow.py`` says, ``craft``'s as
``tests/test_torch_craft.py`` says).
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu import nn as jnn
from ptlflow_tpu_torch.ops import correlation as tcorr
from ptlflow_tpu_torch.scripts import infer as tinfer
from ptlflow_tpu_torch.scripts import model_benchmark as tbench
from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
from ptlflow_tpu_torch.utils import flow_io, image_io
from ptlflow_tpu_torch.utils.io_adapter import IOAdapter
from tests import test_torch_craft, test_torch_rapidflow
from tests.test_torch_recurrent_pyramid_train import DP_TRAIN
from tests.test_torch_skflow import H, ITERS, build


def test_infer_bf16_casts_a_model_without_mixed_mode_as_jax(tmp_path):
    """``infer --bf16`` of ``skflow`` (2 iterations, 64x96) from a
    checkpoint: the flow it writes within 5e-3 px of the JAX package's
    forward with ``cast_params(params, bfloat16)`` on float32 images, and
    off the float32 forward by more than that (the cast took place).  The
    float32 forward is the port's, which the parity tests hold within
    1e-4 px of the JAX package's: one JAX compilation, not two."""
    jmodel, tmodel, _ = build("skflow", 160, iters=ITERS)
    ckpt = tmp_path / "skflow.ckpt"
    torch.save({"state_dict": tmodel.state_dict()}, ckpt)
    rng = np.random.RandomState(160)
    frames = [rng.randint(0, 256, (H, 96, 3), dtype=np.uint8)
              for _ in range(2)]
    paths = [tmp_path / f"frame_{k}.png" for k in range(2)]
    for p, f in zip(paths, frames):
        image_io.imwrite(p, f)
    out = tmp_path / "out"
    written = tinfer.infer(tinfer._parse_args(
        ["--model", "skflow", "--device", "cpu", "--ckpt_path", str(ckpt),
         "--set", f"model.init_args.iters={ITERS}", "--bf16",
         "--input_path", *map(str, paths), "--output_path", str(out)]))
    assert [p.name for p in written] == ["frame_0.flo"]
    got = flow_io.read_flo(written[0])

    images = IOAdapter(device="cpu").prepare_inputs(frames)["images"]
    forward = jax.jit(lambda p, x: jmodel.forward(p, x))
    x = {"images": jnp.asarray(images.numpy())}
    want = np.asarray(forward(jnn.cast_params(jmodel.params, jnp.bfloat16),
                              x)["flows"])[0, 0].transpose(1, 2, 0)
    fp32 = tmodel({"images": images})["flows"][0, 0].numpy().transpose(
        1, 2, 0)
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert np.abs(got - fp32).max() > 5e-3


def test_model_benchmark_bf16_is_the_mixed_mode():
    """``model_benchmark``'s bf16 row is the model's mixed-precision mode
    (``raft``: bf16 weights, fp32 coords) and refuses ``skflow`` and
    ``memflow``, which have none; the port's lookup refuses the bf16 coords
    that the JAX script's cast of the images would give."""
    row = tbench.benchmark_one("raft", "bf16", (32, 48), 1, 1,
                               torch.device("cpu"), num_trials=1, warmup=0)
    assert row["datatype"] == "bf16"
    for name, refusal in (("skflow", "fp32 only"),
                          ("memflow", "no mixed-precision mode")):
        with pytest.raises(ValueError, match=refusal):
            tbench.benchmark_one(name, "bf16", (32, 48), 1, 1,
                                 torch.device("cpu"), num_trials=1, warmup=0)
    pyramid = tcorr.build_corr_pyramid(torch.randn(1, 8, 4, 6),
                                       torch.randn(1, 8, 4, 6), 2)
    coords = tcorr.coords_grid(1, 4, 6, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        tcorr.make_corr_lookup(pyramid, 1)(coords)


def test_validate_bf16_cast_of_dpflow_matches_jax():
    """``validate --bf16`` of ``dpflow`` (on the allow-list: its weights
    cast to bf16, each layer casting them back to its fp32 input's dtype)
    at 64x96, at ``DP_TRAIN``'s narrow widths: the flow within 5e-3 px of
    the JAX package's forward with ``cast_params(params, bfloat16)``, and
    off the fp32 forward (the port's, as in the ``infer`` test) by more
    than that (the cast took place)."""
    jmodel, tmodel, _ = test_torch_rapidflow.build("dpflow", 161, **DP_TRAIN)
    images = test_torch_rapidflow.images_of(161)
    x = {"images": jnp.asarray(images)}
    forward = jax.jit(lambda p, x: jmodel.forward(p, x))
    want = np.asarray(forward(jnn.cast_params(jmodel.params, jnp.bfloat16),
                              x)["flows"])
    fp32 = tmodel({"images": torch.from_numpy(images)})["flows"].numpy()
    assert cast_to_bf16(tmodel, "dpflow")
    assert tmodel.fnet.up_gru.weight.dtype == torch.bfloat16
    got = tmodel({"images": torch.from_numpy(images)})["flows"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    assert np.abs(got.numpy() - fp32).max() > 5e-3


def test_validate_bf16_cast_of_craft_matches_jax():
    """``validate --bf16`` of ``craft`` (on the allow-list) at 64x96, 2
    iterations: the weights cast to bf16, the sliding positional biases
    and input-skip coefficients among them, each layer computing in the
    fp32 images' dtype; the flow within 5e-3 px of the JAX package's
    forward with ``cast_params(params, bfloat16)``, and off the fp32
    forward (the port's, as in the ``infer`` test) by more than that (the
    cast took place)."""
    jmodel, tmodel, _ = test_torch_craft.build(162, iters=2)
    images = np.random.RandomState(162).rand(1, 2, 3, 64, 96).astype(
        np.float32)
    x = {"images": jnp.asarray(images)}
    forward = jax.jit(lambda p, x: jmodel.forward(p, x))
    want = np.asarray(forward(jnn.cast_params(jmodel.params, jnp.bfloat16),
                              x)["flows"])
    fp32 = tmodel({"images": torch.from_numpy(images)})["flows"].numpy()
    assert cast_to_bf16(tmodel, "craft")
    pos = tmodel.corr_fn.vispos_encoder.pos_coder.biases
    assert pos.dtype == torch.bfloat16
    assert tmodel.update_block.aggregator.input_skip_coeff.dtype == \
        torch.bfloat16
    got = tmodel({"images": torch.from_numpy(images)})["flows"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
    assert np.abs(got.numpy() - fp32).max() > 5e-3
