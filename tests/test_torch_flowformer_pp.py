"""The PyTorch port's FlowFormer++ against the JAX package's on the CPU:
the eval forward, the checkpoint names, and the bf16 weight cast of
``validate --bf16`` against the JAX package's cast forward.

Weights, conditioning and the jitted JAX core as in
``tests/test_torch_flowformer.py``; this file compiles a JAX FlowFormer++
in fp32 and once more with its weights cast.
"""

import copy

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax.numpy as jnp

import ptlflow_tpu
from ptlflow_tpu import nn as jnn
from ptlflow_tpu_torch.scripts import validate as tvalidate
from tests.test_torch_flowformer import (DEPTH, build, check_eval_forward,
                                         check_reference_names, images_of,
                                         jitted_predict)


@pytest.fixture(scope="module")
def ffpp():
    return build("flowformer_pp", 91)


def test_eval_forward_matches_jax(ffpp):
    check_eval_forward(ffpp)


def test_state_dict_names_are_the_references(ffpp):
    check_reference_names("flowformer_pp", ffpp)


def test_bf16_cast_forward_matches_jax(ffpp, capsys):
    """``validate --bf16`` on ``flowformer_pp`` (provisional on the JAX
    package's allow-list): the weights stored in bfloat16, and the forward
    of float32 images computing in float32 on them, except the latent
    tokens' query path (their LayerNorm output and query projection in
    bfloat16), as the JAX cast does.  Within 5e-3 px of the JAX package's
    cast forward (1.6e-4 px on this seed; the fp32 forwards 4.4e-5 px);
    the cast moves the flow (by 0.31 px)."""
    jmodel, tmodel, _ = ffpp
    images = images_of(101)
    fp32 = tmodel({"images": torch.from_numpy(images)})["flows"]
    jcast = ptlflow_tpu.get_model_reference("flowformer_pp")(
        decoder_depth=DEPTH)
    jcast.params = jnn.cast_params(jmodel.params, jnp.bfloat16)
    want = jitted_predict(jcast).forward(jcast.params, {"images": images})
    tcast = copy.deepcopy(tmodel)
    assert tvalidate.cast_to_bf16(tcast, "flowformer_pp")
    assert "PROVISIONAL" in capsys.readouterr().out
    latent = tcast.memory_encoder.cost_perceiver_encoder.latent_tokens
    assert latent.dtype == torch.bfloat16
    assert tcast.memory_decoder.att.pos_emb.rel_ind.dtype == torch.int64
    got = tcast({"images": torch.from_numpy(images)})
    assert got["flows"].dtype == torch.float32
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    assert (got["flows"] - fp32).abs().max() > 0.1
