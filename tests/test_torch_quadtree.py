"""The PyTorch port's quadtree attention (MatchFlow's matching encoder)
against the JAX package's, on the CPU: ``QuadtreeAttention`` over a 3-level
pyramid, ``LocalFeatureTransformer``'s self and cross layers and the sine
positions with the train/eval rescale.

Weights are ``random_params`` carried by ``state_dict_from_jax``; inputs
come from numpy seeds.  The top-k selections may list equal scores in
another order than ``lax.top_k``; the next level reads only the set, so the
messages are compared, not the indices.
"""

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu.models.matchflow import quadtree as jqt
from ptlflow_tpu_torch.models.matchflow import quadtree as tqt
from tests.test_torch_train import carry_random

# an 8x12 map pools to 4x6 and 2x3: the coarse level's 6 tokens, then 24
# and 32 candidates a query group
H, W = 8, 12


def tokens(seed, b=2, c=32):
    return np.random.RandomState(seed).randn(b, H * W, c).astype(np.float32)


@pytest.mark.parametrize("topks", [(16, 8, 8), (4, 3, 2)])
def test_quadtree_attention_matches_jax(topks):
    """Width 32, 4 heads, 3 levels; the registered top-k (16, 8, 8: the
    coarse level keeps all 6 tokens) and (4, 3, 2), where each finer level
    sees a strict subset: the message within 1e-5 of the JAX package's,
    and the levels' blend reaches every level."""
    jmod = jqt.QuadtreeAttention(32, 4, list(topks), scale=3)
    tmod = tqt.QuadtreeAttention(32, 4, list(topks), scale=3)
    params = carry_random(jmod, tmod, 70)
    x, t = tokens(71), tokens(72)
    want = np.asarray(jax.jit(lambda p, a, b: jmod(p, a, b, H, W))(
        params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(t), H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.abs(want).max() > 0.1


def test_local_feature_transformer_matches_jax():
    """Two self/cross layer pairs at width 64 (8 heads), the cross layers
    updating both frames from the old pair: both outputs within 1e-5 of
    the JAX package's."""
    names = ["self", "cross"] * 2
    jmod = jqt.LocalFeatureTransformer(names, d_model=64)
    tmod = tqt.LocalFeatureTransformer(names, d_model=64)
    params = carry_random(jmod, tmod, 73)
    f0, f1 = tokens(74, c=64), tokens(75, c=64)
    want = jax.jit(lambda p, a, b: jmod(p, a, b, H, W))(
        params, jnp.asarray(f0), jnp.asarray(f1))
    with torch.no_grad():
        got = tmod(torch.from_numpy(f0), torch.from_numpy(f1), H, W)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert not np.allclose(np.asarray(want[0]), np.asarray(want[1]))


@pytest.mark.parametrize("scale", [(1.0, 1.0), (368 / 436, 496 / 1024)])
def test_sine_positions_match_jax(scale):
    """The 256-channel positions of a 55x128 map, plain and rescaled by a
    368x496 training size at 436x1024: equal to the JAX package's (both
    numpy float32, NCHW here, NHWC there)."""
    got = tqt.sine_pos_encoding(256, 55, 128, *scale)
    want = jqt.sine_pos_encoding(256, 55, 128, *scale)
    assert got.dtype == np.float32 and got.shape == (1, 256, 55, 128)
    np.testing.assert_array_equal(got, np.moveaxis(want, -1, 1))
