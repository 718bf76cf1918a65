"""The port's NeuFlow (``neuflow``) against the JAX package's, on the CPU:
the bidirectional cross-attention with its LayerNorm post-norm and the
flow self-attention, the eval forward of frames of 120x180, which both
packages pad (replicate, both sides) to 128x192, and one train step at
64x96.

Weights are ``random_params``; the 1/8 refiner's output convolution
(``refine_s8.conv4``) is damped by 0.01: random refiners step by
thousands of pixels (4e3 px mean flows at 128x192, which float32 rounding
moves by 0.4 px), 38 px damped (1.3e-4 px).
"""

import importlib

import jax
import numpy as np
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

from tests.test_torch_flownet import assert_forward_matches, build
from tests.test_torch_flownet_train import compiled_step
from tests.test_torch_pwcnet_train import assert_list_step_matches
from tests.test_torch_train import carry_random, nhwc, synthetic_batch

# the packages re-export the class ``neuflow`` under the module's name
jneuflow = importlib.import_module("ptlflow_tpu.models.neuflow.neuflow")
tneuflow = importlib.import_module("ptlflow_tpu_torch.models.neuflow.neuflow")

DAMPED = ("refine_s8.conv4",)


def test_feature_attention_matches_jax():
    """Two cross-attention layers between two (2, 12, 4, 6) maps, each
    frame's tokens attending to the other's, then the LayerNorm (eps
    1e-6), within 1e-5 of the JAX package's; and the flow self-attention
    with the flow as values."""
    rng = np.random.RandomState(900)
    jmod = jneuflow.FeatureAttention(12, 2, post_norm=True)
    tmod = tneuflow.FeatureAttention(12, 2)
    params = carry_random(jmod, tmod, 901)
    f0, f1 = (rng.randn(2, 12, 4, 6).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda p, a, b: jmod(p, a, b))(
        params, *(nhwc(torch.from_numpy(a)) for a in (f0, f1)))
    got = tmod(torch.from_numpy(f0), torch.from_numpy(f1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-5)

    jflow = jneuflow.FlowAttention(12)
    tflow = tneuflow.FlowAttention(12)
    params = carry_random(jflow, tflow, 902)
    flow = (3 * rng.randn(2, 2, 4, 6)).astype(np.float32)
    want = jax.jit(lambda p, a, b: jflow(p, a, b))(
        params, nhwc(torch.from_numpy(f0)), nhwc(torch.from_numpy(flow)))
    got = tflow(torch.from_numpy(f0), torch.from_numpy(flow))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


def test_eval_forward_matches_jax():
    """``flows`` within 5e-3 px of the JAX package's: the backbone (both
    frames, position channels), the attentions and the global matching
    at 1/16, the merge, the 7x7 local correlation of the warped frame and
    the refiner at 1/8, the convex upsampling; no autograd graph."""
    jmodel, tmodel, _ = build("neuflow", 910, DAMPED, factor=0.01)
    images = np.random.RandomState(911).rand(1, 2, 3, 120, 180).astype(
        np.float32)
    want = assert_forward_matches(jmodel, tmodel, images)
    assert 1.0 < np.abs(np.asarray(want["flows"])).max() < 200.0


def test_train_step_matches_jax_value_and_grad():
    """One step at 64x96, batch 2: both predictions (the refined 1/8 flow
    upsampled bilinearly, the convex-upsampled one) within 5e-3 px, the
    (0.2, 1)-weighted L1 loss within 1e-5, every gradient within 1e-3 of
    its tensor's largest element and the affine-free BatchNorms'
    statistics (the backbone's, moved once a frame, and ``conv_s8``'s)
    within 1e-5."""
    jmodel, tmodel, _ = build("neuflow", 920, DAMPED, factor=0.01)
    batch = synthetic_batch(921, b=2, h=64, w=96)
    run = compiled_step(jmodel, batch)

    def step(jm, b):
        (loss, (state, out)), grads = run(jm, b)
        return (loss, (state, out["flow_preds"])), grads

    named = assert_list_step_matches(tmodel, batch, jmodel, step=step)
    for name in ("backbone.block1_1.conv1.weight",
                 "cross_attn_s16.layers.1.mlp.2.weight",
                 "flow_attn_s16.q_proj.weight", "merge_s8.2.weight",
                 "refine_s8.conv1.conv.weight", "conv_s8.conv2.weight",
                 "upsample_s1.conv3.bias"):
        assert named[name].abs().max() > 0, name
