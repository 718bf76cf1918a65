"""The port's IRR models (``irr_pwcnet``, ``irr_pwcnet_irr``, ``irr_pwc``,
``scopeflow``) against the JAX package's, on the CPU: the eval forwards of
``irr_pwcnet`` and ``irr_pwcnet_irr`` at 128x128 (the smallest input whose
1/64 level is 2x2: at 1x1 the warp's normalisation divides by zero, in the
JAX package as in the reference), ScopeFlow's double rescale of its
context flows, and the two losses on fixed predictions (``irr_pwc``'s and
``scopeflow``'s eval forwards: ``tests/test_torch_irr_train.py``).

Weights are ``random_params``, carried into the port by
``state_dict_from_jax`` and loaded strictly; ``condition`` damps the flow
estimators' and context networks' output convolutions by 0.1 (0.02 for
the weight-shared estimator), the occlusion ones by 0.02: random dense
estimators otherwise give flows of 1e4 px at 64x96.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax.numpy as jnp

from tests.test_torch_pwcnet import build, compile_o0
from tests.test_torch_train import nchw

jirr = importlib.import_module("ptlflow_tpu.models.irr.irr")
tirr = importlib.import_module("ptlflow_tpu_torch.models.irr.irr")

H = W = 128


def condition(params, factor=0.1, occ_factor=0.02):
    """Scale, in place, the last convolution of every flow estimator and
    context network by ``factor``, and of the occlusion ones and the
    occlusion upsampler by ``occ_factor``: the random occlusion branch
    otherwise grows its logits ~10x a level, to 1e5 at the last.  A logit
    past ~16 saturates the sigmoid at 1.0 in float32, where the JAX
    package's jitted F1 loss takes log(0) (XLA adds the 1e-8 to the 1
    first)."""
    convs = []
    for est_name, ctx_name, f in (
            ("flow_estimators", "context_networks", factor),
            ("occ_estimators", "occ_context_networks", occ_factor)):
        if est_name not in params:
            continue
        ests = params[est_name]
        convs += [(est["conv_last"]["0"], f) for est in (
            [ests] if "conv_last" in ests else ests.values())]
        convs.append((params[ctx_name]["convs"]["6"]["0"], f))
    if "occ_shuffle_upsample" in params:
        convs.append((params["occ_shuffle_upsample"]["out_convs"]["0"],
                      occ_factor))
    for conv, f in convs:
        for leaf in ("weight", "bias"):
            conv[leaf] = conv[leaf] * f


# the weight-shared estimator runs at every level on its own output
FACTORS = {"irr_pwcnet_irr": 0.02}


def build_irr(name, seed):
    factor = FACTORS.get(name, 0.1)
    return build(name, seed, damped=(),
                 prepare=lambda p: condition(p, factor))


@pytest.mark.parametrize("name", ["irr_pwcnet", "irr_pwcnet_irr"])
def test_eval_forward_matches_jax(name):
    """``flows`` within 5e-3 px of the JAX package's, no autograd graph.
    ``irr_pwc``'s and ``scopeflow``'s eval forwards are held in
    ``tests/test_torch_irr_train.py``, on the compilation of the train
    step."""
    jmodel, tmodel, _ = build_irr(name, 110)
    images = np.random.RandomState(111).rand(1, 2, 3, H, W).astype(
        np.float32)
    x = jnp.asarray(images)
    want = compile_o0(lambda p, x: jmodel.forward(p, {"images": x}),
                      jmodel.params, x)(jmodel.params, x)
    got = tmodel({"images": torch.from_numpy(images)})
    assert got["flows"].grad_fn is None
    assert got["flows"].shape == (1, 1, 2, H, W)
    np.testing.assert_allclose(got["flows"].numpy(),
                               np.asarray(want["flows"]), atol=5e-3)
    assert 0.5 < np.abs(np.asarray(want["flows"])).max() < 100.0


def test_scopeflow_rescales_its_context_flows_twice():
    """ScopeFlow's training predictions are IRR-PWC's on the same weights,
    but for the context flows of each estimation level, which it rescales
    to global units once more (the JAX package's ``_cont_extra_rescale``):
    (W_im / w, H_im / h) times div_flow times IRR-PWC's."""
    assert jirr.ScopeFlow._cont_extra_rescale
    _, scope, _ = build_irr("scopeflow", 113)
    plain = tirr.irr_pwc()
    plain.load_state_dict(scope.state_dict())
    x = {"images": torch.from_numpy(np.random.RandomState(114).rand(
        1, 2, 3, H, W).astype(np.float32))}
    with torch.no_grad():
        a = scope(x, training=True)["flow_preds"]
        b = plain(x, training=True)["flow_preds"]
    assert [len(lv) for lv in a] == [4] * 5 + [2, 2]
    for lv_a, lv_b in zip(a, b):
        for i, (fa, fb) in enumerate(zip(lv_a, lv_b)):
            if len(lv_a) == 4 and i < 2:
                h, w = fb.shape[-2:]
                scale = torch.tensor([W / w, H / h]).view(2, 1, 1) * 0.05
                torch.testing.assert_close(fa, fb * scale)
            else:
                torch.testing.assert_close(fa, fb, rtol=0, atol=0)


def test_losses_match_jax_on_fixed_predictions():
    """``MultiScaleEPE_PWC`` on five predictions (1/4 to 1/64 of 128x192,
    the ground truth average-pooled to each), and the bidirectional
    occlusion loss on two levels of four flows and four occlusions plus an
    upsampling level of two each, with both ground-truth directions and
    occlusions: within 1e-5 relative of the JAX package's."""
    rng = np.random.RandomState(112)
    gt = {"flows": rng.randn(2, 1, 2, 128, 192).astype(np.float32) * 3,
          "flows_b": rng.randn(2, 1, 2, 128, 192).astype(np.float32) * 3,
          "occs": (rng.rand(2, 1, 1, 128, 192) > 0.7).astype(np.float32),
          "occs_b": (rng.rand(2, 1, 1, 128, 192) > 0.7).astype(np.float32)}
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    preds = [rng.randn(2, 128 // s, 192 // s, 2).astype(np.float32)
             for s in (64, 32, 16, 8, 4)]
    want = jirr.MultiScaleEPE_PWC(0.05)({"flow_preds": preds}, jgt)
    got = tirr.MultiScaleEPE_PWC(0.05)(
        {"flow_preds": [nchw(p) for p in preds]}, tgt)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)

    def level(s, n, c):
        return [rng.randn(2, 128 // s, 192 // s, c).astype(np.float32)
                for _ in range(n)]

    flows = [level(8, 4, 2), level(4, 4, 2), level(2, 2, 2)]
    occs = [level(8, 4, 1), level(4, 4, 1), level(2, 2, 1)]
    jl = jirr.MultiScaleEPE_PWC_Bi_Occ_upsample(0.05, 4)
    tl = tirr.MultiScaleEPE_PWC_Bi_Occ_upsample(0.05, 4)
    for inputs in (gt, {"flows": gt["flows"]}):
        want = jl({"flow_preds": flows, "occ_preds": occs},
                  {k: jnp.asarray(v) for k, v in inputs.items()})
        got = tl({"flow_preds": [[nchw(p) for p in lv] for lv in flows],
                  "occ_preds": [[nchw(p) for p in lv] for lv in occs]},
                 {k: torch.from_numpy(v) for k, v in inputs.items()})
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
