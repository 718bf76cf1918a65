"""The port's LiteFlowNet2 and LiteFlowNet3 (``liteflownet2``, and
``liteflownet3``, ``liteflownet3s``, each with and without the pseudo
regularization) against the JAX package's, on the CPU: the eval forward of
frames of 128x160 (1/32: 4x5), flows and LiteFlowNet3's ``confs``.

LiteFlowNet3 deforms the upsampled flow by a displacement predicted from
the first frame's self-correlation (the same map as both arguments of
``local_correlation``, dilation 2) and modulates its 9x9 cost volume; the
S versions start both a level earlier; the pseudo variants add a sub-pixel
and a regularization stage at 1/2.  Weights are ``random_params``; the last
convolution of each matching and sub-pixel flow network, of the pseudo
sub-pixel stage and of each deformation's displacement head is damped by
0.1 (``HEADS``), which leaves flows of a few pixels.

A name and its pseudo variant share one draw (the pseudo variant's tree;
the plain one takes it without the pseudo stage and with its own x4
``up_flow``) and one compilation of both JAX forwards, whose common trunk
XLA computes once: 10 s where two compilations take 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests._torch_threads import cap_torch_threads  # noqa: F401

import ptlflow_tpu
from tests.test_torch_flownet import (assert_forward_matches, damp_modules,
                                      images_of, port_model)
from tests.test_torch_pwcnet import compile_o0
from tests.test_torch_train import random_params

HEADS = ("matching_nets.*.flow_net.10", "subpixel_nets.*.flow_net",
         "pseudo_subpixel.flow_net.1", "deformation_nets.*.disp_pred")
PSEUDO = ("pseudo_subpixel", "pseudo_regularization", "up_flow")


@pytest.fixture(scope="module")
def pairs():
    return {}


def pair(cache, base):
    """(the JAX package's outputs by name, the port's models by name, the
    images) of ``base`` and ``base + "_pseudoreg"``, computed once."""
    if base not in cache:
        names = (base, base + "_pseudoreg")
        jb, jp = (ptlflow_tpu.get_model_reference(n)() for n in names)
        pp = random_params(jax.eval_shape(jp.init, jax.random.PRNGKey(0)),
                           np.random.RandomState(160))
        damp_modules(pp, HEADS, 0.1)
        up = random_params(
            {"up_flow": jax.eval_shape(jb.init,
                                       jax.random.PRNGKey(0))["up_flow"]},
            np.random.RandomState(162))["up_flow"]

        def plain(p, up):
            return dict({k: v for k, v in p.items() if k not in PSEUDO},
                        up_flow=up)

        def both(p, up, x):
            return (jb.forward(plain(p, up), {"images": x}),
                    jp.forward(p, {"images": x}))

        images = images_of(161, h=128, w=160)
        args = (jax.tree_util.tree_map(jnp.asarray, pp),
                jax.tree_util.tree_map(jnp.asarray, up), jnp.asarray(images))
        want = compile_o0(both, *args)(*args)
        cache[base] = (dict(zip(names, want)),
                       {base: port_model(base, plain(pp, up)),
                        names[1]: port_model(names[1], pp)}, images)
    return cache[base]


@pytest.mark.parametrize("name", [
    "liteflownet2", "liteflownet2_pseudoreg", "liteflownet3",
    "liteflownet3_pseudoreg", "liteflownet3s", "liteflownet3s_pseudoreg"])
def test_eval_forward_matches_jax(name, pairs):
    """``flows`` within 5e-3 px of the JAX package's, of a few pixels, and
    LiteFlowNet3's ``confs`` (its last confidence, upsampled x4) within
    1e-4, in (0, 1)."""
    wants, tmodels, images = pair(pairs, name.replace("_pseudoreg", ""))
    lfn3 = name.startswith("liteflownet3")
    want = assert_forward_matches(
        None, tmodels[name], images,
        dict(flows=5e-3, **({"confs": 1e-4} if lfn3 else {})), wants[name])
    assert 0.5 < np.abs(np.asarray(want["flows"])).max() < 100.0
    if lfn3:
        confs = np.asarray(want["confs"])
        assert confs.shape == (1, 1, 1, 128, 160)
        assert 0 < confs.min() <= confs.max() < 1
