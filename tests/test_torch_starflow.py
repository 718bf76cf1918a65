"""The port's STaRFlow against the JAX package's, on the CPU: the eval
forward of 3 frames at 128x192 (IRR's 1/64 level needs at least 2x2): the
forward and backward flows and occlusions of both pairs, the second pair
reading the temporal memory the first left at each level.

The JAX twin runs eagerly with its modules and its ops (the cost volume,
the warp, the resize and the flow rescale) each jitted on its own
(``jitted_pieces``): a level's pieces then compile once and serve both
directions and both pairs, where one jit of the whole forward traces and
compiles them four times over (40 s).  The arithmetic is the JAX
package's, op for op.

Weights are ``random_params``; the shared estimator's and context
network's output convolutions and the occlusion upsampler's are damped by
0.02 (``HEADS``), as ``tests/test_torch_irr.py`` damps the weight-shared
IRR estimator: a random shared estimator otherwise gives flows of 1e3 px.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax
import jax.numpy as jnp

from ptlflow_tpu_torch.data import dummy_datasets as tdummy
from ptlflow_tpu_torch.scripts import infer as tinfer
from ptlflow_tpu_torch.scripts import validate as tvalidate
from ptlflow_tpu_torch.utils import flow_io, image_io
from tests.test_torch_flownet import build, port_model

jsf = importlib.import_module("ptlflow_tpu.models.starflow.starflow")

HEADS = ("flow_and_occ_estimators.conv_last.0", "context_networks.convs.6.0",
         "occ_shuffle_upsample.out_convs.0")
H, W = 128, 192

# the ops the JAX forward calls by module name, with their static arguments
JITTED_OPS = {"compute_cost_volume": (2,), "irr_warp": (2, 3, 4),
              "upsample2d_as": (1,), "rescale_flow": (1, 2, 3, 4)}


@pytest.fixture(scope="module")
def jitted_pieces():
    """The starflow module's ops jitted while this file's tests run."""
    saved = {name: getattr(jsf, name) for name in JITTED_OPS}
    for name, static in JITTED_OPS.items():
        setattr(jsf, name, jax.jit(saved[name], static_argnums=static))
    yield
    for name, fn in saved.items():
        setattr(jsf, name, fn)


def jit_module_calls(jmodel):
    """Each submodule that the JAX forward calls directly jitted on its
    instance (its parameters and tensors as arguments)."""
    mods = [jmodel.feature_pyramid_extractor, jmodel.flow_and_occ_estimators,
            jmodel.context_networks, jmodel.refine_flow, jmodel.refine_occ,
            jmodel.occ_shuffle_upsample, jmodel.conv_1x1_1,
            jmodel.conv_1x1_time, *jmodel.conv_1x1]
    for mod in mods:
        cls = type(mod)
        jitted = jax.jit(functools.partial(cls.__call__, mod))
        mod.__class__ = type(cls.__name__, (cls,), {
            "__call__": lambda self, p, *a, _j=jitted: _j(p, *a)})


@pytest.fixture(scope="module")
def models(jitted_pieces):
    jmodel, tmodel, params = build("starflow", 500, HEADS, factor=0.02)
    jit_module_calls(jmodel)
    images = np.random.RandomState(501).rand(1, 3, 3, H, W).astype(
        np.float32)
    want = jmodel.forward(jmodel.params, {"images": jnp.asarray(images)})
    return tmodel, params, images, jax.tree_util.tree_map(np.asarray, want)


def test_eval_forward_matches_jax(models):
    """``flows`` and ``flows_b`` (B, 2, 2, H, W) within 5e-3 px, ``occs``
    and ``occs_b`` within 1e-4 of the JAX package's, with no autograd
    graph; flows of a few pixels, occlusions spread over (0, 1)."""
    tmodel, _, images, want = models
    got = tmodel({"images": torch.from_numpy(images)})
    assert sorted(got) == ["flows", "flows_b", "occs", "occs_b"]
    for key, atol in (("flows", 5e-3), ("flows_b", 5e-3), ("occs", 1e-4),
                      ("occs_b", 1e-4)):
        assert got[key].shape == want[key].shape == (
            1, 2, 1 + key.startswith("flow"), H, W), key
        assert got[key].grad_fn is None
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=atol,
                                   err_msg=key)
    assert 1.0 < np.abs(want["flows"]).max() < 100.0
    assert want["occs"].std() > 1e-3


def test_second_pair_reads_the_memory(models):
    """The second pair's outputs from the 3-frame window are not those of
    the pair alone: the first pair's features, warped by its backward
    flow, enter each level's estimator."""
    tmodel, _, images, want = models
    alone = tmodel({"images": torch.from_numpy(images[:, 1:])})
    assert np.abs(alone["flows"][:, 0].numpy()
                  - want["flows"][:, 1]).max() > 1e-2
    first = tmodel({"images": torch.from_numpy(images[:, :2])})
    np.testing.assert_allclose(first["flows"][:, 0].numpy(),
                               want["flows"][:, 0], atol=5e-3)


def test_training_is_refused(models):
    """STaRFlow is registered but not trainable, in the JAX package as in
    the reference: its training forward raises."""
    tmodel = models[0]
    with pytest.raises(NotImplementedError):
        tmodel({"images": torch.zeros(1, 2, 3, 64, 64)}, training=True)


def test_state_dict_reads_back_into_jax(models):
    """The port's ``state_dict`` (IRR's module names) read by the JAX
    package's ``from_torch`` is the JAX tree it came from."""
    _, params, _, _ = models
    tmodel = port_model("starflow", params)
    jmodel = jsf.StarFlow()
    back = jmodel.from_torch({k: v.numpy()
                              for k, v in tmodel.state_dict().items()})
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf)


def test_scripts_run_starflow_on_pairs(tmp_path):
    """``validate`` gives STaRFlow pairs, as every model, and reads its one
    flow a pair; ``infer`` on a folder of 3 frames writes each pair's flow,
    its visualization and its occlusion map (8-bit gray) at the frames'
    size (128x128: IRR's 1/64 level needs 2x2)."""
    size = (128, 128)
    sintel = tdummy.write_sintel(tmp_path / "data", n_seqs=1, n_frames=3,
                                 size=size)
    cfg = tmp_path / "datasets.yaml"
    cfg.write_text(f"mpi_sintel: {sintel}\n")
    metrics = tvalidate.validate(tvalidate._parse_args(
        ["--model", "starflow", "--device", "cpu", "--set",
         f"data.dataset_config_path={cfg}", "--val_dataset",
         "sintel-clean-trainval", "--max_samples", "2", "--output_path",
         str(tmp_path / "val")]))
    epe = [v for k, v in metrics["sintel-clean-trainval"].items()
           if k.endswith("epe")]
    assert epe and all(np.isfinite(e) for e in epe)
    out = tmp_path / "infer"
    written = tinfer.infer(tinfer._parse_args(
        ["--model", "starflow", "--device", "cpu", "--input_path",
         str(sintel / "training" / "clean" / "seq_0"), "--output_path",
         str(out)]))
    assert [p.name for p in written] == ["frame_0001.flo", "frame_0002.flo"]
    for p in written:
        assert flow_io.read_flo(p).shape == (*size, 2)
        occ = image_io.imread(out / f"{p.stem}_occs.png")
        assert occ.shape[:2] == size and occ.dtype == np.uint8
