"""The PyTorch port's evaluation harness against the JAX package's, on the
CPU: datasets read from trees the JAX package's writers made, the
datamodule's selection language, the YAML reader against PyYAML, the flow
metrics, ``validate`` on the same weights and data, the other scripts as
smoke runs, and the whole harness imported and run without OpenCV, PyYAML,
PIL, h5py or JAX.

Tolerances: datasets equal to the bit; metrics within 1e-5 (absolute, and
relative for values over 1: float32 sums in another order); the two
``validate``s within 5e-3 px in every written flow and 5e-3 in EPE (the
JAX package's own RAFT oracle tolerance at 3 GRU iterations).
"""

import argparse
import glob
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401
import yaml

import jax.numpy as jnp

import ptlflow_tpu
from ptlflow_tpu.data import datamodule as jdm
from ptlflow_tpu.data import datasets as jds
from ptlflow_tpu.data import dummy_datasets as jdummy
from ptlflow_tpu.utils import flow_metrics as jfm
import ptlflow_tpu_torch
from ptlflow_tpu_torch.data import datamodule as tdm
from ptlflow_tpu_torch.data import datasets as tds
from ptlflow_tpu_torch.data import dummy_datasets as tdummy
from ptlflow_tpu_torch.scripts import infer as tinfer
from ptlflow_tpu_torch.scripts import model_benchmark as tbench
from ptlflow_tpu_torch.scripts import test as ttest
from ptlflow_tpu_torch.scripts import validate as tvalidate
from ptlflow_tpu_torch.utils import flow_io
from ptlflow_tpu_torch.utils import flow_metrics as tfm
from ptlflow_tpu_torch.utils import yaml_subset

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the JAX package's validate.py
SIZE = (64, 96)

pytest.importorskip("cv2")  # the JAX package's writers and readers


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    """Dummy trees written by the JAX package's writers (OpenCV)."""
    root = tmp_path_factory.mktemp("jax_trees")
    return {
        "sintel": jdummy.write_sintel(root, n_seqs=2, n_frames=3, size=SIZE),
        "kitti_2012": jdummy.write_kitti(root, year="2012", n=2, size=SIZE),
        "kitti_2015": jdummy.write_kitti(root, year="2015", n=2, size=SIZE),
        "chairs": jdummy.write_flying_chairs(root, n=3, size=SIZE),
        "hd1k": jdummy.write_hd1k(root, n_seqs=1, n_frames=3, size=SIZE),
    }


def _dataset_pair(name, trees):
    """The same dataset built by both packages."""
    if name == "sintel":
        kw = dict(split="trainval", pass_names=["clean", "final"],
                  get_occlusion_mask=True)
        return (jds.SintelDataset(str(trees["sintel"]), **kw),
                tds.SintelDataset(str(trees["sintel"]), **kw))
    if name.startswith("kitti"):
        kw = dict(versions=["2012", "2015"], split="trainval",
                  get_occlusion_mask=name == "kitti_occ")
        roots = (str(trees["kitti_2012"]), str(trees["kitti_2015"]))
        return jds.KittiDataset(*roots, **kw), tds.KittiDataset(*roots, **kw)
    if name == "chairs":
        return (jds.FlyingChairsDataset(str(trees["chairs"]), split="train"),
                tds.FlyingChairsDataset(str(trees["chairs"]), split="train"))
    return (jds.Hd1kDataset(str(trees["hd1k"])),
            tds.Hd1kDataset(str(trees["hd1k"])))


@pytest.mark.parametrize("name", ["sintel", "kitti", "kitti_occ", "chairs",
                                  "hd1k"])
def test_datasets_match_jax(jax_trees, name):
    """Equal lengths and meta; images, flows, valids and occlusions equal
    to the bit (PNG and PPM images, .flo and 16-bit PNG flows, 8-bit PNG
    occlusion masks read in grayscale)."""
    jset, tset = _dataset_pair(name, jax_trees)
    assert len(tset) == len(jset) > 0
    for i in range(len(jset)):
        want, got = jset[i], tset[i]
        assert sorted(got) == sorted(want)
        assert got["meta"] == want["meta"]
        for key in want:
            if key != "meta":
                assert got[key].dtype == want[key].dtype, key
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("selection", [
    "sintel-clean-trainval", "chairs-train+3*sintel-clean+kitti-2015-train*5",
    "sintel-final-val+kitti-2015-val", " things-seqlen_3-seqpos_middle ",
    None])
def test_parse_dataset_selection_matches_jax(selection):
    assert (tdm.FlowDataModule.parse_dataset_selection(selection)
            == jdm.FlowDataModule.parse_dataset_selection(selection))


def test_datamodule_validate_stage_matches_jax(jax_trees, tmp_path):
    cfg = tmp_path / "datasets.yaml"
    cfg.write_text(yaml.safe_dump({
        "mpi_sintel": str(jax_trees["sintel"]),
        "kitti_2012": str(jax_trees["kitti_2012"]),
        "kitti_2015": str(jax_trees["kitti_2015"]),
        "flying_chairs": str(jax_trees["chairs"]),
        "hd1k": str(jax_trees["hd1k"])}))
    sel = ("sintel-clean-trainval+sintel-final-trainval+kitti-2015-trainval"
           "+kitti-2012-trainval+chairs-val+hd1k")
    mods = []
    for pkg in (jdm, tdm):
        dm = pkg.FlowDataModule(val_dataset=sel, test_dataset="sintel-test",
                                dataset_config_path=str(cfg))
        dm.setup("validate")
        dm.setup("test")
        mods.append(dm)
    jmod, tmod = mods
    assert tmod.val_dataset_names == jmod.val_dataset_names
    assert tmod.test_dataset_names == jmod.test_dataset_names
    assert ([len(d) for d in tmod.val_data + tmod.test_data]
            == [len(d) for d in jmod.val_data + jmod.test_data])
    # the fit stage builds the training recipe of the same selection
    fit = []
    for pkg in (jdm, tdm):
        dm = pkg.FlowDataModule(train_dataset="chairs-train+2*sintel-clean",
                                dataset_config_path=str(cfg))
        dm.setup("fit")
        fit.append(dm.train_data)
    assert len(fit[1]) == len(fit[0]) > 0


YAML_FILES = sorted(
    [ROOT / "datasets.yaml"]
    + [Path(p) for p in glob.glob(str(ROOT / "configs/results/*.yaml"))]
    + [Path(p) for p in glob.glob(
        str(ROOT / "ptlflow_tpu/models/*/configs/*.yaml"))])


@pytest.mark.parametrize("path", YAML_FILES,
                         ids=[p.relative_to(ROOT).as_posix()
                              for p in YAML_FILES])
def test_yaml_reader_matches_pyyaml(path):
    assert yaml_subset.load(path) == yaml.safe_load(path.read_text())


def test_yaml_reader_refuses_what_it_does_not_read():
    for text in ("a: &x 1\n", "a: !!str 1\n", "a: |\n  x\n", "---\na: 1\n",
                 "a: 0x10\n", "a: 2001-01-01\n", "a: b: c\n", "a:\n\tb: 1\n",
                 "a: [1, 2\n"):
        with pytest.raises(yaml_subset.YamlSubsetError):
            yaml_subset.safe_load(text)


# ------------------------------------------------------------------ metrics
def _close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _metric_inputs(seed, b=2, h=24, w=40, hyp=None):
    rng = np.random.RandomState(seed)
    gt_shape = (b, 2, h, w) if hyp is None else (b, hyp, 2, h, w)
    pred = (rng.randn(b, 2, h, w) * 4).astype(np.float32)
    gt = (pred[:, None] if hyp else pred) + (
        rng.randn(*gt_shape) * 3).astype(np.float32)
    gt = gt.astype(np.float32)
    return {
        "pred_flows": pred, "target_flows": gt,
        "valids": (rng.rand(b, 1, h, w) > 0.2).astype(np.float32),
        "occs": (rng.rand(b, 1, h, w) > 0.7).astype(np.float32),
        "pred_occs": rng.rand(b, 1, h, w).astype(np.float32),
        "mbs": (rng.rand(b, 1, h, w) > 0.8).astype(np.float32),
        "pred_mbs": rng.rand(b, 1, h, w).astype(np.float32),
        "pred_confs": rng.rand(b, 1, h, w).astype(np.float32),
    }


@pytest.mark.parametrize("keys,hyp", [
    (("pred_flows", "target_flows"), None),
    (("pred_flows", "target_flows", "valids"), None),
    (("pred_flows", "target_flows", "valids", "occs", "pred_occs", "mbs",
      "pred_mbs", "pred_confs"), None),
    (("pred_flows", "target_flows", "valids"), 3)])
def test_compute_flow_metrics_matches_jax(keys, hyp):
    """Masks, occlusion splits, the three F1 inputs and 5-D
    multi-hypothesis GT."""
    inputs = {k: v for k, v in _metric_inputs(4, hyp=hyp).items()
              if k in keys}
    want = jfm.compute_flow_metrics(
        **{k: jnp.asarray(v) for k, v in inputs.items()})
    got = tfm.compute_flow_metrics(
        **{k: torch.from_numpy(v) for k, v in inputs.items()})
    _close({k: v.numpy() for k, v in got.items()},
           {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("mode,interp", [("epoch_mean", False),
                                         ("ema", False),
                                         ("epoch_mean", True)])
def test_flow_metrics_accumulator_matches_jax(mode, interp):
    """Three updates of (B, 1, 2, H, W) predictions; with interpolation the
    predictions are at half the GT's size."""
    jm = jfm.FlowMetrics(prefix="val/", average_mode=mode, ema_decay=0.9,
                         interpolate_pred_to_target_size=interp)
    tm = tfm.FlowMetrics(prefix="val/", average_mode=mode, ema_decay=0.9,
                         interpolate_pred_to_target_size=interp)
    for seed in range(3):
        d = _metric_inputs(10 + seed)
        pred = d["pred_flows"][:, None]
        if interp:
            pred = pred[..., ::2, ::2].copy()
        preds = {"flows": pred}
        targets = {"flows": d["target_flows"][:, None],
                   "valids": d["valids"][:, None],
                   "occs": d["occs"][:, None]}
        jm.update({k: jnp.asarray(v) for k, v in preds.items()},
                  {k: jnp.asarray(v) for k, v in targets.items()})
        tm.update({k: torch.from_numpy(v) for k, v in preds.items()},
                  {k: torch.from_numpy(v) for k, v in targets.items()})
    _close(tm.compute(), jm.compute())


# -------------------------------------------------------------- validate
def _jax_validate_args(cfg, out, **kw):
    args = dict(model="raft", ckpt_path=None, config=None,
                set=[f"data.dataset_config_path={cfg}"],
                val_dataset="sintel-clean-trainval", warm_start=False,
                output_path=str(out), write_outputs=True, scale_factor=None,
                max_forward_side=None, iters=None, max_samples=2, all=False,
                select=None, exclude=None, flow_format="flo",
                write_individual_metrics=False, metric_exclude=None,
                seq_val_mode="all", bf16=False, spatial_shards=None,
                show=False, epe_clip=5.0)
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.fixture(scope="module")
def sintel_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("validate")
    sintel = jdummy.write_sintel(root, n_seqs=1, n_frames=3, size=SIZE)
    cfg = root / "datasets.yaml"
    cfg.write_text(yaml.safe_dump({"mpi_sintel": str(sintel)}))
    return cfg


@pytest.mark.parametrize("flags", [[], ["--warm_start"],
                                   ["--scale_factor", "0.5"]])
def test_validate_matches_jax(sintel_cfg, tmp_path, flags):
    """``raft`` at full width, 3 GRU iterations, the first 2 pairs of a
    dummy Sintel sequence, the same weights in both packages (the port's
    init with its flow head damped by 0.1, carried to JAX by
    ``from_torch``): every written flow within 5e-3 px, EPE within 5e-3.
    The second pair is warm-started under ``--warm_start``."""
    tmodel = ptlflow_tpu_torch.get_model("raft", args={"iters": 3},
                                         device="cpu")
    with torch.no_grad():
        head = tmodel.update_block.flow_head.conv2
        head.weight.mul_(0.1)
        head.bias.mul_(0.1)
    jmodel = ptlflow_tpu.get_model("raft", args={"iters": 3})
    jmodel.params = jmodel.from_torch(
        {k: v.numpy() for k, v in tmodel.state_dict().items()})

    targs = tvalidate._parse_args(
        ["--model", "raft", "--device", "cpu", "--set",
         f"data.dataset_config_path={sintel_cfg}", "--val_dataset",
         "sintel-clean-trainval", "--max_samples", "2", "--write_outputs",
         "--flow_format", "flo", "--output_path", str(tmp_path / "port")]
        + flags)
    got = tvalidate.validate(targs, model=tmodel, model_name="raft")
    import validate as jvalidate  # the JAX package's script

    jargs = _jax_validate_args(
        sintel_cfg, tmp_path / "jax", warm_start="--warm_start" in flags,
        scale_factor=0.5 if "--scale_factor" in flags else None)
    want = jvalidate.validate(jargs, model=jmodel, model_name="raft")

    name = "sintel-clean-trainval"
    assert abs(got[name]["epe"] - want[name]["epe"]) <= 5e-3
    files = sorted((tmp_path / "jax" / "raft" / name).glob("*.flo"))
    assert [f.name for f in files] == ["000000.flo", "000001.flo"]
    for f in files:
        mine = flow_io.read_flo(tmp_path / "port" / "raft" / name / f.name)
        assert mine.shape == (*SIZE, 2)
        np.testing.assert_allclose(mine, flow_io.read_flo(f), atol=5e-3)
    for suffix in ("_viz.png", "_epe.png"):
        assert (tmp_path / "port" / "raft" / name / f"000001{suffix}").exists()
    header = (tmp_path / "port" / "raft" / "metrics.csv").read_text()
    assert header.splitlines()[0] == (
        tmp_path / "jax" / "raft" / "metrics.csv").read_text().splitlines()[0]


def test_validate_refuses_what_the_port_lacks(sintel_cfg, tmp_path):
    base = ["--model", "raft", "--device", "cpu", "--set",
            f"data.dataset_config_path={sintel_cfg}", "--output_path",
            str(tmp_path)]
    for extra, err in ((["--show"], NotImplementedError),
                       (["--spatial_shards", "2"], NotImplementedError),
                       (["--model", "gma", "--bf16"], ValueError)):
        with pytest.raises(err):
            tvalidate.validate(tvalidate._parse_args(base + extra))


# --------------------------------------------------------- other scripts
@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    """Sintel and KITTI 2015 trees written by the port's own writers."""
    root = tmp_path_factory.mktemp("port_tree")
    sintel = tdummy.write_sintel(root, n_seqs=1, n_frames=3, size=SIZE)
    kitti = tdummy.write_kitti(root, year="2015", n=2, size=SIZE)
    cfg = root / "datasets.yaml"
    cfg.write_text(f"mpi_sintel: {sintel}\nkitti_2015: {kitti}\n")
    return {"sintel": sintel, "kitti": kitti, "cfg": cfg}


def test_infer_runs_on_the_cpu(port_tree, tmp_path):
    """Three frames of a folder, warm-started: two flows and their
    visualizations; a video input is refused."""
    frames = port_tree["sintel"] / "training" / "clean" / "seq_0"
    written = tinfer.infer(tinfer._parse_args(
        ["--model", "raft_small", "--device", "cpu", "--set",
         "model.init_args.iters=2", "--input_path", str(frames),
         "--output_path", str(tmp_path), "--warm_start"]))
    assert [p.name for p in written] == ["frame_0001.flo", "frame_0002.flo"]
    for p in written:
        flow = flow_io.read_flo(p)
        assert flow.shape == (*SIZE, 2) and np.isfinite(flow).all()
        assert (tmp_path / f"{p.stem}_viz.png").exists()
    with pytest.raises(NotImplementedError, match="video"):
        list(tinfer.init_input(["clip.mp4"]))


def test_test_script_writes_submission_layouts(port_tree, tmp_path):
    out = ttest.main(["--model", "raft_small", "--device", "cpu", "--set",
                      "model.init_args.iters=2",
                      f"data.dataset_config_path={port_tree['cfg']}",
                      "--test_dataset", "sintel-test+kitti-2015-test",
                      "--output_path", str(tmp_path)])
    sintel = sorted(p.name for p in (out / "sintel-test" / "seq_0").iterdir())
    assert sintel == ["frame_0001.flo", "frame_0002.flo"]
    kitti = sorted((out / "kitti-2015-test" / "flow").iterdir())
    assert [p.name for p in kitti] == ["000000_10.png", "000001_10.png"]
    assert flow_io.read_flow_png(kitti[0]).shape == (*SIZE, 2)


# model_benchmark.py:259, the JAX script's CSV columns
JAX_BENCHMARK_COLUMNS = ["model", "datatype", "input_h", "input_w", "params",
                         "flops", "time_ms", "fps", "mem_gb", "commit",
                         "device"]


def test_model_benchmark_runs_on_the_cpu(tmp_path):
    rows = tbench.main(["--models", "raft_small", "--device", "cpu",
                        "--input_size", "64", "96", "--iters", "2",
                        "--num_samples", "1", "--num_trials", "2",
                        "--warmup", "1", "--datatypes", "fp32", "bf16",
                        "--output_path", str(tmp_path)])
    assert [r["datatype"] for r in rows] == ["fp32", "bf16"]
    lines = (tmp_path / "benchmark.csv").read_text().splitlines()
    assert lines[0].startswith("# flops: ") and "lookup" in lines[0]
    assert lines[1].split(",") == JAX_BENCHMARK_COLUMNS
    csv_rows = tbench.read_rows(tmp_path / "benchmark.csv")
    assert len(csv_rows) == 2
    for r in csv_rows:
        assert r["device"] == "cpu" and float(r["flops"]) > 0
        assert float(r["time_ms"]) > 0 and r["mem_gb"] == "nan"


def test_entry_points_default_to_the_card(port_tree):
    """Without --device every entry point asks for the card, and raises
    where there is none rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    calls = [
        lambda: tvalidate.main(["--model", "raft", "--set",
                                f"data.dataset_config_path="
                                f"{port_tree['cfg']}"]),
        lambda: tinfer.main(["--model", "raft", "--input_path",
                             str(port_tree["sintel"])]),
        lambda: ttest.main(["--model", "raft"]),
        lambda: tbench.main(["--models", "raft"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


BLOCKED = ("cv2", "yaml", "PIL", "h5py", "jax", "optax", "tensorboard")


def test_harness_runs_without_cv2_yaml_pil_h5py_or_jax(tmp_path):
    """A PyTorch install without those packages: in a fresh interpreter
    where importing any of them (or optax, or tensorboard) fails, the
    port's data, augmentations, IO, metrics, CLI, checkpoint manager,
    loggers and scripts import, its writers make a Sintel + KITTI tree, and
    its ``validate`` runs over it on the CPU; nothing of the JAX package is
    imported."""
    code = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import torch
torch.set_num_threads({torch.get_num_threads()})
import ptlflow_tpu_torch.data
from ptlflow_tpu_torch.data import dummy_datasets, transforms
from ptlflow_tpu_torch.data import device_transforms
from ptlflow_tpu_torch.utils import image_io, flow_io, flow_metrics, cli
from ptlflow_tpu_torch.utils import checkpoint_manager, logger
from ptlflow_tpu_torch.scripts import validate, infer, test, model_benchmark
from ptlflow_tpu_torch.scripts import train
from pathlib import Path
root = Path({str(tmp_path)!r})
s = dummy_datasets.write_sintel(root, n_seqs=1, n_frames=3, size=(64, 96))
k = dummy_datasets.write_kitti(root, n=1, size=(64, 96))
(root / "ds.yaml").write_text(f"mpi_sintel: {{s}}\\nkitti_2015: {{k}}\\n")
m = validate.validate(validate._parse_args([
    "--model", "raft_small", "--device", "cpu", "--iters", "2",
    "--val_dataset", "sintel-clean-trainval+kitti-2015-trainval",
    "--set", f"data.dataset_config_path={{root / 'ds.yaml'}}",
    "--write_outputs", "--warm_start", "--output_path", str(root / "out")]))
assert sorted(m) == ["kitti-2015-trainval", "sintel-clean-trainval"], m
assert all(v["epe"] == v["epe"] for v in m.values()), m
bad = [n for n in sys.modules if n.split(".")[0] in {BLOCKED!r} + (
    "ptlflow_tpu",) and sys.modules[n] is not None]
assert not bad, bad
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
