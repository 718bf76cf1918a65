"""The PyTorch port's training entry point and its parts, on the CPU:
``scripts/train.py`` as ``tests/test_train_script.py`` drives the JAX
package's ``train.py`` (``raft_small`` at 64x96, 2 GRU iterations, over a
dummy FlyingChairs tree, ``--device cpu``); the datamodule's fit stage
against the JAX package's on the same trees; gradient accumulation against
``optax.MultiSteps``; a checkpoint round trip that must give the same bits
as training straight through; the checkpoint manager, as
``tests/utils/test_checkpoint_manager.py`` checks the JAX package's; and
the loggers.
"""

import json
import random

import numpy as np
import optax
import pytest
import torch

from tests._torch_threads import cap_torch_threads  # noqa: F401

import jax.numpy as jnp

from ptlflow_tpu.data import datamodule as jdm
from ptlflow_tpu.parallel import train as jtrain
from ptlflow_tpu.utils import logger as jlogger
import ptlflow_tpu_torch
from ptlflow_tpu_torch.data import datamodule as tdm
from ptlflow_tpu_torch.data import device_transforms as tdt
from ptlflow_tpu_torch.data import dummy_datasets as tdummy
from ptlflow_tpu_torch.parallel import train as ttrain
from ptlflow_tpu_torch.scripts import train as ttrain_script
from ptlflow_tpu_torch.utils.checkpoint_manager import (CheckpointManager,
                                                        save_checkpoint)
from ptlflow_tpu_torch.utils import logger as tlogger
from ptlflow_tpu_torch.utils.ckpt import load_checkpoint

SIZE = (64, 96)


@pytest.fixture(scope="module")
def chairs_cfg(tmp_path_factory):
    """A FlyingChairs tree of 5 pairs at 64x96 (4 train, 1 val) and the
    datasets.yaml that points at it."""
    root = tmp_path_factory.mktemp("chairs")
    tree = tdummy.write_flying_chairs(root, n=5, size=SIZE)
    cfg = root / "datasets.yaml"
    cfg.write_text(f"flying_chairs: {tree}\n")
    return cfg


def argv(cfg, ckpt_dir, *extra):
    return ["--model", "raft_small", "--device", "cpu", "--set",
            f"data.dataset_config_path={cfg}", "model.init_args.iters=2",
            "data.train_num_workers=0", "--train_dataset", "chairs-train",
            "--val_dataset", "chairs-val", "--train_batch_size", "1",
            "--train_crop_size", *map(str, SIZE), "--log_every_n_steps",
            "1", "--loggers", "none", "--ckpt_dir", str(ckpt_dir), *extra]


# --------------------------------------------------------- the script
def test_train_script_smoke(chairs_cfg, tmp_path):
    """Two steps with a validation: last.ckpt (loading strictly into a
    fresh model), the top-k index and train_info.json."""
    out = ttrain_script.main(argv(chairs_cfg, tmp_path, "--max_steps", "2",
                                  "--val_every_n_steps", "2"))
    d = tmp_path / "raft_small"
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    assert json.loads((d / "train_info.json").read_text())["steps"] == 2
    index = json.loads((d / "index.json").read_text())
    assert [n for _, n in index["topk"]] == ["step2.ckpt"]
    fresh = ptlflow_tpu_torch.get_model("raft_small", args={"iters": 2},
                                        device="cpu")
    fresh.load_state_dict(load_checkpoint(d / "last.ckpt")["state_dict"],
                          strict=True)
    for k, v in out["model"].state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_train_script_max_epochs(chairs_cfg, tmp_path, capsys):
    """--max_epochs converts to steps: 4 training pairs at batch 2 are 2
    steps an epoch, so 2 epochs are 4 steps."""
    out = ttrain_script.main(argv(chairs_cfg, tmp_path, "--max_epochs", "2",
                                  "--train_batch_size", "2",
                                  "--val_every_n_steps", "100"))
    assert out["steps"] == 4
    assert "using 4 (2 epochs * 2 steps / 1 device)" in capsys.readouterr().out


def test_train_script_accumulate_grad_batches(chairs_cfg, tmp_path):
    """--accumulate_grad_batches 2: 3 micro-batches are one optimizer step
    and one accumulated micro-batch, and last_state.ckpt keeps both."""
    out = ttrain_script.main(argv(chairs_cfg, tmp_path, "--max_steps", "3",
                                  "--accumulate_grad_batches", "2",
                                  "--val_every_n_steps", "100"))
    opt = out["state"].opt_state
    assert out["steps"] == 3 and (opt.count, opt.mini_step) == (1, 1)
    saved = load_checkpoint(tmp_path / "raft_small" / "last_state.ckpt")
    assert saved["optimizer"]["step"] == 3
    assert (saved["optimizer"]["count"], saved["optimizer"]["mini_step"]) \
        == (1, 1)
    assert (tmp_path / "raft_small" / "last.ckpt").exists()


def test_train_script_resume(chairs_cfg, tmp_path, capsys):
    """--resume restores weights, optimizer state and step from
    last_state.ckpt and picks up at step 2; --resume_ckpt with a
    weights-only file restores the weights only."""
    ttrain_script.main(argv(chairs_cfg, tmp_path, "--max_steps", "2",
                            "--val_every_n_steps", "2"))
    capsys.readouterr()
    out = ttrain_script.main(argv(chairs_cfg, tmp_path, "--max_steps", "4",
                                  "--val_every_n_steps", "2", "--resume"))
    text = capsys.readouterr().out
    assert "resumed training state from" in text and "at step 2" in text
    assert "step 3/4" in text and "step 1/4" not in text
    assert out["state"].opt_state.count == 4
    last = str(tmp_path / "raft_small" / "last.ckpt")
    out = ttrain_script.main(argv(chairs_cfg, tmp_path / "w", "--max_steps",
                                  "1", "--resume_ckpt", last))
    assert f"resumed weights only from {last}" in capsys.readouterr().out
    assert out["state"].opt_state.count == 1


def test_train_script_refuses_what_the_port_lacks(chairs_cfg, tmp_path):
    """More than one device raises, naming the DDP item; without --device
    the script asks for the card and raises where there is none."""
    for extra in (["--n_devices", "2"], ["--num_nodes", "2"]):
        with pytest.raises(NotImplementedError, match="DDP"):
            ttrain_script.main(argv(chairs_cfg, tmp_path, *extra))
    if not torch.cuda.is_available():
        args = argv(chairs_cfg, tmp_path)
        del args[args.index("--device"):args.index("--device") + 2]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain_script.main(args)


# ------------------------------------------------- the fit stage
@pytest.fixture(scope="module")
def finetune_trees(tmp_path_factory):
    """Things, Sintel, KITTI 2015 and HD1K trees at 64x96, and the
    datasets.yaml that points at them."""
    root = tmp_path_factory.mktemp("finetune")
    trees = {"flying_things3d": tdummy.write_things(root, size=SIZE),
             "mpi_sintel": tdummy.write_sintel(root, size=SIZE),
             "kitti_2015": tdummy.write_kitti(root, size=SIZE),
             "hd1k": tdummy.write_hd1k(root, size=SIZE)}
    cfg = root / "datasets.yaml"
    cfg.write_text("".join(f"{k}: {v}\n" for k, v in trees.items()))
    return cfg


def both(cfg, **kw):
    mods = []
    for pkg in (jdm, tdm):
        dm = pkg.FlowDataModule(dataset_config_path=str(cfg), **kw)
        dm.setup("fit")
        mods.append(dm)
    return mods


def test_fit_stage_batches(chairs_cfg):
    """The crop rounds up to the output stride; a batch holds the crop
    size, a worker-fed DataLoader gives the same shapes, and
    ``train_transform_cuda`` swaps in ``DeviceCompose`` and forces the
    workers to 0."""
    jmod, tmod = both(chairs_cfg, train_dataset="chairs-train",
                      train_batch_size=2, train_num_workers=0,
                      train_crop_size=(60, 90))
    assert len(tmod.train_data) == len(jmod.train_data) == 4
    batch = next(iter(tmod.train_dataloader()))
    assert batch["images"].shape == (2, 2, 3, 64, 96)
    assert batch["flows"].shape == (2, 1, 2, 64, 96)
    assert batch["valids"].shape == (2, 1, 1, 64, 96)
    assert next(iter(jmod.train_dataloader()))["images"].shape \
        == batch["images"].shape
    tmod.train_num_workers = 1
    loader = tmod.train_dataloader()
    assert isinstance(loader, torch.utils.data.DataLoader)
    assert next(iter(loader))["images"].shape == (2, 2, 3, 64, 96)
    dm = tdm.FlowDataModule(dataset_config_path=str(chairs_cfg),
                            train_dataset="chairs-train", train_num_workers=2,
                            train_crop_size=(64, 96),
                            train_transform_cuda=True,
                            train_transform_fp16=True)
    dm.setup("fit")
    assert isinstance(dm.train_data.transform, tdt.DeviceCompose)
    assert dm.train_data.transform.out_dtype == torch.bfloat16
    assert isinstance(dm.train_dataloader(), tdm.SimpleLoader)
    assert dm.train_num_workers == 0


def test_sintel_finetune_parts_match_jax(finetune_trees):
    """The SEA-RAFT TSKH mixture: the same parts, repeats and length as the
    JAX package's on the same trees, and a sample of each part at the
    crop size."""
    jmod, tmod = both(finetune_trees,
                      train_dataset="sintel_finetune-searaft_split",
                      train_crop_size=SIZE)
    jparts, tparts = jmod.train_data.datasets, tmod.train_data.datasets
    assert [len(p) for p in tparts] == [len(p) for p in jparts]
    times = [getattr(p, "times", 1) for p in tparts]
    assert times == [getattr(p, "times", 1) for p in jparts] \
        == [1, 20, 20, 80, 30]
    assert len(tmod.train_data) == len(jmod.train_data) > 0
    random.seed(0)
    for i in np.cumsum([0] + [len(p) for p in tparts[:-1]]):
        assert tmod.train_data[int(i)]["images"].shape == (2, 3, *SIZE)


def test_overfit_set_matches_jax(finetune_trees):
    """One Sintel clean pair resized to the crop, as the JAX package gives
    it."""
    jmod, tmod = both(finetune_trees, train_dataset="overfit",
                      train_crop_size=(48, 80))
    assert len(tmod.train_data) == len(jmod.train_data) == 1
    want, got = jmod.train_data[0], tmod.train_data[0]
    assert got["images"].shape == (2, 3, 48, 80)
    for k in ("images", "flows", "valids"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------- the optimizer
def test_accumulate_steps_match_optax_multisteps():
    """make_optimizer(accumulate_steps=3) against the JAX package's
    ``optax.MultiSteps(chain(clip_by_global_norm, adamw))`` over 7
    micro-steps, one gradient large enough to be clipped: every parameter
    within 1e-6 of its tensor's largest value, and unchanged between
    optimizer steps."""
    rng = np.random.RandomState(12)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, wdecay=1e-1, total_steps=10, pct_start=0.3,
              grad_clip=1.0, accumulate_steps=3)
    jtx = jtrain.make_optimizer(**kw)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = jtx.init(jparams)
    ttx = ttrain.make_optimizer(**kw)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    topt = ttx.init(tparams)
    for i, scale in enumerate((0.1, 30.0, 0.5, 0.2, 2.0, 0.3, 1.0)):
        g = {k: (scale * rng.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
        updates, jopt = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {k: v.clone() for k, v in tparams.items()}
        topt = ttx.update([torch.from_numpy(g[k]) for k in tparams], topt,
                          tparams.values())
        assert topt.count == (i + 1) // 3 and topt.mini_step == (i + 1) % 3
        for k, v in tparams.items():
            want = np.asarray(jparams[k])
            assert np.abs(v.numpy() - want).max() <= 1e-6 * np.abs(want).max()
            if (i + 1) % 3:
                assert torch.equal(v, before[k])


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Two steps, a checkpoint of weights and optimizer state, a fresh
    model and optimizer loaded from it, two more steps: the same bits as
    four steps straight through on the same batches."""
    rng = np.random.RandomState(13)
    batches = [{"images": torch.from_numpy(rng.rand(1, 2, 3, 32, 48)
                                           .astype(np.float32)),
                "flows": torch.from_numpy((3 * rng.randn(1, 1, 2, 32, 48))
                                          .astype(np.float32)),
                "valids": torch.ones(1, 1, 1, 32, 48)} for _ in range(4)]

    def fresh():
        model = ptlflow_tpu_torch.get_model("raft_small", args={"iters": 2},
                                            device="cpu")
        tx = ttrain.make_optimizer(lr=4e-4, total_steps=10)
        return (model, ttrain.create_train_state(model, tx),
                ttrain.build_train_step(model, tx))

    model, state, step = fresh()
    for b in batches:
        state, _ = step(state, b)
    straight = (model.state_dict(), ttrain.optimizer_state_dict(state))

    model, state, step = fresh()
    for b in batches[:2]:
        state, _ = step(state, b)
    path = tmp_path / "state.ckpt"
    save_checkpoint(path, model.state_dict(),
                    optimizer=ttrain.optimizer_state_dict(state))
    model, state, step = fresh()
    saved = load_checkpoint(path)
    model.load_state_dict(saved["state_dict"], strict=True)
    state = ttrain.load_optimizer_state(state, saved["optimizer"])
    assert state.step == 2 and state.opt_state.count == 2
    for b in batches[2:]:
        state, _ = step(state, b)
    for k, v in model.state_dict().items():
        assert torch.equal(v, straight[0][k]), k
    opt = ttrain.optimizer_state_dict(state)
    assert opt["step"] == opt["count"] == 4
    for key in ("mu", "nu"):
        for k, v in opt[key].items():
            assert torch.equal(v, straight[1][key][k]), (key, k)


# --------------------------------------------- the checkpoint manager
def weights(v):
    return {"layer.weight": torch.full((4, 4), float(v))}


def test_checkpoint_manager_topk_and_last(tmp_path):
    cm = CheckpointManager(str(tmp_path), top_k=2, monitor="val/epe")
    cm.save_step(weights(1), 100, {"val/epe": 3.0})
    cm.save_step(weights(2), 200, {"val/epe": 1.0})
    cm.save_step(weights(3), 300, {"val/epe": 2.0})
    cm.save_step(weights(4), 400, {"val/epe": 5.0})  # worse: not kept
    assert (tmp_path / "last.ckpt").exists()
    assert cm.best_path().endswith("step200.ckpt")
    assert {p.name for p in tmp_path.glob("step*")} == {"step200.ckpt",
                                                        "step300.ckpt"}
    assert cm.load(cm.best_path())["layer.weight"][0, 0] == 2.0
    assert cm.load(str(tmp_path / "last.ckpt"))["layer.weight"][0, 0] == 4.0


def test_checkpoint_manager_hpc_resume_priority(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    assert cm.resolve_resume_path() is None
    cm.save_step(weights(1), 10)
    assert cm.resolve_resume_path().endswith("last.ckpt")
    cm.hpc_save(weights(2), 20)
    cm.hpc_save(weights(3), 30)
    assert cm.max_hpc_version() == 2
    assert cm.resolve_resume_path().endswith("hpc_ckpt_2.ckpt")
    explicit = str(tmp_path / "hpc_ckpt_1.ckpt")
    assert cm.resolve_resume_path(explicit) == explicit


def test_checkpoint_manager_index_survives_restart(tmp_path):
    cm = CheckpointManager(str(tmp_path), top_k=1)
    cm.save_step(weights(1), 1, {"val/epe": 2.5})
    cm2 = CheckpointManager(str(tmp_path), top_k=1)
    assert cm2.best_path().endswith("step1.ckpt")


# -------------------------------------------------------------- loggers
def test_loggers(tmp_path, capsys):
    """TensorBoard writes its event file; a backend whose package is
    missing (wandb here) or that does not exist is skipped with the JAX
    package's notice; the flow grid and the image sampler are the JAX
    package's."""
    rng = np.random.RandomState(14)
    img = rng.rand(24, 32, 3).astype(np.float32)
    pred, gt = (3 * rng.randn(2, 24, 32, 2)).astype(np.float32)
    grid = tlogger.make_flow_grid(img, pred, gt)
    np.testing.assert_array_equal(grid, jlogger.make_flow_grid(img, pred, gt))
    samplers = [m.ImageSampler(5, 23) for m in (tlogger, jlogger)]
    assert [samplers[0].should_log(i) for i in range(23)] \
        == [samplers[1].should_log(i) for i in range(23)]
    log = tlogger.MultiLogger(str(tmp_path), backends=["tensorboard",
                                                       "wandb", "nope"])
    notices = capsys.readouterr().out
    assert "[logger] backend 'wandb' unavailable" in notices
    assert "[logger] backend 'nope' unavailable" in notices
    assert [type(lg).__name__ for lg in log.loggers] == ["TensorBoardLogger"]
    log.log_scalars({"train/loss": 1.5}, 1)
    log.log_image("val/chairs/0", grid, 1)
    log.flush()
    log.close()
    assert list(tmp_path.glob("events.out.tfevents.*"))
