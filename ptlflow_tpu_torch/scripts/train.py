"""Training entry point of the PyTorch port (the JAX package's ``train.py``):
model, data and trainer from flags and a YAML config, the clipped AdamW /
OneCycle train step with optional gradient accumulation, periodic
validation with each dataset's headline metric, last and top-k checkpoints,
a resumable training state, and scalar and image loggers.

    python -m ptlflow_tpu_torch.scripts.train \\
        --config ptlflow_tpu/models/raft/configs/raft-train1-chairs.yaml \\
        [--max_steps N] [--resume] [--device cpu]

Runs on one device: the card unless ``--device cpu``; raises where CUDA is
absent.  The top-level keys of ``--config`` fill the flags left unset (the
reference's LightningCLI precedence), so the config's ``lr`` and ``wdecay``
apply.  Writes under ``<ckpt_dir>/<model>``: ``last.ckpt`` and the best
``step<N>.ckpt`` (the reference's Lightning layout, ``index.json`` beside
them), ``last_state.ckpt`` (the weights, the optimizer state and the step,
refreshed at every validation and at the end) and ``train_info.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import random
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ptlflow_tpu_torch.parallel import (build_train_step, create_train_state,
                                        load_optimizer_state, make_optimizer,
                                        optimizer_state_dict)
from ptlflow_tpu_torch.utils.checkpoint_manager import (CheckpointManager,
                                                        save_checkpoint)
from ptlflow_tpu_torch.utils.ckpt import load_checkpoint, split_checkpoint
from ptlflow_tpu_torch.utils.cli import (add_common_model_args,
                                         datamodule_from_cfg, load_config,
                                         model_from_args, parse_with_config)
from ptlflow_tpu_torch.utils.flow_metrics import FlowMetrics
from ptlflow_tpu_torch.utils.logger import (ImageSampler, MultiLogger,
                                            make_flow_grid)

# per-dataset headline metric (reference base_model.py:40-59)
DATASET_MAIN_METRIC = {
    "chairs": "epe", "chairs2": "epe", "things": "epe", "sintel": "epe",
    "kitti": "flall", "hd1k": "flall", "spring": "px1", "viper": "wauc",
    "autoflow": "epe", "kubric": "epe", "middlebury": "epe", "monkaa": "epe",
    "tartanair": "epe",
}

# metric direction: px1 (fraction of pixels within 1px) and wauc are
# higher-is-better; epe/flall are lower-is-better.
METRIC_MODE = {"epe": "min", "flall": "min", "px1": "max", "wauc": "max"}

_NO_DDP = ("training on more than one device is not ported yet: DDP is "
           "queued in ROADMAP.md (queue 1, item 2)")


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_model_args(parser)
    parser.add_argument("--train_dataset", type=str, default=None)
    parser.add_argument("--val_dataset", type=str, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--wdecay", type=float, default=None)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--max_epochs", type=int, default=None,
                        help="used when --max_steps is unset: max_steps = "
                        "epochs * ceil(steps_per_epoch / n_devices)")
    parser.add_argument("--train_batch_size", type=int, default=None)
    parser.add_argument("--train_crop_size", type=int, nargs=2, default=None)
    parser.add_argument("--train_num_workers", type=int, default=None)
    parser.add_argument("--grad_clip", "--gradient_clip_val",
                        dest="grad_clip", type=float, default=None,
                        help="global-norm gradient clip (falls back to the "
                        "config's trainer.gradient_clip_val, then 1.0); 0 "
                        "disables clipping")
    parser.add_argument("--accumulate_grad_batches", type=int, default=None,
                        help="average gradients over k micro-batches per "
                        "optimizer step (Lightning's "
                        "accumulate_grad_batches)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from <ckpt_dir>/<model>/last_state.ckpt "
                        "(weights, optimizer state and step), else the "
                        "newest HPC checkpoint, else the weights of "
                        "last.ckpt")
    parser.add_argument("--resume_ckpt", type=str, default=None,
                        help="checkpoint to resume from; a weights-only one "
                        "(no optimizer state) restores the weights and "
                        "starts a fresh optimizer")
    parser.add_argument("--val_every_n_steps", type=int, default=1000)
    parser.add_argument("--log_every_n_steps", type=int, default=100)
    parser.add_argument("--ckpt_dir", type=str, default="ptlflow_checkpoints")
    parser.add_argument("--seed", type=int, default=42,
                        help="seeds the weights (without a checkpoint), the "
                        "data order and the augmentations")
    parser.add_argument("--n_devices", type=int, default=None)
    parser.add_argument("--num_nodes", type=int, default=1)
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="torch.autograd.set_detect_anomaly(True): fail "
                        "at the first backward op that makes a NaN")
    parser.add_argument("--loggers", type=str, nargs="*",
                        default=["tensorboard"],
                        choices=["tensorboard", "wandb", "comet", "neptune",
                                 "swanlab", "none"],
                        help="scalar and image logging backends; missing "
                        "packages are skipped with a notice")
    parser.add_argument("--log_num_images", type=int, default=5,
                        help="flow-grid images logged per validation run")
    return parse_with_config(parser, argv)


@torch.no_grad()
def run_validation(model, dm, logger=None, step: int = 0,
                   num_images: int = 5) -> Dict[str, Dict[str, float]]:
    """The eval forward (``training=False``) over each validation loader:
    ``{dataset: {metric: value}}``, and flow grids of a few pairs to the
    logger."""
    device = next(model.parameters()).device
    results = {}
    for name, loader in zip(dm.val_dataset_names, dm.val_dataloader()):
        metrics = FlowMetrics()
        sampler = ImageSampler(num_images=num_images,
                               epoch_size=max(len(loader), 1)) \
            if logger is not None else None
        for i, batch in enumerate(loader):
            preds = model({"images": torch.as_tensor(batch["images"])
                           .to(device)})
            targets = {k: torch.as_tensor(batch[k]).to(device)
                       for k in ("flows", "valids") if k in batch}
            metrics.update({"flows": preds["flows"]}, targets)
            if sampler is not None and sampler.should_log(i):
                img = np.asarray(batch["images"][0, 0]).transpose(1, 2, 0)
                pred = preds["flows"][0, 0].permute(1, 2, 0).float() \
                    .cpu().numpy()
                gt = np.asarray(batch["flows"][0, 0]).transpose(1, 2, 0)
                logger.log_image(f"val/{name}/{i}",
                                 make_flow_grid(img, pred, gt), step)
        results[name] = metrics.compute()
    return results


def _resume(args, model, state, ckpt_dir: Path, manager: CheckpointManager):
    """The training state to start from and its step: ``--resume_ckpt``,
    else (``--resume``) ``last_state.ckpt``, an HPC checkpoint or
    ``last.ckpt``.  A file without optimizer state restores the weights
    only."""
    path = args.resume_ckpt
    if path is None:
        cand = ckpt_dir / "last_state.ckpt"
        path = str(cand) if cand.exists() else manager.resolve_resume_path()
    if path is None:
        print("--resume: no checkpoint found; starting fresh")
        return state
    ckpt = load_checkpoint(path)
    model.load_state_dict(split_checkpoint(ckpt)[0], strict=True)
    if not (isinstance(ckpt, dict) and "optimizer" in ckpt):
        print(f"resumed weights only from {path}")
        return state
    state = load_optimizer_state(state, ckpt["optimizer"])
    print(f"resumed training state from {path} at step {state.step}")
    return state


def train(args, timings: Optional[Dict[str, List[float]]] = None) -> dict:
    """Train as the flags say; returns ``{"model", "state", "steps",
    "ckpt_dir", "losses", "best_val"}``.  ``timings``, where given, receives
    per step the host ms spent waiting for the batch (``wait_ms``), the
    host ms from asking for the batch to the loss on the host
    (``step_ms``; each step then waits for the card) and, on the card, the
    step's ms by CUDA events (``step_event_ms``); per validation, the host
    ms to write its checkpoints (``save_ms``: ``last.ckpt``, a new best
    ``step<N>.ckpt``, ``last_state.ckpt``)."""
    if (args.n_devices or 1) > 1 or args.num_nodes > 1:
        raise NotImplementedError(_NO_DDP)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    random.seed(args.seed)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    cfg = load_config(args)
    model, model_name = model_from_args(args, cfg)
    if not (args.ckpt_path or cfg.get("ckpt_path")):
        model.init_params(args.seed)
    if model.loss_fn is None:
        raise ValueError(f"model {model_name} has no loss function and "
                         f"cannot be trained")
    device = next(model.parameters()).device

    train_cfg = cfg.get("trainer", {})
    lr = args.lr or cfg.get("model", {}).get("init_args", {}).get("lr") \
        or 1e-4
    wdecay = args.wdecay or 1e-4
    max_steps = args.max_steps or train_cfg.get("max_steps")

    dm = datamodule_from_cfg(
        cfg, output_stride=model.output_stride,
        train_dataset=args.train_dataset, val_dataset=args.val_dataset,
        train_batch_size=args.train_batch_size,
        train_crop_size=tuple(args.train_crop_size)
        if args.train_crop_size else None,
        train_num_workers=args.train_num_workers)
    dm.setup("fit")
    if dm.train_data is None:
        raise ValueError("no training dataset: pass --train_dataset or set "
                         "data.train_dataset in the config")
    loader = dm.train_dataloader()

    if not max_steps:
        # epochs -> steps (reference base_model.py:507-539), on one device
        max_epochs = args.max_epochs or train_cfg.get("max_epochs")
        if max_epochs:
            steps_per_epoch = max(1, math.ceil(len(dm.train_data)
                                               / (dm.train_batch_size or 1)))
            max_steps = max_epochs * steps_per_epoch
            print(f"--max_steps unset: using {max_steps} ({max_epochs} "
                  f"epochs * {steps_per_epoch} steps / 1 device)")
        else:
            max_steps = 100000
    accum = (args.accumulate_grad_batches
             or train_cfg.get("accumulate_grad_batches") or 1)
    grad_clip = args.grad_clip
    if grad_clip is None:
        grad_clip = train_cfg.get("gradient_clip_val", 1.0)
    if not grad_clip:  # 0 disables clipping (Lightning semantics)
        grad_clip = None
    tx = make_optimizer(lr=lr, wdecay=wdecay, total_steps=max_steps,
                        grad_clip=grad_clip, accumulate_steps=accum)
    if accum > 1:
        print(f"gradient accumulation: {accum} micro-batches per "
              f"optimizer step")
    state = create_train_state(model, tx)
    step_fn = build_train_step(model, tx)

    ckpt_dir = Path(args.ckpt_dir) / model_name
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    main_name = dm.val_dataset_names[0] if dm.val_dataset_names else ""
    main_key = next((v for k, v in DATASET_MAIN_METRIC.items()
                     if k in main_name), "epe")
    main_mode = METRIC_MODE.get(main_key, "min")
    manager = CheckpointManager(str(ckpt_dir), top_k=1,
                                monitor=f"val/{main_key}", mode=main_mode)
    best_val = float("inf") if main_mode == "min" else -float("inf")
    hparams = {"model_name": model_name}

    def save_state():
        save_checkpoint(ckpt_dir / "last_state.ckpt", model.state_dict(),
                        hparams, optimizer=optimizer_state_dict(state))

    if args.resume or args.resume_ckpt:
        state = _resume(args, model, state, ckpt_dir, manager)

    backends = [b for b in args.loggers if b != "none"]
    logger = MultiLogger(str(ckpt_dir / "logs"), backends=backends,
                         project="ptlflow_tpu") if backends else None

    losses = []
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    print(f"training {model_name}: {max_steps} steps, lr={lr}, "
          f"device={device}")
    while state.step < max_steps:
        batches = iter(loader)
        epoch_start = state.step
        while state.step < max_steps:
            t_ask = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t_got = time.perf_counter()
            batch = {k: torch.as_tensor(v) for k, v in batch.items()
                     if k != "meta"}
            if timings is not None and on_card:
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                events[0].record()
            state, metrics = step_fn(state, batch)
            step = state.step
            if timings is not None:
                if on_card:
                    events[1].record()
                metrics["loss"].item()  # waits for the step
                t_done = time.perf_counter()
                timings.setdefault("wait_ms", []).append(
                    (t_got - t_ask) * 1e3)
                timings.setdefault("step_ms", []).append(
                    (t_done - t_ask) * 1e3)
                if on_card:
                    timings.setdefault("step_event_ms", []).append(
                        events[0].elapsed_time(events[1]))
            if step % args.log_every_n_steps == 0:
                loss = metrics["loss"].item()
                losses.append(loss)
                dt = time.perf_counter() - t0
                print(f"step {step}/{max_steps} loss={loss:.4f} "
                      f"({step / dt:.2f} it/s)")
                if logger is not None:
                    logger.log_scalars({"train/loss": loss,
                                        "train/it_per_s": step / dt}, step)
            if dm.val_data and step % args.val_every_n_steps == 0:
                results = run_validation(model, dm, logger=logger, step=step,
                                         num_images=args.log_num_images)
                for name, m in results.items():
                    print(f"  val {name}: epe={m.get('epe', -1):.4f}")
                    if logger is not None:
                        logger.log_scalars({f"val/{name}/{k}": float(v)
                                            for k, v in m.items()}, step)
                default = (float("inf") if main_mode == "min"
                           else -float("inf"))
                score = results[main_name].get(main_key, default)
                t_save = time.perf_counter()
                manager.save_step(model.state_dict(), step,
                                  {f"val/{main_key}": score}, hparams)
                improved = (score < best_val if main_mode == "min"
                            else score > best_val)
                if improved:
                    best_val = score
                    print(f"  new best {main_key}={score:.4f} -> saved")
                save_state()
                if timings is not None:
                    timings.setdefault("save_ms", []).append(
                        (time.perf_counter() - t_save) * 1e3)
        if state.step == epoch_start:
            raise ValueError(f"the training set ({len(dm.train_data)} "
                             f"samples) holds no full batch of "
                             f"{dm.train_batch_size}")

    if logger is not None:
        logger.flush()
        logger.close()
    save_checkpoint(ckpt_dir / "last.ckpt", model.state_dict(), hparams)
    save_state()
    with open(ckpt_dir / "train_info.json", "w") as f:
        json.dump({"model": model_name, "steps": state.step, "lr": lr,
                   "best_val": best_val}, f)
    print(f"done; checkpoints in {ckpt_dir}")
    return {"model": model, "state": state, "steps": state.step,
            "ckpt_dir": ckpt_dir, "losses": losses, "best_val": best_val}


def main(argv=None):
    return train(_parse_args(argv))


if __name__ == "__main__":
    main()
