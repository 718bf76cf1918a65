"""Offline validation of the PyTorch port (the JAX package's ``validate.py``):
EPE/px/Fl/WAUC per dataset, ``--scale_factor`` / ``--max_forward_side``
through ``IOAdapter``, model x checkpoint sweeps (``--all``/``--select``/
``--exclude``), per-sample metrics tables, flow/viz/EPE output files, and
warm start on continuous sequences (``--warm_start``).

    python -m ptlflow_tpu_torch.scripts.validate --model raft \\
        --val_dataset sintel-clean-trainval [--device cpu]

Runs on the card unless ``--device cpu``; raises where CUDA is absent.  Each
batch goes to the device once, and images, flows, predictions and metrics
stay there; only the per-sample metrics (one copy per pair) and, with
``--write_outputs``, the predicted flow come back to the host.
"""

from __future__ import annotations

import argparse
import csv
import inspect
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

import ptlflow_tpu_torch
from ptlflow_tpu_torch.nn import cast_params
from ptlflow_tpu_torch.utils import flow_io, image_io
from ptlflow_tpu_torch.utils.cli import (add_common_model_args,
                                         datamodule_from_cfg, load_config,
                                         model_from_args,
                                         model_name_from_args,
                                         parse_with_config)
from ptlflow_tpu_torch.utils.flow_metrics import FlowMetrics
from ptlflow_tpu_torch.utils.flow_viz import apply_jet, flow_to_rgb
from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

# The JAX package's bf16 sweep (ptlflow_tpu/utils/bf16_allowlist.json,
# copied): the models whose weights validate --bf16 may cast to bfloat16.
BF16_ALLOWLIST = (Path(__file__).resolve().parent.parent / "utils"
                  / "bf16_allowlist.json")


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_model_args(parser)
    parser.add_argument("--all", action="store_true",
                        help="validate all models with pretrained ckpts")
    parser.add_argument("--select", type=str, nargs="*", default=None)
    parser.add_argument("--exclude", type=str, nargs="*", default=None)
    parser.add_argument("--val_dataset", "--data.val_dataset",
                        dest="val_dataset", type=str,
                        default="sintel-clean-trainval")
    parser.add_argument("--output_path", type=str, default="outputs/validate")
    parser.add_argument("--write_outputs", action="store_true")
    parser.add_argument("--scale_factor", type=float, default=None)
    parser.add_argument("--max_forward_side", type=int, default=None)
    parser.add_argument("--warm_start", action="store_true")
    parser.add_argument("--iters", type=int, default=None)
    parser.add_argument("--seq_val_mode", type=str, default="all",
                        choices=("all", "first", "middle", "last"),
                        help="which prediction frame to evaluate when the "
                        "model predicts more than one")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 inference: the model's mixed_precision "
                        "mode (bf16 weights and activations, fp32 flow); "
                        "for a model without one, its weights cast to "
                        "bf16 if it is on the bf16 allow-list, else fp32")
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--show", action="store_true",
                        help="display results on screen: not available in "
                        "the port (no OpenCV window)")
    parser.add_argument("--max_show_side", type=int, default=1000)
    parser.add_argument("--flow_format", type=str, default="original",
                        choices=("flo", "png", "original"),
                        help="format for saved flow; 'original' matches the "
                        "dataset's GT format")
    parser.add_argument("--reversed", action="store_true",
                        help="with --all/--select: iterate the model list "
                        "in reversed order")
    parser.add_argument("--write_individual_metrics", action="store_true",
                        help="save a per-image metrics table")
    parser.add_argument("--epe_clip", type=float, default=5.0,
                        help="EPE clipping for the error-map visualization")
    parser.add_argument("--metric_exclude", type=str, nargs="*", default=None,
                        help="metric names to drop from saved results")
    parser.add_argument("--spatial_shards", type=int, default=None,
                        help="shard the correlation volume over N devices: "
                        "not available in the port yet")
    return parse_with_config(parser, argv)


def forward_scale(images_shape, args) -> Optional[float]:
    """The input scale of ``--scale_factor`` / ``--max_forward_side``:
    ``max_forward_side`` caps the longest side, else ``scale_factor``
    applies; None when no scaling is needed."""
    scale = args.scale_factor
    if args.max_forward_side is not None:
        side = max(int(images_shape[-2]), int(images_shape[-1]))
        if side > args.max_forward_side:
            scale = args.max_forward_side / side
    if scale is None or scale == 1.0:
        return None
    return scale


class _StageClock:
    """Per-stage time of one pair: the host clock for host work, CUDA
    events around the device work on the card (read once the pair's
    metrics have been copied to the host, which waits for them)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, list] = {}

    def start(self, name: str):
        self.marks[name] = [self._now()]

    def stop(self, name: str):
        self.marks[name].append(self._now())

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, name: str) -> float:
        a, b = self.marks[name]
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def validate_one_dataloader(model, loader, dataset_name: str, args,
                            out_dir: Path,
                            timings: Optional[Dict[str, List[float]]] = None
                            ) -> Dict[str, float]:
    """Metrics of ``model`` over one loader.  ``timings``, where given,
    receives per pair the host ms to read and decode it (``decode_ms``),
    the device ms of the forward (``forward_ms``) and of the metrics
    (``metrics_ms``), the host ms to write its outputs (``write_ms``) and
    the host ms of the whole pair (``pair_ms``)."""
    device = model.device
    metrics = FlowMetrics()
    rows = []
    prev_preds = None
    batches = iter(loader)
    i = 0
    while args.max_samples is None or i < args.max_samples:
        t0 = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            break
        decode_ms = (time.perf_counter() - t0) * 1e3
        clock = _StageClock(device)
        images = torch.from_numpy(batch["images"]).to(device)
        adapter = IOAdapter(model, device=device,
                            target_scale_factor=forward_scale(images.shape,
                                                              args),
                            interpolation_align_corners=False)
        inputs = adapter.prepare_inputs(images)
        meta = batch.get("meta", {})
        if args.warm_start:
            starts = meta.get("is_seq_start", [True])
            if starts and starts[0]:
                prev_preds = None
            if prev_preds is not None:
                inputs["prev_preds"] = prev_preds
        clock.start("forward")
        preds = model(inputs)
        clock.stop("forward")
        if args.warm_start and "flow_small" in preds:
            prev_preds = {"flow_small": preds["flow_small"]}
        # predictions back at the input resolution, flows rescaled; the
        # model-resolution outputs ("flow_small") stay as they are
        small = {k: v for k, v in preds.items() if "small" in k}
        preds = dict(adapter.unscale({k: v for k, v in preds.items()
                                      if k not in small}), **small)
        n_flows = batch["flows"].shape[1] if "flows" in batch else 1
        if n_flows > 1 and args.seq_val_mode != "all":
            # evaluate a single frame of multi-frame predictions
            if args.seq_val_mode == "first":
                k = 0
            elif args.seq_val_mode == "middle":
                k = batch["images"].shape[1] // 2
            else:
                k = n_flows - 1
            for key in ("flows", "valids", "occs"):
                if key in batch and batch[key].ndim == 5:
                    batch[key] = batch[key][:, k:k + 1]
            if preds["flows"].shape[1] > 1:
                preds = dict(preds, flows=preds["flows"][:, k:k + 1])
        targets = None
        if "flows" in batch:
            targets = {key: torch.from_numpy(batch[key]).to(device)
                       for key in ("flows", "valids", "occs") if key in batch}
            clock.start("metrics")
            metrics.update({"flows": preds["flows"]}, targets)
            clock.stop("metrics")
            if args.write_individual_metrics:
                one = FlowMetrics()
                one.update({"flows": preds["flows"]}, targets)
                rows.append({"dataset": dataset_name, "index": i,
                             **one.compute()})
        t1 = time.perf_counter()
        if args.write_outputs:
            _write_outputs(preds["flows"], batch, targets is not None,
                           dataset_name, i, out_dir, args)
        if timings is not None:
            t2 = time.perf_counter()
            timings.setdefault("decode_ms", []).append(decode_ms)
            timings.setdefault("forward_ms", []).append(clock.ms("forward"))
            if targets is not None:
                timings.setdefault("metrics_ms", []).append(
                    clock.ms("metrics"))
            if args.write_outputs:
                timings.setdefault("write_ms", []).append((t2 - t1) * 1e3)
            timings.setdefault("pair_ms", []).append((t2 - t0) * 1e3)
        i += 1
    if rows and args.write_individual_metrics:
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f"{dataset_name}_individual_metrics.csv", "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return metrics.compute()


def _write_outputs(flows: torch.Tensor, batch, has_gt: bool,
                   dataset_name: str, i: int, out_dir: Path, args) -> None:
    """The first flow of the pair as ``{i:06d}.{flo|png}``, its colour
    visualization and, with GT, its EPE map clipped at ``--epe_clip``
    (OpenCV's JET colours)."""
    flow = flows[0, 0].permute(1, 2, 0).float().cpu().numpy()
    sub = out_dir / dataset_name
    sub.mkdir(parents=True, exist_ok=True)
    stem = f"{i:06d}"
    fmt = args.flow_format
    if fmt == "original":
        # the dataset's own GT format: KITTI/HD1K 16-bit PNG, else .flo
        fmt = ("png" if any(s in dataset_name.lower()
                            for s in ("kitti", "hd1k")) else "flo")
    flow_io.flow_write(sub / f"{stem}.{fmt}", flow)
    image_io.imwrite(sub / f"{stem}_viz.png", flow_to_rgb(flow)[..., ::-1])
    if has_gt:
        gt = np.transpose(batch["flows"][0, 0], (1, 2, 0))
        epe_map = np.linalg.norm(flow - gt, axis=-1)
        clip = max(args.epe_clip, 1e-6)
        epe_img = (np.clip(epe_map / clip, 0, 1) * 255).astype(np.uint8)
        image_io.imwrite(sub / f"{stem}_epe.png", apply_jet(epe_img))


def has_mixed_mode(model_cls) -> bool:
    """Whether the model class takes ``mixed_precision``."""
    params = inspect.signature(model_cls.__init__).parameters
    return "mixed_precision" in params


def cast_to_bf16(model: torch.nn.Module, model_name: str) -> bool:
    """``validate --bf16`` for a model without a mixed-precision mode, as
    the JAX ``validate.py`` (:257-293) does it: the weights cast to
    bfloat16 in place (norm statistics stay float32) where the bf16
    allow-list has the model, with a notice where it has it only as
    provisional; otherwise a notice, and the model stays float32.  Every
    layer then casts its weights to its input's dtype, so the forward of
    float32 images computes in float32 on bf16-rounded weights, as the JAX
    package's does.  Returns whether it cast."""
    with open(BF16_ALLOWLIST) as f:
        lists = json.load(f)
    provisional = set(lists.get("provisional", []))
    if model_name not in set(lists["allow"]) | provisional:
        print(f"[{model_name}] not on the bf16 allow-list "
              f"({BF16_ALLOWLIST.name}); validating in fp32")
        return False
    if model_name in provisional:
        print(f"[{model_name}] bf16 support is PROVISIONAL (random-weight "
              f"rel delta 0.3-1.0; re-validate with real checkpoints — "
              f"scripts/run_accuracy.sh)")
    cast_params(model, torch.bfloat16)
    return True


def validate(args, model=None, model_name: Optional[str] = None,
             timings: Optional[Dict[str, Dict[str, List[float]]]] = None):
    """Validate ``model`` (or the one ``args`` names) on every dataset of
    ``args.val_dataset``; writes ``metrics.csv`` under
    ``<output_path>/<model>`` and returns ``{dataset: {metric: value}}``.
    ``timings``, where given, receives per dataset the per-pair stage
    times of ``validate_one_dataloader``."""
    if args.show:
        raise NotImplementedError("--show needs a display window (OpenCV's "
                                  "highgui), which the port does not use; "
                                  "write the images with --write_outputs")
    if args.spatial_shards:
        raise NotImplementedError("--spatial_shards is not ported yet "
                                  "(ROADMAP, queue 1, item 9)")
    cfg = load_config(args)
    init_args = {}
    if args.iters is not None:
        init_args["iters"] = args.iters
    if model is None:
        model_name = model_name_from_args(args, cfg)
        if args.bf16 and has_mixed_mode(
                ptlflow_tpu_torch.get_model_reference(model_name)):
            init_args["mixed_precision"] = True
        model, model_name = model_from_args(args, cfg, init_args)
    elif args.iters is not None and hasattr(model, "iters"):
        model.iters = args.iters
    if args.bf16 and not getattr(model, "mixed_precision", False):
        if has_mixed_mode(type(model)):
            raise ValueError(f"--bf16: {model_name} was built without its "
                             f"mixed-precision mode")
        cast_to_bf16(model, model_name)

    dm = datamodule_from_cfg(cfg, output_stride=model.output_stride,
                             val_dataset=args.val_dataset)
    dm.setup("validate")

    out_dir = Path(args.output_path) / (model_name or "model")
    out_dir.mkdir(parents=True, exist_ok=True)

    all_metrics = {}
    drop = set(args.metric_exclude or [])
    for name, loader in zip(dm.val_dataset_names, dm.val_dataloader()):
        stage = None if timings is None else timings.setdefault(name, {})
        m = validate_one_dataloader(model, loader, name, args, out_dir, stage)
        m = {k: v for k, v in m.items() if k not in drop}
        print(f"[{model_name}] {name}: " +
              ", ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())
                        if k in ("epe", "px1", "flall", "wauc")))
        all_metrics[name] = m

    with open(out_dir / "metrics.csv", "w", newline="") as f:
        writer = csv.writer(f)
        keys = sorted({k for m in all_metrics.values() for k in m})
        writer.writerow(["model", "checkpoint", "dataset"] + keys)
        for name, m in all_metrics.items():
            writer.writerow([model_name, args.ckpt_path or "", name] +
                            [f"{m.get(k, float('nan')):.6f}" for k in keys])
    return all_metrics


def validate_list_of_models(args):
    """The ``--all``/``--select`` sweep over models and their pretrained
    checkpoints; a model that fails is reported and skipped."""
    names = list(args.select or ptlflow_tpu_torch.get_model_names())
    if args.reversed:
        names.reverse()
    exclude = set(args.exclude or [])
    for name in names:
        if name in exclude:
            continue
        ref = ptlflow_tpu_torch.get_model_reference(name)
        ckpts = list(getattr(ref, "pretrained_checkpoints", {}) or [None])
        for ckpt in ckpts:
            args.model, args.ckpt_path = name, ckpt
            try:
                validate(args)
            except Exception as e:  # the sweep goes on past a failure
                print(f"[skip] {name}/{ckpt}: {type(e).__name__}: {e}")


def main(argv=None):
    args = _parse_args(argv)
    if args.all or args.select:
        validate_list_of_models(args)
    else:
        validate(args)


if __name__ == "__main__":
    main()
