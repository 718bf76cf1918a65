"""Benchmark-submission files from the PyTorch port (the JAX package's
``test.py``): runs a model over each dataset's test split and writes each
prediction under the benchmark's own naming (Sintel:
``<seq>/frame_NNNN.flo``; KITTI: ``flow/NNNNNN_10.png``; Spring:
``<seq>/flow_FW_<side>/flow_FW_<side>_NNNN.flo5``, which needs h5py).

    python -m ptlflow_tpu_torch.scripts.test --model raft \\
        --test_dataset sintel-test+kitti-2015-test [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ptlflow_tpu_torch.scripts.validate import forward_scale
from ptlflow_tpu_torch.utils import flow_io, image_io
from ptlflow_tpu_torch.utils.cli import (add_common_model_args,
                                         datamodule_from_cfg, load_config,
                                         model_from_args, parse_with_config)
from ptlflow_tpu_torch.utils.flow_viz import flow_to_rgb
from ptlflow_tpu_torch.utils.io_adapter import IOAdapter


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_model_args(parser)
    parser.add_argument("--test_dataset", type=str, default="sintel-test",
                        help="e.g. sintel-test+kitti-2015-test")
    parser.add_argument("--output_path", type=str, default="outputs/test")
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--scale_factor", type=float, default=None,
                        help="multiply the input by this factor before the "
                        "forward")
    parser.add_argument("--max_forward_side", type=int, default=None,
                        help="downscale inputs whose longest side exceeds "
                        "this; predictions are upscaled back")
    parser.add_argument("--save_viz", action="store_true",
                        help="also save RGB flow visualizations")
    return parse_with_config(parser, argv)


def generate_outputs(model, loader, dataset_name: str, out_root: Path,
                     max_samples=None, args=None):
    """Each test sample's flow, written under the benchmark's naming."""
    device = model.device
    for i, batch in enumerate(loader):
        if max_samples is not None and i >= max_samples:
            break
        images = torch.from_numpy(batch["images"]).to(device)
        scale = forward_scale(images.shape, args) if args is not None \
            else None
        adapter = IOAdapter(model, device=device, target_scale_factor=scale,
                            interpolation_align_corners=False)
        preds = model(adapter.prepare_inputs(images))
        flows = adapter.unscale({"flows": preds["flows"]})["flows"]
        flow = flows[0, 0].permute(1, 2, 0).float().cpu().numpy()
        meta = batch.get("meta", {})
        img_path = None
        if meta.get("image_paths"):
            first = meta["image_paths"][0]
            img_path = Path(first[0] if isinstance(first, list) else first)
        if dataset_name.startswith("sintel"):
            seq = meta.get("misc", ["seq"])[0]
            sub = out_root / dataset_name / seq
            sub.mkdir(parents=True, exist_ok=True)
            name = img_path.stem if img_path is not None else f"frame_{i:04d}"
            flow_io.write_flo(sub / f"{name}.flo", flow)
        elif dataset_name.startswith("kitti"):
            sub = out_root / dataset_name / "flow"
            sub.mkdir(parents=True, exist_ok=True)
            name = img_path.name if img_path is not None else f"{i:06d}_10.png"
            flow_io.write_flow_png(sub / name, flow)
        elif dataset_name.startswith("spring"):
            seq_side = meta.get("misc", ["0000_left"])[0]
            seq, side = seq_side.rsplit("_", 1)
            sub = out_root / dataset_name / seq / f"flow_FW_{side}"
            sub.mkdir(parents=True, exist_ok=True)
            name = img_path.stem.replace("frame", "flow_FW") \
                if img_path is not None else f"flow_FW_{side}_{i:04d}"
            flow_io.write_flo5(sub / f"{name}.flo5", flow)
        else:
            sub = out_root / dataset_name
            sub.mkdir(parents=True, exist_ok=True)
            flow_io.write_flo(sub / f"{i:06d}.flo", flow)
        if args is not None and args.save_viz:
            vdir = out_root / dataset_name / "viz"
            vdir.mkdir(parents=True, exist_ok=True)
            image_io.imwrite(vdir / f"{i:06d}.png",
                             flow_to_rgb(flow)[..., ::-1])


def main(argv=None):
    args = _parse_args(argv)
    cfg = load_config(args)
    model, model_name = model_from_args(args, cfg)
    dm = datamodule_from_cfg(cfg, output_stride=model.output_stride,
                             test_dataset=args.test_dataset)
    dm.setup("test")
    out_root = Path(args.output_path) / (model_name or "model")
    for name, loader in zip(dm.test_dataset_names, dm.test_dataloader()):
        generate_outputs(model, loader, name, out_root, args.max_samples,
                         args=args)
        print(f"wrote {name} submission files to {out_root / name}")
    return out_root


if __name__ == "__main__":
    main()
