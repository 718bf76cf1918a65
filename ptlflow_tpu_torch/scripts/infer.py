"""Inference of the PyTorch port on image pairs and folders of frames (the
JAX package's ``infer.py``): writes flow files and colour visualizations,
optionally warm-starting each pair from the last.

    python -m ptlflow_tpu_torch.scripts.infer --model raft \\
        --input_path frame1.png frame2.png [--device cpu]

Images are read without OpenCV (PNG, PPM, PGM; ``utils/image_io.py``).
Video files and webcams need OpenCV's video capture and are refused.  Runs
on the card unless ``--device cpu``; raises where CUDA is absent.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np
import torch

import ptlflow_tpu_torch
from ptlflow_tpu_torch.nn import cast_params
from ptlflow_tpu_torch.scripts.validate import has_mixed_mode
from ptlflow_tpu_torch.utils import flow_io, image_io
from ptlflow_tpu_torch.utils.cli import (add_common_model_args, load_config,
                                         model_from_args,
                                         model_name_from_args,
                                         parse_with_config)
from ptlflow_tpu_torch.utils.flow_viz import flow_to_rgb
from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

IMG_EXTS = (".png", ".ppm", ".pgm", ".pnm")
VID_EXTS = (".mp4", ".avi", ".mkv", ".webm")


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_model_args(parser)
    parser.add_argument("--input_path", type=str, nargs="+", required=True,
                        help="two or more images, or a folder of frames")
    parser.add_argument("--output_path", type=str, default="outputs/infer")
    parser.add_argument("--flow_format", type=str, default="flo",
                        choices=["flo", "png", "flo5", "npy"])
    parser.add_argument("--gt_path", type=str, default=None,
                        help="optional GT flow to print EPE")
    parser.add_argument("--scale_factor", type=float, default=None)
    parser.add_argument("--write_viz", action="store_true", default=True)
    parser.add_argument("--not_write_outputs", action="store_true",
                        help="do not save flow/viz files")
    parser.add_argument("--input_size", type=int, nargs=2, default=[0, 0],
                        help="if larger than zero, resize the input before "
                        "forwarding")
    parser.add_argument("--warm_start", action="store_true",
                        help="initialise each pair's flow from the previous "
                        "pair's (consecutive frames of one sequence)")
    parser.add_argument("--show", action="store_true",
                        help="display each result: not available in the "
                        "port (no OpenCV window)")
    parser.add_argument("--bf16", action="store_true",
                        help="the model's mixed_precision mode; a model "
                        "without one gets its weights cast to bf16")
    return parse_with_config(parser, argv)


def init_input(input_path: List[str]) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, BGR frame) of each image, or of each image of a folder in
    name order."""
    if len(input_path) == 1 and (input_path[0].isdigit()
                                 or Path(input_path[0]).suffix.lower()
                                 in VID_EXTS):
        raise NotImplementedError(
            f"{input_path[0]}: video files and webcams need OpenCV's video "
            f"capture, which the port does not use; pass the frames as "
            f"images or a folder of them")
    if len(input_path) == 1 and Path(input_path[0]).is_dir():
        paths = sorted(p for p in Path(input_path[0]).iterdir()
                       if p.suffix.lower() in IMG_EXTS)
    else:
        paths = [Path(p) for p in input_path]
    for p in paths:
        yield p.stem, image_io.imread(p)


def infer(args) -> List[Path]:
    """Flow of each consecutive pair of frames; returns the flow files
    written."""
    if args.show:
        raise NotImplementedError("--show needs a display window (OpenCV's "
                                  "highgui), which the port does not use")
    cfg = load_config(args)
    mixed = args.bf16 and has_mixed_mode(
        ptlflow_tpu_torch.get_model_reference(model_name_from_args(args, cfg)))
    model, _ = model_from_args(args, cfg,
                               {"mixed_precision": True} if mixed else None)
    if args.bf16 and not mixed:
        # as the JAX infer.py does: the weights cast to bfloat16, every one
        # (no allow-list); each layer casts them back to its input's dtype
        cast_params(model, torch.bfloat16)

    in_size = args.input_size or [0, 0]
    target_size = tuple(in_size) if min(in_size) > 0 else None
    io_adapter = IOAdapter(model, target_scale_factor=args.scale_factor,
                           target_size=target_size)

    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    prev_name, prev_frame, prev_preds = None, None, None
    for cur_name, frame in init_input(args.input_path):
        if prev_frame is None:
            prev_name, prev_frame = cur_name, frame
            continue
        inputs = io_adapter.prepare_inputs([prev_frame, frame])
        if args.warm_start and prev_preds is not None:
            inputs["prev_preds"] = prev_preds
        preds = model(inputs)
        if args.warm_start and "flow_small" in preds:
            prev_preds = {"flow_small": preds["flow_small"]}
        flows = io_adapter.unscale({"flows": preds["flows"]})["flows"]
        flow_hwc = flows[0, 0].permute(1, 2, 0).float().cpu().numpy()

        stem = f"{prev_name}"
        if not args.not_write_outputs:
            path = out_dir / f"{stem}.{args.flow_format}"
            flow_io.flow_write(path, flow_hwc)
            written.append(path)
            if args.write_viz:
                image_io.imwrite(out_dir / f"{stem}_viz.png",
                                 flow_to_rgb(flow_hwc)[..., ::-1])
        if args.gt_path is not None:
            gt = flow_io.flow_read(args.gt_path)
            valid = ~np.isnan(gt[..., 0])
            epe = np.linalg.norm(flow_hwc - np.nan_to_num(gt), axis=-1)
            print(f"{stem}: EPE = {epe[valid].mean():.4f}")
        prev_name, prev_frame = cur_name, frame
    print(f"wrote outputs to {out_dir}")
    return written


def main(argv=None):
    infer(_parse_args(argv))


if __name__ == "__main__":
    main()
