"""Speed and size of the PyTorch port's models (the JAX package's
``model_benchmark.py``): parameters, FLOPs, time per forward and peak memory
over models x datatypes, appended to ``<output_path>/benchmark.csv`` with
the JAX script's columns.

    python -m ptlflow_tpu_torch.scripts.model_benchmark --models raft \\
        --input_size 436 1024 --datatypes fp32 bf16 [--device cpu]

On the card, each trial times ``--num_samples`` forwards by CUDA events
after ``--warmup`` forwards, and ``--final_speed_mode`` reduces the
``--num_trials`` trials; fp32 runs with TF32 off; ``bf16`` is the model's
mixed_precision mode (bf16 weights and activations, fp32 flow), refused by
models without one.  Peak memory is ``torch.cuda.max_memory_allocated``.
FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
forward: it counts the matmuls and convolutions that dispatch through
PyTorch's operators, not the hand-written correlation lookup (a kernel
launched outside them), nor elementwise work; the JAX script's figure is
XLA's ``cost_analysis``, which counts every fused operation, so the two do
not compare.  With ``--device cpu`` the times are host-clock times of the
CPU and the memory column is empty.
"""

from __future__ import annotations

import argparse
import csv
import signal
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

import ptlflow_tpu_torch
from ptlflow_tpu_torch.utils.cli import (add_device_arg, parse_with_config,
                                         resolve_device)

FIELDNAMES = ["model", "datatype", "input_h", "input_w", "params", "flops",
              "time_ms", "fps", "mem_gb", "commit", "device"]
CSV_NOTE = ("# flops: torch.utils.flop_counter.FlopCounterMode over one "
            "forward (matmuls and convolutions; not the hand-written "
            "correlation lookup, not elementwise ops; not comparable with "
            "the JAX package's XLA cost_analysis); time_ms: CUDA events on "
            "the card, host clock on the CPU; fp32 with TF32 off")


def _parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default=None,
                        help="YAML with top-level keys matching these flags "
                        "(e.g. configs/results/model_benchmark_all.yaml)")
    parser.add_argument("--models", "--select", dest="models", type=str,
                        nargs="*", default=None)
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--exclude", type=str, nargs="*", default=[])
    parser.add_argument("--input_size", type=int, nargs=2,
                        default=(500, 1000))
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--datatypes", type=str, nargs="*",
                        default=["fp32"], choices=["fp32", "bf16"])
    parser.add_argument("--iters", type=int, default=None,
                        help="override model GRU iterations")
    parser.add_argument("--corr_dtype", type=str, default=None,
                        choices=["bfloat16", "float32"],
                        help="correlation-volume storage dtype for models "
                        "that take it (raft, sea_raft)")
    parser.add_argument("--warmup", type=int, default=3,
                        help="forwards before the timed trials")
    parser.add_argument("--num_samples", type=int, default=3,
                        help="forwards per trial")
    parser.add_argument("--num_trials", type=int, default=3)
    parser.add_argument("--final_speed_mode", type=str, default="min",
                        choices=["min", "avg", "median"])
    parser.add_argument("--sleep_interval", type=float, default=0.0,
                        help="seconds to sleep between models")
    parser.add_argument("--output_path", type=str,
                        default="outputs/benchmark")
    parser.add_argument("--per_model_timeout", type=int, default=None,
                        help="seconds; abort one model's benchmark and "
                        "continue the sweep")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of one forward "
                        "to <output_path>/trace")
    add_device_arg(parser)
    return parse_with_config(parser, argv)


def count_flops(model, inputs) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(inputs)
    return float(counter.get_total_flops())


def trial_ms(model, inputs, device: torch.device, num_samples: int) -> float:
    """Mean ms per forward over ``num_samples`` forwards in a row: CUDA
    events on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(num_samples):
            model(inputs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / num_samples
    t0 = time.perf_counter()
    for _ in range(num_samples):
        model(inputs)
    return (time.perf_counter() - t0) * 1e3 / num_samples


def benchmark_one(name: str, dtype: str, input_size, iters, num_samples: int,
                  device: torch.device, batch_size: int = 1,
                  num_trials: int = 3, speed_mode: str = "min",
                  corr_dtype: str = None, warmup: int = 3,
                  profile_dir=None) -> Dict:
    args = {}
    if iters is not None:
        args["iters"] = iters
    if corr_dtype is not None:
        args["corr_dtype"] = corr_dtype
    if dtype == "bf16":
        args["mixed_precision"] = True
    model = ptlflow_tpu_torch.get_model(name, args=args, device=device)
    if dtype == "bf16" and not getattr(model, "mixed_precision", False):
        raise ValueError(f"{name}: no mixed-precision mode")
    n_params = sum(v.numel() for k, v in model.state_dict().items()
                   if not k.endswith("num_batches_tracked"))
    h, w = input_size
    rng = np.random.RandomState(0)
    n_imgs = getattr(model, "required_images", 2)
    images = torch.from_numpy(
        rng.rand(batch_size, n_imgs, 3, h, w).astype(np.float32)).to(device)
    inputs = {"images": images}

    cuda = device.type == "cuda"
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        flops = count_flops(model, inputs)
        for _ in range(warmup):
            model(inputs)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        times = [trial_ms(model, inputs, device, num_samples)
                 for _ in range(num_trials)]
        mem_gb = (torch.cuda.max_memory_allocated(device) / 1e9 if cuda
                  else float("nan"))
        if profile_dir is not None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            with profile(activities=acts) as prof:
                model(inputs)
                if cuda:
                    torch.cuda.synchronize(device)
            trace = Path(profile_dir) / f"{name}_{dtype}.json"
            prof.export_chrome_trace(str(trace))
            print(f"profiler trace written to {trace}")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    if speed_mode == "avg":
        ms = sum(times) / len(times)
    elif speed_mode == "median":
        ms = sorted(times)[len(times) // 2]
    else:
        ms = min(times)
    return {
        "model": name, "datatype": dtype, "input_h": h, "input_w": w,
        "params": n_params, "flops": flops, "time_ms": ms,
        "fps": 1e3 / ms, "mem_gb": mem_gb, "commit": _git_commit(),
        "device": (torch.cuda.get_device_name(device) if cuda else "cpu"),
        "trials_ms": times,
    }


def _git_commit() -> str:
    """The checkout's commit (``-dirty`` with local changes), or "unknown"
    outside a git checkout."""
    here = Path(__file__).resolve().parent
    try:
        sha = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=here, capture_output=True, text=True,
                             timeout=10).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "--untracked-files=no"],
            cwd=here, capture_output=True, text=True,
            timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return sha + ("-dirty" if dirty else "") if sha else "unknown"


def read_rows(csv_path: Path) -> List[Dict[str, str]]:
    """The rows of a benchmark CSV, past its ``#`` note."""
    with open(csv_path, newline="") as f:
        return list(csv.DictReader(line for line in f
                                   if not line.startswith("#")))


def main(argv=None) -> List[Dict]:
    args = _parse_args(argv)
    device = resolve_device(args)
    names = args.models or (ptlflow_tpu_torch.get_model_names() if args.all
                            else ["raft"])
    names = [n for n in names if n not in set(args.exclude)]
    out_dir = Path(args.output_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    csv_path = out_dir / "benchmark.csv"
    has_data = csv_path.exists() and csv_path.stat().st_size > 0
    # resume an interrupted sweep: skip the (model, datatype) rows it has
    done = ({(r["model"], r["datatype"]) for r in read_rows(csv_path)}
            if has_data else set())
    rows = []
    with open(csv_path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=FIELDNAMES,
                                extrasaction="ignore")
        if not has_data:
            f.write(CSV_NOTE + "\n")
            writer.writeheader()
            f.flush()
        for name in names:
            for dtype in args.datatypes:
                if (name, dtype) in done:
                    continue
                if args.per_model_timeout:
                    def _timeout(signum, frame):
                        raise TimeoutError(
                            f"exceeded {args.per_model_timeout}s")

                    signal.signal(signal.SIGALRM, _timeout)
                    signal.alarm(args.per_model_timeout)
                try:
                    row = benchmark_one(
                        name, dtype, args.input_size, args.iters,
                        args.num_samples, device,
                        batch_size=args.batch_size,
                        num_trials=args.num_trials,
                        speed_mode=args.final_speed_mode,
                        corr_dtype=args.corr_dtype, warmup=args.warmup,
                        profile_dir=(out_dir / "trace" if args.profile
                                     else None))
                except Exception as e:  # the sweep goes on past a failure
                    print(f"[skip] {name}/{dtype}: {type(e).__name__}: {e}")
                    continue
                finally:
                    if args.per_model_timeout:
                        signal.alarm(0)
                if args.sleep_interval > 0:
                    time.sleep(args.sleep_interval)
                rows.append(row)
                writer.writerow(row)
                f.flush()  # a crash keeps the rows before it
                print(f"{name} [{dtype}] on {row['device']}: "
                      f"{row['time_ms']:.3f} ms, "
                      f"{row['params'] / 1e6:.2f} M params, "
                      f"{row['flops'] / 1e9:.1f} GFLOPs")
    print(f"wrote {csv_path}")
    return rows


if __name__ == "__main__":
    main()
