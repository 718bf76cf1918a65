#!/usr/bin/env python3
"""Run the PyTorch port of ptlflow_tpu on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, each of which must pass, else the script exits non-zero:

1. build every CUDA kernel of ``ptlflow_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card;
3. serve 3 frame pairs at 436x1024 through ``raft`` and ``raft_small``
   (12 GRU iterations, seeded random weights) via IOAdapter -> model ->
   unscale, counting the kernel launches of each run;
4. run the same weights and input on the card and on the CPU (plain
   versions) and compare the flows;
5. time the kernel, its plain version and the PyTorch yardstick at the main
   path's shapes, the RAFT forward in fp32 and mixed precision, and profile
   one forward.

The second-to-last line is ``{"kernels": [...]}``, the line before it the
card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  With no card it prints no result and
exits 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 436, 1024  # Sintel frames: the main path's size
ITERS = 12
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12   # H100 SXM fp32 outside the tensor cores
# Plain-versus-kernel tolerances: fp32 sums of the same terms in another
# order; bf16 one rounding apart, compared in fp32.
ATOL_FP32 = 1e-5
RTOL_BF16, ATOL_BF16 = 1e-2, 1e-5
# Card against CPU, 12 iterations at 256x320, TF32 off (see phase 4).
ATOL_CARD_CPU_PX = 1e-2


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(torch, fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events around
    each call.  With ``flush`` the buffer is overwritten before every call,
    so the call finds the 50 MB L2 cold, as in the model, where the update
    block runs between two lookups; the overwrite also keeps the card busy
    while the host enqueues the call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def smooth_pair(seed: int, h: int, w: int, shift=(3, 2)):
    """A smooth random BGR texture and its copy moved by ``shift`` (x, y)
    pixels, as uint8 HWC frames."""
    import torch
    import torch.nn.functional as F

    rng = np.random.RandomState(seed)
    m = 16
    low = torch.from_numpy(rng.rand(1, 3, (h + 2 * m) // 8,
                                    (w + 2 * m) // 8).astype(np.float32))
    tex = F.interpolate(low, size=(h + 2 * m, w + 2 * m), mode="bicubic",
                        align_corners=False).clamp(0, 1)[0]
    tex = (tex.permute(1, 2, 0).numpy() * 255).astype(np.uint8)
    dx, dy = shift
    return (tex[m:m + h, m:m + w], tex[m - dy:m - dy + h, m - dx:m - dx + w])


def damp_flow_head(model, factor: float = 0.03) -> None:
    """Scale the last conv of the flow head: random RAFT weights otherwise
    step ~30 px per iteration and fp32 rounding grows ~5x per iteration, so
    two correct runs of 12 iterations need not agree.  Damped, the steps are
    of trained size."""
    import torch

    with torch.no_grad():
        conv = model.update_block.flow_head.conv2
        conv.weight.mul_(factor)
        conv.bias.mul_(factor)


def in_range_patch_elems(torch, coords, shapes, radius: int) -> int:
    """Elements of the (2r+2)^2 patches that fall inside each level for
    these coords: what the lookup must read."""
    p = 2 * radius + 2
    total = 0
    for i, (h2, w2) in enumerate(shapes):
        c = torch.floor(coords / 2 ** i).long() - radius  # (B, 2, H1, W1)
        x0, y0 = c[:, 0], c[:, 1]
        nx = (torch.minimum(x0 + p, torch.tensor(w2, device=c.device))
              - x0.clamp(min=0)).clamp(min=0)
        ny = (torch.minimum(y0 + p, torch.tensor(h2, device=c.device))
              - y0.clamp(min=0)).clamp(min=0)
        total += int((nx * ny).sum())
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.utils import cuda_build
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    pkg_dir = os.path.dirname(os.path.abspath(ptlflow_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        raise RuntimeError(f"ptlflow_tpu_torch came from {pkg_dir}, not from "
                           f"this checkout")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tag = card_tag()
    log(f"card: {tag}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    log(f"[1 build] {len(built)} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, (path, nvcc_log) in built.items():
        log(f"  {name}: {os.path.relpath(path, HERE)}")
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    # ---------------------------------------------------------------- 2
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    def case_inputs(b, h1, w1, h2, w2, c, lo, hi):
        f1, f2 = randn(b, c, h1, w1), randn(b, c, h2, w2)
        pyr = corr.build_corr_pyramid(f1, f2, 4)
        u = torch.rand(b, 2, h1, w1, generator=g).to(dev)
        scale = torch.tensor([w2, h2], device=dev).view(1, 2, 1, 1)
        coords = (lo + (hi - lo) * u) * scale  # fractions of the map size
        return pyr, coords

    hp, wp = -(-H // 8), -(-W // 8)  # raft at 1024x436: Q = 55*128 = 7040
    cases = [
        # name, (b, h1, w1, h2, w2, c, lo, hi), radius, dtype
        ("small Q=77, fp32, r=3", (1, 7, 11, 14, 22, 32, -0.3, 1.3), 3,
         torch.float32),
        ("small Q=77, fp32, r=4", (1, 7, 11, 14, 22, 32, -0.3, 1.3), 4,
         torch.float32),
        ("prime Q=37, fp32, r=4", (1, 1, 37, 8, 12, 16, -0.3, 1.3), 4,
         torch.float32),
        ("prime Q=37, bf16, r=3", (1, 1, 37, 8, 12, 16, -0.3, 1.3), 3,
         torch.bfloat16),
        ("batch 2, bf16, r=4", (2, 9, 13, 9, 13, 32, -0.3, 1.3), 4,
         torch.bfloat16),
        ("raft Q=7040, fp32, r=4", (1, hp, wp, hp, wp, 256, -0.1, 1.1), 4,
         torch.float32),
        ("raft Q=7040, bf16, r=4", (1, hp, wp, hp, wp, 256, -0.1, 1.1), 4,
         torch.bfloat16),
        ("raft_small Q=7040, fp32, r=3", (1, hp, wp, hp, wp, 128, -0.1, 1.1),
         3, torch.float32),
    ]
    main_err = None
    for label, shape, radius, dtype in cases:
        pyr, coords = case_inputs(*shape)
        pyr = [p.to(dtype) for p in pyr]
        got = corr.corr_lookup_kernel(pyr, coords, radius)
        torch.cuda.synchronize()
        want = corr.corr_pyramid_lookup_plain(pyr, coords, radius)
        err = (got.float() - want.float()).abs().max().item()
        log(f"[2 kernel vs plain] {label}: out {tuple(got.shape)} "
            f"{str(dtype)[6:]}, max |err| {err:.3e}")
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=ATOL_FP32)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=RTOL_BF16, atol=ATOL_BF16)
        if label.startswith("raft Q=7040, fp32"):
            main_err = err
            main_inputs = (pyr, coords)

    # ---------------------------------------------------------------- 3
    pairs = [smooth_pair(seed, H, W, shift=(2 + seed, 1 + seed))
             for seed in range(3)]
    launches = {}
    for name in ("raft", "raft_small"):
        model = ptlflow_tpu_torch.get_model(name, args={"iters": ITERS})
        adapter = IOAdapter(model)
        corr.corr_lookup_kernel.launches = 0
        for k, pair in enumerate(pairs):
            before = corr.corr_lookup_kernel.launches
            out = adapter.unscale(model(adapter.prepare_inputs(list(pair))))
            flows = out["flows"]
            torch.cuda.synchronize()
            if tuple(flows.shape) != (1, 1, 2, H, W):
                raise AssertionError(f"{name}: flows {tuple(flows.shape)}")
            if not torch.isfinite(flows).all():
                raise AssertionError(f"{name}: non-finite flows")
            n = corr.corr_lookup_kernel.launches - before
            if n != ITERS:
                raise AssertionError(f"{name}: {n} lookup launches in one "
                                     f"forward, expected {ITERS}")
            mean = flows.mean(dim=(0, 1, 3, 4)).tolist()
            log(f"[3 serve] {name} request {k}: flows {tuple(flows.shape)} "
                f"finite, mean flow ({mean[0]:.3f}, {mean[1]:.3f}) px, "
                f"{n} lookup launches")
        launches[name] = corr.corr_lookup_kernel.launches
        if launches[name] != ITERS * len(pairs):
            raise AssertionError(f"{name}: {launches[name]} launches")
        del model

    # ---------------------------------------------------------------- 4
    for name in ("raft", "raft_small"):
        cpu_model = ptlflow_tpu_torch.get_model(name, args={"iters": ITERS},
                                                device="cpu")
        damp_flow_head(cpu_model)
        gpu_model = ptlflow_tpu_torch.get_model(name, args={"iters": ITERS})
        gpu_model.load_state_dict(cpu_model.state_dict())
        pair = smooth_pair(7, 256, 320, shift=(3, 2))
        x = IOAdapter(cpu_model).prepare_inputs(list(pair))
        want = cpu_model(x)["flows"]
        got = gpu_model({"images": x["images"].to(dev)})["flows"].cpu()
        diff = (got - want).abs().max().item()
        log(f"[4 card vs cpu] {name} 256x320, {ITERS} iters: max |dflow| "
            f"{diff:.3e} px (flow up to {want.abs().max().item():.2f} px, "
            f"tolerance {ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")

    # ---------------------------------------------------------------- 5
    pyr, coords = main_inputs
    radius = 4
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    reps = 50
    kernel_ms = timed_ms(torch, lambda: corr.corr_lookup_kernel(
        pyr, coords, radius), reps, flush)
    plain_ms = timed_ms(torch, lambda: corr.corr_pyramid_lookup_plain(
        pyr, coords, radius), reps, flush)

    def grid_sample_lookup():
        # one torch.nn.functional.grid_sample per level + cat: the
        # yardstick only, the port never calls it
        b, _, h1, w1 = coords.shape
        n = 2 * radius + 1
        d = torch.linspace(-radius, radius, n, device=dev)
        delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)
        cen = coords.permute(0, 2, 3, 1).reshape(-1, 1, 1, 2)
        outs = []
        for i, lvl in enumerate(pyr):
            h2, w2 = lvl.shape[1:]
            c = cen / 2 ** i + delta.view(1, n, n, 2)
            grid = torch.stack([2 * c[..., 0] / (w2 - 1) - 1,
                                2 * c[..., 1] / (h2 - 1) - 1], dim=-1)
            s = torch.nn.functional.grid_sample(lvl[:, None], grid,
                                                align_corners=True)
            outs.append(s.view(b, h1, w1, -1))
        return torch.cat(outs, dim=-1).permute(0, 3, 1, 2).contiguous()

    lib_out = grid_sample_lookup()
    lib_err = (lib_out - corr.corr_lookup_kernel(pyr, coords, radius)
               ).abs().max().item()
    library_ms = timed_ms(torch, grid_sample_lookup, reps, flush)
    warm_ms = timed_ms(torch, lambda: [corr.corr_lookup_kernel(
        pyr, coords, radius) for _ in range(20)], 5) / 20

    q = coords.shape[0] * coords.shape[2] * coords.shape[3]
    n2 = (2 * radius + 1) ** 2
    shapes = [tuple(p.shape[1:]) for p in pyr]
    elt = pyr[0].element_size()
    patch_elems = in_range_patch_elems(torch, coords, shapes, radius)
    nbytes = q * 2 * 4 + patch_elems * elt + q * len(pyr) * n2 * elt
    flops = 9 * q * len(pyr) * n2  # three 2-tap lerps per output
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                >= flops / FP32_FLOPS_PER_S else "operations")
    log(f"[5 lookup] [{tag}] Q={q}, levels {shapes}, r={radius}, fp32, "
        f"L2 flushed per launch: kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, grid_sample yardstick {library_ms:.4f} ms "
        f"(max |diff| to kernel {lib_err:.2e}); back-to-back kernel "
        f"{warm_ms:.4f} ms")
    log(f"[5 lookup] bound: {nbytes} bytes ({patch_elems} in-range patch "
        f"elements) -> {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s; "
        f"{flops} FLOP -> {flops / FP32_FLOPS_PER_S * 1e3:.5f} ms at 67 "
        f"TFLOP/s; bound {bound_ms:.4f} ms by {bound_by}, kernel at "
        f"{bound_ms / kernel_ms:.1%} of it")

    images = torch.from_numpy(np.stack(
        [np.stack(smooth_pair(11, H, W))]).astype(np.float32) / 255.0)
    images = images.permute(0, 1, 4, 2, 3).contiguous().to(dev)
    fwd = {}
    for name, args in [("raft", {}), ("raft", {"mixed_precision": True}),
                       ("raft_small", {})]:
        model = ptlflow_tpu_torch.get_model(name, args={"iters": ITERS,
                                                        **args})
        label = f"{name} {'mixed' if args else 'fp32'}"
        for _ in range(3):
            model({"images": images})
        runs = sorted(timed_ms(torch, lambda: model({"images": images}), 10)
                      for _ in range(3))
        ms = runs[1]
        fwd[label] = ms
        log(f"[5 forward] [{tag}] {label}, {W}x{H}, {ITERS} iters: "
            f"{ms:.3f} ms/forward, {1e3 / ms:.2f} fps (median of 3 runs of "
            f"10 forwards: {', '.join(f'{r:.3f}' for r in runs)} ms)")
        profile_forward(torch, model, images, label, tag, ms)
        del model

    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=30, check=True).stdout.strip()
    log(f"card after timing (sm clock, max sm clock, power, temp): {clocks}")

    kernels = [{
        "name": "corr_lookup",
        "route": "cuda",
        "source": "ptlflow_tpu_torch/csrc/corr_lookup.cu",
        "replaces": "ptlflow_tpu/ops/correlation.py:273",
        "launches": launches["raft"],
        "launches_by_path": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "warm_ms": warm_ms,
    }]
    log(json.dumps({"forward_ms": fwd, "card": tag}))
    log(tag)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile_forward(torch, model, images, label: str, tag: str,
                    event_ms: float) -> None:
    """Device time by kernel over one forward (torch.profiler).  A first
    profiled forward absorbs the tracer's start-up and is not read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model({"images": images})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                rows.append((us / 1e3, e.count, e.key))
    if not rows:
        log(f"[5 profile] [{tag}] {label}: no device time recorded: not "
            f"measured")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    lookup = sum(r[0] for r in rows if "corr_lookup" in r[2])
    launches = sum(r[1] for r in rows)
    log(f"[5 profile] [{tag}] {label} forward under the profiler: "
        f"{busy:.3f} ms of kernels ({launches} launches) in {wall_ms:.3f} ms "
        f"wall; against the unprofiled {event_ms:.3f} ms forward the card "
        f"idles {1 - busy / event_ms:.1%}; lookup kernel {lookup:.3f} ms "
        f"({lookup / busy:.1%} of kernel time)")
    for ms, count, key in rows[:12]:
        log(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}")


if __name__ == "__main__":
    sys.exit(main())
