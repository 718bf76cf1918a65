#!/usr/bin/env python3
"""Run the PyTorch port of ptlflow_tpu on one CUDA card, end to end.

    python3 chip_smoke.py [--against OTHER_corr_lookup.cu ...]

Phases, each of which must pass, else the script exits non-zero:

1. build every CUDA kernel of ``ptlflow_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card: the
   lookup at radii 0, 1, 3, 4 and 8 in fp32 and bf16, on odd map widths,
   an empty level, one query, a prime Q and coords far outside the map,
   and at the main path's shapes;
3. serve 3 frame pairs at 436x1024 through ``raft`` and ``raft_small``
   (12 GRU iterations, seeded random weights) via IOAdapter -> model ->
   unscale, counting the kernel launches of each run (the model prepares
   the lookup once per forward and launches it once per iteration);
4. run the same weights and input on the card and on the CPU (plain
   versions) and compare the flows;
5. time the kernel (CUDA events and the profiler's device time, L2 cold,
   fp32 and bf16), its plain version and the PyTorch yardstick at the main
   path's shapes, the host time of a one-shot and of a prepared lookup
   call, the RAFT forward in fp32 and mixed precision, and profile one
   forward.

``--against`` builds other versions of ``csrc/corr_lookup.cu`` (the same C
interface) and times each in turns with the repo's kernel on the same
inputs (other, repo, repo, other), in the same run.

The second-to-last line is ``{"kernels": [...]}``, the line before it the
card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  With no card it prints no result and
exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
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
    each call.  ``flush`` runs before every call and sweeps the 50 MB L2
    (see ``flushes``), so the call finds its inputs cold, as in the model,
    where the update block runs between two lookups; the sweep also keeps
    the card busy while the host enqueues the call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def profiled_ms(torch, fn, reps: int, flush, name: str = "corr_lookup"):
    """Mean device time per launch of the kernels whose name holds ``name``
    over ``reps`` calls of ``fn``, L2 flushed before each, by the profiler
    (torch.profiler), or None where it recorded no device time.  A first
    profiled run absorbs the tracer's start-up and is not read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if name in e.key and str(getattr(e, "device_type", "")).endswith(
                "CUDA"):
            total += (getattr(e, "self_device_time_total", None)
                      or getattr(e, "self_cuda_time_total", 0))
            count += e.count
    return total / count / 1e3 if count and total > 0 else None


def flushes(torch, dev) -> dict:
    """Two ways to sweep the L2 before a timed call.  "dirty" overwrites
    256 MB and leaves the L2 full of written lines, which the timed call's
    own traffic must write back to memory first; "clean" reads 256 MB and
    leaves it full of lines that can be dropped."""
    buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    return {"dirty": buf.zero_, "clean": buf.max}


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def host_us(torch, fn, calls: int):
    """Host microseconds per call of ``fn`` over ``calls`` calls between two
    syncs: to enqueue them all, and until the card has run them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6


def lookup_bound(torch, pyr, coords, radius: int) -> dict:
    """Least time of one lookup on this card: the bytes it must move (the
    coords, the in-range patch elements, the output) over the memory rate,
    or its FLOPs over the fp32 rate, whichever is larger."""
    q = coords.shape[0] * coords.shape[2] * coords.shape[3]
    n2 = (2 * radius + 1) ** 2
    shapes = [tuple(p.shape[1:]) for p in pyr]
    elt = pyr[0].element_size()
    patch_elems, patch_sectors = patch_traffic(torch, coords, shapes, radius,
                                               elt)
    out_bytes = q * len(pyr) * n2 * elt
    nbytes = q * 2 * 4 + patch_elems * elt + out_bytes
    flops = 9 * q * len(pyr) * n2  # three 2-tap lerps per output
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "patch_elems": patch_elems,
            "patch_sector_bytes": patch_sectors * 32,
            "sector_bytes": patch_sectors * 32 + out_bytes, "flops": flops,
            "bytes_ms": bytes_ms, "flops_ms": flops_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


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


def patch_traffic(torch, coords, shapes, radius: int, elt: int):
    """Elements of the (2r+2)^2 patches that fall inside each level for
    these coords (what the lookup must read), and the 32-byte memory
    sectors that their rows touch (what the card must fetch for them:
    a row of in-range elements at any offset spans whole sectors)."""
    p = 2 * radius + 2
    q = torch.arange(coords.shape[0] * coords.shape[2] * coords.shape[3],
                     device=coords.device)[:, None]
    offs = torch.arange(p, device=coords.device)
    elems = sectors = 0
    for i, (h2, w2) in enumerate(shapes):
        c = torch.floor(coords / 2 ** i).long() - radius  # (B, 2, H1, W1)
        x0 = c[:, 0].reshape(-1, 1)
        y0 = c[:, 1].reshape(-1, 1)
        xs, xe = x0.clamp(min=0), (x0 + p).clamp(max=w2)
        ys = y0 + offs  # (Q, p) rows
        rows = (ys >= 0) & (ys < h2) & (xe > xs)
        elems += int(((xe - xs) * rows).sum())
        start = ((q * h2 + ys) * w2 + xs) * elt
        end = ((q * h2 + ys) * w2 + xe) * elt
        n = end.sub(1).div(32, rounding_mode="floor") - start.div(
            32, rounding_mode="floor") + 1
        sectors += int((n * rows).sum())
    return elems, sectors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", nargs="*", default=[],
                        help="other corr_lookup.cu sources to time in turns "
                             "with the repo's kernel")
    args = parser.parse_args(argv)
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
    edge_cases = [
        # name, (b, h1, w1, h2, w2, c, lo, hi)
        ("Q=77, odd W2=23", (1, 7, 11, 14, 23, 32, -0.3, 1.3)),
        ("Q=37, W2=125", (1, 1, 37, 9, 125, 16, -0.3, 1.3)),
        ("Q=1", (1, 1, 1, 8, 13, 16, -0.3, 1.3)),
        ("batch 2, 5x5 maps, empty level", (2, 5, 5, 5, 5, 16, -0.3, 1.3)),
        ("coords at +-1e7", (1, 3, 6, 10, 15, 16, -0.3, 1.3)),
    ]
    cases = [(f"{label}, r={radius}", shape, radius, dtype)
             for radius in (0, 1, 3, 4, 8)
             for dtype in (torch.float32, torch.bfloat16)
             for label, shape in edge_cases]
    cases += [
        ("raft Q=7040, r=4", (1, hp, wp, hp, wp, 256, -0.1, 1.1), 4,
         torch.float32),
        ("raft Q=7040, r=4", (1, hp, wp, hp, wp, 256, -0.1, 1.1), 4,
         torch.bfloat16),
        ("raft_small Q=7040, r=3", (1, hp, wp, hp, wp, 128, -0.1, 1.1), 3,
         torch.float32),
    ]
    far = torch.tensor([1e7, -1e7, 3.5, -2.5e6, 2.5], device=dev)
    main_err = None
    main_inputs = {}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, shape, radius, dtype in cases:
        pyr, coords = case_inputs(*shape)
        pyr = [p.to(dtype) for p in pyr]
        if label.startswith("coords at"):
            coords[0, 0, 0, :5] = far
            coords[0, 1, 1, :5] = far.flip(0)
        got = corr.corr_lookup_kernel(pyr, coords, radius)
        torch.cuda.synchronize()
        want = corr.corr_pyramid_lookup_plain(pyr, coords, radius)
        err = (got.float() - want.float()).abs().max().item()
        worst[dtype] = max(worst[dtype], err)
        log(f"[2 kernel vs plain] {label}, {str(dtype)[6:]}: out "
            f"{tuple(got.shape)}, levels "
            f"{[tuple(p.shape[1:]) for p in pyr]}, max |err| {err:.3e}")
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=0, atol=ATOL_FP32)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=RTOL_BF16, atol=ATOL_BF16)
        if label.startswith("raft Q=7040"):
            main_inputs[dtype] = (pyr, coords)
            if dtype == torch.float32:
                main_err = err
    log(f"[2 kernel vs plain] {len(cases)} cases pass: worst fp32 |err| "
        f"{worst[torch.float32]:.3e} (tolerance {ATOL_FP32}), worst bf16 "
        f"|err| {worst[torch.bfloat16]:.3e} (rtol {RTOL_BF16})")

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
    pyr, coords = main_inputs[torch.float32]
    radius = 4
    sweeps = flushes(torch, dev)
    flush = sweeps["dirty"]
    reps = 50
    lookup = corr.make_corr_lookup(pyr, radius)
    kernel_ms = timed_ms(torch, lambda: lookup(coords), reps, flush)
    clean_ms = timed_ms(torch, lambda: lookup(coords), reps, sweeps["clean"])
    profiler_ms = profiled_ms(torch, lambda: lookup(coords), reps, flush)
    clean_profiler_ms = profiled_ms(torch, lambda: lookup(coords), reps,
                                    sweeps["clean"])
    plain_ms = timed_ms(torch, lambda: corr.corr_pyramid_lookup_plain(
        pyr, coords, radius), reps, flush)
    bf16_pyr, bf16_coords = main_inputs[torch.bfloat16]
    bf16_lookup = corr.make_corr_lookup(bf16_pyr, radius)
    bf16_ms = timed_ms(torch, lambda: bf16_lookup(bf16_coords), reps, flush)
    bf16_profiler_ms = profiled_ms(torch, lambda: bf16_lookup(bf16_coords),
                                   reps, flush)

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
    lib_err = (lib_out - lookup(coords)).abs().max().item()
    library_ms = timed_ms(torch, grid_sample_lookup, reps, flush)
    warm_ms = timed_ms(torch, lambda: [lookup(coords) for _ in range(20)],
                       5) / 20

    bound = lookup_bound(torch, pyr, coords, radius)
    bound_ms, bound_by = bound["bound_ms"], bound["bound_by"]
    # what the sweep itself costs a call: a plain copy that reads and
    # writes as many bytes as the bound counts, after each sweep
    src = torch.empty(bound["bytes"] // 2, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = {k: timed_ms(torch, lambda: dst.copy_(src), reps, f)
               for k, f in sweeps.items()}
    # and what any launch costs after it: a one-element fill
    tiny = torch.empty(1, device=dev)
    floor_ms = {k: timed_ms(torch, tiny.zero_, reps, f)
                for k, f in sweeps.items()}
    del src, dst
    bf16_bound = lookup_bound(torch, bf16_pyr, bf16_coords, radius)
    q = coords.shape[0] * coords.shape[2] * coords.shape[3]
    shapes = [tuple(p.shape[1:]) for p in pyr]
    log(f"[5 lookup] [{tag}] Q={q}, levels {shapes}, r={radius}, L2 flushed "
        f"per launch; fp32: kernel {kernel_ms:.4f} ms by CUDA events, "
        f"{fmt_ms(profiler_ms)} device time by the profiler, plain "
        f"{plain_ms:.4f} ms, grid_sample yardstick {library_ms:.4f} ms (max "
        f"|diff| to kernel {lib_err:.2e}); back-to-back kernel "
        f"{warm_ms:.4f} ms; bf16: kernel {bf16_ms:.4f} ms by events, "
        f"{fmt_ms(bf16_profiler_ms)} by the profiler")
    log(f"[5 lookup] [{tag}] after a clean sweep (L2 read, not written): "
        f"fp32 kernel {clean_ms:.4f} ms by events, "
        f"{fmt_ms(clean_profiler_ms)} by the profiler; a copy of the "
        f"bound's {bound['bytes']} bytes: {copy_ms['dirty']:.4f} ms after "
        f"the dirty sweep, {copy_ms['clean']:.4f} ms after the clean one; "
        f"a one-element fill: {floor_ms['dirty']:.4f} and "
        f"{floor_ms['clean']:.4f} ms")
    for label, bd, ms in (("fp32", bound, kernel_ms),
                          ("bf16", bf16_bound, bf16_ms)):
        log(f"[5 lookup] {label} bound: {bd['bytes']} bytes "
            f"({bd['patch_elems']} in-range patch elements) -> "
            f"{bd['bytes_ms']:.5f} ms at 3.35 TB/s; {bd['flops']} FLOP -> "
            f"{bd['flops_ms']:.5f} ms at 67 TFLOP/s; bound "
            f"{bd['bound_ms']:.5f} ms by {bd['bound_by']}, kernel at "
            f"{bd['bound_ms'] / ms:.1%} of it; the in-range patch rows span "
            f"{bd['patch_sector_bytes']} bytes of whole 32-byte sectors, "
            f"{bd['sector_bytes']} with the output, moved at "
            f"{bd['sector_bytes'] / ms / 1e9:.3f} TB/s")

    # host cost of one call, in turns: the one-shot call checks the pyramid
    # and builds the pointer arrays each time, the prepared one does not
    host = {"one_shot": [], "prepared": []}
    for kind in ("one_shot", "prepared", "prepared", "one_shot"):
        fn = ((lambda: corr.corr_pyramid_lookup(pyr, coords, radius))
              if kind == "one_shot" else (lambda: lookup(coords)))
        host[kind].append(host_us(torch, fn, 1000))
    for kind, runs in host.items():
        log(f"[5 host] [{tag}] {kind} lookup call, fp32 Q={q}: "
            + "; ".join(f"{enq:.2f} us to enqueue, {wall:.2f} us with the "
                        f"card" for enq, wall in runs)
            + " (per call, over 1000 calls between syncs)")
    host_us_one_shot = min(r[0] for r in host["one_shot"])
    host_us_prepared = min(r[0] for r in host["prepared"])

    against = []
    for path in args.against:
        other_lib = corr._corr_lookup_lib(
            ctypes.CDLL(str(cuda_build.build_file(path))))
        row = {"source": path}
        for label, (p_, c_), mine in (("fp32", (pyr, coords), lookup),
                                      ("bf16", (bf16_pyr, bf16_coords),
                                       bf16_lookup)):
            other = corr._kernel_lookup(p_, radius, other_lib)
            err = (other(c_).float() - mine(c_).float()).abs().max().item()
            turns = [timed_ms(torch, (lambda: other(c_)) if k % 3 == 0
                              else (lambda: mine(c_)), reps, flush)
                     for k in range(4)]
            clean = [timed_ms(torch, (lambda: other(c_)) if k % 3 == 0
                              else (lambda: mine(c_)), reps, sweeps["clean"])
                     for k in range(4)]
            row[label] = {
                "other_ms": [turns[0], turns[3]],
                "repo_ms": [turns[1], turns[2]],
                "other_clean_ms": [clean[0], clean[3]],
                "repo_clean_ms": [clean[1], clean[2]],
                "other_profiler_ms": profiled_ms(torch, lambda: other(c_),
                                                 reps, flush),
                "max_abs_diff": err}
            log(f"[5 against] [{tag}] {path}, {label}, L2 cold, in turns: "
                f"other {turns[0]:.4f}, repo {turns[1]:.4f}, repo "
                f"{turns[2]:.4f}, other {turns[3]:.4f} ms; after the clean "
                f"sweep: other {clean[0]:.4f}, repo {clean[1]:.4f}, repo "
                f"{clean[2]:.4f}, other {clean[3]:.4f} ms; other by the "
                f"profiler {fmt_ms(row[label]['other_profiler_ms'])}; max "
                f"|diff| {err:.2e}")
        against.append(row)

    images = torch.from_numpy(np.stack(
        [np.stack(smooth_pair(11, H, W))]).astype(np.float32) / 255.0)
    images = images.permute(0, 1, 4, 2, 3).contiguous().to(dev)
    fwd = {}
    for name, extra in [("raft", {}), ("raft", {"mixed_precision": True}),
                        ("raft_small", {})]:
        model = ptlflow_tpu_torch.get_model(name, args={"iters": ITERS,
                                                        **extra})
        label = f"{name} {'mixed' if extra else 'fp32'}"
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
        "profiler_ms": profiler_ms,
        "clean_ms": clean_ms,
        "clean_profiler_ms": clean_profiler_ms,
        "copy_ms": copy_ms,
        "fill_ms": floor_ms,
        "bf16_ms": bf16_ms,
        "bf16_profiler_ms": bf16_profiler_ms,
        "bf16_bound_ms": bf16_bound["bound_ms"],
        "host_us_one_shot": host_us_one_shot,
        "host_us_prepared": host_us_prepared,
    }]
    if against:
        kernels[0]["against"] = against
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
