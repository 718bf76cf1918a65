#!/usr/bin/env python3
"""Run the PyTorch port of ptlflow_tpu on one CUDA card, end to end.

    python3 chip_smoke.py [--against OTHER_corr_lookup.cu ...]

Phases, each of which must pass, else the script exits non-zero:

1. build every CUDA kernel of ``ptlflow_tpu_torch/csrc`` with nvcc, one
   nvcc per source, all at once;
2. hold each kernel against its plain PyTorch version on the card, at
   radii 0, 1, 3, 4 and 8 in fp32 and bf16, on odd map widths, an empty
   level, one query, a prime Q and coords far outside the map, and at the
   main paths' shapes (phase 12's one-level lookups among them: Q = 448 on
   rapidflow's 14x32 level, Q = 32,640 on dpflow's 136x240 level at
   1080p, its training levels; phase 13's Q = 21,120 pyramid, neuflow2's
   1/16 level and streamflow's training pyramid; phase 17's
   separableflow pyramid at 1024x448 and its training pyramid at batch
   10): the lookup, and the
   lookup's backward (which must also give the same bits twice); and the
   coords' gradient of ``neuflow2``'s lookups against autograd of the
   plain version;
3. serve 3 frame pairs at 436x1024 through ``raft`` and ``raft_small``
   (12 GRU iterations), ``sea_raft_m`` (4 refinements), ``sea_raft_l``
   (12) and ``gma`` (12), with seeded random weights, via IOAdapter ->
   model -> unscale, counting the kernel launches of each run (the model
   prepares the lookup once per forward and launches it once per
   iteration) and checking that the eval forward builds no autograd graph;
   then serve two consecutive pairs of one sequence through ``raft`` and
   through ``gma``, the second warm-started from the first's
   ``flow_small``;
4. run the same weights and input on the card and on the CPU (plain
   versions) and compare the flows of ``raft``, ``raft_small``,
   ``sea_raft_m`` and ``gma``; then one train step of ``raft`` and one of
   ``sea_raft_s`` at 128x160, 2 iterations, on both, and compare the loss,
   every parameter's gradient and the BatchNorm statistics;
5. time the lookup kernel (CUDA events and the profiler's device time, L2
   cold, fp32 and bf16), its plain version and the PyTorch yardstick at
   the eval path's shapes, the host time of a one-shot and of a prepared
   lookup call, the forward of each served model in fp32 and of ``raft``
   and ``sea_raft_m`` in mixed precision, and profile one forward of
   each;
6. train ``raft`` at full width as ``raft-train1-chairs.yaml`` does (368x496
   crops, batch 10, 12 iterations, AdamW + OneCycle, clip 1.0) for 5 steps
   on seeded synthetic batches, counting both kernels' launches per step;
7. time the backward kernel at the training shape against its plain
   version and the backward of a ``grid_sample`` lookup, and profile one
   train step;
8. run the evaluation harness as a user would: write a Sintel tree at
   436x1024 and a KITTI 2015 tree at 375x1242 with the port's own writers
   (no OpenCV) and read every file back bit for bit; ``validate(args)`` of
   ``raft`` over both (12 iterations, warm start, outputs written), its
   metrics held to float64 numpy metrics of the written flows, 12 lookup
   launches a pair, its first flow held to a direct forward; ``infer`` on 3
   frames; ``model_benchmark`` of ``raft`` in fp32 and bf16;
9. run the training entry point as a user would: write a FlyingChairs tree
   at 384x512 with the port's writer, run ``scripts/train.py --config
   raft-train1-chairs.yaml`` (368x496 crops, batch 10, 12 iterations, 4
   loader workers) for 6 steps validating every 3, then ``--resume`` to 8,
   counting 12 lookups and 12 backward lookups a step, and load
   ``last.ckpt`` strictly into a fresh ``raft`` whose flows must equal the
   trained model's; hold ``DeviceCompose`` on the card against the same
   pipeline on the CPU (one sample, the same draws, one noise field) and
   time it; train 4 steps with ``data.train_transform_cuda=true``;
10. FlowFormer and FlowFormer++ (the registered 32 decoder steps, one
    lookup each): serve 3 consecutive pairs of one sequence at 436x1024,
    each warm-started from the last, counting 32 lookups a forward; time
    and profile each forward in fp32 and with ``validate --bf16``'s
    allow-list weight cast, with its peak memory; the tiled forward of
    ``flowformer`` with ``train_size`` (432, 960): 4 tiles, 128 lookups;
    the flows of both at 256x320 on the card against the CPU; one
    ``flowformer`` train step at 128x160 (2 decoder steps) on both; train
    steps of ``flowformer`` at 368x496 through ``build_train_step`` at the
    largest of FF_TRAIN_BATCHES that fits, counting 32 lookups and 32
    backward lookups a step; and both kernels timed at FlowFormer's
    one-level shapes (phase 2 checks them there against their plain
    versions);
11. SKFlow, LCV-RAFT and LCV-RAFT-small (32 iterations), MemFlow and
    MemFlow-T (15 decoder steps): serve 3 consecutive pairs of one
    sequence at 436x1024, each warm-started from the last, counting one
    lookup launch a step; stream 4 pairs with ``meta`` through
    ``memflow``, whose memory must count 1, 2, 2, 2 frames; time and
    profile each fp32 forward with its peak memory (the depthwise
    convolutions and the softmaxes by kernel name) and ``memflow``'s
    ``validate --bf16`` cast; the flows of all five at 256x320 on the card
    against the CPU, and the ``memflow`` stream frame by frame; one train
    step at 128x160 (2 steps) of ``skflow``, ``memflow`` and ``lcv_raft``
    on both; and train steps of ``memflow`` at 368x496 at the largest of
    SK_TRAIN_BATCHES that fits, counting 15 lookups and 15 backward
    lookups a step.  Phase 2 checks both kernels on LCV-RAFT's pyramid at
    128x160, whose last levels do not shrink;
12. RAPIDFlow (+``_it1``, ``_it2``, ``_it3``, ``_it6``), RPKNet and DPFlow,
    the coarse-to-fine recurrent pyramids (a one-level correlation block
    prepared once a level, one lookup a step): serve 3 consecutive pairs
    at 436x1024 through each, warm-started from the last (RAPIDFlow from
    its full-size ``flows``, the others from ``flow_small``), counting 12,
    1, 2, 3, 6, 12 and 12 lookups a forward; ``dpflow`` also at 1080x1920
    (4 levels, 16 lookups); time and profile each fp32 forward with its
    peak memory (the depthwise convolutions by kernel name) and
    ``dpflow``'s ``validate --bf16`` cast; the flows of all seven at
    256x320 on the card against the CPU; one train step at 128x160 (2
    steps a level) of ``rapidflow``, ``rpknet`` and ``dpflow`` (Laplace
    loss) on both; train ``rapidflow`` and ``dpflow`` at 352x480 as their
    chairs configs set it (batch 8 and 5), counting 12 lookups and 12
    backward lookups a step; and time both kernels at ``rapidflow``'s 1/8
    level and ``dpflow``'s 1080p one;
13. CRAFT, NeuFlow v2, VideoFlow (BOF, MOF) and StreamFlow, the
    attention-built cost volume, two-scale global matching and the
    multi-frame models: serve 3 consecutive windows of one sequence at
    436x1024 through each (``craft`` pairs warm-started from the last's
    ``flow_small``, ``neuflow2`` cold pairs, ``videoflow_bof`` 3 and
    ``videoflow_mof`` 5 frames with their backward flows, ``streamflow`` 4
    frames and 3 flows), counting 32, 9, 64, 64 and 15 lookups a forward;
    time and profile each fp32 forward with its peak memory (CRAFT's
    attention GEMMs, the depthwise convolutions by kernel name) and
    ``craft``'s ``validate --bf16`` cast; the flows of all five at
    256x320 on the card against the CPU; one train step at 128x160 of
    ``craft``, ``neuflow2`` (whose lookups give the coords a gradient: 4
    more forward launches each) and ``streamflow`` (4 frames, 3 flows) on
    both; train ``craft`` (12 iterations) and ``streamflow`` at 368x496 at
    the largest batch that fits and ``neuflow2`` at batch 8, counting
    lookups and backward lookups a step; and time both kernels at
    ``videoflow_mof``'s and ``streamflow``'s pyramid (Q = 21,120; phase 2
    checks them there, at ``neuflow2``'s 1/16 level and at
    ``streamflow``'s training pyramid, and the coords' gradient at
    ``neuflow2``'s training levels);
14. MEMFOF, LLA-Flow (+RAFT), CSFlow, SplatFlow, ReCoVEr (mn, rn, cx) and
    Flow-Anything, the volume-pooled and re-correlated pyramids, the
    two-pyramid lookup, the splat and the new context backbones: serve 3
    consecutive windows of one sequence through each (``memfof`` 3 frames
    at 1080x1920 and 436x1024, 16 lookups; ``llaflow``, ``llaflow_raft``
    32 and ``csflow`` 64, pairs warm-started from the last; ``splatflow``
    3 frames at 375x1242, 64; ReCoVEr and Flow-Anything 4), time and
    profile each fp32 forward with its peak memory (LLA-Flow's GEMMs,
    ReCoVEr-CX's depthwise convolutions) and the ``validate --bf16`` casts
    of ``memfof`` and ``csflow``; the flows of every name at 256x320 on
    the card against the CPU; both kernels against their plain versions
    and timed on MEMFOF's 1080p levels and CSFlow's strip pyramid;
    ``softsplat_average`` against the CPU at SplatFlow's 1/8 KITTI shape;
    one train step at 128x160 of ``csflow``, ``llaflow``, ``llaflow_raft``,
    ``memfof``, ``recover_mn`` and ``recover_cx`` on both; and train
    ``csflow`` and ``llaflow`` (12 iterations) and ``memfof`` at 368x496 at
    the first batch of (10, 8, 6, 4) that fits;
15. WAFT (``waft_dav2_a1``, ``waft_dav2_a2``, ``waft_twins_a2``; the gated
    ``waft_dinov3_a2`` is not constructible), FlowSeek (``flowseek_t``,
    ``flowseek_m``), DIP, Flow1D and GMFlowNet (+``_mix``), the ViT
    backbones, the basis fields, PatchMatch, the 1-D lookup and POLA:
    serve 3 consecutive pairs of one sequence at 436x1024 through each
    (``flow1d`` also 2 pairs at 1080x1920; ``flow1d`` and ``gmflownet(_mix)``
    warm-started from the last's ``flow_small``), counting 4 lookups a
    forward for FlowSeek, 32 for GMFlowNet and none elsewhere; time and
    profile each fp32 forward with its peak memory and the ``validate
    --bf16`` casts of the five allow-list names; the flows of all nine at
    256x320 on the card against the CPU (GMFlowNet's initial matches
    counted where they differ); one train step at 128x160 of
    ``waft_twins_a2``, ``dip``, ``flow1d`` and ``gmflownet`` on both;
    train ``gmflownet`` (32 iterations) and ``waft_twins_a2`` at 368x496 at
    the first batch of (10, 8, 6, 4, 2) that fits; and both kernels against
    their plain versions and timed at GMFlowNet's training pyramid.
16. MatchFlow (``matchflow``, ``matchflow_raft``), SCV (``scv4``,
    ``scv8``), MS-RAFT+ (``ms_raft_p``) and CCMR (``ccmr``, ``ccmr_p``),
    the quadtree attention, the sparse top-k volume and the on-the-fly
    AltCorrBlock: serve 3 consecutive pairs of one sequence at 436x1024
    through each, warm-started from the last's ``flow_small``, counting 32
    lookups a forward for MatchFlow and none for SCV and the AltCorrBlock
    defaults; time and profile each fp32 forward with its peak memory (the
    top-k and gather kernels by name, the AltCorrBlock lookups' device ms);
    the flows of all seven at 256x320 on the card against the CPU, the CPU
    taking the card's top-k selections and the differing ones counted;
    ``ms_raft_p``, ``ccmr`` and ``ccmr_p`` built with
    ``alternate_corr=False`` (their CorrBlock launches the lookup kernel)
    against the AltCorrBlock defaults at 256x320, ``ccmr`` at 436x1024
    too; one train step at 128x160 of ``matchflow``, ``scv4`` and
    ``ms_raft_p`` on both; train ``matchflow`` (32 iterations) and
    ``ms_raft_p`` at 368x496 at the first batch of (8, 6, 4, 2, 1) that
    fits; and both kernels against their plain versions and timed at
    ``ccmr``'s CorrBlock pyramid at 436x1024.
17. SeparableFlow, PWC-Net (``pwcnet``, ``pwcnet_nodc``) and IRR
    (``irr_pwc``, ``scopeflow``, ``irr_pwcnet``, ``irr_pwcnet_irr``),
    GANet's SGA and NLF recursions, the 3-D aggregation U-Nets and the
    local correlation: serve 3 consecutive pairs of one sequence at
    436x1024 through each, cold, counting 32 lookups a forward for
    ``separableflow`` and none for the others (``irr_pwc``'s and
    ``scopeflow``'s backward flows and occlusions checked); time and
    profile each fp32 forward with its peak memory, the SGA's, the NLF's
    and ``local_correlation``'s device ms, calls and launches by CUDA
    events around their calls, and the ``validate --bf16`` casts of
    ``separableflow`` and ``pwcnet``; the flows of all seven at 256x320 on
    the card against the CPU (``separableflow``'s NLF-filtered volume and
    initial flow too); one train step at 128x192 of ``separableflow`` (32
    iterations), ``pwcnet`` and ``irr_pwc`` on both; train
    ``separableflow`` (32 iterations) at 368x496 and ``irr_pwc`` at
    384x512 at the first batch of (10, 8, 6, 4, 2) that fits; and both
    kernels against their plain versions and timed at ``separableflow``'s
    pyramids (phase 2 checks them there too).
18. FlowNet (``flownets``, ``flownetc``, ``flownetsd``, ``flownetcs``,
    ``flownetcss``, ``flownet2``), LiteFlowNet (``liteflownet``,
    ``liteflownet2``, ``liteflownet3``, ``liteflownet3s``, each of the last
    three with and without ``_pseudoreg``) and FastFlowNet, the
    encoder-decoders, the matching cascades and the shuffled decoders on
    the local correlation: serve 3 consecutive pairs of one sequence at
    436x1024 through each, cold, counting no lookup launch (LiteFlowNet3's
    ``confs`` checked); time each fp32 forward with its peak memory and
    ``local_correlation``'s device ms and calls by CUDA events around its
    calls, profile those of ``flownetc``, ``flownet2``, ``liteflownet3``
    and ``fastflownet``, and time the ``validate --bf16`` casts of
    ``flownet2``, ``liteflownet3`` and ``fastflownet`` with their mean
    |flow| difference from fp32; the flows (and ``confs``) of all 14 at
    256x320 on the card against the CPU, and ``local_correlation`` with
    its gradient on LiteFlowNet3's self-correlation; one train step at
    128x192 of ``flownetc``, ``flownet2`` (its loss from full size) and
    ``fastflownet`` on both; and train the three at 384x512 at the first
    batch of (10, 8, 6, 4, 2) that fits.
19. MaskFlowNet (``maskflownet_s``, ``maskflownet``), HD3 (``hd3``,
    ``hd3_ctxt``), STaRFlow and DICL, on the local correlation, the
    deformable convolution, HD3's match densities and DICL's learned
    matching volume (plain PyTorch; no lookup launch): serve 3 cold pairs
    at 436x1024 through each (STaRFlow 3 windows of 4 frames, its
    backward flows and occlusions checked; ``maskflownet_s``'s ``occs``),
    time each fp32 forward with the CUDA-event ms and calls of those ops,
    profile ``maskflownet``, ``hd3`` and ``dicl`` once each; the
    deformable convolution and its gradients at MaskFlowNet's 1/4 level on
    the card against the CPU; the flows (and occlusions) of all six at
    256x320 on the card against the CPU, HD3's argmax cells replayed on the
    CPU; one train step of ``maskflownet`` and ``hd3`` at 128x192 and of
    ``dicl`` at 128x256 on both (HD3's and DICL's, ill-conditioned in
    float32, in float64 too, and in float32 against the CPU's own float32
    spread); and train the five trainable names
    at 384x512 at the first batch of (10, 8, 6, 4, 2) that fits.
20. VCN (``vcn``, ``vcn_small``), NeuFlow and GMFlow (``gmflow``,
    ``gmflow_refine``), on VCN's separable 4-D volume filtering and
    truncated soft winner-take-all and GMFlow's global and split-window
    matching (plain PyTorch; no lookup launch): serve 3 cold pairs at
    436x1024 through each, time and profile each fp32 forward with the
    CUDA-event ms and calls of VCN's volume, filtering and
    winner-take-all, NeuFlow's attentions and local correlation and
    GMFlow's transformer, matchings and propagation; time VCN's 4-D
    convolutions as ``Conv3d`` on a view and as folded 2-D convolutions;
    the flows of all five at 256x320 on the card against the CPU, VCN's
    argmax indices replayed on the CPU; one train step at 128x192 of
    ``vcn_small``, ``neuflow`` and ``gmflow_refine`` on both (VCN's and
    GMFlow's, ill-conditioned in float32, in float64 too and in float32
    against the CPU's own spread); and train the five at 384x512 at the
    first batch of (10, 8, 6, 4, 2) that fits.
21. UniMatch (``unimatch``, ``unimatch_sc2``, ``unimatch_sc2_ref6``) and
    GMFlow+ (``gmflow_p``, ``_sc2``, ``_sc2_ref6``: the same classes), on
    GMFlow's matching and the regression refinement, which builds the
    all-pairs volume of the 1/4 features once (Q = 28,672 on 112x256 at
    1024x448) and looks it up once a step: serve 3 cold pairs at 436x1024
    through ``unimatch_sc2_ref6``, counting 6 lookups a forward, and one
    through ``unimatch`` and ``unimatch_sc2``, counting none; time each
    fp32 forward with the CUDA-event ms and calls of the transformer, the
    matchings, the propagation, the refinement's volume, lookups and
    update blocks, and profile ``unimatch_sc2_ref6``'s once; both kernels
    against their plain versions (the lookup in fp32 and bf16, the
    backward bit for bit twice) and timed on that level; the flows of the
    three at 256x320 on the card against the CPU, each ``gmflow_p*`` name
    equal on the card to its twin on the same weights; one train step of
    ``unimatch_sc2_ref6`` at 64x96 on both (in float32 against the CPU's
    own spread and in float64, 6 lookups and 6 backward lookups); and
    train it at 384x512 at the first batch of (8, 6, 4, 2) that fits.

Phases 10-16 time their forwards but profile none (the script's time went
to phase 17; PERF.md section 5 keeps the profiles of their last profiled
runs), so "times and profiles" below reads "times" there, and their 1080p
update steps are timed, not profiled.

A profiler reading under its kernel's bound, or whose kernel records do not
match the launches that the wrappers counted, is printed as invalid and
recorded as null with its reason (``invalid_profiler_readings``).

``--against`` builds other versions of ``csrc/corr_lookup.cu`` (the same C
interface) and times each in turns with the repo's kernel on the same
inputs (other, repo, repo, other), in the same run.

The second-to-last line is ``{"kernels": [...]}``, the line before it the
card's name and power limit (after ``{"harness": ...}``,
``{"train_cli": ...}``, ``{"flowformer": ...}``, ``{"sk_family": ...}``,
``{"recurrent_pyramid": ...}``, ``{"video_and_attention": ...}``,
``{"volume_and_backbone": ...}``, ``{"slice13": ...}``,
``{"slice14": ...}``, ``{"slice15": ...}``, ``{"slice16": ...}``,
``{"slice17": ...}``, ``{"slice18": ...}`` and ``{"slice19": ...}``,
phases 8-21's numbers),
and
the last
line ``{"ok": true, "device": {...}}``.  With no card it prints no result
and exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
H, W = 436, 1024  # Sintel frames: the main path's size
KITTI_H, KITTI_W = 375, 1242  # KITTI 2015 frames (phase 8)
ITERS = 12
# (model, iterations) served at H x W: RAFT's and GMA's 12 GRU iterations,
# SEA-RAFT's own depths (sea_raft_m 4 refinements, sea_raft_l 12)
SERVE = (("raft", ITERS), ("raft_small", ITERS), ("sea_raft_m", 4),
         ("sea_raft_l", 12), ("gma", ITERS))
# Largest mean |flow| (px) a served SEA-RAFT may give on its pairs, which
# move 2-4 px: a trained model's size, so that its lookups read the windows
# around the true motion
SERVED_FLOW_PX = 8.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12   # H100 SXM fp32 outside the tensor cores
# Plain-versus-kernel tolerances: fp32 sums of the same terms in another
# order; bf16 one rounding apart, compared in fp32.
ATOL_FP32 = 1e-5
RTOL_BF16, ATOL_BF16 = 1e-2, 1e-5
# Card against CPU, 12 iterations at 256x320, TF32 off (see phase 4).
ATOL_CARD_CPU_PX = 1e-2
# Backward kernel against its plain version: fp32 max |err| relative to the
# largest gradient; bf16 as the forward.
RTOL_BWD_FP32 = 1e-5
# The coords' gradient through the kernel (NeuFlow v2) against autograd of
# the plain version: a sum of 81 products of the output's gradient and a
# difference of two lookups, each within ATOL_FP32, relative to the largest
RTOL_COORDS_GRAD = 1e-4
# raft-train1-chairs.yaml (ptlflow_tpu/models/raft/configs): crops, batch
TRAIN_B, TRAIN_H, TRAIN_W = 10, 368, 496
TRAIN_STEPS = 5
# phases 10-17's timed forwards: forwards a timed run (each timed by the
# median of 3 runs) and warm-ups (the 3 served pairs just before warm the
# model); phase 5's are 10 and 3, and they were 5 and 2 in phases 11-16
# before phase 17 had to fit into the script's time.  Phases 10-16 profile
# no forward (the profiles of 24k-launch forwards took ~10 s each to
# digest), phase 17 each fp32 forward once; the bf16 casts are timed, not
# profiled; the timed train steps are 2 (4 or 3 before), the second read
FWD_REPS, FWD_WARMUPS = 1, 0
# Card against CPU, one train step at 128x160, 2 iterations: the loss within
# RTOL_LOSS, the BatchNorm statistics within ATOL_BN, and the gradient of
# the whole model, as one vector, within GRAD_RTOL of the CPU's by its
# largest element and by its norm.  Tensor by tensor, 1e-3 of each tensor's
# largest element does not hold between two fp32 implementations of this
# step: a ReLU input within rounding of 0 takes either side, and behind a
# norm on batch statistics one such flip moves a small tensor's gradient by
# percents.  The per-tensor figures are printed beside those of the CPU
# against itself with its input one rounding off (GRAD_FLOOR: the scale,
# relative to the model's largest gradient, below which a tensor's
# gradient is rounding, as where it is zero in exact arithmetic).
GRAD_RTOL, GRAD_FLOOR = 1e-3, 1e-6
RTOL_LOSS, ATOL_BN = 1e-5, 1e-5
# An ill-conditioned step in float32: the card's gradient and BatchNorm
# statistics within SPREAD_FACTOR times the CPU's own float32 spread
# (``train_step_card_vs_cpu``).  On an H100, HD3's and DICL's steps at 5
# batch seeds each put the card 0.42-2.34 times that spread off the CPU
# (the BatchNorm statistics 1.35-1.80 times): twice the largest reading
SPREAD_FACTOR = 5.0
# Phase 9: the training entry point with raft-train1-chairs.yaml
RAFT_CHAIRS_CONFIG = "ptlflow_tpu/models/raft/configs/raft-train1-chairs.yaml"
CHAIRS_H, CHAIRS_W = 384, 512  # FlyingChairs frames
CHAIRS_PAIRS = 61  # 60 in chairs-train (6 batches of 10 an epoch), 1 in val
CLI_STEPS, CLI_RESUMED, CLI_VAL_EVERY, CLI_CUDA_STEPS = 6, 8, 3, 4
# Phase 10: FlowFormer and FlowFormer++ at their registered depth, the
# tiled forward at FlowFormer's Sintel crop, and training on 368x496 crops
# (TRAIN_H x TRAIN_W) at the first of FF_TRAIN_BATCHES that fits the card
# (batch 12 runs out of 80 GB on the H100, in every run so far: the search
# starts at 8)
FF_SERVE = ("flowformer", "flowformer_pp")
FF_DEPTH = 32
FF_TRAIN_SIZE = (432, 960)
FF_TRAIN_BATCHES = (8, 6, 4, 2)
FF_TRAIN_STEPS = 2
# Phase 11: SKFlow, LCV-RAFT (+small) and MemFlow (+T) at their registered
# depths; MemFlow trained on 368x496 crops at the first of SK_TRAIN_BATCHES
# that fits the card
SK_SERVE = (("skflow", 32), ("lcv_raft", 32), ("lcv_raft_small", 32),
            ("memflow", 15), ("memflow_t", 15))
SK_TRAIN_BATCHES = (8, 6, 4, 2)
SK_TRAIN_STEPS = 2
# Phase 12: the coarse-to-fine recurrent pyramids at their registered depths
# (lookups a forward: steps a level times levels at 1024x436), DPFlow also at
# Spring's 1920x1080 (4 levels), and their training as
# rapidflow-train1-chairs.yaml (batch 8) and dpflow-train1-chairs.yaml
# (batch 5) set it: 352x480 crops, AdamW, clip 1.0, 12 lookups a step
RP_SERVE = (("rapidflow", 12), ("rapidflow_it1", 1), ("rapidflow_it2", 2),
            ("rapidflow_it3", 3), ("rapidflow_it6", 6), ("rpknet", 12),
            ("dpflow", 12))
SPRING_H, SPRING_W, SPRING_LOOKUPS = 1080, 1920, 16
RP_TRAIN_H, RP_TRAIN_W = 352, 480
RP_TRAIN = (("rapidflow", 8, 4e-4), ("dpflow", 5, 2.5e-4))
RP_TRAIN_STEPS = 2
# (label, (channels, H, W)) of the one-level lookups both kernels are timed
# at: rapidflow's 1/8 level of 1024x448, dpflow's of 1920x1088
RP_KERNEL_LEVELS = (("rapidflow 1/8", (128, 56, 128)),
                    ("dpflow 1080p 1/8", (256, 136, 240)))
# Phase 13: CRAFT, NeuFlow v2, VideoFlow (BOF, MOF) and StreamFlow at their
# registered depths: (model, lookup launches a forward, frames a window).
# NeuFlow v2 resizes 1024x436 to 1024x448: 1 lookup at 1/16 and 8 at 1/8
VA_SERVE = (("craft", 32, 2), ("neuflow2", 9, 2), ("videoflow_bof", 64, 3),
            ("videoflow_mof", 64, 5), ("streamflow", 15, 4))
# training at 368x496: craft at iters=12 (as raft-train1-chairs.yaml sets
# RAFT; the repo has no CRAFT train config) and streamflow at its 15 on 4
# frames, each at the first of its VA_TRAIN_BATCHES that fits (streamflow's
# batches 8, 6 and 4 run out of 80 GB on the H100, 4 in every run so far:
# its search starts at 3); neuflow2 at 8
VA_TRAIN_BATCHES = {"craft": (8, 6, 4, 2), "streamflow": (3, 2)}
VA_TRAIN_STEPS = 2
# the lookups of videoflow_mof (5 frames) and streamflow (4) at 1024x436:
# Q = 3 x 55 x 128 on the 4 levels 55x128 ... 6x16
VA_KERNEL_Q = (3, 55, 128)
# Phase 14: MEMFOF, LLA-Flow (+RAFT), CSFlow, SplatFlow, ReCoVEr (mn, rn,
# cx) and Flow-Anything at their registered depths: (model, lookup launches
# a forward, frames a window, warm-started from the last, (H, W)).  MEMFOF
# at Spring's 1080p (its own use) and at H x W, SplatFlow at KITTI 2015's
# size (its one checkpoint is KITTI's)
VB_NAMES = ("memfof", "llaflow", "llaflow_raft", "csflow", "splatflow",
            "recover_mn", "recover_rn", "recover_cx", "flow_anything")
VB_SERVE = (("memfof", 16, 3, False, (SPRING_H, SPRING_W)),
            ("memfof", 16, 3, False, (H, W)),
            ("llaflow", 32, 2, True, (H, W)),
            ("llaflow_raft", 32, 2, True, (H, W)),
            ("csflow", 64, 2, True, (H, W)),
            ("splatflow", 64, 3, False, (KITTI_H, KITTI_W)),
            ("recover_mn", 4, 2, False, (H, W)),
            ("recover_rn", 4, 2, False, (H, W)),
            ("recover_cx", 4, 2, False, (H, W)),
            ("flow_anything", 4, 2, False, (H, W)))
# one train step card against CPU at 128x160, 2 iterations: (model, the
# forward kernel's and the backward's launches, the batch seed).  Seed 5
# (phase 4's) meets a ReLU input within rounding of 0: the CPU with its
# input one rounding off moves the whole gradient of llaflow, llaflow_raft
# and memfof by 1.1e-3 to 2.5e-3; on seed 6 by 1.0e-4 to 3.8e-4.  MEMFOF's
# step (four ResNet34 trunks, 60 BatchNorms on batch statistics at 1/16 of
# 128x160) parts card from CPU by 5.3e-4 to 1.6e-3 of the whole gradient's
# norm on seeds 6-15, the same bits on two card runs; seed 15 is one of the
# two at 5.3e-4
VB_STEP_CHECK = (("csflow", (4, 4), 6), ("llaflow", (2, 2), 6),
                 ("llaflow_raft", (2, 2), 6), ("memfof", (4, 4), 15),
                 ("recover_mn", (2, 2), 6), ("recover_cx", (2, 2), 6))
# timed training at 368x496 at the first batch that fits: csflow and
# llaflow at 12 iterations (raft-train1-chairs.yaml's RAFT), memfof at its 8
VB_TRAIN = (("csflow", {"iters": ITERS}, 2 * ITERS),
            ("llaflow", {"iters": ITERS}, ITERS),
            ("memfof", {}, 16))
VB_TRAIN_BATCHES = (10, 8, 6, 4)
VB_TRAIN_STEPS = 2
# Phase 15: WAFT, FlowSeek, DIP, Flow1D and GMFlowNet at their registered
# depths: (model, lookup launches a forward, warm-started from the last
# pair's flow_small, (H, W)).  Flow1D also at 1920x1080, the high-resolution
# use it was designed for.  WAFT, FlowSeek and DIP read no previous
# prediction (as in the JAX package), so their pairs are served cold
S13_NAMES = ("waft_dav2_a1", "waft_dav2_a2", "waft_twins_a2", "flowseek_t",
             "flowseek_m", "dip", "flow1d", "gmflownet", "gmflownet_mix")
S13_SERVE = (("waft_dav2_a1", 0, False, (H, W)),
             ("waft_dav2_a2", 0, False, (H, W)),
             ("waft_twins_a2", 0, False, (H, W)),
             ("flowseek_t", 4, False, (H, W)),
             ("flowseek_m", 4, False, (H, W)),
             ("dip", 0, False, (H, W)),
             ("flow1d", 0, True, (H, W)),
             ("flow1d", 0, True, (SPRING_H, SPRING_W)),
             ("gmflownet", 32, True, (H, W)),
             ("gmflownet_mix", 32, True, (H, W)))
# the bf16 allow-list's names: validate --bf16 casts their weights
S13_BF16 = ("waft_dav2_a1", "waft_dav2_a2", "waft_twins_a2", "flowseek_t",
            "flowseek_m")
# one train step card against CPU at 128x160, 2 iterations (rounds): (model,
# the forward kernel's and the backward's launches, the batch seed).  Seed
# 6 parts flow1d's card from its CPU by 7.65e-4 of the whole gradient's
# norm (the CPU with its input one rounding off: 3.3e-4); on the CPU, seeds
# 6-11 move it by 6.6e-5 (seed 9) to 1.0e-3 (seed 7) that way
S13_STEP_CHECK = (("waft_twins_a2", (0, 0), 6), ("dip", (0, 0), 6),
                  ("flow1d", (0, 0), 9), ("gmflownet", (2, 2), 6))
# timed training at 368x496 at the first batch that fits, at the registered
# depths: gmflownet's 32 iterations (32 lookups and 32 backward lookups a
# step), waft_twins_a2's 5 refinements (no lookup)
S13_TRAIN = (("gmflownet", {}, (32, 32)), ("waft_twins_a2", {}, (0, 0)))
S13_TRAIN_BATCHES = (10, 8, 6, 4, 2)
S13_TRAIN_STEPS = 2
# GMFlowNet's mutual-match initialisation at 256x320 on smooth frames
# shifted by whole feature pixels (x, y), so that most pixels have a clear
# best match
S13_MATCH_SHIFT = (16, 8)
# Phase 16: MatchFlow (+RAFT), SCV (4, 8), MS-RAFT+ and CCMR (+) at their
# registered depths: (model, lookup launches a forward).  MatchFlow resizes
# 1024x436 to 1024x448 and launches the lookup once an iteration; SCV's
# sparse volume and the on-the-fly AltCorrBlock of MS-RAFT+ and CCMR (their
# default) launch none
S14_SERVE = (("matchflow", 32), ("matchflow_raft", 32), ("scv4", 0),
             ("scv8", 0), ("ms_raft_p", 0), ("ccmr", 0), ("ccmr_p", 0))
S14_NAMES = tuple(name for name, _ in S14_SERVE)
# served without ``damp_to_served_size``: MS-RAFT+ upsamples its coords to
# the next scale (``condition_slice14``), which leaves each finer grid up to
# a pixel off, 2^scales px at the input, whatever the flow head
S14_UNDAMPED = ("ms_raft_p",)
# the CorrBlock route (alternate_corr=False), whose lookup is the kernel: one
# launch an iteration, sum(iters) a forward
S14_DENSE = (("ms_raft_p", 25), ("ccmr", 33), ("ccmr_p", 38))
# one train step card against CPU at 128x160, 2 iterations (a scale): (model,
# args, the forward kernel's and the backward's launches, the batch seed)
S14_STEP_CHECK = (("matchflow", {"iters": 2}, (2, 2), 6),
                  ("scv4", {"iters": 2}, (0, 0), 6),
                  ("ms_raft_p", {"iters": (2, 2, 2, 2)}, (0, 0), 6))
# timed training at 368x496 at the first of its batches that fits, at the
# registered depths: matchflow's 32 iterations (32 lookups and 32 backward
# lookups a step), ms_raft_p's (4, 6, 5, 10) on AltCorrBlock (none; batch 8
# runs out of 80 GB in every run so far, so its search starts at 6)
S14_TRAIN = (("matchflow", (32, 32), (8, 6, 4, 2, 1)),
             ("ms_raft_p", (0, 0), (6, 4, 2, 1)))
S14_TRAIN_STEPS = 2
# Phase 17: SeparableFlow, PWC-Net (+nodc) and IRR (irr_pwc, scopeflow,
# irr_pwcnet, irr_pwcnet_irr) at their registered depths: (model, lookup
# launches a forward).  SeparableFlow pads 1024x436 to 1024x448 and launches
# the lookup once an iteration; the PWC family runs on local correlations
S15_SERVE = (("separableflow", 32), ("pwcnet", 0), ("pwcnet_nodc", 0),
             ("irr_pwc", 0), ("scopeflow", 0), ("irr_pwcnet", 0),
             ("irr_pwcnet_irr", 0))
S15_NAMES = tuple(name for name, _ in S15_SERVE)
S15_BF16 = ("separableflow", "pwcnet")
# profiled once each: PWC-Net only.  SeparableFlow's 24k-launch and IRR's
# 11k-launch profiles take ~20 and ~8 s each to digest, and their readings
# held across four runs (PERF.md section 5)
S15_PROFILED = ("pwcnet",)
# one train step card against CPU: (model, args, the forward kernel's and
# the backward's launches, the batch seed, the size).  PWC's and IRR's
# losses pool the ground truth by whole ratios, so their size is a multiple
# of 64 (128x160 fails in the JAX package as in the port).  SeparableFlow's
# random-weight step is ill-conditioned where its U-Nets' initial flows
# weigh in the loss: with 2 iterations one rounding of the input moves its
# whole gradient by 0.24-1.4% on the CPU at 128x192 (seeds 6-40).  At its
# registered 32 iterations they weigh 0.8^32-0.8^34 of the last and one
# rounding moves it by 1.1e-4 to 6.5e-4 (seeds 1-17); seed 9 is 1.1e-4
S15_STEP_CHECK = (("separableflow", {}, (32, 32), 9, (128, 192)),
                  ("pwcnet", {}, (0, 0), 6, (128, 192)),
                  ("irr_pwc", {}, (0, 0), 6, (128, 192)))
# timed training at the first batch that fits: (model, crop, launches a
# step); irr_pwc's loss needs a multiple of 64, so it trains at 384x512
S15_TRAIN = (("separableflow", (TRAIN_H, TRAIN_W), (32, 32)),
             ("irr_pwc", (384, 512), (0, 0)))
S15_TRAIN_BATCHES = (10, 8, 6, 4, 2)
S15_TRAIN_STEPS = 2
# SeparableFlow's NLF-filtered volume card against CPU, of its largest
# element: float32 sums of the rows' products in another order
RTOL_NLF = 1e-4
# ``local_correlation``'s output and both gradients card against CPU, of
# each one's largest element (float32 sums of the same terms in another
# order), at (radius, dilation, stride, channels, height, width, one map
# as both arguments): PWC's and IRR's (and FastFlowNet's, whose 1/4 level
# has PWC's shape at 1024x448), FlowNetC's dilated window and LiteFlowNet's
# dilated and strided one (phase 17); LiteFlowNet3's self-correlation at
# its 1/4 level, whose gradient adds both arguments' (phase 18)
RTOL_LOCAL_CORR = 1e-5
LOCAL_CORR_CASES = ((4, 1, 1, 32, 112, 256, False),
                    (10, 2, 1, 256, 48, 64, False),
                    (3, 2, 2, 64, 56, 128, False),
                    (4, 2, 1, 64, 112, 256, True))
# Phase 18: FlowNet (S, C, SD, CS, CSS, 2), LiteFlowNet (1, 2, 3, 3S and the
# pseudo-regularised variants) and FastFlowNet, on local correlations (no
# lookup launch)
S16_NAMES = ("flownets", "flownetc", "flownetsd", "flownetcs", "flownetcss",
             "flownet2", "liteflownet", "liteflownet2",
             "liteflownet2_pseudoreg", "liteflownet3",
             "liteflownet3_pseudoreg", "liteflownet3s",
             "liteflownet3s_pseudoreg", "fastflownet")
S16_PROFILED = ("flownetc", "flownet2", "liteflownet3", "fastflownet")
S16_BF16 = ("flownet2", "liteflownet3", "fastflownet")
# FlowNet2's ``flow_preds`` are its fusion network's (full size, 1/2, 1/4):
# its loss pools the ground truth from full size (the registered 1/4 fails
# on their shapes, in the JAX package too)
S16_ARGS = {"flownet2": {"loss_start_scale": 1}}
# one train step card against CPU: (model, batch seed, size); the losses
# pool by whole ratios, so the sizes are multiples of 64
S16_STEP_CHECK = (("flownetc", 6, (128, 192)), ("flownet2", 6, (128, 192)),
                  ("fastflownet", 6, (128, 192)))
S16_TRAIN = ("flownetc", "flownet2", "fastflownet")
S16_TRAIN_SIZE = (384, 512)
S16_TRAIN_BATCHES = (10, 8, 6, 4, 2)
S16_TRAIN_STEPS = 2
# the flow heads damped by 0.1 (the CPU tests' ``HEADS``): random
# encoder-decoders and cascades grow their flows level after level
S16_DAMPED = {"flownet": ("*predict_flow*",),
              "liteflownet": ("matching_nets.*.flow_net.6",
                              "subpixel_nets.*.flow_net.6"),
              "liteflownet23": ("matching_nets.*.flow_net.10",
                                "subpixel_nets.*.flow_net",
                                "pseudo_subpixel.flow_net.1",
                                "deformation_nets.*.disp_pred"),
              "fastflownet": ("decoder*.conv7",)}
# Phase 19: MaskFlowNet (+S), HD3 (+ctxt), STaRFlow and DICL, on the local
# correlation, the deformable convolution, HD3's densities and DICL's
# matching volume (no lookup launch)
S17_NAMES = ("maskflownet_s", "maskflownet", "hd3", "hd3_ctxt", "starflow",
             "dicl")
S17_PROFILED = ("maskflownet", "hd3", "dicl")
# frames a served window (STaRFlow's recurrence runs over 4)
S17_WINDOW = {"starflow": 4}
# one train step card against CPU: (model, batch seed, size, ill
# conditioned).  HD3's and DICL's float32 steps are ill-conditioned: the
# port's own float32 step is 4e-3 to 3.5e-2 (HD3's DLA-34, batch seeds
# 1-9, 128x192 to 256x320) and 3.6e-4 to 1.3e-3 (DICL, batch 1-2; each
# BatchNorm's backward sums ~1e5 terms that cancel, tests/test_torch_dicl.py)
# of its whole gradient off its float64 one; they are held in float64 and,
# in float32, to SPREAD_FACTOR times the spread this run measures
# (``train_step_card_vs_cpu``)
S17_STEP_CHECK = (("maskflownet", 6, (128, 192), False),
                  ("hd3", 6, (128, 192), True),
                  ("dicl", 6, (128, 256), True))
S17_TRAIN = ("maskflownet_s", "maskflownet", "hd3", "hd3_ctxt", "dicl")
S17_TRAIN_SIZE = (384, 512)
S17_TRAIN_BATCHES = (10, 8, 6, 4, 2)
S17_TRAIN_STEPS = 2
# the heads damped as the CPU tests damp them: (module patterns, factor)
S17_DAMPED = {
    "maskflownet": (("*pred_flow*", "*pred_mask*", "*dc_conv7"), 0.1),
    "hd3": (("*cls.2", "Decoder_4.cls"), 0.1),
    "starflow": (("flow_and_occ_estimators.conv_last.0",
                  "context_networks.convs.6.0",
                  "occ_shuffle_upsample.out_convs.0"), 0.02),
    "dicl": (("context_net2.6", "context_net3.6", "context_net4.5",
              "context_net5.4", "context_net6.3",
              "dap_layer*.dap_layer.conv"), 0.1)}
# HD3's density heads' centre-cell logit (``condition_slice17``)
HD3_CENTRE_LOGIT = 4.0
# occlusions in [0, 1], card against CPU at 256x320
ATOL_OCCS = 1e-4
# the deformable convolution and its gradients, card against CPU, by each
# tensor's largest element (float32 sums; the sampler's input gradient
# adds by atomics on the card)
RTOL_DEFORM = 1e-4

# Phase 20: VCN (+small), NeuFlow, GMFlow (+refine): the separable 4-D
# volume filtering, the truncated soft winner-take-all, the global and
# split-window matching (plain PyTorch; no lookup launch)
S18_NAMES = ("vcn", "vcn_small", "neuflow", "gmflow", "gmflow_refine")
# one train step card against CPU: (model, batch seed, size, ill
# conditioned).  VCN's and GMFlow's float32 steps are ill-conditioned:
# VCN's whole gradient lies 1e-4 to 3.2e-3 from float64 over 10 batch
# seeds (tests/test_torch_vcn.py; each BatchNorm of the 2x3 (1/64) level
# sums few terms that cancel), ``vcn_small``'s here 1.4e-3 (the port on
# the CPU); ``gmflow_refine``'s moves by 9e-4 to 2.2e-3 when the images
# move by one rounding (batch seeds 5 and 6, the CPU), its softmax
# matchings near an argmax.  NeuFlow's moves by 8e-6
S18_STEP_CHECK = (("vcn_small", 6, (128, 192), True),
                  ("neuflow", 6, (128, 192), False),
                  ("gmflow_refine", 6, (128, 192), True))
S18_TRAIN_SIZE = (384, 512)
S18_TRAIN_BATCHES = (10, 8, 6, 4, 2)
S18_TRAIN_STEPS = 2
# the heads damped as the CPU tests damp them (the refiner's by 0.003:
# 134 px mean flows at 256x320 from the init's weights at 0.01)
S18_DAMPED = {"vcn": (("dc*_conv7",), 0.1),
              "neuflow": (("refine_s8.conv4",), 0.003),
              "gmflow": (("backbone.conv2",), 0.1)}
# VCN's finest (1/4) volume at 1024x448: the displacement convolution's
# channels, displacements and pixels (``vcn_conv_forms``)
VCN_LEVEL2 = (12, 9, 112, 256)

# Phase 21: UniMatch and GMFlow+ (model, lookups a forward at 1024x436)
S19_SERVE = (("unimatch", 0), ("unimatch_sc2", 0), ("unimatch_sc2_ref6", 6))
S19_NAMES = tuple(name for name, _ in S19_SERVE)
# each GMFlow+ name and its UniMatch twin (the same class)
S19_TWINS = {"gmflow_p": "unimatch", "gmflow_p_sc2": "unimatch_sc2",
             "gmflow_p_sc2_ref6": "unimatch_sc2_ref6"}
# the card-against-CPU train step: ill-conditioned in float32 as
# gmflow_refine's is (tests/test_torch_unimatch_train.py), so held in
# float64 too; 64x96 puts 2x3 windows at 1/4
S19_STEP_SEED, S19_STEP_SIZE = 6, (64, 96)
# batch 10 fits alone (70.3 GiB peak) but not after phases 1-20 on an
# 80 GB H100: the search starts at 8
S19_TRAIN_SIZE = (384, 512)
S19_TRAIN_BATCHES = (8, 6, 4, 2)
S19_TRAIN_STEPS = 2
# the refinement's 1/4 level at 1024x448: batch, channels, height, width
UNIMATCH_LEVEL = (1, 128, 112, 256)

# softsplat_average, card against CPU: float32 sums of a few terms whose
# atomics add in no fixed order on the card
ATOL_SPLAT = 1e-5
# LiteFlowNet3's ``confs`` (sigmoids in [0, 1]) card against CPU at
# 256x320, as its CPU tests hold them to the JAX package's
ATOL_CONFS = 1e-4
# DeviceCompose, card against CPU on one Chairs sample, the same draws and
# one noise field: float32 sums of the same few terms in another order
ATOL_AUG_IMAGES, ATOL_AUG_FLOWS_PX = 1e-5, 1e-4


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(torch, fn, reps: int, flush=None, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events around
    each call, after one untimed call where ``warm`` (a caller that has
    just run ``fn`` passes False).  ``flush`` runs before every call and
    sweeps the 50 MB L2 (see ``flushes``), so the call finds its inputs
    cold, as in the model, where the update block runs between two
    lookups; the sweep also keeps the card busy while the host enqueues
    the call."""
    if warm:
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


# Profiler readings that no card could give (under the kernel's bound) or
# whose kernel records do not match the launches: each is printed as
# invalid and kept here with its reason, and its number is null
INVALID_READINGS = []


def profiled_ms(torch, fn, reps: int, flush, name: str = "corr_lookup",
                bound_ms=None, label: str = ""):
    """Mean device time per launch of the kernels whose name holds ``name``
    over ``reps`` calls of ``fn``, L2 flushed before each, by the profiler
    (torch.profiler), or None where it recorded no device time.  A first
    profiled run absorbs the tracer's start-up and is not read.

    The time is the sum of the matching kernels' own records (each
    launch's start to end on the card) over their number, which must equal
    the launches that the wrappers counted in the profiled run; a run that
    lost records is read again, up to 3 times.  The profiler loses records
    now and then late in a long process, and the records left can then be
    short: the backward once read 0.0866 ms at RAFT's train shape, and
    0.0618 ms at FlowFormer's on 17 records of 20 launches, both under
    the kernel's bound.  A reading whose records do not match the launches,
    or under ``bound_ms``, which no card can give, is printed as invalid,
    kept in INVALID_READINGS with its reason, and gives None.
    ``key_averages()`` is read only to compare (``profiler_readings``)."""
    for attempt in range(3):
        readings = profiler_readings(torch, fn, reps, flush, name)
        if readings["records"] == readings["launches"]:
            break
    ms, reason = readings["records_ms"], None
    if readings["records"] != readings["launches"]:
        reason = (f"{readings['records']} kernel records for "
                  f"{readings['launches']} launches, {attempt + 1} times")
    elif ms is not None and bound_ms is not None and ms < bound_ms:
        reason = f"{ms:.5f} ms is under the {bound_ms:.5f} ms bound"
    if reason is not None:
        log(f"[profiler] {label or name}: reading invalid, recorded as null: "
            f"{reason}")
        INVALID_READINGS.append({"label": label or name, "kernel": name,
                                 "reason": reason, "readings": readings})
        return None
    return ms


def profiler_readings(torch, fn, reps: int, flush, name: str) -> dict:
    """One profiled run of ``reps`` calls of ``fn`` (after a discarded one):
    the launches of the kernel ``name`` ("corr_lookup" or
    "corr_lookup_backward") that its wrapper counted, the card's records of
    that kernel and their mean duration, and ``key_averages()``'s self-time
    mean and count for the kernels whose name holds ``name`` (the reading
    ``profiled_ms`` took before it read the records)."""
    from torch.profiler import ProfilerActivity, profile

    from ptlflow_tpu_torch.ops import correlation as corr

    backward = name == "corr_lookup_backward"
    wrapper = (corr.corr_lookup_backward_kernel if backward
               else corr.corr_lookup_kernel)

    def ours(event_name: str) -> bool:
        # the forward kernel's name is a prefix of the backward's
        return name in event_name and (backward
                                       or "backward" not in event_name)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):
        torch.cuda.synchronize()
        before = wrapper.launches
        with profile(activities=acts) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        launches = wrapper.launches - before
    durations = [e.time_range.elapsed_us() for e in prof.events()
                 if ours(e.name)
                 and str(getattr(e, "device_type", "")).endswith("CUDA")]
    self_total, self_count = 0.0, 0
    for e in prof.key_averages():
        if name in e.key and str(getattr(e, "device_type", "")).endswith(
                "CUDA"):
            self_total += (getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0))
            self_count += e.count
    return {"launches": launches, "records": len(durations),
            "records_ms": (sum(durations) / len(durations) / 1e3
                           if durations and sum(durations) > 0 else None),
            "records_min_ms": min(durations) / 1e3 if durations else None,
            "records_max_ms": max(durations) / 1e3 if durations else None,
            "self_ms": (self_total / self_count / 1e3
                        if self_count and self_total > 0 else None),
            "self_count": self_count}


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


def smooth_frames(seed: int, h: int, w: int, n: int = 2, shift=(3, 2)):
    """``n`` frames of a smooth random BGR texture, frame k moved by k times
    ``shift`` (x, y) pixels (at most 16 in all), as uint8 HWC frames."""
    import torch
    import torch.nn.functional as F

    rng = np.random.RandomState(seed)
    m = 16 * (n - 1)
    low = torch.from_numpy(rng.rand(1, 3, (h + 2 * m) // 8,
                                    (w + 2 * m) // 8).astype(np.float32))
    tex = F.interpolate(low, size=(h + 2 * m, w + 2 * m), mode="bicubic",
                        align_corners=False).clamp(0, 1)[0]
    tex = (tex.permute(1, 2, 0).numpy() * 255).astype(np.uint8)
    dx, dy = shift
    return [tex[m - k * dy:m - k * dy + h, m - k * dx:m - k * dx + w]
            for k in range(n)]


def smooth_pair(seed: int, h: int, w: int, shift=(3, 2)):
    """A smooth random BGR texture and its copy moved by ``shift``."""
    return tuple(smooth_frames(seed, h, w, 2, shift))


def train_batch(torch, seed: int, b: int, h: int, w: int, dev,
                frames: int = 2) -> dict:
    """A batch of the JAX package's train step in the port's layout:
    ``images`` (B, F, 3, H, W) in [0, 1], ``b`` smooth sequences of
    ``frames`` frames, each moved by its own whole-pixel shift a frame;
    ``flows`` (B, F - 1, 2, H, W), that shift; and ``valids`` (B, F - 1, 1,
    H, W), a fifth of the pixels 0."""
    rng = np.random.RandomState(seed)
    images, flows = [], []
    for k in range(b):
        shift = (int(rng.randint(-4, 5)), int(rng.randint(-4, 5)))
        images.append(np.stack(smooth_frames(seed * 100 + k, h, w, frames,
                                             shift)))
        flows.append(np.broadcast_to(
            np.array(shift, np.float32)[None, :, None, None],
            (frames - 1, 2, h, w)))
    images = torch.from_numpy(np.stack(images).astype(np.float32) / 255.0)
    valids = (rng.rand(b, frames - 1, 1, h, w) > 0.2).astype(np.float32)
    return {"images": images.permute(0, 1, 4, 2, 3).contiguous().to(dev),
            "flows": torch.from_numpy(np.stack(flows)).to(dev),
            "valids": torch.from_numpy(valids).to(dev)}


def grid_sample_lookup(torch, pyr, coords, radius: int):
    """The lookup by one ``torch.nn.functional.grid_sample`` per level and a
    ``cat``: the PyTorch yardstick only, the port never calls it."""
    b, _, h1, w1 = coords.shape
    n = 2 * radius + 1
    d = torch.linspace(-radius, radius, n, device=coords.device)
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


def backward_bound(torch, grad_out, coords, shapes, radius: int) -> dict:
    """Least time of one backward launch on this card: grad_out and the
    coords read once and every level's dense gradient written once, over
    the memory rate; or its operations (at most 4 taps of a multiply, a
    multiply and an add per in-range patch cell of these coords) over the
    fp32 rate; whichever is larger."""
    q = coords.shape[0] * coords.shape[2] * coords.shape[3]
    elt = grad_out.element_size()
    dense = q * sum(h * w for h, w in shapes) * elt
    nbytes = grad_out.numel() * elt + coords.numel() * 4 + dense
    elems, _ = patch_traffic(torch, coords, shapes, radius, elt)
    ops = 12 * elems
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "dense_bytes": dense, "ops": ops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def bn_stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


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


def set_layer_scales(torch, model, seed: int) -> None:
    """Every layer scale ``gamma`` (ConvNeXt's, 1e-6 at init, and GMA's
    aggregator's, 0 at init: the blocks they scale add next to nothing
    there; LLA-Flow's and MEMFOF's blends, 0 at init) and torchvision
    ConvNeXt's ``layer_scale`` (1e-6 at init, ReCoVEr-CX) to seeded values
    in [0.1, 1], so that a check sees those blocks."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("gamma", "layer_scale"):
                p.copy_(0.1 + 0.9 * torch.rand(p.shape, generator=gen))


def draw_factors(torch, model, seed: int) -> None:
    """NeXt1D's depthwise factors ``weight_h`` and ``weight_v``, zero at
    init (a zero factor tests nothing), seeded normal with std
    (2 / k^2)^(1/4), so that their k x k product has a convolution's
    He-normal scale; every layer scale (``gamma``, ``layer_scale*``)
    seeded in [0.1, 1]."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("weight_h", "weight_v"):
                k = max(p.shape[2:])
                p.copy_((2.0 / k ** 2) ** 0.25
                        * torch.randn(p.shape, generator=gen))
            elif leaf == "gamma" or leaf.startswith("layer_scale"):
                p.copy_(0.1 + 0.9 * torch.rand(p.shape, generator=gen))


def randomise_norms(torch, model, seed: int) -> None:
    """Seeded BatchNorm statistics and affine weights, as the CPU tests
    give them, so that BatchNorm is not the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                c = mod.num_features
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_var.copy_(1 + 0.5 * torch.rand(c, generator=gen))
                mod.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(c, generator=gen))


def calibrate_norms(torch, model, images) -> None:
    """Every BatchNorm's running statistics to those of ``images`` (one
    training forward at momentum 1), as training leaves them for its data:
    random statistics do not normalise ResNet34's activations, and
    SEA-RAFT's flows then reach ~1000 px at 64x96."""
    norms = [m for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    saved = [m.momentum for m in norms]  # 0.1, MobileNetV3's 0.01
    for m in norms:
        m.momentum = 1.0
    with torch.no_grad():
        model({"images": images}, training=True)
    for m, momentum in zip(norms, saved):
        m.momentum = momentum


def flow_conv(model):
    """The convolution whose first two output channels are the flow step:
    FlowFormer's flow head, SEA-RAFT's, which also gives the info
    channels, the super-kernel flow head's last convolution (SKFlow,
    MemFlow) or RAFT's (LCV-RAFT)."""
    if hasattr(model, "memory_decoder"):
        return model.memory_decoder.update_block.flow_head.conv2
    if hasattr(model, "flow_head"):
        return model.flow_head[2]
    head = getattr(model, "network", model).update_block.flow_head
    return head.ffn2[2] if hasattr(head, "ffn2") else head.conv2


def condition_super_kernel(torch, model) -> None:
    """Random super-kernel blocks (SKFlow, MemFlow) multiply their input's
    scale by ~4 each, so that two iterations at 64x96 step ~5e6 px: every
    block's last convolution (``ffn2.2``) scaled by 0.2 and the flow
    head's by 0.03 more, as ``tests/test_torch_skflow.py`` does (steps of
    10-40 px that one rounding of the input moves by under 1e-4 px)."""
    from ptlflow_tpu_torch.models.skflow.skflow import (
        PCBlock4_Deep_nopool_res)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, PCBlock4_Deep_nopool_res):
                mod.ffn2[2].weight.mul_(0.2)
                mod.ffn2[2].bias.mul_(0.2)
        conv = flow_conv(model)
        conv.weight.mul_(0.03)
        conv.bias.mul_(0.03)


def learned_metric(torch, model, seed: int) -> None:
    """LCV-RAFT's metric far from the identity that its init gives (W = I
    is RAFT's correlation): ``raw_P`` normal with std 0.3, ``raw_D``
    standard normal, as ``tests/test_torch_lcv.py`` draws them."""
    gen = torch.Generator().manual_seed(seed)
    blk = getattr(model, "corr_block", model)
    with torch.no_grad():
        blk.raw_P.copy_(0.3 * torch.randn(blk.raw_P.shape, generator=gen))
        blk.raw_D.copy_(torch.randn(blk.raw_D.shape, generator=gen))


def condition_flowformer(torch, model) -> None:
    """Random FlowFormer weights give cost maps of ~1700 and 800-1600 px
    flows at 160x128 that two CPU runs one fp32 rounding of the input apart
    do not share (1.6e3 px).  The matching features' Twins stage 2 scaled
    by 0.1 (its patch norm, each residual branch's last layer and the
    positional conv's bias; its LayerNorms make the rest scale-free), so
    the cost maps by 0.01, and the flow head's last conv by 0.01: 9-12 px
    flows that such runs give within 1.1e-4 px at 320x256 over 32 steps."""
    svt = model.memory_encoder.feat_encoder.svt
    with torch.no_grad():
        for mod in [svt.patch_embeds[1].norm] + [
                m for blk in svt.blocks[1] for m in (blk.attn.proj,
                                                     blk.mlp.fc2)]:
            mod.weight.mul_(0.1)
            mod.bias.mul_(0.1)
        svt.pos_block[1].proj[0].bias.mul_(0.1)
        conv = flow_conv(model)
        conv.weight.mul_(0.01)
        conv.bias.mul_(0.01)


def condition_video_and_attention(torch, name: str, model) -> None:
    """Phase 13's models, conditioned to steps of trained size with their
    zero-init parameters drawn (a zero tests nothing), as their CPU tests
    do.  CRAFT: the sliding positional biases (zero at init) seeded
    uniform in +-0.1, seeded BatchNorms, the flow head damped by 0.01 (32
    iterations, as LCV-RAFT's).  NeuFlow v2: seeded BatchNorms, the
    refiners' flow steps damped by 0.03.  VideoFlow
    and StreamFlow: ``condition_super_kernel`` and seeded layer scales
    (GMA's aggregator ``gamma``); MOF's mask convolution by 0.01 more (it
    multiplies the mask by 100); StreamFlow's temporal transformer (zero
    at init) seeded: linear weights uniform in +-1/sqrt(fan-in), biases
    normal with std 0.1, norm weights 1 + that."""
    gen = torch.Generator().manual_seed(13)
    if name in ("craft", "neuflow2"):
        randomise_norms(torch, model, 13)
    if name == "craft":
        damp_flow_head(model, 0.01)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n.endswith("pos_coder.biases"):
                    p.copy_(torch.empty(p.shape).uniform_(-0.1, 0.1,
                                                          generator=gen))
        return
    if name == "neuflow2":
        # random refiners step ~1400 px at 256x320, and one rounding of the
        # input moves a train step's whole gradient by 2.6e-3; the flow
        # channels of both refiners' last convolution damped by 0.03: 59 px
        # (the global matching's), 2.5e-5
        with torch.no_grad():
            for refine in (model.refine_s16, model.refine_s8):
                refine.conv3.weight[:2].mul_(0.03)
                refine.conv3.bias[:2].mul_(0.03)
        return
    condition_super_kernel(torch, model)
    set_layer_scales(torch, model, 13)
    with torch.no_grad():
        if name == "videoflow_mof":
            for leaf in ("weight", "bias"):
                getattr(model.update_block.mask[2], leaf).mul_(0.01)
        if name == "streamflow":
            block = model.update_block.transformer_block
            for n, p in block.named_parameters():
                if p.dim() == 2:
                    bound = p.shape[1] ** -0.5
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                          generator=gen))
                else:
                    base = 1.0 if "norm" in n and n.endswith("weight") else 0
                    p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen))


def flow_heads(model):
    """(convolution, output channels) of the flow steps a model serves:
    MEMFOF's flow head gives both directions' (2<-1: 0-1, 2->3: 6-7),
    SplatFlow's two GRU branches have a flow head each, the others as
    ``flow_conv``."""
    if hasattr(model, "update") and hasattr(model.update, "flow_head_sp"):
        return [(model.update.flow_head.conv2, [0, 1]),
                (model.update.flow_head_sp.conv2, [0, 1])]
    if type(model).__name__ == "memfof":
        return [(model.flow_head[2], [0, 1, 6, 7])]
    if hasattr(model, "update_block_s"):  # DIP: propagation and search
        return [(model.update_block_s.flow_head.conv2, [0, 1]),
                (model.update_block.flow_head.conv2, [0, 1])]
    return [(flow_conv(model), [0, 1])]


def condition_volume_and_backbone(torch, name: str, model, images) -> None:
    """Phase 14's models, conditioned to steps of trained size with their
    zero-init parameters drawn, as their CPU tests do.  MEMFOF, ReCoVEr and
    Flow-Anything as SEA-RAFT (seeded layer scales, ConvNeXt's
    ``layer_scale`` and the aggregator's ``gamma`` among them; the flow
    head's flow channels damped by 0.01, its info channels by 0.1, each
    ConvNeXt ``final`` conv by 0.1; the norms calibrated on ``images``).
    LLA-Flow, CSFlow and SplatFlow as LCV-RAFT (32 iterations): the flow
    heads damped by 0.01, seeded norms and blends (``gamma``); CSFlow's
    second-frame strip BatchNorms by 1e-3 (random strips sum to ~1e3 px
    initial flows)."""
    set_layer_scales(torch, model, 14)
    with torch.no_grad():
        if name == "memfof" or name.startswith(("recover", "flow_any")):
            head, flow = flow_heads(model)[0]
            info = [c for c in range(head.out_channels) if c not in flow]
            for channels, factor in ((flow, 0.01), (info, 0.1)):
                head.weight[channels] *= factor
                head.bias[channels] *= factor
            for blk in model.update_block.refine:
                blk.final.weight.mul_(0.1)
        else:
            for conv, _ in flow_heads(model):
                conv.weight.mul_(0.01)
                conv.bias.mul_(0.01)
    if name == "memfof" or name.startswith(("recover", "flow_any")):
        calibrate_norms(torch, model, images)
        return
    randomise_norms(torch, model, 14)
    if name == "csflow":
        with torch.no_grad():
            for blk in (model.strip_corr_block_v2.conv2_1,
                        model.strip_corr_block_v2.conv2_2):
                blk.bn.weight.mul_(1e-3)
                blk.bn.bias.mul_(1e-3)


def damp_sea_raft_heads(torch, model) -> None:
    """SEA-RAFT's flow head (also FlowSeek's): its flow channels damped by
    0.01, its info channels by 0.1, and each ConvNeXt refine block's
    ``final`` conv by 0.1."""
    with torch.no_grad():
        head = model.flow_head[2]
        head.weight[:2].mul_(0.01)
        head.bias[:2].mul_(0.01)
        head.weight[2:].mul_(0.1)
        head.bias[2:].mul_(0.1)
        for blk in model.update_block.refine:
            blk.final.weight.mul_(0.1)


def condition_slice13(torch, name: str, model, images) -> None:
    """Phase 15's models, conditioned to steps of trained size, as their CPU
    tests do.  Every layer scale (DINOv2's LayerScale ``gamma``, 1.0 at
    init, 12 blocks deep; ConvNeXt's) seeded in [0.1, 1].  WAFT: each
    feature head's last conv damped to maps of unit size (Twins' ``final``
    by 1e-3, the DepthAnything heads' output convs by 1e-2), the refine
    ViT's output conv by 0.01, the hidden state's update by 0.5 (the
    refinement then keeps the state's size) and the flow head's last conv
    by 0.01.  FlowSeek: as SEA-RAFT (flow channels by 0.01, info by 0.1,
    each ConvNeXt ``final`` by 0.1, the norms calibrated on ``images``)
    and ``merge_head``'s last conv by 0.05 (the depth features reach ~200
    otherwise).  DIP and Flow1D: the RAFT-style flow heads damped by 0.03
    (20 + 20 rounds, 32 iterations); GMFlowNet's by 0.01 (its flows start
    at the matches, 60 px on random features at 256x320, and at 0.03 one
    rounding of the input moves them by 4e-3 px); seeded norms."""
    set_layer_scales(torch, model, 15)
    with torch.no_grad():
        def damp(mod, factor):
            mod.weight.mul_(factor)
            if mod.bias is not None:
                mod.bias.mul_(factor)

        if name.startswith("waft"):
            enc = getattr(model, "encoder", None)
            if hasattr(enc, "final"):
                damp(enc.final, 1e-3)
            if hasattr(enc, "dpt_head"):
                damp(enc.dpt_head.refine[0].out_conv, 1e-2)
            if hasattr(model, "da_feature"):
                damp(model.da_feature.depth_anything.depth_head.scratch
                     .output_conv1, 1e-2)
            damp(model.refine_net.dpt_head.scratch.output_conv1, 0.01)
            damp(model.refine_transform, 0.5)
            damp(model.flow_head[2], 0.01)
            return
        if name.startswith("flowseek"):
            damp_sea_raft_heads(torch, model)
            damp(model.merge_head[4], 0.05)
        else:
            for conv, _ in flow_heads(model):
                damp(conv, 0.01 if name.startswith("gmflownet") else 0.03)
    if name.startswith("flowseek"):
        calibrate_norms(torch, model, images)
    else:
        randomise_norms(torch, model, 15)


def condition_slice14(torch, name: str, model) -> None:
    """Phase 16's models, conditioned as their CPU tests are: the flow head's
    last conv damped by 0.01 (32 iterations, or 25 to 38 over the scales),
    GMA's aggregator ``gamma`` (0 at init) seeded in [0.1, 1] and seeded
    BatchNorm statistics (MatchFlow's encoders, SCV's context encoder;
    MS-RAFT+ and CCMR have GroupNorms).  MS-RAFT+ upsamples its *coords*
    to the next scale with the last mask, whose zero-padded 3x3
    neighbourhood a random mask mixes into them (30 px mean flows at
    64x96, whatever the flow head): its mask head picks the centre
    neighbour instead (its 4 logits +10, the weights x 0.01), as a
    trained one must at the borders; each finer grid is then up to a pixel
    off the upsampled coords (S14_UNDAMPED)."""
    set_layer_scales(torch, model, 16)
    damp_flow_head(model, 0.01)
    randomise_norms(torch, model, 16)
    if name == "ms_raft_p":
        with torch.no_grad():
            conv = model.update_block.mask[2]
            conv.weight.mul_(0.01)
            # channel k*4 + i*2 + j, centre k = 4; the block scales the
            # mask by 0.25: logits +10
            conv.bias[16:20] += 40.0


def condition_slice15(torch, name: str, model) -> None:
    """Phase 17's models, conditioned as their CPU tests are.  SeparableFlow:
    the flow head's last conv damped by 0.01 (32 iterations), the shift
    regressions' 3-D convolutions by 0.1 (random ones saturate the softmax
    over the 193 bins), seeded BatchNorm statistics, the 3-D ones too.
    PWC-Net: its flow predictors (``predict_flow2``-``6``, ``dc_conv7``)
    damped by 0.1 (random DenseNet decoders grow the flow level after
    level).  IRR: the flow estimators' and context networks' last
    convolutions by 0.1 (0.02 for the weight-shared estimator), the
    occlusion ones and the occlusion upsampler's by 0.02 (random occlusion
    logits grow ~10x a level and saturate the sigmoid)."""
    def damp(conv, factor):
        with torch.no_grad():
            conv.weight.mul_(factor)
            if conv.bias is not None:
                conv.bias.mul_(factor)

    if name == "separableflow":
        damp_flow_head(model, 0.01)
        for agg in (model.cost_agg1, model.cost_agg2):
            for shift in (agg.shift0, agg.shift1, agg.shift2):
                damp(shift.conv3d_2d, 0.1)
        randomise_norms(torch, model, 17)
        gen = torch.Generator().manual_seed(17)
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, torch.nn.BatchNorm3d):
                    c = mod.num_features
                    mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                    mod.running_var.copy_(1 + 0.5 * torch.rand(
                        c, generator=gen))
        return
    if name.startswith("pwcnet"):
        for mod_name, mod in model.named_children():
            if mod_name.startswith("predict_flow") or mod_name == "dc_conv7":
                damp(mod, 0.1)
        return
    flow = 0.02 if name == "irr_pwcnet_irr" else 0.1
    ests = model.flow_estimators
    for est in (ests if isinstance(ests, torch.nn.ModuleList) else [ests]):
        damp(est.conv_last[0], flow)
    damp(model.context_networks.convs[6][0], flow)
    if hasattr(model, "occ_estimators"):
        damp(model.occ_estimators.conv_last[0], 0.02)
        damp(model.occ_context_networks.convs[6][0], 0.02)
        damp(model.occ_shuffle_upsample.out_convs[0], 0.02)


def s16_family(name: str) -> str:
    """The key of phase 18's per-family tables (``S16_DAMPED``)."""
    if name.startswith("flownet"):
        return "flownet"
    if name.startswith(("liteflownet2", "liteflownet3")):
        return "liteflownet23"
    return name


def condition_slice16(torch, name: str, model) -> None:
    """Phase 18's models, conditioned as their CPU tests are: the flow
    heads (``S16_DAMPED``: every ``predict_flow*`` of the FlowNets at any
    depth, the last convolution of LiteFlowNet's matching and sub-pixel
    flow networks, of the pseudo sub-pixel stage and of LiteFlowNet3's
    displacement heads, FastFlowNet's decoder outputs) damped by 0.1."""
    import fnmatch

    patterns = S16_DAMPED[s16_family(name)]
    with torch.no_grad():
        for mod_name, mod in model.named_modules():
            if (any(fnmatch.fnmatch(mod_name, p) for p in patterns)
                    and getattr(mod, "weight", None) is not None):
                mod.weight.mul_(0.1)
                if mod.bias is not None:
                    mod.bias.mul_(0.1)


def s17_family(name: str) -> str:
    """The key of phase 19's per-family tables (``S17_DAMPED``)."""
    return {"maskflownet_s": "maskflownet", "hd3_ctxt": "hd3"}.get(name,
                                                                   name)


def condition_slice17(torch, name: str, model, images=None) -> None:
    """Phase 19's models, conditioned as their CPU tests are
    (``S17_DAMPED``): MaskFlowNet's flow and mask heads and context output,
    HD3's density heads and DICL's displacement projections and context
    outputs by 0.1, STaRFlow's shared estimator, context and occlusion
    upsampler outputs by 0.02.  HD3's density heads also favour the
    support's centre cell by HD3_CENTRE_LOGIT, as a trained model's
    residual densities do, and its BatchNorms take ``images``' statistics
    (``calibrate_norms``): at the init's statistics DLA-34's eval
    activations grow until the random heads peak at the support's edge,
    each level adds its widest step, and the ~400 px flows at 256x320 move
    by 1.1e-2 px between two float32 runs (the card's and the CPU's, the
    argmax cells replayed)."""
    import fnmatch

    patterns, factor = S17_DAMPED[s17_family(name)]
    with torch.no_grad():
        for mod_name, mod in model.named_modules():
            if (any(fnmatch.fnmatch(mod_name, p) for p in patterns)
                    and getattr(mod, "weight", None) is not None):
                mod.weight.mul_(factor)
                if mod.bias is not None:
                    mod.bias.mul_(factor)
                    if s17_family(name) == "hd3":
                        mod.bias[mod.bias.numel() // 2] += HD3_CENTRE_LOGIT
    if s17_family(name) == "hd3" and images is not None:
        calibrate_norms(torch, model, images)


def s18_family(name: str) -> str:
    """The key of phase 20's per-family tables (``S18_DAMPED``)."""
    return {"vcn_small": "vcn", "gmflow_refine": "gmflow"}.get(name, name)


def condition_slice18(torch, name: str, model) -> None:
    """Phase 20's models, conditioned as their CPU tests are
    (``S18_DAMPED``): VCN's hypotheses' fusion heads (a softmax picks
    among the hypotheses) and GMFlow's backbone output (random features
    make the softmax matching near an argmax) by 0.1, NeuFlow's 1/8
    refiner output by 0.003 (random refiners step by thousands of
    pixels)."""
    import fnmatch

    patterns, factor = S18_DAMPED[s18_family(name)]
    with torch.no_grad():
        for mod_name, mod in model.named_modules():
            if (any(fnmatch.fnmatch(mod_name, p) for p in patterns)
                    and getattr(mod, "weight", None) is not None):
                mod.weight.mul_(factor)
                if mod.bias is not None:
                    mod.bias.mul_(factor)


def condition_slice19(torch, name: str, model) -> None:
    """Phase 21's models, conditioned as their CPU tests are
    (``tests/test_torch_unimatch.py``): GMFlow's backbone output by 0.1
    (``condition_slice18``) and the refinement's flow head by 0.1 (random
    refinement steps otherwise add tens of pixels each)."""
    condition_slice18(torch, "gmflow", model)
    if hasattr(model, "refine"):
        conv = model.refine.flow_head.conv2
        with torch.no_grad():
            conv.weight.mul_(0.1)
            conv.bias.mul_(0.1)


class ArgmaxReplay:
    """Every ``torch.argmax`` of a run on the card recorded, then given to
    a run on the CPU, as ``TopkReplay`` does for ``torch.topk``: HD3's
    density cells, where a near tie in float32 may be broken either way
    and move a flow by a support cell.  Counts the elements whose own
    argmax differs from the card's."""

    def __init__(self, torch):
        self.torch = torch
        self.argmax = torch.argmax
        self.recorded = []
        self.elements = self.differ = 0

    def record(self):
        self.recorded = []

        def argmax(x, *args, **kw):
            out = self.argmax(x, *args, **kw)
            self.recorded.append(out.cpu())
            return out

        return swapped(self.torch, "argmax", argmax, self)

    def replay(self):
        pending = iter(self.recorded)
        self.elements = self.differ = 0

        def argmax(x, *args, **kw):
            own = self.argmax(x, *args, **kw)
            idx = next(pending).to(x.device)
            if idx.shape != own.shape:
                raise AssertionError(f"argmax replay: {tuple(idx.shape)} "
                                     f"recorded, {tuple(own.shape)} asked")
            self.elements += own.numel()
            self.differ += int((idx != own).sum())
            return idx

        return swapped(self.torch, "argmax", argmax, self)


@contextlib.contextmanager
def swapped(module, name: str, fn, value=None):
    """``module.name`` replaced by ``fn`` within the block, which gets
    ``value``."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield value
    finally:
        setattr(module, name, saved)


class TopkReplay:
    """Every ``torch.topk`` of a run on the card recorded, then given to a
    run on the CPU: the quadtree attention's and SCV's selections, where a
    near tie in float32 may be broken either way and move a flow by a
    pixel.  The CPU run takes the card's indices (its values gathered from
    its own scores) and counts the rows whose own selection, as a set,
    differs from the card's."""

    def __init__(self, torch):
        self.torch = torch
        self.topk = torch.topk
        self.recorded = []
        self.rows = self.differ = 0

    def record(self):
        self.recorded = []

        def topk(x, k, dim=-1, **kw):
            out = self.topk(x, k, dim, **kw)
            self.recorded.append(out.indices.cpu())
            return out

        return swapped(self.torch, "topk", topk, self)

    def replay(self):
        torch = self.torch
        pending = iter(self.recorded)
        self.rows = self.differ = 0

        def topk(x, k, dim=-1, **kw):
            own = self.topk(x, k, dim, **kw).indices
            idx = next(pending).to(x.device)
            if idx.shape != own.shape or dim not in (-1, x.dim() - 1):
                raise AssertionError(f"top-k replay: {tuple(idx.shape)} "
                                     f"recorded, {tuple(own.shape)} asked")
            moved = (idx.sort(-1).values != own.sort(-1).values).any(-1)
            self.rows += moved.numel()
            self.differ += int(moved.sum())
            return torch.return_types.topk((x.gather(-1, idx), idx))

        return swapped(self.torch, "topk", topk, self)


def parity_weights(torch, name: str, model, images) -> None:
    """Random weights conditioned to steps of trained size, so that two
    correct runs agree (random RAFT-family weights are chaotic: fp32
    rounding grows ~5x per iteration).  RAFT: the flow head damped by 0.03.
    GMA: that, seeded norms and layer scales.  SEA-RAFT: seeded layer
    scales, the flow head's flow channels damped by 0.01 and its info
    channels by 0.1, each ConvNeXt block's ``final`` conv by 0.1 (random
    ones multiply the hidden state by ~2.5 a block, and nothing bounds it),
    and the norms calibrated on ``images``.  FlowFormer:
    ``condition_flowformer``.  RAPIDFlow, RPKNet, DPFlow:
    ``draw_factors`` and the flow head damped by 0.03.  SKFlow and MemFlow:
    ``condition_super_kernel``, seeded norms and layer scales (the memory
    readout's ``gamma`` among them).  LCV-RAFT: RAFT's flow head damped by
    0.01 (32 iterations), seeded norms and ``learned_metric``.  CRAFT,
    NeuFlow v2, VideoFlow, StreamFlow: ``condition_video_and_attention``.
    MEMFOF, LLA-Flow, CSFlow, SplatFlow, ReCoVEr, Flow-Anything:
    ``condition_volume_and_backbone``.  WAFT, FlowSeek, DIP, Flow1D,
    GMFlowNet: ``condition_slice13``.  MatchFlow, SCV, MS-RAFT+, CCMR:
    ``condition_slice14``.  SeparableFlow, PWC-Net, IRR:
    ``condition_slice15``.  FlowNet, LiteFlowNet, FastFlowNet:
    ``condition_slice16``.  MaskFlowNet, HD3, STaRFlow, DICL:
    ``condition_slice17``.  VCN, NeuFlow, GMFlow: ``condition_slice18``.
    UniMatch, GMFlow+: ``condition_slice19``."""
    if name in S19_NAMES or name in S19_TWINS:
        condition_slice19(torch, name, model)
        return
    if name in S18_NAMES:
        condition_slice18(torch, name, model)
        return
    if name in S17_NAMES:
        condition_slice17(torch, name, model, images)
        return
    if name in S16_NAMES:
        condition_slice16(torch, name, model)
        return
    if name in S15_NAMES:
        condition_slice15(torch, name, model)
        return
    if name in S14_NAMES:
        condition_slice14(torch, name, model)
        return
    if name in S13_NAMES:
        condition_slice13(torch, name, model, images)
        return
    if name.startswith("flowformer"):
        condition_flowformer(torch, model)
        return
    if name in VB_NAMES:
        condition_volume_and_backbone(torch, name, model, images)
        return
    if name in {n for n, _, _ in VA_SERVE}:
        condition_video_and_attention(torch, name, model)
        return
    if name.startswith(("rapidflow", "rpknet", "dpflow")):
        draw_factors(torch, model, 1)
        # at 0.1 (the CPU tests' damping at 64x96) rapidflow's 12 steps
        # give 90 px mean flows at 256x320, which one rounding of the input
        # moves by 8.9e-3 px
        damp_flow_head(model, 0.03)
        return
    if name.startswith(("skflow", "memflow")):
        condition_super_kernel(torch, model)
        set_layer_scales(torch, model, 1)
        randomise_norms(torch, model, 1)
        return
    if name.startswith("lcv"):
        # 32 iterations: at RAFT's 0.03 two CPU runs one rounding of the
        # input apart part by 0.02 px at 256x320 (lcv_raft_small), at 0.01
        # by 6e-4
        damp_flow_head(model, 0.01)
        learned_metric(torch, model, 1)
        randomise_norms(torch, model, 1)
        return
    if name.startswith("sea_raft"):
        set_layer_scales(torch, model, 1)
        damp_sea_raft_heads(torch, model)
        calibrate_norms(torch, model, images)
        return
    damp_flow_head(model)
    if name == "gma":
        set_layer_scales(torch, model, 1)
        randomise_norms(torch, model, 1)


def damp_to_served_size(torch, name: str, model, images) -> None:
    """Scale the flow head's flow channels (``flow_heads``), and CSFlow's
    strip initialisation (its second-frame strip BatchNorms: the strips'
    sums are linear in them), until ``model``'s mean |flow| on ``images``
    is at most SERVED_FLOW_PX: conditioned by ``parity_weights`` alone,
    SEA-RAFT still gives 60-250 px at 1024x436.  Each round aims at half
    the limit; the flow is near linear in the scale, so one or two rounds
    do."""
    heads = flow_heads(model)
    if hasattr(model, "strip_corr_block_v2"):
        blk = model.strip_corr_block_v2
        heads += [(blk.conv2_1.bn, slice(None)), (blk.conv2_2.bn,
                                                   slice(None))]
    mags = []
    for _ in range(5):
        with torch.no_grad():
            flows = model({"images": images})["flows"]
            mag = flows.norm(dim=2).mean().item()
            mags.append(f"{mag:.3f}")
            if mag <= SERVED_FLOW_PX:
                log(f"[served weights] {name}: mean |flow| on the "
                    f"calibration pair {' -> '.join(mags)} px")
                return
            scale = 0.5 * SERVED_FLOW_PX / mag
            for head, channels in heads:
                head.weight[channels] *= scale
                head.bias[channels] *= scale
    raise AssertionError(f"{name}: mean |flow| {mag} px after 5 rounds")


def served_model(torch, name: str, args: dict, images):
    """``get_model(name, args=args)`` on the card, its seeded random
    weights used as they are, except SEA-RAFT's, which ``parity_weights``
    conditions on ``images`` and ``damp_to_served_size`` damps to flows of
    trained size: the init's weights step ~4x further each refinement (mean
    flows of 8e7 px from sea_raft_m, 6e12 px from sea_raft_l at 1024x436),
    so that its lookups read no map at all."""
    import ptlflow_tpu_torch

    model = ptlflow_tpu_torch.get_model(name, args=args)
    if name.startswith("sea_raft"):
        # a mixed-precision model refuses the training forward that
        # calibrates the norms: condition fp32 weights and load them
        fp32 = ptlflow_tpu_torch.get_model(
            name, args=dict(args, mixed_precision=False))
        parity_weights(torch, name, fp32, images)
        damp_to_served_size(torch, name, fp32, images)
        model.load_state_dict(fp32.state_dict())
    return model


def train_step_card_vs_cpu(torch, name: str, dev, args=None,
                           lookups=2, frames: int = 2,
                           batch_seed: int = 5, size=(128, 160),
                           ill_conditioned: bool = False) -> dict:
    """One train step of ``name`` at 128x160 (or ``size``), batch 2,
    2 iterations (or the ``args`` that set 2 decoder steps, or 2 steps a
    level), on the CPU and on the card from the same weights
    (``parity_weights``), in float32: the loss within RTOL_LOSS, the
    BatchNorm statistics within ATOL_BN and the whole gradient within
    GRAD_RTOL, by its largest element and by its norm; the per-tensor
    figures printed, and where a check fails, beside those of the CPU
    again with the images one fp32 rounding off (how far rounding alone
    moves this step), before the failure is raised.  An
    ``ill_conditioned`` step, one that float32 rounding alone moves past
    those tolerances, is held to them in float64, and in float32 to limits
    this run measures: SPREAD_FACTOR times the larger of the CPU float32
    step's distances from the CPU's step on the nudged images and from the
    CPU's float64 step, by each metric (the BatchNorm statistics' limit is
    ATOL_BN at least).  The card step must launch each kernel ``lookups``
    times (a pair: the forward kernel's launches, the backward's).  The
    batch holds sequences of ``frames`` frames (``train_batch``, seeded with
    ``batch_seed``).  Every other step takes the card float32 step's top-k
    selections (``TopkReplay``) and argmax indices (``ArgmaxReplay``)."""
    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.nn import split_trainable
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain

    args = {"iters": 2} if args is None else args
    cpu_model = ptlflow_tpu_torch.get_model(name, args=args, device="cpu")
    batch = train_batch(torch, batch_seed, 2, *size, "cpu", frames)
    parity_weights(torch, name, cpu_model, batch["images"])
    expected = lookups if isinstance(lookups, tuple) else (lookups, lookups)
    gpu_model = ptlflow_tpu_torch.get_model(name, args=args)
    start = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    # the CPU again, on images one fp32 rounding off (x (1 + 2^-23))
    nudged = dict(batch, images=batch["images"] * (1 + 2.0 ** -23))
    step_out, launched = {}, {}

    def step(label, model, where, b, dtype=torch.float32):
        if dtype != torch.float32:
            model.to(dtype)
        model.load_state_dict(start)
        params, _ = split_trainable(model)
        corr.corr_lookup_kernel.launches = 0
        corr.corr_lookup_backward_kernel.launches = 0
        loss, grads = ttrain.loss_and_grads(
            model, params, {k: v.to(where, dtype) for k, v in b.items()})
        step_out[label] = (loss.item(), list(params), [g.cpu() for g in grads],
                           {k: v.cpu() for k, v in bn_stats(model).items()},
                           ttrain.global_norm(grads).item())
        launched[label] = (corr.corr_lookup_kernel.launches,
                           corr.corr_lookup_backward_kernel.launches)

    replay, areplay = TopkReplay(torch), ArgmaxReplay(torch)
    with replay.record(), areplay.record():
        step("card", gpu_model, dev, batch)
    with replay.replay(), areplay.replay():
        step("cpu", cpu_model, "cpu", batch)
    topk_rows = [replay.differ, replay.rows]
    argmax_elements = [areplay.differ, areplay.elements]
    if ill_conditioned:
        for args_ in (("cpu nudged", cpu_model, "cpu", nudged),
                      ("card float64", gpu_model, dev, batch, torch.float64),
                      ("cpu float64", cpu_model, "cpu", batch,
                       torch.float64)):
            with replay.replay(), areplay.replay():
                step(*args_)
    if replay.rows:
        log(f"[4 card vs cpu] {name} train step: {topk_rows[0]} of "
            f"{topk_rows[1]} top-k selections differ between the card and "
            f"the CPU; the CPU took the card's")
    if areplay.elements:
        log(f"[4 card vs cpu] {name} train step: {argmax_elements[0]} of "
            f"{argmax_elements[1]} argmax indices differ between the card "
            f"and the CPU; the CPU took the card's")
    for label, got in launched.items():
        if label.startswith("card") and got != expected:
            raise AssertionError(f"{name} {label} train step: launches "
                                 f"{got}, expected {expected}")

    def gap(label, ref):
        """(loss, gradient by its largest element, by its norm, BatchNorm
        statistics) of step ``label`` against step ``ref``, relative to
        ``ref``'s, in float64."""
        (rl, _, rg, rs, _), (l, _, g, s, _) = step_out[ref], step_out[label]
        d = torch.cat([(a.double() - b.double()).flatten()
                       for a, b in zip(g, rg)])
        flat = torch.cat([b.double().flatten() for b in rg])
        bn = max(((s[k].double() - rs[k].double()).abs().max().item()
                  for k in rs), default=0.0)
        return (abs(l - rl) / abs(rl), d.abs().max().item()
                / flat.abs().max().item(), (d.norm() / flat.norm()).item(),
                bn)

    def per_tensor(label, ref):
        names, rg = step_out[ref][1], step_out[ref][2]
        gmax = max(g.abs().max().item() for g in rg)
        return sorted(((a.double() - b.double()).abs().max().item()
                       / max(b.abs().max().item(), GRAD_FLOOR / GRAD_RTOL
                             * gmax), n)
                      for n, a, b in zip(names, step_out[label][2], rg))

    def held(label, ref, limits):
        """Log step ``label`` against step ``ref``; the first limit it
        passes by name, or None."""
        dl, gmax_rel, gnorm_rel, bn = gap(label, ref)
        ratios = per_tensor(label, ref)
        log(f"[4 card vs cpu] {name} train step, {label} against {ref}: "
            f"worst per-tensor max |dg| / max(max |g|, "
            f"{GRAD_FLOOR / GRAD_RTOL:g} max |g| of the model): "
            + ", ".join(f"{n} {r:.2e}" for r, n in ratios[-4:])
            + f" ({sum(r > GRAD_RTOL for r, _ in ratios)} of {len(ratios)} "
            f"over {GRAD_RTOL})")
        lt, gt, nt, bt = limits
        log(f"[4 card vs cpu] {name} train step, 2x{size[0]}x{size[1]}, "
            f"{label} against {ref}, {expected} launches: loss "
            f"{step_out[label][0]:.7f} / {step_out[ref][0]:.7f}; grad norm "
            f"{step_out[label][4]:.6f} / {step_out[ref][4]:.6f}; the whole "
            f"gradient: max |dg| / max |g| {gmax_rel:.2e} (limit {gt:.2e}), "
            f"|dg| / |g| {gnorm_rel:.2e} (limit {nt:.2e}); BN statistics "
            f"max |d| {bn:.2e} (limit {bt:.2e})")
        for what, v, t in (("loss", dl, lt), ("gradient max", gmax_rel, gt),
                           ("gradient norm", gnorm_rel, nt),
                           ("BN statistics", bn, bt)):
            if not v <= t:
                return f"{what} {v:.3e} over {t:.3e}"
        return None

    fixed = (RTOL_LOSS, GRAD_RTOL, GRAD_RTOL, ATOL_BN)
    if ill_conditioned:
        spread = [max(a, b) for a, b in zip(gap("cpu nudged", "cpu"),
                                            gap("cpu float64", "cpu"))]
        limits = (RTOL_LOSS, SPREAD_FACTOR * spread[1],
                  SPREAD_FACTOR * spread[2],
                  max(ATOL_BN, SPREAD_FACTOR * spread[3]))
        failed = held("card float64", "cpu float64", fixed)
        failed32 = held("card", "cpu", limits)
        failed = failed or failed32
    else:
        limits = fixed
        failed = held("card", "cpu", fixed)
        if failed:
            with replay.replay(), areplay.replay():
                step("cpu nudged", cpu_model, "cpu", nudged)
            held("cpu nudged", "cpu", fixed)
    if failed:
        raise AssertionError(f"{name} card train step: {failed}")
    dl, gmax_rel, gnorm_rel, bn = gap("card", "cpu")
    out = {"loss": [step_out["card"][0], step_out["cpu"][0]],
           "grad_max_rel": gmax_rel, "grad_norm_rel": gnorm_rel,
           "bn_err": bn, "launches": launched["card"]}
    if ill_conditioned:
        out["limits"] = dict(zip(("loss", "grad_max_rel", "grad_norm_rel",
                                  "bn_err"), limits))
        for label, ref in (("cpu nudged", "cpu"), ("cpu float64", "cpu"),
                           ("card", "cpu float64"),
                           ("card float64", "cpu float64")):
            out[f"{label} against {ref}"] = dict(zip(
                ("loss", "grad_max_rel", "grad_norm_rel", "bn_err"),
                gap(label, ref)))
    if topk_rows[1]:
        out["topk_rows_differing"] = topk_rows
    if argmax_elements[1]:
        out["argmax_differing"] = argmax_elements
    return out


def coords_grad_check(torch, dev, case_inputs) -> None:
    """Phase 2, NeuFlow v2's lookups: prepared with ``coords_grad``, on
    its training levels at 368x496, batch 8 (1/16: Q = 5704 on 23x31;
    1/8: Q = 22,816 on 46x62), autograd through the kernel gives the coords
    and the level the gradients of autograd through the plain version on
    the same inputs: the level's within RTOL_BWD_FP32, the coords' within
    RTOL_COORDS_GRAD of the largest, with the forward kernel launched 1 +
    4 times and the backward once."""
    from ptlflow_tpu_torch.ops import correlation as corr

    for s in (16, 8):
        h, w = -(-TRAIN_H // s), -(-TRAIN_W // s)
        pyr, coords = case_inputs(8, h, w, h, w, 128, -0.1, 1.1, 1)
        grad = torch.randn((8, 81, h, w),
                           generator=torch.Generator().manual_seed(s)).to(dev)
        got = {}
        for label in ("kernel", "plain"):
            lvl = pyr[0].detach().requires_grad_()
            c = coords.detach().requires_grad_()
            before = (corr.corr_lookup_kernel.launches,
                      corr.corr_lookup_backward_kernel.launches)
            if label == "kernel":
                out = corr.make_corr_lookup([lvl], 4, coords_grad=True)(c)
            else:
                out = corr.corr_pyramid_lookup_plain([lvl], c, 4)
            got[label] = torch.autograd.grad(out, [c, lvl], grad)
            torch.cuda.synchronize()
            n = (corr.corr_lookup_kernel.launches - before[0],
                 corr.corr_lookup_backward_kernel.launches - before[1])
            if label == "kernel" and n != (5, 1):
                raise AssertionError(f"coords gradient at 1/{s}: launches "
                                     f"{n}, expected (5, 1)")
        errs = []
        for k, (g, wp) in enumerate(zip(got["kernel"], got["plain"])):
            err = (g - wp).abs().max().item()
            gmax = wp.abs().max().item()
            tol = (RTOL_COORDS_GRAD if k == 0 else RTOL_BWD_FP32) * gmax
            errs.append((err, gmax))
            if not err <= tol:
                raise AssertionError(f"coords gradient at 1/{s}: |err| "
                                     f"{err} of {gmax}")
        log(f"[2 coords gradient] neuflow2 1/{s} train level Q={8 * h * w}, "
            f"{h}x{w}, r=4: coords max |err| {errs[0][0]:.3e} of max |grad| "
            f"{errs[0][1]:.3e}, level {errs[1][0]:.3e} of {errs[1][1]:.3e}; "
            f"5 forward and 1 backward launches")


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
    t_main = time.perf_counter()
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
    t_phase = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    def case_inputs(b, h1, w1, h2, w2, c, lo, hi, levels=4, lcv=None):
        """A pyramid and coords; ``lcv`` = r: LCV-RAFT's first ``levels``
        levels, whose pooling stops once a side is no larger than 2r + 1,
        under a learned metric far from the identity."""
        f1, f2 = randn(b, c, h1, w1), randn(b, c, h2, w2)
        if lcv is None:
            pyr = corr.build_corr_pyramid(f1, f2, levels)
        else:
            from ptlflow_tpu_torch.models.lcv.lcv_raft import (
                LearnableCorrBlock)

            blk = LearnableCorrBlock(c, levels, lcv)
            learned_metric(torch, blk, 2)
            with torch.no_grad():
                pyr = blk.to(dev).compute_cost_volume(f1, f2)[:levels]
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
        # FlowFormer's lookup: one level, each pixel's whole cost map
        (f"flowformer Q={hp * wp}, 1 level, r=4",
         (1, hp, wp, hp, wp, 256, -0.1, 1.1, 1), 4, torch.float32),
        (f"flowformer_pp Q={-(-H // 32) * 4 * wp}, 1 level, r=4",
         (1, -(-H // 32) * 4, wp, -(-H // 32) * 4, wp, 256, -0.1, 1.1, 1), 4,
         torch.float32),
    ]
    # LCV-RAFT's pyramid at 128x160 (its card-vs-CPU train step's size):
    # 16x20, 8x10, 8x10, 8x10 at r = 4 and 16x20, 8x10, 4x5, 4x5 at r = 3,
    # the last levels unshrunk and read at coords / 2^l
    cases += [(f"lcv 2x16x20, unshrunk levels, r={radius}",
               (2, 16, 20, 16, 20, 256, -0.3, 1.3, 4, radius), radius, dtype)
              for radius in (4, 3) for dtype in (torch.float32,
                                                 torch.bfloat16)]
    # the recurrent pyramids' one-level, one-channel lookups (phase 12):
    # rapidflow's 1/32 level of 1024x448 (Q = 448 on 14x32) and its 1/8
    # (Q = 7168 on 56x128); dpflow at 1920x1088: the 1/8 level (Q = 32,640
    # on 136x240, a 4.26 GB fp32 volume) and the 1/64 (17x30)
    cases += [(f"{label}, 1 level, r=4", (1, h, w, h, w, c, -0.1, 1.1, 1), 4,
               torch.float32)
              for label, (c, h, w) in (
                  ("rapidflow 1/32 Q=448", (128, 14, 32)),
                  ("rapidflow 1/8 Q=7168", (128, 56, 128)),
                  ("dpflow 1080p 1/8 Q=32640", (256, 136, 240)),
                  ("dpflow 1080p 1/64 Q=510", (256, 17, 30)))]
    # phase 13's: videoflow_mof's and streamflow's 3 pairs at 1024x436 (Q =
    # 21,120 on 4 levels), neuflow2's 1/16 level of 1024x448 (Q = 1792 on
    # 28x64; its 1/8 level is rapidflow's 56x128 above)
    b3, _, _ = VA_KERNEL_Q
    cases += [(f"videoflow_mof/streamflow Q={b3 * hp * wp}, r=4",
               (b3, hp, wp, hp, wp, 256, -0.1, 1.1), 4, dtype)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [("neuflow2 1/16 Q=1792, 1 level, r=4",
               (1, 28, 64, 28, 64, 128, -0.1, 1.1, 1), 4, torch.float32)]
    # phase 17's: separableflow's pyramid at 1024x448 (Q = 7168 on 56x128
    # ... 7x16)
    s8h, s8w = -(-H // 64) * 8, -(-W // 64) * 8
    cases += [(f"separableflow Q={s8h * s8w}, r=4",
               (1, s8h, s8w, s8h, s8w, 256, -0.1, 1.1), 4, torch.float32)]
    far = torch.tensor([1e7, -1e7, 3.5, -2.5e6, 2.5], device=dev)
    main_err = None
    main_inputs = {}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for label, shape, radius, dtype in cases:
        pyr, coords = case_inputs(*shape)
        pyr = [p.to(dtype) for p in pyr]
        if label.startswith("lcv") and (pyr[-1].shape != pyr[-2].shape):
            raise AssertionError(f"{label}: levels "
                                 f"{[tuple(p.shape[1:]) for p in pyr]}")
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
        if label.startswith("flowformer Q="):
            main_inputs["flowformer"] = (pyr, coords, err)
    log(f"[2 kernel vs plain] {len(cases)} cases pass: worst fp32 |err| "
        f"{worst[torch.float32]:.3e} (tolerance {ATOL_FP32}), worst bf16 "
        f"|err| {worst[torch.bfloat16]:.3e} (rtol {RTOL_BF16})")

    # the backward: the same edge cases, raft's training shape, and
    # FlowFormer's at its reference batch of 8
    th, tw = -(-TRAIN_H // 8), -(-TRAIN_W // 8)
    bwd_cases = [c for c in cases
                 if not c[0].startswith(("raft ", "raft_", "flowformer"))]
    bwd_cases += [(f"raft train Q={TRAIN_B * th * tw}, r=4",
                   (TRAIN_B, th, tw, th, tw, 256, -0.1, 1.1), 4, dtype)
                  for dtype in (torch.float32, torch.bfloat16)]
    bwd_cases += [(f"flowformer train Q={8 * th * tw}, 1 level, r=4",
                   (8, th, tw, th, tw, 256, -0.1, 1.1, 1), 4, torch.float32)]
    # dpflow's training levels at 352x480, batch 5: 1/32 (Q = 825) and 1/8
    # (Q = 13,200)
    bwd_cases += [(f"dpflow train Q={5 * h * w}, 1 level, r=4",
                   (5, h, w, h, w, 256, -0.1, 1.1, 1), 4, torch.float32)
                  for h, w in ((RP_TRAIN_H // 32, RP_TRAIN_W // 32),
                               (RP_TRAIN_H // 8, RP_TRAIN_W // 8))]
    # streamflow's training pyramid at 368x496, batch 4: Q = 3 x 4 x 2852 on
    # 46x62 ... 5x7
    bwd_cases += [(f"streamflow train Q={3 * 4 * th * tw}, r=4",
                   (3 * 4, th, tw, th, tw, 256, -0.1, 1.1), 4,
                   torch.float32)]
    # separableflow's training pyramid at 368x496 (padded to 384x512),
    # batch 10: Q = 30,720 on 48x64 ... 6x8
    s8h, s8w = -(-TRAIN_H // 64) * 8, -(-TRAIN_W // 64) * 8
    bwd_cases += [(f"separableflow train Q={10 * s8h * s8w}, r=4",
                   (10, s8h, s8w, s8h, s8w, 256, -0.1, 1.1), 4,
                   torch.float32)]
    worst_bwd = {torch.float32: 0.0, torch.bfloat16: 0.0}
    train_inputs, bwd_err, bwd_gmax = None, None, None
    for label, shape, radius, dtype in bwd_cases:
        pyr, coords = case_inputs(*shape)
        if label.startswith("coords at"):
            coords[0, 0, 0, :5] = far
            coords[0, 1, 1, :5] = far.flip(0)
        shapes = [tuple(p.shape[1:]) for p in pyr]
        b, _, h1, w1 = coords.shape
        grad = randn(b, len(pyr) * (2 * radius + 1) ** 2, h1, w1).to(dtype)
        got = corr.corr_lookup_backward_kernel(grad, coords, shapes, radius)
        again = corr.corr_lookup_backward_kernel(grad, coords, shapes,
                                                 radius)
        torch.cuda.synchronize()
        want = corr.corr_pyramid_lookup_backward_plain(grad, coords, shapes,
                                                       radius)
        for gk, ga, wp in zip(got, again, want):
            if gk.dtype != dtype or gk.shape != wp.shape:
                raise AssertionError(f"{label}: backward gives {gk.dtype} "
                                     f"{tuple(gk.shape)}")
            if not torch.equal(gk, ga):
                raise AssertionError(f"{label}: two backward launches differ")
        live = [(gk.float(), wp.float()) for gk, wp in zip(got, want)
                if wp.numel()]
        err = max((gk - wp).abs().max().item() for gk, wp in live)
        gmax = max(wp.abs().max().item() for _, wp in live)
        rel = err / max(gmax, 1e-30)
        worst_bwd[dtype] = max(worst_bwd[dtype], rel)
        log(f"[2 backward vs plain] {label}, {str(dtype)[6:]}: levels "
            f"{shapes}, max |err| {err:.3e} of max |grad| {gmax:.3e}, "
            f"two launches bitwise equal")
        if dtype == torch.float32:
            if not err <= RTOL_BWD_FP32 * gmax:
                raise AssertionError(f"{label}: backward |err| {err}")
        else:
            for gk, wp in live:
                torch.testing.assert_close(gk, wp, rtol=RTOL_BF16,
                                           atol=ATOL_BF16)
        if label.startswith("raft train") and dtype == torch.float32:
            train_inputs = (pyr, coords, grad)
            bwd_err, bwd_gmax = err, gmax
        del got, again, want, live
    log(f"[2 backward vs plain] {len(bwd_cases)} cases pass: worst fp32 "
        f"|err| / max |grad| {worst_bwd[torch.float32]:.3e} (tolerance "
        f"{RTOL_BWD_FP32}), worst bf16 {worst_bwd[torch.bfloat16]:.3e} (rtol "
        f"{RTOL_BF16}); bitwise repeatable")
    coords_grad_check(torch, dev, case_inputs)

    log(f"[2] {time.perf_counter() - t_phase:.1f} s")
    # ---------------------------------------------------------------- 3
    t_phase = time.perf_counter()
    pairs = [smooth_pair(seed, H, W, shift=(2 + seed, 1 + seed))
             for seed in range(3)]
    launches = {}
    for name, iters in SERVE:
        model = served_model(torch, name, {"iters": iters},
                             IOAdapter(device=dev).prepare_inputs(
                                 list(pairs[0]))["images"])
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
            if (flows.grad_fn is not None
                    or out["flow_small"].grad_fn is not None):
                raise AssertionError(f"{name}: the eval forward built an "
                                     f"autograd graph")
            n = corr.corr_lookup_kernel.launches - before
            if n != iters:
                raise AssertionError(f"{name}: {n} lookup launches in one "
                                     f"forward, expected {iters}")
            mean = flows.mean(dim=(0, 1, 3, 4)).tolist()
            log(f"[3 serve] {name} request {k}: flows {tuple(flows.shape)} "
                f"finite, no grad_fn, mean flow ({mean[0]:.3f}, "
                f"{mean[1]:.3f}) px, {n} lookup launches")
        launches[name] = corr.corr_lookup_kernel.launches
        if launches[name] != iters * len(pairs):
            raise AssertionError(f"{name}: {launches[name]} launches")
        del model

    # warm start: frames 0-1 of a sequence, then frames 1-2 from there
    frames = smooth_frames(21, H, W, 3, shift=(3, 2))
    for name in ("raft", "gma"):
        model = ptlflow_tpu_torch.get_model(name, args={"iters": ITERS})
        damp_flow_head(model)  # steps of trained size, as in phase 4
        adapter = IOAdapter(model)
        x1 = adapter.prepare_inputs(frames[1:])
        corr.corr_lookup_kernel.launches = 0
        first = model(adapter.prepare_inputs(frames[:2]))
        warm = model(dict(x1, prev_preds={"flow_small": first["flow_small"]}))
        torch.cuda.synchronize()
        key = f"{name} warm start"
        launches[key] = corr.corr_lookup_kernel.launches
        cold = model(x1)
        if launches[key] != 2 * ITERS:
            raise AssertionError(f"{key}: {launches[key]} lookup launches "
                                 f"for two requests")
        for label, out in (("first", first), ("warm", warm)):
            if not torch.isfinite(out["flows"]).all():
                raise AssertionError(f"{key}: non-finite {label} flows")
            if out["flows"].grad_fn is not None:
                raise AssertionError(f"{key}: an autograd graph")
        mean = warm["flows"].mean(dim=(0, 1, 3, 4)).tolist()
        moved = (warm["flows"] - cold["flows"]).abs().mean().item()
        log(f"[3 warm start] {name}, two consecutive pairs at {W}x{H}: "
            f"{launches[key]} lookup launches, warm-started flows finite, "
            f"mean ({mean[0]:.3f}, {mean[1]:.3f}) px (true motion 3, 2), "
            f"mean |warm - cold| {moved:.4f} px")
        del model, first, warm, cold

    log(f"[3] {time.perf_counter() - t_phase:.1f} s")
    # ---------------------------------------------------------------- 4
    t_phase = time.perf_counter()
    for name in ("raft", "raft_small", "sea_raft_m", "gma"):
        iters = dict(SERVE)[name]
        cpu_model = ptlflow_tpu_torch.get_model(name, args={"iters": iters},
                                                device="cpu")
        pair = smooth_pair(7, 256, 320, shift=(3, 2))
        x = IOAdapter(cpu_model).prepare_inputs(list(pair))
        parity_weights(torch, name, cpu_model, x["images"])
        gpu_model = ptlflow_tpu_torch.get_model(name, args={"iters": iters})
        gpu_model.load_state_dict(cpu_model.state_dict())
        want = cpu_model(x)["flows"]
        got = gpu_model({"images": x["images"].to(dev)})["flows"].cpu()
        diff = (got - want).abs().max().item()
        log(f"[4 card vs cpu] {name} 256x320, {iters} iters: max |dflow| "
            f"{diff:.3e} px (flow up to {want.abs().max().item():.2f} px, "
            f"tolerance {ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
    del cpu_model, gpu_model

    # one train step's gradients, card against CPU
    from ptlflow_tpu_torch.parallel import train as ttrain

    step_check = {name: train_step_card_vs_cpu(torch, name, dev)
                  for name in ("raft", "sea_raft_s")}

    log(f"[4] {time.perf_counter() - t_phase:.1f} s")
    # ---------------------------------------------------------------- 5
    t_phase = time.perf_counter()
    pyr, coords = main_inputs[torch.float32]
    radius = 4
    sweeps = flushes(torch, dev)
    flush = sweeps["dirty"]
    reps = 50
    lookup = corr.make_corr_lookup(pyr, radius)
    bound = lookup_bound(torch, pyr, coords, radius)
    bound_ms, bound_by = bound["bound_ms"], bound["bound_by"]
    bf16_pyr, bf16_coords = main_inputs[torch.bfloat16]
    bf16_bound = lookup_bound(torch, bf16_pyr, bf16_coords, radius)
    kernel_ms = timed_ms(torch, lambda: lookup(coords), reps, flush)
    clean_ms = timed_ms(torch, lambda: lookup(coords), reps, sweeps["clean"])
    profiler_ms = profiled_ms(torch, lambda: lookup(coords), reps, flush,
                              bound_ms=bound_ms, label="raft shape, dirty")
    clean_profiler_ms = profiled_ms(torch, lambda: lookup(coords), reps,
                                    sweeps["clean"], bound_ms=bound_ms,
                                    label="raft shape, clean")
    plain_ms = timed_ms(torch, lambda: corr.corr_pyramid_lookup_plain(
        pyr, coords, radius), reps, flush)
    bf16_lookup = corr.make_corr_lookup(bf16_pyr, radius)
    bf16_ms = timed_ms(torch, lambda: bf16_lookup(bf16_coords), reps, flush)
    bf16_profiler_ms = profiled_ms(torch, lambda: bf16_lookup(bf16_coords),
                                   reps, flush,
                                   bound_ms=bf16_bound["bound_ms"],
                                   label="raft shape, bf16")

    lib_out = grid_sample_lookup(torch, pyr, coords, radius)
    lib_err = (lib_out - lookup(coords)).abs().max().item()
    library_ms = timed_ms(
        torch, lambda: grid_sample_lookup(torch, pyr, coords, radius), reps,
        flush)
    warm_ms = timed_ms(torch, lambda: [lookup(coords) for _ in range(20)],
                       5) / 20

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
            other = corr._KernelLookup(p_, radius, other_lib)
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
    fwd, fwd_profile = {}, {}
    mixed = {"mixed_precision": True}
    for name, extra in [("raft", {}), ("raft", mixed), ("raft_small", {}),
                        ("sea_raft_m", {}), ("sea_raft_m", mixed),
                        ("sea_raft_l", {}), ("gma", {})]:
        iters = dict(SERVE)[name]
        model = served_model(torch, name, {"iters": iters, **extra}, images)
        label = f"{name} {'mixed' if extra else 'fp32'}"
        for _ in range(3):
            model({"images": images})
        runs = sorted(timed_ms(torch, lambda: model({"images": images}), 10)
                      for _ in range(3))
        ms = runs[1]
        fwd[label] = ms
        log(f"[5 forward] [{tag}] {label}, {W}x{H}, {iters} iters: "
            f"{ms:.3f} ms/forward, {1e3 / ms:.2f} fps (median of 3 runs of "
            f"10 forwards: {', '.join(f'{r:.3f}' for r in runs)} ms)")
        fwd_profile[label] = profile_forward(torch, model, images, label, tag,
                                             ms)
        del model

    log(f"[5] {time.perf_counter() - t_phase:.1f} s")
    # ---------------------------------------------------------------- 6
    t_phase = time.perf_counter()
    model = ptlflow_tpu_torch.get_model(
        "raft", args={"iters": ITERS, "corr_levels": 4, "corr_radius": 4,
                      "gamma": 0.8, "max_flow": 400.0})
    tx = ttrain.make_optimizer(lr=4e-4, wdecay=1e-4, total_steps=120000,
                               pct_start=0.05, grad_clip=1.0)
    step = ttrain.build_train_step(model, tx)
    state = ttrain.create_train_state(model, tx)
    params_before = {k: v.detach().clone() for k, v in state.params.items()}
    stats_before = bn_stats(model)
    batches = [train_batch(torch, 100 + k, TRAIN_B, TRAIN_H, TRAIN_W, dev)
               for k in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train = {"step_ms": [], "loss": [], "grad_norm": [], "lookup": [],
             "lookup_backward": []}
    for k, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        corr.corr_lookup_kernel.launches = 0
        corr.corr_lookup_backward_kernel.launches = 0
        start.record()
        state, metrics = step(state, batch)
        end.record()
        end.synchronize()
        train["lookup"].append(corr.corr_lookup_kernel.launches)
        train["lookup_backward"].append(
            corr.corr_lookup_backward_kernel.launches)
        train["step_ms"].append(start.elapsed_time(end))
        train["loss"].append(metrics["loss"].item())
        train["grad_norm"].append(metrics["grad_norm"].item())
        log(f"[6 train] [{tag}] raft step {k + 1}: loss "
            f"{train['loss'][-1]:.5f}, grad norm "
            f"{train['grad_norm'][-1]:.5f}, "
            f"{train['step_ms'][-1]:.3f} ms by CUDA events, "
            f"{train['lookup'][-1]} lookup and {train['lookup_backward'][-1]} "
            f"backward launches")
        if not (math.isfinite(train["loss"][-1])
                and math.isfinite(train["grad_norm"][-1])):
            raise AssertionError(f"train step {k + 1}: non-finite metrics")
        if (train["lookup"][-1], train["lookup_backward"][-1]) != (ITERS,
                                                                   ITERS):
            raise AssertionError(f"train step {k + 1}: expected {ITERS} "
                                 f"launches of each kernel")
    if state.step != TRAIN_STEPS or state.opt_state.count != TRAIN_STEPS:
        raise AssertionError("train state did not advance once per step")
    moved_p = sum(not torch.equal(v, params_before[k])
                  for k, v in state.params.items())
    stats_after = bn_stats(model)
    moved_s = sum(not torch.equal(v, stats_before[k])
                  for k, v in stats_after.items())
    later = sorted(train["step_ms"][1:])
    step_ms = (later[1] + later[2]) / 2  # median of steps 2-5
    train.update(median_step_ms=step_ms,
                 samples_per_s=TRAIN_B / step_ms * 1e3,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 params_moved=[moved_p, len(state.params)],
                 bn_stats_moved=[moved_s, len(stats_after)])
    log(f"[6 train] [{tag}] raft {TRAIN_W}x{TRAIN_H}, batch {TRAIN_B}, "
        f"{ITERS} iters, fp32 (TF32 off): {step_ms:.3f} ms per step (median "
        f"of steps 2-{TRAIN_STEPS}), {train['samples_per_s']:.2f} samples/s, "
        f"peak {train['peak_gib']:.2f} GiB allocated; {moved_p} of "
        f"{len(state.params)} trainable tensors and {moved_s} of "
        f"{len(stats_after)} BatchNorm statistics changed")
    # the norm3 of each stride-2 block is kept for the checkpoints and never
    # run: 2 BatchNorms of cnet, 4 statistics
    if moved_p < 0.9 * len(state.params) or moved_s < len(stats_after) - 4:
        raise AssertionError("training left the weights or the BatchNorm "
                             "statistics in place")
    profile_batch = batches[-1]
    del params_before, batches

    log(f"[6] {time.perf_counter() - t_phase:.1f} s")
    # ---------------------------------------------------------------- 7
    t_phase = time.perf_counter()
    pyr_t, coords_t, grad_t = train_inputs
    shapes_t = [tuple(p.shape[1:]) for p in pyr_t]

    def bwd():
        return corr.corr_lookup_backward_kernel(grad_t, coords_t, shapes_t, 4)

    bwd_reps = 20
    bb = backward_bound(torch, grad_t, coords_t, shapes_t, 4)
    bwd_ms = timed_ms(torch, bwd, bwd_reps, flush)
    bwd_profiler_ms = profiled_ms(torch, bwd, bwd_reps, flush,
                                  name="corr_lookup_backward",
                                  bound_ms=bb["bound_ms"],
                                  label="backward, raft train shape")
    # the profiler's key_averages() self time, which once read 0.0866 ms
    # here under the 0.1393 ms bound, against the kernel's own records
    bwd_readings = profiler_readings(torch, bwd, bwd_reps, flush,
                                     "corr_lookup_backward")
    log(f"[7 profiler] [{tag}] backward at raft's train shape, "
        f"{bwd_readings['launches']} launches counted: "
        f"{bwd_readings['records']} kernel records, mean "
        f"{fmt_ms(bwd_readings['records_ms'])} (min "
        f"{fmt_ms(bwd_readings['records_min_ms'])}, max "
        f"{fmt_ms(bwd_readings['records_max_ms'])}); key_averages() self "
        f"time {fmt_ms(bwd_readings['self_ms'])} over "
        f"{bwd_readings['self_count']} events; bound {bb['bound_ms']:.5f} "
        f"ms")
    bwd_plain_ms = timed_ms(
        torch, lambda: corr.corr_pyramid_lookup_backward_plain(
            grad_t, coords_t, shapes_t, 4), 3, flush)
    levels = [p.detach().requires_grad_() for p in pyr_t]
    gs_out = grid_sample_lookup(torch, levels, coords_t, 4)
    gs_err = max((a - b).abs().max().item() for a, b in zip(
        torch.autograd.grad(gs_out, levels, grad_t, retain_graph=True),
        bwd()))
    bwd_library_ms = timed_ms(torch, lambda: torch.autograd.grad(
        gs_out, levels, grad_t, retain_graph=True), 5, flush)
    del gs_out, levels
    # autograd's sums of the 12 dense per-iteration level gradients: one
    # sum of every level, by events, times 11
    parts = [(torch.empty((coords_t.shape[0] * th * tw, h, w_), device=dev),
              torch.empty((coords_t.shape[0] * th * tw, h, w_), device=dev))
             for h, w_ in shapes_t]
    sum_ms = timed_ms(torch, lambda: [a + b for a, b in parts], 10, flush)
    del parts
    log(f"[7 backward] [{tag}] Q={coords_t.shape[0] * th * tw}, levels "
        f"{shapes_t}, r=4, fp32, L2 flushed per launch: kernel "
        f"{bwd_ms:.4f} ms by CUDA events, {fmt_ms(bwd_profiler_ms)} device "
        f"time by the profiler; plain {bwd_plain_ms:.4f} ms; backward of the "
        f"grid_sample lookup {bwd_library_ms:.4f} ms (max |diff| to the "
        f"kernel {gs_err:.2e}); bound {bb['bytes']} bytes "
        f"({bb['dense_bytes']} of dense level gradients) -> "
        f"{bb['bytes_ms']:.5f} ms at 3.35 TB/s, {bb['ops']} operations -> "
        f"{bb['ops_ms']:.5f} ms, so {bb['bound_ms']:.5f} ms by "
        f"{bb['bound_by']}, kernel at {bb['bound_ms'] / bwd_ms:.1%} of it; "
        f"one sum of every level's dense gradient {sum_ms:.4f} ms, x11 per "
        f"step {11 * sum_ms:.3f} ms")
    train_profile = profile_train_step(
        torch, step, state, profile_batch,
        [(coords_t.shape[0] * th * tw, h, w_) for h, w_ in shapes_t], tag,
        step_ms)
    # the same step with cuDNN's algorithms chosen by timing, not by its
    # heuristics: a measurement for later work, the port does not set it
    torch.backends.cudnn.benchmark = True
    for _ in range(2):  # the first steps time the algorithms
        state, _ = step(state, profile_batch)
    bench_ms = sorted(timed_ms(torch, lambda: step(state, profile_batch), 1)
                      for _ in range(3))[1]
    torch.backends.cudnn.benchmark = False
    train["cudnn_benchmark_step_ms"] = bench_ms
    log(f"[7 train] [{tag}] the same step with torch.backends.cudnn.benchmark "
        f"on: {bench_ms:.3f} ms (median of 3, after 2 steps that time the "
        f"algorithms), against {step_ms:.3f} ms")
    del model, state, step, pyr_t, coords_t, grad_t, train_inputs

    log(f"[7] {time.perf_counter() - t_phase:.1f} s")
    # ---------------------------------------------------------------- 8
    t_phase = time.perf_counter()
    work = os.path.join(HERE, "_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        harness = harness_phase(torch, dev, tag, work, fwd["raft fp32"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches["raft validate, 10 pairs"] = harness["validate_launches"]
    launches["raft infer, 3 frames"] = harness["infer_launches"]

    log(f"[8] {time.perf_counter() - t_phase:.1f} s")
    # ---------------------------------------------------------------- 9
    t_phase = time.perf_counter()
    work = os.path.join(HERE, "_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        train_cli = train_cli_phase(torch, dev, tag, work,
                                    train["median_step_ms"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cli_path = (f"raft train CLI: {CLI_STEPS} steps + "
                f"{CLI_STEPS // CLI_VAL_EVERY} validations, resumed to "
                f"{CLI_RESUMED}, {CLI_CUDA_STEPS} with train_transform_cuda")
    cli_launches = [sum(run[i] for run in train_cli["launches"].values())
                    for i in (0, 1)]
    launches[cli_path] = cli_launches[0]

    log(f"[9] {time.perf_counter() - t_phase:.1f} s")
    # ---------------------------------------------------------------- 10
    t_phase = time.perf_counter()
    ff = flowformer_phase(torch, dev, tag, main_inputs["flowformer"])
    launches.update(ff["launches"])
    ff_bwd_launches = {
        "flowformer train step at 128x160, 2 decoder steps":
            ff["train_step_card_vs_cpu"]["launches"][1],
        f"flowformer train, {FF_TRAIN_STEPS} steps at {TRAIN_W}x{TRAIN_H}, "
        f"batch {ff['train']['batch']}": sum(ff["train"]["lookup_backward"])}
    launches[f"flowformer train, {FF_TRAIN_STEPS} steps at {TRAIN_W}x"
             f"{TRAIN_H}, batch {ff['train']['batch']}"] = sum(
                 ff["train"]["lookup"])

    log(f"[10] {time.perf_counter() - t_phase:.1f} s")
    # ---------------------------------------------------------------- 11
    t11 = time.perf_counter()
    sk = sk_family_phase(torch, dev, tag)
    log(f"[11] {time.perf_counter() - t11:.1f} s")
    launches.update(sk["launches"])
    sk_train_path = (f"memflow train, {SK_TRAIN_STEPS} steps at {TRAIN_W}x"
                     f"{TRAIN_H}, batch {sk['train']['batch']}")
    launches[sk_train_path] = sum(sk["train"]["lookup"])

    # ---------------------------------------------------------------- 12
    t12 = time.perf_counter()
    rp = recurrent_pyramid_phase(torch, dev, tag)
    log(f"[12] {time.perf_counter() - t12:.1f} s")
    launches.update(rp["launches"])
    rp_train_paths = {
        name: (f"{name} train, {RP_TRAIN_STEPS} steps at {RP_TRAIN_W}x"
               f"{RP_TRAIN_H}, batch {rec['batch']}")
        for name, rec in rp["train"].items()}
    for name, path in rp_train_paths.items():
        launches[path] = sum(rp["train"][name]["lookup"])

    # ---------------------------------------------------------------- 13
    t13 = time.perf_counter()
    va = video_and_attention_phase(torch, dev, tag)
    log(f"[13] {time.perf_counter() - t13:.1f} s")
    launches.update(va["launches"])
    va_train_paths = {
        name: (f"{name} train, {VA_TRAIN_STEPS} steps at {TRAIN_W}x"
               f"{TRAIN_H}, batch {rec['batch']}")
        for name, rec in va["train"].items()}
    for name, path in va_train_paths.items():
        launches[path] = sum(va["train"][name]["lookup"])

    # ---------------------------------------------------------------- 14
    t14 = time.perf_counter()
    vb = volume_and_backbone_phase(torch, dev, tag)
    log(f"[14] {time.perf_counter() - t14:.1f} s")
    launches.update(vb["launches"])
    vb_train_paths = {
        name: (f"{name} train, {VB_TRAIN_STEPS} steps at {TRAIN_W}x"
               f"{TRAIN_H}, batch {rec['batch']}")
        for name, rec in vb["train"].items()}
    for name, path in vb_train_paths.items():
        launches[path] = sum(vb["train"][name]["lookup"])

    # ---------------------------------------------------------------- 15
    t15 = time.perf_counter()
    s13 = slice13_phase(torch, dev, tag)
    log(f"[15] {time.perf_counter() - t15:.1f} s")
    launches.update(s13["launches"])
    s13_train_paths = {
        name: (f"{name} train, {S13_TRAIN_STEPS} steps at {TRAIN_W}x"
               f"{TRAIN_H}, batch {rec['batch']}")
        for name, rec in s13["train"].items()}
    for name, path in s13_train_paths.items():
        launches[path] = sum(s13["train"][name]["lookup"])

    # ---------------------------------------------------------------- 16
    t16 = time.perf_counter()
    s14 = slice14_phase(torch, dev, tag)
    log(f"[16] {time.perf_counter() - t16:.1f} s")
    launches.update(s14["launches"])
    s14_train_paths = {
        name: (f"{name} train, {S14_TRAIN_STEPS} steps at {TRAIN_W}x"
               f"{TRAIN_H}, batch {rec['batch']}")
        for name, rec in s14["train"].items()}
    for name, path in s14_train_paths.items():
        launches[path] = sum(s14["train"][name]["lookup"])

    # ---------------------------------------------------------------- 17
    t17 = time.perf_counter()
    s15 = slice15_phase(torch, dev, tag)
    log(f"[17] {time.perf_counter() - t17:.1f} s")
    launches.update(s15["launches"])
    s15_train_paths = {
        name: (f"{name} train, {S15_TRAIN_STEPS} steps at {rec['size'][1]}x"
               f"{rec['size'][0]}, batch {rec['batch']}")
        for name, rec in s15["train"].items()}
    for name, path in s15_train_paths.items():
        launches[path] = sum(s15["train"][name]["lookup"])

    # ---------------------------------------------------------------- 18
    t18 = time.perf_counter()
    s16 = slice16_phase(torch, dev, tag)
    log(f"[18] {time.perf_counter() - t18:.1f} s")
    launches.update(s16["launches"])
    s16_train_paths = {
        name: (f"{name} train, {S16_TRAIN_STEPS} steps at {rec['size'][1]}x"
               f"{rec['size'][0]}, batch {rec['batch']}")
        for name, rec in s16["train"].items()}
    for name, path in s16_train_paths.items():
        launches[path] = sum(s16["train"][name]["lookup"])

    # ---------------------------------------------------------------- 19
    t19 = time.perf_counter()
    s17 = slice17_phase(torch, dev, tag)
    log(f"[19] {time.perf_counter() - t19:.1f} s")
    launches.update(s17["launches"])
    s17_train_paths = {
        name: (f"{name} train, {S17_TRAIN_STEPS} steps at {rec['size'][1]}x"
               f"{rec['size'][0]}, batch {rec['batch']}")
        for name, rec in s17["train"].items()}
    for name, path in s17_train_paths.items():
        launches[path] = sum(s17["train"][name]["lookup"])

    # ---------------------------------------------------------------- 20
    t20 = time.perf_counter()
    s18 = slice18_phase(torch, dev, tag)
    log(f"[20] {time.perf_counter() - t20:.1f} s")
    launches.update(s18["launches"])
    s18_train_paths = {
        name: (f"{name} train, {S18_TRAIN_STEPS} steps at {rec['size'][1]}x"
               f"{rec['size'][0]}, batch {rec['batch']}")
        for name, rec in s18["train"].items()}
    for name, path in s18_train_paths.items():
        launches[path] = sum(s18["train"][name]["lookup"])

    # ---------------------------------------------------------------- 21
    t21 = time.perf_counter()
    s19 = slice19_phase(torch, dev, tag)
    log(f"[21] {time.perf_counter() - t21:.1f} s")
    launches.update(s19["launches"])
    s19_train_paths = {
        name: (f"{name} train, {S19_TRAIN_STEPS} steps at {rec['size'][1]}x"
               f"{rec['size'][0]}, batch {rec['batch']}")
        for name, rec in s19["train"].items()}
    for name, path in s19_train_paths.items():
        launches[path] = sum(s19["train"][name]["lookup"])
    s19_step_path = (f"unimatch_sc2_ref6 train step at {S19_STEP_SIZE[1]}x"
                     f"{S19_STEP_SIZE[0]}")
    launches[s19_step_path] = s19["train_step_card_vs_cpu"][
        "unimatch_sc2_ref6"]["launches"][0]

    log(f"[1-21] {time.perf_counter() - t_main:.1f} s")
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
        "train_launches_per_step": train["lookup"],
        "flowformer_shape": ff["kernels"]["corr_lookup"],
        "recurrent_pyramid_shapes": rp["kernels"]["corr_lookup"],
        "video_and_attention_shapes": va["kernels"]["corr_lookup"],
        "volume_and_backbone_shapes": vb["kernels"]["corr_lookup"],
        "slice13_shapes": s13["kernels"]["corr_lookup"],
        "slice14_shapes": s14["kernels"]["corr_lookup"],
        "slice15_shapes": s15["kernels"]["corr_lookup"],
        "slice19_shapes": s19["kernels"]["corr_lookup"],
        "invalid_profiler_readings": [
            r for r in INVALID_READINGS if r["kernel"] == "corr_lookup"],
    }, {
        "name": "corr_lookup_backward",
        "route": "cuda",
        "source": "ptlflow_tpu_torch/csrc/corr_lookup_backward.cu",
        "replaces": "ptlflow_tpu/ops/correlation.py:456",
        "replaces_note": "no Pallas counterpart: the JAX package trains "
                         "through jax.grad of its XLA lookup",
        "launches": sum(train["lookup_backward"]),
        "launches_per_step": train["lookup_backward"],
        "launches_by_path": dict(
            {f"{name} train step at 128x160, 2 iters": check["launches"][1]
             for name, check in step_check.items()},
            **{cli_path: cli_launches[1]}, **ff_bwd_launches,
            **{f"{name} train step at 128x160, 2 steps": check["launches"][1]
               for name, check in sk["train_step_card_vs_cpu"].items()},
            **{sk_train_path: sum(sk["train"]["lookup_backward"])},
            **{f"{name} train step at 128x160, 2 steps a level":
               check["launches"][1]
               for name, check in rp["train_step_card_vs_cpu"].items()},
            **{path: sum(rp["train"][name]["lookup_backward"])
               for name, path in rp_train_paths.items()},
            **{f"{name} train step at 128x160, 2 steps": check["launches"][1]
               for name, check in va["train_step_card_vs_cpu"].items()},
            **{path: sum(va["train"][name]["lookup_backward"])
               for name, path in va_train_paths.items()},
            **{f"{name} train step at 128x160, 2 iterations":
               check["launches"][1]
               for name, check in vb["train_step_card_vs_cpu"].items()},
            **{path: sum(vb["train"][name]["lookup_backward"])
               for name, path in vb_train_paths.items()},
            **{f"{name} train step at 128x160, 2 iterations":
               check["launches"][1]
               for name, check in s13["train_step_card_vs_cpu"].items()},
            **{path: sum(s13["train"][name]["lookup_backward"])
               for name, path in s13_train_paths.items()},
            **{f"{name} train step at 128x160, 2 iterations":
               check["launches"][1]
               for name, check in s14["train_step_card_vs_cpu"].items()},
            **{path: sum(s14["train"][name]["lookup_backward"])
               for name, path in s14_train_paths.items()},
            **{f"{name} train step at {size[1]}x{size[0]}":
               s15["train_step_card_vs_cpu"][name]["launches"][1]
               for name, _, _, _, size in S15_STEP_CHECK},
            **{path: sum(s15["train"][name]["lookup_backward"])
               for name, path in s15_train_paths.items()},
            **{f"{name} train step at {size[1]}x{size[0]}":
               s16["train_step_card_vs_cpu"][name]["launches"][1]
               for name, _, size in S16_STEP_CHECK},
            **{path: sum(s16["train"][name]["lookup_backward"])
               for name, path in s16_train_paths.items()},
            **{f"{name} train step at {size[1]}x{size[0]}":
               s17["train_step_card_vs_cpu"][name]["launches"][1]
               for name, _, size, _ in S17_STEP_CHECK},
            **{path: sum(s17["train"][name]["lookup_backward"])
               for name, path in s17_train_paths.items()},
            **{f"{name} train step at {size[1]}x{size[0]}":
               s18["train_step_card_vs_cpu"][name]["launches"][1]
               for name, _, size, _ in S18_STEP_CHECK},
            **{path: sum(s18["train"][name]["lookup_backward"])
               for name, path in s18_train_paths.items()},
            **{s19_step_path: s19["train_step_card_vs_cpu"][
                "unimatch_sc2_ref6"]["launches"][1]},
            **{path: sum(s19["train"][name]["lookup_backward"])
               for name, path in s19_train_paths.items()}),
        "max_abs_err": bwd_err,
        "max_abs_grad": bwd_gmax,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bb["bound_ms"],
        "bound_by": bb["bound_by"],
        "library_ms": bwd_library_ms,
        "profiler_ms": bwd_profiler_ms,
        "bound_bytes": bb["bytes"],
        "level_sums_ms": 11 * sum_ms,
        "flowformer_shape": ff["kernels"]["corr_lookup_backward"],
        "recurrent_pyramid_shapes": rp["kernels"]["corr_lookup_backward"],
        "video_and_attention_shapes":
            va["kernels"]["corr_lookup_backward"],
        "volume_and_backbone_shapes":
            vb["kernels"]["corr_lookup_backward"],
        "slice13_shapes": s13["kernels"]["corr_lookup_backward"],
        "slice14_shapes": s14["kernels"]["corr_lookup_backward"],
        "slice15_shapes": s15["kernels"]["corr_lookup_backward"],
        "slice19_shapes": s19["kernels"]["corr_lookup_backward"],
        "profiler_readings_raft_train_shape": bwd_readings,
        "invalid_profiler_readings": [
            r for r in INVALID_READINGS
            if r["kernel"] == "corr_lookup_backward"],
    }]
    if against:
        kernels[0]["against"] = against
    log(json.dumps({"forward_ms": fwd, "card": tag}))
    log(json.dumps({"forward_profile": fwd_profile, "card": tag}))
    log(json.dumps({"train_step_card_vs_cpu": step_check, "card": tag}))
    log(json.dumps({"train": train, "train_profile": train_profile,
                    "card": tag}))
    log(json.dumps({"harness": harness}))
    log(json.dumps({"train_cli": train_cli}))
    log(json.dumps({"flowformer": {k: v for k, v in ff.items()
                                   if k != "kernels"}, "card": tag}))
    log(json.dumps({"sk_family": sk, "card": tag}))
    log(json.dumps({"recurrent_pyramid": {k: v for k, v in rp.items()
                                          if k != "kernels"},
                    "card": tag}))
    log(json.dumps({"video_and_attention": {k: v for k, v in va.items()
                                            if k != "kernels"},
                    "card": tag}))
    log(json.dumps({"volume_and_backbone": {k: v for k, v in vb.items()
                                            if k != "kernels"},
                    "card": tag}))
    log(json.dumps({"slice13": {k: v for k, v in s13.items()
                                if k != "kernels"}, "card": tag}))
    log(json.dumps({"slice14": {k: v for k, v in s14.items()
                                if k != "kernels"}, "card": tag}))
    log(json.dumps({"slice15": {k: v for k, v in s15.items()
                                if k != "kernels"}, "card": tag}))
    log(json.dumps({"slice16": s16, "card": tag}))
    log(json.dumps({"slice17": s17, "card": tag}))
    log(json.dumps({"slice18": s18, "card": tag}))
    log(json.dumps({"slice19": {k: v for k, v in s19.items()
                                if k != "kernels"}, "card": tag}))
    log(tag)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def harness_data(root: str):
    """Phase 8's dummy datasets, written by the port's own writers: a
    Sintel tree at H x W (2 sequences x 3 frames, clean and final, each
    sequence a smooth texture moved by its own whole-pixel shift, that
    shift as GT) and a KITTI 2015 tree at KITTI_H x KITTI_W (2 pairs, 16-bit
    flow PNGs, a fifth of the pixels invalid).  Returns the trees' roots
    and every file's expected content: ``{path: (kind, array)}``."""
    from ptlflow_tpu_torch.data import dummy_datasets

    sintel = {}
    for s in range(2):
        shift = (2 + s, 1 + s)
        flow = np.broadcast_to(np.array(shift, np.float32),
                               (H, W, 2)).copy()
        sintel[s] = (smooth_frames(30 + s, H, W, 3, shift), [flow, flow])
    kitti = {}
    rng = np.random.RandomState(40)
    for i in range(2):
        shift = (3 - 2 * i, 1 + i)
        flow = np.broadcast_to(np.array(shift, np.float32),
                               (KITTI_H, KITTI_W, 2)).copy()
        flow[rng.rand(KITTI_H, KITTI_W) < 0.2] = np.nan
        kitti[i] = (list(smooth_pair(40 + i, KITTI_H, KITTI_W, shift)), flow)
    s_root = dummy_datasets.write_sintel(root, n_seqs=2, n_frames=3,
                                         size=(H, W), frames=sintel.get)
    k_root = dummy_datasets.write_kitti(root, year="2015", n=2,
                                        size=(KITTI_H, KITTI_W),
                                        frames=kitti.get)
    expect = {}
    for s, (frames, flows) in sintel.items():
        for split in ("training", "test"):
            for pass_name in ("clean", "final"):
                for f, img in enumerate(frames, 1):
                    expect[os.path.join(s_root, split, pass_name, f"seq_{s}",
                                        f"frame_{f:04d}.png")] = ("img", img)
        for f, flow in enumerate(flows, 1):
            expect[os.path.join(s_root, "training", "flow", f"seq_{s}",
                                f"frame_{f:04d}.flo")] = ("flo", flow)
            expect[os.path.join(s_root, "training", "occlusions", f"seq_{s}",
                                f"frame_{f:04d}.png")] = (
                "img", np.zeros((H, W), np.uint8))
    for i, (frames, flow) in kitti.items():
        for split in ("training", "testing"):
            for t, img in zip((10, 11), frames):
                expect[os.path.join(k_root, split, "image_2",
                                    f"{i:06d}_{t}.png")] = ("img", img)
        for sub in ("flow_occ", "flow_noc"):
            expect[os.path.join(k_root, "training", sub,
                                f"{i:06d}_10.png")] = ("kitti", flow)
    return str(s_root), str(k_root), sintel, kitti, expect


def numpy_flow_metrics(preds, gts) -> dict:
    """The validate metrics in float64 numpy, straight from the Spring and
    KITTI definitions: per pair, masked means over the valid pixels (GT not
    NaN) of epe, epe < 1/3/5 px, Fl-all (epe > 3 px and > 5% of |gt|, in
    percent) and WAUC (100 * sum_i w_i #(epe <= i/20) / (n sum_i w_i),
    w_i = 1 - (i-1)/100, i = 1..100); then the mean over pairs."""
    out = {k: [] for k in ("epe", "px1", "px3", "px5", "flall", "wauc")}
    w = 1.0 - (np.arange(1, 101) - 1.0) / 100.0
    for pred, gt in zip(preds, gts):
        valid = ~np.isnan(gt).any(axis=-1)
        g = gt[valid].astype(np.float64)
        e = np.linalg.norm(pred[valid].astype(np.float64) - g, axis=-1)
        mag = np.linalg.norm(g, axis=-1)
        out["epe"].append(e.mean())
        for t in (1, 3, 5):
            out[f"px{t}"].append((e < t).mean())
        out["flall"].append(100.0 * ((e > 3) & (e > 0.05 * mag)).mean())
        counts = np.array([(e <= i / 20.0).sum() for i in range(1, 101)])
        out["wauc"].append(100.0 * (w * counts).sum() / (e.size * w.sum()))
    return {k: float(np.mean(v)) for k, v in out.items()}


def harness_phase(torch, dev, tag: str, work: str, raft_fp32_ms: float
                  ) -> dict:
    """Phase 8: the evaluation harness on the card.  Writes phase 8's
    trees (``harness_data``) and reads every file back with ``image_io`` /
    ``flow_io``, bit for bit; runs ``validate(args)`` of ``raft`` (12
    iterations, warm start, outputs written) over Sintel + KITTI 2015 with
    phase 3's warm-start weights (the init, flow head damped to steps of
    trained size) saved as a checkpoint; holds its metrics to float64 numpy
    metrics of the written flows, its launches to 12 a pair and its first
    flow to a direct IOAdapter forward; runs ``infer`` on 3 frames and
    ``model_benchmark`` of ``raft`` in fp32 and bf16."""
    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.scripts import infer as tinfer
    from ptlflow_tpu_torch.scripts import model_benchmark as tbench
    from ptlflow_tpu_torch.scripts import validate as tvalidate
    from ptlflow_tpu_torch.utils import flow_io, image_io
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    t0 = time.perf_counter()
    s_root, k_root, sintel, kitti, expect = harness_data(work)
    write_s = time.perf_counter() - t0
    on_disk = {os.path.join(d, f) for top in (s_root, k_root)
               for d, _, files in os.walk(top) for f in files}
    if on_disk != set(expect):
        raise AssertionError(f"the writers made {sorted(on_disk ^ set(expect))}"
                             f" beyond or short of the expected files")
    decode_ms = []
    for path, (kind, want) in sorted(expect.items()):
        if kind == "img":
            t1 = time.perf_counter()
            got = image_io.imread(path, image_io.IMREAD_UNCHANGED)
            if got.shape == (H, W, 3):
                decode_ms.append((time.perf_counter() - t1) * 1e3)
        elif kind == "flo":
            got = flow_io.read_flo(path)
        else:
            got = flow_io.read_flow_png(path)
        if got.dtype != want.dtype or not np.array_equal(got, want,
                                                          equal_nan=True):
            raise AssertionError(f"{path} reads back otherwise than written")
    # the decoder's slow path: every row Paeth-filtered (the written files
    # use filter None), undone along anti-diagonals
    filtered = np.random.RandomState(0).randint(0, 256, (H, W, 3), np.uint8)
    paeth_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        image_io.unfilter(np.full(H, 4, np.uint8), filtered)
        paeth_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"[8 data] [{tag}] wrote {len(expect)} files in {write_s:.2f} s "
        f"(Sintel {W}x{H}: 2 sequences x 3 frames, clean and final; KITTI "
        f"2015 {KITTI_W}x{KITTI_H}: 2 pairs); every file reads back bit for "
        f"bit; decode of a {W}x{H} PNG on the host: median "
        f"{np.median(decode_ms):.2f} ms over {len(decode_ms)} (filter "
        f"None); undoing the Paeth filter of a whole frame "
        f"{np.median(paeth_ms):.2f} ms")

    cfg = os.path.join(work, "datasets.yaml")
    with open(cfg, "w") as f:
        f.write(f"mpi_sintel: {s_root}\nkitti_2015: {k_root}\n")
    ckpt = os.path.join(work, "raft_damped.ckpt")
    model = ptlflow_tpu_torch.get_model("raft", args={"iters": ITERS})
    damp_flow_head(model)
    torch.save(model.state_dict(), ckpt)
    del model
    out = os.path.join(work, "validate")
    args = tvalidate._parse_args([
        "--model", "raft", "--ckpt_path", ckpt, "--iters", str(ITERS),
        "--val_dataset", "sintel-trainval+kitti-2015-trainval",
        "--warm_start", "--write_outputs", "--flow_format", "flo",
        "--set", f"data.dataset_config_path={cfg}", "--output_path", out])
    timings = {}
    corr.corr_lookup_kernel.launches = 0
    t0 = time.perf_counter()
    metrics = tvalidate.validate(args, timings=timings)
    torch.cuda.synchronize()
    validate_s = time.perf_counter() - t0
    launches = corr.corr_lookup_kernel.launches
    pairs = {"sintel-trainval": [], "kitti-2015-trainval": []}
    for pass_name in ("clean", "final"):  # the dataset's order
        for s in range(2):
            for k in range(2):
                pairs["sintel-trainval"].append(sintel[s][1][k])
    pairs["kitti-2015-trainval"] = [kitti[i][1] for i in range(2)]
    n_pairs = sum(len(v) for v in pairs.values())
    if launches != ITERS * n_pairs:
        raise AssertionError(f"validate: {launches} lookup launches for "
                             f"{n_pairs} pairs, expected {ITERS} a pair")
    oracle = {}
    for name, gts in pairs.items():
        preds = [flow_io.read_flo(os.path.join(out, "raft", name,
                                               f"{i:06d}.flo"))
                 for i in range(len(gts))]
        if any(p.shape != g.shape or not np.isfinite(p).all()
               for p, g in zip(preds, gts)):
            raise AssertionError(f"validate {name}: flows of the wrong shape "
                                 f"or not finite")
        want = numpy_flow_metrics(preds, gts)
        got = metrics[name]
        errs = {k: abs(got[k] - want[k]) for k in want}
        oracle[name] = {"metrics": {k: got[k] for k in want},
                        "numpy": want, "abs_err": errs}
        log(f"[8 validate] {name}: " + ", ".join(
            f"{k} {got[k]:.6f} (numpy {want[k]:.6f})" for k in want))
        for k, e in errs.items():
            if not e <= (1e-3 if k == "wauc" else 1e-4):
                raise AssertionError(f"validate {name}: {k} {got[k]} against "
                                     f"numpy's {want[k]}")
    model = ptlflow_tpu_torch.get_model("raft", ckpt_path=ckpt,
                                        args={"iters": ITERS})
    adapter = IOAdapter(model)
    direct = adapter.unscale(model(adapter.prepare_inputs(
        sintel[0][0][:2])))["flows"][0, 0].permute(1, 2, 0).cpu().numpy()
    first = flow_io.read_flo(os.path.join(out, "raft", "sintel-trainval",
                                          "000000.flo"))
    direct_err = float(np.abs(direct - first).max())
    del model
    if not direct_err <= 1e-5:
        raise AssertionError(f"validate's first flow is {direct_err} px off "
                             f"a direct forward")
    stage = {k: [v for t in timings.values() for v in t[k]]
             for k in ("decode_ms", "forward_ms", "metrics_ms", "write_ms",
                       "pair_ms")}
    per_pair = {k: float(np.median(v)) for k, v in stage.items()}
    log(f"[8 validate] [{tag}] raft, {ITERS} iters, warm start, "
        f"{n_pairs} pairs: metrics within 1e-4 of numpy (wauc 1e-3), "
        f"{launches} lookup launches ({ITERS} a pair), first flow "
        f"{direct_err:.2e} px from a direct forward; {validate_s:.3f} s in "
        f"all, {validate_s / n_pairs * 1e3:.1f} ms a pair; median per "
        f"pair: {per_pair['pair_ms']:.1f} ms in the loop; decode "
        f"{per_pair['decode_ms']:.2f} ms and output writing "
        f"{per_pair['write_ms']:.2f} ms (host), forward "
        f"{per_pair['forward_ms']:.3f} ms and metrics "
        f"{per_pair['metrics_ms']:.3f} ms (CUDA events); phase 5's raft "
        f"fp32 forward {raft_fp32_ms:.3f} ms")

    corr.corr_lookup_kernel.launches = 0
    written = tinfer.infer(tinfer._parse_args([
        "--model", "raft", "--ckpt_path", ckpt, "--set",
        f"model.init_args.iters={ITERS}", "--input_path",
        os.path.join(s_root, "training", "clean", "seq_0"), "--warm_start",
        "--output_path", os.path.join(work, "infer")]))
    infer_launches = corr.corr_lookup_kernel.launches
    flows = [flow_io.read_flo(p) for p in written]
    if (len(flows) != 2 or infer_launches != 2 * ITERS
            or any(f.shape != (H, W, 2) or not np.isfinite(f).all()
                   for f in flows)):
        raise AssertionError(f"infer: {len(flows)} flows, {infer_launches} "
                             f"lookup launches")
    log(f"[8 infer] 3 frames -> {[os.path.basename(p) for p in written]}, "
        f"finite {W}x{H} flows, {infer_launches} lookup launches")

    rows = tbench.main([
        "--models", "raft", "--input_size", str(H), str(W), "--iters",
        str(ITERS), "--datatypes", "fp32", "bf16", "--num_trials", "1",
        "--num_samples", "10", "--output_path", os.path.join(work, "bench")])
    if [r["datatype"] for r in rows] != ["fp32", "bf16"]:
        raise AssertionError(f"model_benchmark gave {len(rows)} rows")
    bench = {r["datatype"]: {"ms": r["time_ms"], "flops": r["flops"],
                             "mem_gb": r["mem_gb"], "params": r["params"]}
             for r in rows}
    log(f"[8 benchmark] [{tag}] raft {W}x{H}, {ITERS} iters, 1 trial of 10: "
        + "; ".join(f"{k} {v['ms']:.3f} ms, {v['flops'] / 1e9:.1f} GFLOP "
                    f"(FlopCounterMode), peak {v['mem_gb']:.3f} GB"
                    for k, v in bench.items())
        + f"; phase 5's raft fp32 {raft_fp32_ms:.3f} ms")
    return {"card": tag, "pairs": n_pairs,
            "decode_ms_per_frame": float(np.median(decode_ms)),
            "paeth_unfilter_ms_per_frame": float(np.median(paeth_ms)),
            "per_pair_median": per_pair, "per_pair": stage,
            "validate_ms_per_pair": validate_s / n_pairs * 1e3,
            "validate_launches": launches, "infer_launches": infer_launches,
            "direct_forward_err_px": direct_err, "metrics": oracle,
            "benchmark": bench, "phase5_raft_fp32_ms": raft_fp32_ms,
            "write_s": write_s}


def train_cli_phase(torch, dev, tag: str, work: str, bare_step_ms: float
                    ) -> dict:
    """Phase 9: ``scripts/train.py`` as a user runs it, on the card, with
    ``raft-train1-chairs.yaml`` at full width (368x496 crops of 384x512
    Chairs pairs written by the port's writer, batch 10, 12 iterations, 4
    loader workers): 6 steps validating every 3, then ``--resume`` to 8;
    every step must launch 12 lookups and 12 backward lookups, the resume
    must pick up at step 6, and ``last.ckpt`` must load strictly into a
    fresh ``raft`` that gives the trained model's flows.  Then
    ``DeviceCompose`` on the card against the same pipeline on the CPU
    (one sample, the same draws, one noise field), timed per sample, and 4
    steps with ``data.train_transform_cuda=true``."""
    import contextlib
    import io
    import random

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.data import (FlowDataModule, FlyingChairsDataset,
                                        dummy_datasets)
    from ptlflow_tpu_torch.data.device_transforms import DeviceCompose
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.scripts import train as train_script
    from ptlflow_tpu_torch.utils.ckpt import load_checkpoint

    t0 = time.perf_counter()
    root = dummy_datasets.write_flying_chairs(
        os.path.join(work, "data"), n=CHAIRS_PAIRS, size=(CHAIRS_H, CHAIRS_W),
        seed=9)
    ds_cfg = os.path.join(work, "datasets.yaml")
    with open(ds_cfg, "w") as f:
        f.write(f"flying_chairs: {root}\n")
    write_s = time.perf_counter() - t0
    dm = FlowDataModule(dataset_config_path=ds_cfg,
                        train_dataset="chairs-train", val_dataset="chairs-val")
    dm.setup("fit")
    n_train, n_val = len(dm.train_data), len(dm.val_data[0])
    if n_train < TRAIN_B or n_val < 1:
        raise AssertionError(f"chairs-train {n_train}, chairs-val {n_val}: "
                             f"too few pairs")

    # the launches of each step, counted around the script's train step
    per_step = []
    build = train_script.build_train_step

    def counting_build(model, tx, mesh=None):
        step = build(model, tx, mesh)

        def counted(state, batch):
            before = (corr.corr_lookup_kernel.launches,
                      corr.corr_lookup_backward_kernel.launches)
            out = step(state, batch)
            per_step.append((corr.corr_lookup_kernel.launches - before[0],
                             corr.corr_lookup_backward_kernel.launches
                             - before[1]))
            return out
        return counted

    def run(argv, timings=None):
        text = io.StringIO()
        corr.corr_lookup_kernel.launches = 0
        corr.corr_lookup_backward_kernel.launches = 0
        first = len(per_step)
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            out = train_script.train(train_script._parse_args(argv), timings)
        seconds = time.perf_counter() - t1
        launches = (corr.corr_lookup_kernel.launches,
                    corr.corr_lookup_backward_kernel.launches)
        for line in text.getvalue().splitlines():
            log(f"[9 train_cli]   {line}")
        steps = per_step[first:]
        if any(s != (ITERS, ITERS) for s in steps):
            raise AssertionError(f"train steps launched {steps}, not "
                                 f"{ITERS} of each kernel")
        if not all(math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"non-finite losses {out['losses']}")
        return out, text.getvalue(), launches, len(steps), seconds

    ckpt_dir = os.path.join(work, "ckpt")
    base = ["--config", os.path.join(HERE, RAFT_CHAIRS_CONFIG),
            "--ckpt_dir", ckpt_dir, "--log_every_n_steps", "1",
            "--val_every_n_steps", str(CLI_VAL_EVERY)]
    data_set = ["--set", f"data.dataset_config_path={ds_cfg}"]
    train_script.build_train_step = counting_build
    try:
        timings = {}
        first, _, launches, n_steps, first_s = run(
            base + data_set + ["--max_steps", str(CLI_STEPS)], timings)
        n_vals = CLI_STEPS // CLI_VAL_EVERY
        want = (ITERS * (CLI_STEPS + n_vals * n_val), ITERS * CLI_STEPS)
        if n_steps != CLI_STEPS or launches != want:
            raise AssertionError(f"{n_steps} steps and {launches} launches "
                                 f"(lookup, backward), not {CLI_STEPS} and "
                                 f"{want}")
        resumed_timings = {}
        resumed, text, resumed_launches, n_resumed, resumed_s = run(
            base + data_set + ["--max_steps", str(CLI_RESUMED), "--resume"],
            resumed_timings)
        if (f"at step {CLI_STEPS}" not in text
                or n_resumed != CLI_RESUMED - CLI_STEPS
                or resumed["steps"] != CLI_RESUMED):
            raise AssertionError(f"the resumed run did not pick up at step "
                                 f"{CLI_STEPS}: {n_resumed} steps")

        # last.ckpt, strictly into a fresh raft: the trained model's flows
        model = resumed["model"]
        fresh = ptlflow_tpu_torch.get_model(
            "raft", args={"iters": ITERS, "corr_levels": 4, "corr_radius": 4,
                          "gamma": 0.8, "max_flow": 400.0})
        saved = load_checkpoint(os.path.join(ckpt_dir, "raft", "last.ckpt"))
        fresh.load_state_dict(saved["state_dict"], strict=True)
        images = torch.from_numpy(dm.val_data[0][0]["images"][None]).to(dev)
        with torch.no_grad():
            ckpt_err = (fresh({"images": images})["flows"]
                        - model({"images": images})["flows"]).abs().max()
        ckpt_err = ckpt_err.item()
        if ckpt_err != 0.0:
            raise AssertionError(f"last.ckpt's flows differ from the trained "
                                 f"model's by {ckpt_err} px")
        del fresh, model, first, resumed

        # DeviceCompose: the datamodule's chairs recipe, card against CPU
        recipe = FlowDataModule(dataset_config_path=ds_cfg)._get_dataset(
            True, "chairs", "train").transform
        card_aug = DeviceCompose.from_compose(recipe, device=dev)
        cpu_aug = DeviceCompose.from_compose(recipe, device="cpu")
        cpu_aug.noise_field = lambda like, seed: card_aug.noise_field(
            like.to(dev), seed).cpu()
        raw_set = FlyingChairsDataset(str(root), split="train")
        raw = {k: v for k, v in raw_set[0].items()
               if isinstance(v, np.ndarray)}
        random.seed(5)
        on_card = card_aug(dict(raw))
        random.seed(5)
        on_cpu = cpu_aug(dict(raw))
        aug_err = {k: (on_card[k].cpu() - on_cpu[k]).abs().max().item()
                   for k in on_cpu}
        if (aug_err["images"] > ATOL_AUG_IMAGES
                or aug_err["flows"] > ATOL_AUG_FLOWS_PX
                or aug_err["valids"] != 0.0):
            raise AssertionError(f"DeviceCompose card against CPU: {aug_err}")
        # the numpy path's host cost of one sample, in this process: the
        # decode alone, then decode and the recipe's transforms
        decode_ms, host_aug_ms = [], []
        for k in range(min(5, n_train)):
            t1 = time.perf_counter()
            raw_set[k]
            t2 = time.perf_counter()
            dm.train_data[k]
            t3 = time.perf_counter()
            decode_ms.append((t2 - t1) * 1e3)
            host_aug_ms.append((t3 - t2) * 1e3)
        aug_ms = []
        for k in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            card_aug(dict(raw))
            end.record()
            end.synchronize()
            aug_ms.append(start.elapsed_time(end))

        # the augmentations on the card, in the main process
        cuda_timings = {}
        _, _, cuda_launches, n_cuda, cuda_s = run(
            base + ["--set", f"data.dataset_config_path={ds_cfg}",
                    "data.train_transform_cuda=true", "--max_steps",
                    str(CLI_CUDA_STEPS), "--val_every_n_steps", "1000",
                    "--ckpt_dir", os.path.join(work, "ckpt_cuda")],
            cuda_timings)
        if n_cuda != CLI_CUDA_STEPS or cuda_launches != (
                ITERS * CLI_CUDA_STEPS, ITERS * CLI_CUDA_STEPS):
            raise AssertionError(f"train_transform_cuda: {n_cuda} steps, "
                                 f"{cuda_launches} launches")
    finally:
        train_script.build_train_step = build

    def med(xs):
        return float(np.median(xs[1:])) if len(xs) > 1 else float("nan")

    out = {
        "card": tag, "train_pairs": n_train, "val_pairs": n_val,
        "write_s": write_s,
        "ms_per_step": med(timings["step_ms"]),
        "loader_wait_ms_per_step": med(timings["wait_ms"]),
        "first_step_ms": timings["step_ms"][0],
        "first_wait_ms": timings["wait_ms"][0],
        "step_event_ms": med(timings["step_event_ms"]),
        "resumed_ms_per_step": med(resumed_timings["step_ms"]),
        "checkpoint_save_ms": timings["save_ms"],
        "run_s": first_s, "resumed_run_s": resumed_s,
        "decode_ms_per_sample": float(np.median(decode_ms)),
        "numpy_pipeline_ms_per_sample": float(np.median(host_aug_ms)),
        "device_compose_ms_per_sample": float(np.median(aug_ms)),
        "device_compose_err": aug_err,
        "cuda_transform_ms_per_step": med(cuda_timings["step_ms"]),
        "cuda_transform_wait_ms_per_step": med(cuda_timings["wait_ms"]),
        "cuda_transform_step_event_ms": med(cuda_timings["step_event_ms"]),
        "cuda_transform_run_s": cuda_s,
        "phase6_bare_step_ms": bare_step_ms,
        "steps": {"run": timings, "resumed": resumed_timings,
                  "cuda_transform": cuda_timings},
        "launches": {"run": launches, "resumed": resumed_launches,
                     "cuda_transform": cuda_launches},
        "last_ckpt_flow_err_px": ckpt_err,
    }
    log(f"[9 train_cli] [{tag}] raft-train1-chairs.yaml ({TRAIN_W}x{TRAIN_H} "
        f"crops of {CHAIRS_W}x{CHAIRS_H} pairs, batch {TRAIN_B}, {ITERS} "
        f"iters, 4 workers): {out['ms_per_step']:.3f} ms per step in the "
        f"loop (host, median of steps 2-{CLI_STEPS}), loader wait "
        f"{out['loader_wait_ms_per_step']:.3f} ms (first "
        f"{out['first_wait_ms']:.1f}), the step {out['step_event_ms']:.3f} "
        f"ms by CUDA events; phase 6's bare step {bare_step_ms:.3f} ms; "
        f"{launches[0]} lookups ({n_vals} validations of {n_val} pair) and "
        f"{launches[1]} backward launches; resumed at step {CLI_STEPS}, "
        f"{out['resumed_ms_per_step']:.3f} ms per step; checkpoints "
        f"{', '.join(f'{v:.1f}' for v in timings['save_ms'])} ms a "
        f"validation (host); last.ckpt's flows "
        f"{ckpt_err} px off; a sample on the host (one process) "
        f"{out['decode_ms_per_sample']:.1f} ms to decode, "
        f"{out['numpy_pipeline_ms_per_sample']:.1f} ms to decode and "
        f"augment; DeviceCompose "
        f"{out['device_compose_ms_per_sample']:.3f} ms a sample by events, "
        f"card vs CPU {aug_err}; with "
        f"train_transform_cuda {out['cuda_transform_ms_per_step']:.3f} ms "
        f"per step (wait {out['cuda_transform_wait_ms_per_step']:.3f} ms, "
        f"step {out['cuda_transform_step_event_ms']:.3f} ms by events)")
    return out


def conditioned_served(torch, name: str, images, args=None):
    """``get_model(name)`` on the card at its registered depth, its seeded
    weights conditioned (``parity_weights``) and damped to flows of
    trained size on ``images`` (``damp_to_served_size``)."""
    import ptlflow_tpu_torch

    model = ptlflow_tpu_torch.get_model(name, args=args)
    parity_weights(torch, name, model, images)
    damp_to_served_size(torch, name, model, images)
    return model


def card_and_cpu(torch, name: str, images, served: bool = True):
    """``name`` on the card at its registered depth, its seeded weights
    conditioned there on ``images`` (``parity_weights``, and where
    ``served`` ``damp_to_served_size``), and a copy of it on the CPU:
    (card model, CPU model).  Conditioning on the card spares the CPU the
    calibration forwards; the two models hold the same tensors either
    way."""
    import copy

    import ptlflow_tpu_torch

    gpu_model = ptlflow_tpu_torch.get_model(name)
    parity_weights(torch, name, gpu_model, images)
    if served:
        damp_to_served_size(torch, name, gpu_model, images)
    return gpu_model, copy.deepcopy(gpu_model).to("cpu")


def check_flows(torch, name: str, out, shape) -> None:
    flows = out["flows"]
    if tuple(flows.shape) != shape:
        raise AssertionError(f"{name}: flows {tuple(flows.shape)}")
    if not torch.isfinite(flows).all():
        raise AssertionError(f"{name}: non-finite flows")
    def tensors(v):  # IRR's occ_preds: a list of lists of tensors
        if isinstance(v, (list, tuple)):
            return [t for x in v for t in tensors(x)]
        return [v]

    if any(t.grad_fn is not None for v in out.values() for t in tensors(v)):
        raise AssertionError(f"{name}: the eval forward built an autograd "
                             f"graph")


def train_at_largest_batch(torch, dev, tag: str, model, tx, batch_sizes,
                           n_steps: int, depth: int, label: str,
                           phase: int, size=(TRAIN_H, TRAIN_W),
                           level_shapes=None, profile_runs: int = 2,
                           frames: int = 2, launches=None) -> dict:
    """``n_steps`` train steps of ``model`` at ``size`` (TRAIN_H x TRAIN_W)
    through
    ``build_train_step`` with optimizer ``tx``, at the first of
    ``batch_sizes`` that fits the card (a batch that runs out of memory is
    logged and the next tried), each on its own seeded synthetic batch of
    sequences of ``frames`` frames, timed by CUDA events, with ``depth``
    launches of each lookup kernel a step asserted (or ``launches``, the
    forward kernel's and the backward's); then one step profiled.
    Returns the per-step ms, loss and launches, the median of steps 2 on,
    samples/s, the peak memory and that above what was allocated before
    the first step, and the profile (``level_shapes(batch)``: the levels' (Q, H, W), whose dense
    gradient sums it counts; by default RAFT's one 1/8 level), none where
    ``profile_runs`` is 0."""
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain

    step = ttrain.build_train_step(model, tx)
    state = ttrain.create_train_state(model, tx)
    crop_h, crop_w = size
    train = None
    for b in batch_sizes:
        batches = [train_batch(torch, 300 + k, b, crop_h, crop_w, dev,
                               frames) for k in range(n_steps)]
        rec = {"batch": b, "step_ms": [], "loss": [], "lookup": [],
               "lookup_backward": []}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            for batch in batches:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                corr.corr_lookup_kernel.launches = 0
                corr.corr_lookup_backward_kernel.launches = 0
                start.record()
                state, metrics = step(state, batch)
                end.record()
                end.synchronize()
                rec["step_ms"].append(start.elapsed_time(end))
                rec["loss"].append(metrics["loss"].item())
                rec["lookup"].append(corr.corr_lookup_kernel.launches)
                rec["lookup_backward"].append(
                    corr.corr_lookup_backward_kernel.launches)
        except torch.cuda.OutOfMemoryError:
            log(f"[{phase} train] batch {b} does not fit in "
                f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}"
                f" GiB; trying the next")
            del batches, rec
            torch.cuda.empty_cache()
            continue
        train = rec
        break
    if train is None:
        raise AssertionError(f"no {label} training batch fits")
    for k, (ms, loss, nf, nb) in enumerate(zip(
            train["step_ms"], train["loss"], train["lookup"],
            train["lookup_backward"])):
        log(f"[{phase} train] [{tag}] {label} step {k + 1}, batch "
            f"{train['batch']}: loss {loss:.5f}, {ms:.3f} ms by CUDA events, "
            f"{nf} lookup and {nb} backward launches")
        if not math.isfinite(loss):
            raise AssertionError(f"{label} train step {k + 1}: non-finite "
                                 f"loss")
        if (nf, nb) != (launches or (depth, depth)):
            raise AssertionError(f"{label} train step {k + 1}: expected "
                                 f"{launches or depth} launches of each "
                                 f"kernel")
    later = sorted(train["step_ms"][1:])
    train["median_step_ms"] = later[len(later) // 2]
    train["samples_per_s"] = train["batch"] / train["median_step_ms"] * 1e3
    train["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    train["steps_gib"] = train["peak_gib"] - base / 2 ** 30
    th, tw = -(-crop_h // 8), -(-crop_w // 8)
    shapes = ([(train["batch"] * th * tw, th, tw)] if level_shapes is None
              else level_shapes(train["batch"]))
    train["profile"] = (profile_train_step(
        torch, step, state, batches[-1], shapes, tag,
        train["median_step_ms"], label=label, phase=phase, runs=profile_runs)
        if profile_runs else None)
    log(f"[{phase} train] [{tag}] {label} {crop_w}x{crop_h}, batch "
        f"{train['batch']}, {depth} steps of the decoder, fp32 (TF32 off): "
        f"{train['median_step_ms']:.3f} ms per step (median of steps "
        f"2-{n_steps}), {train['samples_per_s']:.2f} samples/s, peak "
        f"{train['peak_gib']:.2f} GiB allocated, {train['steps_gib']:.2f} GiB "
        f"above what the model, its optimizer state, the batches and earlier "
        f"phases held before the first step")
    return train


def time_forward(torch, model, images, label: str, tag: str, depth: str,
                 phase: int, out: dict, kernel_names=None,
                 reps: int = 10, warmups: int = 3,
                 profiled: bool = True, runs: int = 3,
                 ranges=(), profile_runs: int = 2) -> None:
    """The eval forward of ``images``: ``warmups`` warm-ups, then the
    median of ``runs`` runs of ``reps`` forwards by CUDA events; the peak
    memory of
    those forwards (each frees what it allocates), and above what was
    allocated before them (the model, and what earlier phases still hold);
    where ``profiled``, a profile
    (``profile_forward`` of ``profile_runs`` forwards, with the kernel
    times by ``kernel_names`` and the launches under the
    ``record_function`` ``ranges``).
    Written into ``out`` under ``label``."""
    for _ in range(warmups):
        model({"images": images})
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # no untimed call before each run: the warm-ups, or in phases 10-20
    # the served pairs just before, have run the model on these inputs
    times = sorted(timed_ms(torch, lambda: model({"images": images}), reps,
                            warm=False) for _ in range(runs))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    median = times[len(times) // 2]
    out["forward_ms"][label] = median
    out["forward_runs_ms"][label] = times
    out["peak_gib"][label] = peak / 2 ** 30
    out["forward_gib"][label] = (peak - base) / 2 ** 30
    h, w = images.shape[-2:]
    log(f"[{phase} forward] [{tag}] {label}, {w}x{h}, {depth}: "
        f"{median:.3f} ms/forward, {1e3 / median:.2f} fps (median of "
        f"{runs} runs of {reps} forwards: "
        f"{', '.join(f'{r:.3f}' for r in times)} ms); "
        f"peak {peak / 2 ** 30:.2f} GiB allocated, "
        f"{(peak - base) / 2 ** 30:.2f} GiB above the "
        f"{base / 2 ** 30:.2f} GiB allocated before the forward")
    if profiled:
        out["profile"][label] = profile_forward(
            torch, model, images, label, tag, median, phase=phase,
            kernel_names=kernel_names, ranges=ranges, runs=profile_runs)


def lookup_record(torch, pyr, coords, radius: int, err, flush) -> dict:
    """The lookup kernel at ``pyr``'s and ``coords``' shapes, L2 flushed
    before each launch: ms by CUDA events and device ms by the profiler,
    its plain version's ms, the ``grid_sample`` yardstick's, the bound;
    ``err`` is phase 2's max |kernel - plain| there."""
    from ptlflow_tpu_torch.ops import correlation as corr

    lookup = corr.make_corr_lookup(pyr, radius)
    bound = lookup_bound(torch, pyr, coords, radius)
    q = coords.shape[0] * coords.shape[2] * coords.shape[3]
    return {"q": q,
            "levels": [tuple(p.shape[1:]) for p in pyr],
            "max_abs_err": err,
            "ms": timed_ms(torch, lambda: lookup(coords), 50, flush),
            "profiler_ms": profiled_ms(
                torch, lambda: lookup(coords), 50, flush,
                bound_ms=bound["bound_ms"],
                label=f"lookup Q={q}, levels "
                      f"{[tuple(p.shape[1:]) for p in pyr]}"),
            "plain_ms": timed_ms(torch, lambda: corr.corr_pyramid_lookup_plain(
                pyr, coords, radius), 20, flush),
            "library_ms": timed_ms(torch, lambda: grid_sample_lookup(
                torch, pyr, coords, radius), 20, flush),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound_bytes": bound["bytes"]}


def backward_record(torch, levels, coords, grad, radius: int, flush,
                    label: str) -> dict:
    """The backward kernel for ``levels``' shapes at ``coords`` with the
    output gradient ``grad``, L2 flushed before each launch: held to its
    plain version (RTOL_BWD_FP32 of the largest gradient) and to itself
    bit for bit, then ms by CUDA events and device ms by the profiler, the
    plain version's ms, the ``autograd.grad`` of the ``grid_sample``
    yardstick's, and the bound."""
    from ptlflow_tpu_torch.ops import correlation as corr

    shapes = [tuple(lvl.shape[1:]) for lvl in levels]

    def bwd():
        return corr.corr_lookup_backward_kernel(grad, coords, shapes, radius)

    got, again = bwd(), bwd()
    want = corr.corr_pyramid_lookup_backward_plain(grad, coords, shapes,
                                                   radius)
    err = max((a - w).abs().max().item() for a, w in zip(got, want))
    gmax = max(w.abs().max().item() for w in want)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    if not (same and err <= RTOL_BWD_FP32 * gmax):
        raise AssertionError(f"{label} backward: |err| {err}, repeatable "
                             f"{same}")
    del got, again, want
    lv = [lvl.detach().requires_grad_() for lvl in levels]
    gs_out = grid_sample_lookup(torch, lv, coords, radius)
    bb = backward_bound(torch, grad, coords, shapes, radius)
    rec = {"q": coords.shape[0] * coords.shape[2] * coords.shape[3],
           "levels": shapes, "max_abs_err": err, "max_abs_grad": gmax,
           "ms": timed_ms(torch, bwd, 20, flush),
           "profiler_ms": profiled_ms(torch, bwd, 20, flush,
                                      name="corr_lookup_backward",
                                      bound_ms=bb["bound_ms"],
                                      label=f"backward {label}"),
           "plain_ms": timed_ms(
               torch, lambda: corr.corr_pyramid_lookup_backward_plain(
                   grad, coords, shapes, radius), 3, flush),
           "library_ms": timed_ms(torch, lambda: torch.autograd.grad(
               gs_out, lv, grad, retain_graph=True), 5, flush),
           "bound_ms": bb["bound_ms"], "bound_by": bb["bound_by"],
           "bound_bytes": bb["bytes"]}
    del gs_out, lv
    return rec


def flowformer_phase(torch, dev, tag: str, ff_lookup) -> dict:
    """Phase 10: FlowFormer and FlowFormer++ on the card (see the module
    docstring).  ``ff_lookup`` is phase 2's (pyramid, coords, max |err|)
    at FlowFormer's one-level eval shape.  Returns the numbers, the launch
    counts of each path and both kernels' timings at FlowFormer's
    shapes."""
    import copy

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {},
           "card_vs_cpu_px": {}}
    # 3 consecutive pairs of one sequence moving (2, 1) px a frame
    frames = smooth_frames(31, H, W, 4, shift=(2, 1))
    calib = IOAdapter(device=dev).prepare_inputs(frames[:2])["images"]
    for name in FF_SERVE:
        model = conditioned_served(torch, name, calib)
        n, x = serve_sequence(torch, name, model, frames, FF_DEPTH,
                              (1, 1, 2, H, W), 10)
        out["launches"][f"{name} serve, 3 pairs warm-started"] = n

        images = x["images"]
        for mode in ("fp32", "bf16 cast"):
            served = model
            if mode == "bf16 cast":
                served = copy.deepcopy(model)
                if not cast_to_bf16(served, name):
                    raise AssertionError(f"{name}: not on the allow-list")
            time_forward(torch, served, images, f"{name} {mode}", tag,
                         f"{FF_DEPTH} decoder steps", 10, out,
                         reps=FWD_REPS, warmups=FWD_WARMUPS,
                         profiled=False)
            del served
        del model

    # the tiled forward at FlowFormer's Sintel crop: tiles at (0|4, 0|64)
    model = conditioned_served(torch, "flowformer", calib)
    model.train_size = FF_TRAIN_SIZE
    model.tile_height = FF_TRAIN_SIZE[0]
    corr.corr_lookup_kernel.launches = 0
    res = model({"images": calib})
    torch.cuda.synchronize()
    n = corr.corr_lookup_kernel.launches
    check_flows(torch, "flowformer tiled", res, (1, 1, 2, H, W))
    if n != 4 * FF_DEPTH:
        raise AssertionError(f"tiled forward: {n} lookup launches, expected "
                             f"{4 * FF_DEPTH}")
    out["launches"][f"flowformer tiled, train_size {FF_TRAIN_SIZE}"] = n
    runs = sorted(timed_ms(torch, lambda: model({"images": calib}), 1,
                           warm=False) for _ in range(3))
    out["forward_ms"]["flowformer tiled"] = runs[1]
    out["forward_runs_ms"]["flowformer tiled"] = runs
    mean = res["flows"].mean(dim=(0, 1, 3, 4)).tolist()
    log(f"[10 tiled] [{tag}] flowformer at {W}x{H}, train_size "
        f"{FF_TRAIN_SIZE}: 4 tiles, {n} lookup launches, flows finite, mean "
        f"({mean[0]:.3f}, {mean[1]:.3f}) px; {runs[1]:.3f} ms/forward "
        f"(median of 3 runs of 1: {', '.join(f'{r:.3f}' for r in runs)} ms)")
    del model, res

    # card against CPU at 256x320, the registered depth
    pair = smooth_pair(7, 256, 320, shift=(3, 2))
    for name in FF_SERVE:
        cpu_model = ptlflow_tpu_torch.get_model(name, device="cpu")
        x = IOAdapter(cpu_model).prepare_inputs(list(pair))
        parity_weights(torch, name, cpu_model, x["images"])
        gpu_model = ptlflow_tpu_torch.get_model(name)
        gpu_model.load_state_dict(cpu_model.state_dict())
        want = cpu_model(x)["flows"]
        got = gpu_model({"images": x["images"].to(dev)})["flows"].cpu()
        diff = (got - want).abs().max().item()
        out["card_vs_cpu_px"][name] = diff
        log(f"[10 card vs cpu] {name} 256x320, {FF_DEPTH} decoder steps: max "
            f"|dflow| {diff:.3e} px (flow up to {want.abs().max().item():.2f} "
            f"px, tolerance {ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        del cpu_model, gpu_model
    out["train_step_card_vs_cpu"] = train_step_card_vs_cpu(
        torch, "flowformer", dev, {"decoder_depth": 2})

    # train steps at 368x496, the registered depth, the largest batch that
    # fits
    model = ptlflow_tpu_torch.get_model("flowformer")
    condition_flowformer(torch, model)
    tx = ttrain.make_optimizer(lr=2.5e-4, wdecay=1e-4, total_steps=120000,
                               pct_start=0.05, grad_clip=1.0)
    out["train"] = train = train_at_largest_batch(
        torch, dev, tag, model, tx, FF_TRAIN_BATCHES, FF_TRAIN_STEPS,
        FF_DEPTH, "flowformer", 10, profile_runs=0)
    th, tw = -(-TRAIN_H // 8), -(-TRAIN_W // 8)
    del model

    # both kernels at FlowFormer's shapes, L2 flushed before each launch
    flush = flushes(torch, dev)["dirty"]
    pyr, coords, err = ff_lookup
    fwd = lookup_record(torch, pyr, coords, 4, err, flush)
    levels, tcoords, grad = level_inputs(torch, dev, 10, train["batch"], th,
                                         tw, 256)
    bwd_rec = backward_record(torch, levels, tcoords, grad, 4, flush,
                              "FlowFormer-shaped")
    out["kernels"] = {"corr_lookup": fwd, "corr_lookup_backward": bwd_rec}
    for kname, rec in out["kernels"].items():
        log(f"[10 kernels] [{tag}] {kname} at FlowFormer's shape Q="
            f"{rec['q']}, levels {rec['levels']}, r=4, fp32, L2 flushed per "
            f"launch: {rec['ms']:.4f} ms by CUDA events, "
            f"{fmt_ms(rec['profiler_ms'])} device time by the profiler; plain "
            f"{rec['plain_ms']:.4f} ms; library {rec['library_ms']:.4f} ms; "
            f"bound {rec['bound_ms']:.5f} ms by {rec['bound_by']} "
            f"({rec['bound_bytes']} bytes), kernel at "
            f"{rec['bound_ms'] / rec['ms']:.1%} of it")
    return out


def memflow_stream(model, adapter, frames, check=None):
    """The consecutive pairs of ``frames`` through ``model``'s stateful
    forward with ``meta``: the first starts the sequence, none ends it, so
    each writes the memory.  Returns each pair's flows, the memory's count
    after it and the lookup launches of its forward; ``check`` is called
    on each pair's outputs."""
    from ptlflow_tpu_torch.ops import correlation as corr

    flows, counts, launches = [], [], []
    for k in range(len(frames) - 1):
        x = adapter.prepare_inputs(frames[k:k + 2])
        x["meta"] = {"is_seq_start": k == 0, "is_seq_end": False}
        before = corr.corr_lookup_kernel.launches
        res = model(x)
        if check is not None:
            check(res)
        flows.append(res["flows"])
        counts.append(model._memory["count"])
        launches.append(corr.corr_lookup_kernel.launches - before)
    return flows, counts, launches


def sk_family_phase(torch, dev, tag: str) -> dict:
    """Phase 11: SKFlow, LCV-RAFT (+small) and MemFlow (+T) on the card at
    their registered depths (SK_SERVE).  Serves 3 consecutive pairs of one
    sequence at H x W, each warm-started from the last, with one lookup
    launch a decoder step and no autograd graph; streams 4 frames with
    ``meta`` through ``memflow``, whose memory must count 1, 2, 2, 2
    frames; times each fp32 forward and ``memflow``'s ``validate --bf16``
    cast; holds the card against the CPU at 256x320 (the
    ``memflow`` stream frame by frame) and one train step at 128x160 of
    ``skflow``, ``memflow`` and ``lcv_raft``; trains ``memflow`` at
    TRAIN_H x TRAIN_W at the first of SK_TRAIN_BATCHES that fits."""
    import copy

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {},
           "card_vs_cpu_px": {}}
    # consecutive frames of one sequence moving (2, 1) px a frame
    frames = smooth_frames(41, H, W, 5, shift=(2, 1))
    calib = IOAdapter(device=dev).prepare_inputs(frames[:2])["images"]
    for name, depth in SK_SERVE:
        t0 = time.perf_counter()
        model = conditioned_served(torch, name, calib)
        n, x = serve_sequence(torch, name, model, frames[:4], depth,
                              (1, 1, 2, H, W), 11)
        out["launches"][f"{name} serve, 3 pairs warm-started"] = n

        time_forward(torch, model, x["images"], f"{name} fp32", tag,
                     f"{depth} steps", 11, out,
                     reps=FWD_REPS, warmups=FWD_WARMUPS, profiled=False)
        if name == "memflow":
            # the memory stream at full size: 4 pairs with meta
            corr.corr_lookup_kernel.launches = 0
            flows, counts, n = memflow_stream(
                model, IOAdapter(model), frames,
                lambda r: check_flows(torch, name, r, (1, 1, 2, H, W)))
            torch.cuda.synchronize()
            if counts != [1, 2, 2, 2] or n != [depth] * 4:
                raise AssertionError(f"memflow stream: counts {counts}, "
                                     f"launches {n}")
            out["stream_counts"] = counts
            out["launches"]["memflow stream, 4 pairs with meta"] = sum(n)
            log(f"[11 stream] memflow, 4 consecutive pairs at {W}x{H} with "
                f"meta: memory count {counts} after each, {n} lookup "
                f"launches, mean |flow| "
                f"{[round(f.norm(dim=2).mean().item(), 3) for f in flows]} "
                f"px")
            model.clear_memory()
            # validate --bf16: memflow is on the allow-list
            cast = copy.deepcopy(model)
            if not cast_to_bf16(cast, name):
                raise AssertionError(f"{name}: not on the allow-list")
            time_forward(torch, cast, x["images"], f"{name} bf16 cast", tag,
                         f"{depth} steps", 11, out,
                         reps=FWD_REPS, warmups=FWD_WARMUPS, profiled=False)
            del cast
        log(f"[11 serve] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"timing")
        del model, x

    # card against CPU at 256x320, the registered depths
    seq = smooth_frames(7, 256, 320, 5, shift=(3, 2))
    for name, depth in SK_SERVE:
        cpu_model = ptlflow_tpu_torch.get_model(name, device="cpu")
        x = IOAdapter(cpu_model).prepare_inputs(seq[:2])
        parity_weights(torch, name, cpu_model, x["images"])
        gpu_model = ptlflow_tpu_torch.get_model(name)
        gpu_model.load_state_dict(cpu_model.state_dict())
        want = cpu_model(x)["flows"]
        got = gpu_model({"images": x["images"].to(dev)})["flows"].cpu()
        diff = (got - want).abs().max().item()
        out["card_vs_cpu_px"][name] = diff
        log(f"[11 card vs cpu] {name} 256x320, {depth} steps: max |dflow| "
            f"{diff:.3e} px (flow up to {want.abs().max().item():.2f} px, "
            f"tolerance {ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        if name == "memflow":
            cpu_model.clear_memory()
            gpu_model.clear_memory()
            want, cpu_counts, _ = memflow_stream(
                cpu_model, IOAdapter(cpu_model), seq)
            got, counts, _ = memflow_stream(gpu_model, IOAdapter(gpu_model),
                                            seq)
            diffs = [(g.cpu() - w).abs().max().item()
                     for g, w in zip(got, want)]
            out["card_vs_cpu_px"]["memflow stream"] = diffs
            log(f"[11 card vs cpu] memflow stream, 4 pairs at 256x320: max "
                f"|dflow| {', '.join(f'{d:.3e}' for d in diffs)} px, memory "
                f"count {counts} on the card, {cpu_counts} on the CPU")
            if counts != cpu_counts or not max(diffs) <= ATOL_CARD_CPU_PX:
                raise AssertionError(f"memflow stream: card and CPU differ "
                                     f"by {diffs} px, counts {counts}")
        del cpu_model, gpu_model
    out["train_step_card_vs_cpu"] = {
        name: train_step_card_vs_cpu(torch, name, dev, args)
        for name, args in (("skflow", {"iters": 2}),
                           ("memflow", {"decoder_depth": 2}),
                           ("lcv_raft", {"iters": 2}))}

    # memflow's train steps at 368x496 (FlowFormer's optimizer of phase 10)
    model = ptlflow_tpu_torch.get_model("memflow")
    condition_super_kernel(torch, model)
    tx = ttrain.make_optimizer(lr=2.5e-4, wdecay=1e-4, total_steps=120000,
                               pct_start=0.05, grad_clip=1.0)
    out["train"] = train_at_largest_batch(
        torch, dev, tag, model, tx, SK_TRAIN_BATCHES, SK_TRAIN_STEPS,
        dict(SK_SERVE)["memflow"], "memflow", 11, profile_runs=0)
    del model
    return out


def serve_sequence(torch, name: str, model, frames, depth: int, shape,
                   phase: int, window: int = 2, warm: bool = True,
                   timing=None):
    """The consecutive windows of ``window`` frames of ``frames`` (pairs,
    by default) through ``model`` via IOAdapter -> model -> unscale; with
    ``warm``, each warm-started from the last: RAPIDFlow from the previous
    pair's full-size ``flows`` (it gives no ``flow_small``), the others
    from its ``flow_small``.  Asserts each window's flows (and backward
    flows, where the model gives them) of ``shape`` finite, no autograd
    graph and ``depth`` lookup launches.  Returns the launches and the
    last window's inputs.  Where ``timing`` is a dict, the last window's
    forward is timed by CUDA events around it and its peak memory read:
    ``ms``, ``peak_gib`` and ``forward_gib`` (above what was allocated
    before it), for the forwards too slow to run again (1080p)."""
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    adapter = IOAdapter(model)
    key = "flows" if name.startswith("rapidflow") else "flow_small"
    corr.corr_lookup_kernel.launches = 0
    prev = x = None
    for k in range(len(frames) - window + 1):
        x = adapter.prepare_inputs(frames[k:k + window])
        if prev is not None:
            x["prev_preds"] = {key: prev}
        before = corr.corr_lookup_kernel.launches
        last = k == len(frames) - window
        if timing is not None and last:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        res = model(x)
        if timing is not None and last:
            end.record()
        torch.cuda.synchronize()
        if timing is not None and last:
            peak = torch.cuda.max_memory_allocated()
            timing.update(ms=start.elapsed_time(end), peak_gib=peak / 2 ** 30,
                          forward_gib=(peak - base) / 2 ** 30)
        n = corr.corr_lookup_kernel.launches - before
        out = adapter.unscale(res)
        check_flows(torch, name, out, shape)
        if "flows_bw" in out:
            check_flows(torch, name, {"flows": out["flows_bw"]}, shape)
        if n != depth:
            raise AssertionError(f"{name}: {n} lookup launches in one "
                                 f"forward, expected {depth}")
        mean = res["flows"].mean(dim=(0, 1, 3, 4)).tolist()
        log(f"[{phase} serve] {name} window {k} of {window} frames at "
            f"{shape[-1]}x{shape[-2]}"
            f"{f', warm-started from {key}' if prev is not None else ''}: "
            f"flows{' and flows_bw' if 'flows_bw' in out else ''} "
            f"{tuple(out['flows'].shape)} finite, no grad_fn, mean "
            f"({mean[0]:.3f}, {mean[1]:.3f}) px, {n} lookup launches")
        prev = res[key] if warm else None
    return corr.corr_lookup_kernel.launches, x


def record_served_forward(out: dict, label: str, timing: dict, tag: str,
                          depth: str, phase: int, shape) -> None:
    """``serve_sequence``'s ``timing`` of a last served window, written
    into ``out`` under ``label`` as ``time_forward`` writes a timed
    forward (one run)."""
    out["forward_ms"][label] = timing["ms"]
    out["forward_runs_ms"][label] = [timing["ms"]]
    out["peak_gib"][label] = timing["peak_gib"]
    out["forward_gib"][label] = timing["forward_gib"]
    log(f"[{phase} forward] [{tag}] {label}, {shape[1]}x{shape[0]}, {depth}: "
        f"{timing['ms']:.3f} ms/forward (the last served window, "
        f"warm-started, by CUDA events); peak {timing['peak_gib']:.2f} GiB "
        f"allocated, {timing['forward_gib']:.2f} GiB above what was "
        f"allocated before it")


def level_inputs(torch, dev, seed: int, b: int, h: int, w: int, c: int):
    """One correlation level of two seeded (b, c, h, w) feature maps, coords
    spread over the map and 10% past each side, and a seeded gradient of
    the (b, 81, h, w) lookup."""
    from ptlflow_tpu_torch.ops import correlation as corr

    g = torch.Generator().manual_seed(seed)
    f1 = torch.randn(b, c, h, w, generator=g).to(dev)
    f2 = torch.randn(b, c, h, w, generator=g).to(dev)
    levels = corr.build_corr_pyramid(f1, f2, 1)
    coords = (torch.rand(b, 2, h, w, generator=g).to(dev) * 1.2 - 0.1) \
        * torch.tensor([w, h], device=dev).view(1, 2, 1, 1)
    grad = torch.randn(b, 81, h, w, generator=g).to(dev)
    return levels, coords, grad


def recurrent_pyramid_phase(torch, dev, tag: str) -> dict:
    """Phase 12: RAPIDFlow (+``_it1``, ``_it2``, ``_it3``, ``_it6``),
    RPKNet and DPFlow on the card at their registered depths (RP_SERVE).
    Serves 3 consecutive warm-started pairs at H x W through each, with one
    lookup launch a step (a ``CorrBlock`` prepared once a level) and no
    autograd graph; ``dpflow`` also at SPRING_H x SPRING_W (4 levels,
    SPRING_LOOKUPS lookups); times each fp32 forward with its peak memory
    and ``dpflow``'s ``validate --bf16`` cast; holds the card against the CPU at 256x320
    and one train step at 128x160 (2 steps a level) of ``rapidflow``,
    ``rpknet`` and ``dpflow``; trains ``rapidflow`` and ``dpflow`` at
    RP_TRAIN_H x RP_TRAIN_W as their chairs configs set it (RP_TRAIN); and
    times both kernels at ``rapidflow``'s 1/8 level and ``dpflow``'s
    1080p one (phase 2 checks them there)."""
    import copy

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {},
           "card_vs_cpu_px": {}}
    # consecutive frames of one sequence moving (2, 1) px a frame
    frames = smooth_frames(51, H, W, 4, shift=(2, 1))
    calib = IOAdapter(device=dev).prepare_inputs(frames[:2])["images"]
    for name, depth in RP_SERVE:
        t0 = time.perf_counter()
        model = conditioned_served(torch, name, calib)
        n, x = serve_sequence(torch, name, model, frames, depth,
                              (1, 1, 2, H, W), 12)
        out["launches"][f"{name} serve, 3 pairs warm-started"] = n
        time_forward(torch, model, x["images"], f"{name} fp32", tag,
                     f"{depth} lookups", 12, out,
                     reps=FWD_REPS, warmups=FWD_WARMUPS, profiled=False)
        if name == "dpflow":
            cast = copy.deepcopy(model)
            if not cast_to_bf16(cast, name):
                raise AssertionError(f"{name}: not on the allow-list")
            time_forward(torch, cast, x["images"], f"{name} bf16 cast", tag,
                         f"{depth} lookups", 12, out, reps=FWD_REPS,
                         warmups=FWD_WARMUPS, profiled=False)
            del cast
            # Spring's size: 4 levels, stride 64
            spring = smooth_frames(52, SPRING_H, SPRING_W, 3, shift=(3, 2))
            # ~4 s and ~5e5 launches a forward, ~2 min to sort under the
            # profiler: the second served pair is the timed forward
            # (4.1-4.5 s in every run so far), and the profile is of one
            # update step at the 1/8 level (the lookup's output and the
            # flow, random)
            t1 = time.perf_counter()
            timing = {}
            n, x = serve_sequence(torch, name, model, spring,
                                  SPRING_LOOKUPS,
                                  (1, 1, 2, SPRING_H, SPRING_W), 12,
                                  timing=timing)
            out["launches"][f"{name} serve at {SPRING_W}x{SPRING_H}, 2 "
                            f"pairs warm-started"] = n
            record_served_forward(out, f"{name} fp32 1080p", timing, tag,
                                  f"{SPRING_LOOKUPS} lookups", 12,
                                  (SPRING_H, SPRING_W))
            g = torch.Generator().manual_seed(12)
            h8, w8 = -(-SPRING_H // 64) * 8, -(-SPRING_W // 64) * 8
            # net, inp (the registered 128 each), corr, flow
            step_in = [torch.randn(1, c, h8, w8, generator=g).to(dev)
                       for c in (128, 128, 81, 2)]

            def update_step(_):
                return model.update_block(*step_in, get_mask=False)

            with torch.no_grad():
                step_ms = timed_ms(torch, lambda: update_step(None), 3)
                label = f"{name} update step at 1080p's 1/8 level"
                out["forward_ms"][label] = step_ms
            log(f"[12 forward] {name} at 1080p timed in "
                f"{time.perf_counter() - t1:.1f} s")
        log(f"[12 serve] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"timing")
        del model, x

    # card against CPU at 256x320, the registered depths
    t0 = time.perf_counter()
    pair = smooth_pair(7, 256, 320, shift=(3, 2))
    for name, depth in RP_SERVE:
        cpu_model = ptlflow_tpu_torch.get_model(name, device="cpu")
        x = IOAdapter(cpu_model).prepare_inputs(list(pair))
        parity_weights(torch, name, cpu_model, x["images"])
        gpu_model = ptlflow_tpu_torch.get_model(name)
        gpu_model.load_state_dict(cpu_model.state_dict())
        want = cpu_model(x)["flows"]
        got = gpu_model({"images": x["images"].to(dev)})["flows"].cpu()
        diff = (got - want).abs().max().item()
        out["card_vs_cpu_px"][name] = diff
        log(f"[12 card vs cpu] {name} 256x320, {depth} lookups: max |dflow| "
            f"{diff:.3e} px (flow up to {want.abs().max().item():.2f} px, "
            f"tolerance {ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        del cpu_model, gpu_model
    log(f"[12 card vs cpu] {time.perf_counter() - t0:.1f} s")
    # 2 steps a level on the 3 levels of 128x160: 6 lookups
    t0 = time.perf_counter()
    out["train_step_card_vs_cpu"] = {
        name: train_step_card_vs_cpu(torch, name, dev, args, lookups=6)
        for name, args in (("rapidflow", {"iters": 6}),
                           ("rpknet", {"iters": 6}),
                           ("dpflow", {"iters_per_level": 2}))}

    # training at the chairs configs' crops and batches
    def level_shapes(b):
        return [(b * (RP_TRAIN_H // s) * (RP_TRAIN_W // s), RP_TRAIN_H // s,
                 RP_TRAIN_W // s) for s in (32, 16, 8)]

    log(f"[12 train step card vs cpu] {time.perf_counter() - t0:.1f} s")
    out["train"] = {}
    for name, batch, lr in RP_TRAIN:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        parity_weights(torch, name, model, None)
        tx = ttrain.make_optimizer(lr=lr, wdecay=1e-4, total_steps=120000,
                                   pct_start=0.05, grad_clip=1.0)
        out["train"][name] = train_at_largest_batch(
            torch, dev, tag, model, tx,
            tuple(b for b in (batch, 4, 2) if b <= batch), RP_TRAIN_STEPS,
            12, name, 12, size=(RP_TRAIN_H, RP_TRAIN_W),
            level_shapes=level_shapes, profile_runs=0)
        log(f"[12 train] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"profile")
        del model, tx

    # both kernels at rapidflow's 1/8 level (1024x436 padded to 1024x448)
    # and dpflow's 1080p one (padded to 1920x1088), L2 flushed per launch
    flush = flushes(torch, dev)["dirty"]
    out["kernels"] = {"corr_lookup": {}, "corr_lookup_backward": {}}
    for label, (c, h, w) in RP_KERNEL_LEVELS:
        levels, coords, grad = level_inputs(torch, dev, 12, 1, h, w, c)
        got = corr.corr_lookup_kernel(levels, coords, 4)
        want = corr.corr_pyramid_lookup_plain(levels, coords, 4)
        err = (got - want).abs().max().item()
        if not err <= ATOL_FP32:
            raise AssertionError(f"{label}: lookup |err| {err}")
        del got, want
        out["kernels"]["corr_lookup"][label] = lookup_record(
            torch, levels, coords, 4, err, flush)
        out["kernels"]["corr_lookup_backward"][label] = backward_record(
            torch, levels, coords, grad, 4, flush, label)
        del levels, coords, grad
        for kname, recs in out["kernels"].items():
            rec = recs[label]
            log(f"[12 kernels] [{tag}] {kname} at {label}, Q={rec['q']}, "
                f"level {rec['levels']}, r=4, fp32, L2 flushed per launch: "
                f"{rec['ms']:.4f} ms by CUDA events, "
                f"{fmt_ms(rec['profiler_ms'])} device time by the profiler; "
                f"plain {rec['plain_ms']:.4f} ms; library "
                f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.5f} ms "
                f"by {rec['bound_by']} ({rec['bound_bytes']} bytes), kernel "
                f"at {rec['bound_ms'] / rec['ms']:.1%} of it")
    return out


def video_and_attention_phase(torch, dev, tag: str) -> dict:
    """Phase 13: CRAFT, NeuFlow v2, VideoFlow (BOF, MOF) and StreamFlow on
    the card at their registered depths (VA_SERVE).  Serves 3 consecutive
    windows of one sequence at H x W through each (``craft`` pairs each
    warm-started from the last's ``flow_small``, ``neuflow2`` cold pairs,
    VideoFlow's 3 and 5 frames with their backward flows, StreamFlow's 4
    frames and 3 flows), counting the lookup launches of each forward and
    asserting no autograd graph; times each fp32 forward with its peak
    memory and ``craft``'s ``validate --bf16`` cast; holds the
    card against the CPU at 256x320 (the registered depths); one train
    step at 128x160 card against CPU of ``craft`` and ``streamflow`` (2
    iterations) and ``neuflow2`` (1 + 2); trains ``craft`` (12
    iterations) and ``streamflow`` (15) at TRAIN_H x TRAIN_W at the first
    of their VA_TRAIN_BATCHES that fits and ``neuflow2`` at batch 8; and
    times both kernels at VA_KERNEL_Q (phase 2 checks them there)."""
    import copy

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {},
           "card_vs_cpu_px": {}}
    # 7 consecutive frames of one sequence moving (2, 1) px a frame
    frames = smooth_frames(61, H, W, 7, shift=(2, 1))
    for name, depth, window in VA_SERVE:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        condition_video_and_attention(torch, name, model)
        shape = (1, 3 if name == "streamflow" else 1, 2, H, W)
        n, x = serve_sequence(torch, name, model, frames[:window + 2], depth,
                              shape, 13, window=window,
                              warm=name == "craft")
        out["launches"][f"{name} serve, 3 windows"] = n
        time_forward(torch, model, x["images"], f"{name} fp32", tag,
                     f"{depth} lookups", 13, out,
                     reps=FWD_REPS, warmups=FWD_WARMUPS, profiled=False)
        if name == "craft":
            cast = copy.deepcopy(model)
            if not cast_to_bf16(cast, name):
                raise AssertionError(f"{name}: not on the allow-list")
            time_forward(torch, cast, x["images"], f"{name} bf16 cast", tag,
                         f"{depth} lookups", 13, out,
                         reps=FWD_REPS, warmups=FWD_WARMUPS, profiled=False)
            del cast
        log(f"[13 serve] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"timing")
        del model, x

    # card against CPU at 256x320, the registered depths
    t0 = time.perf_counter()
    seq = smooth_frames(7, 256, 320, 5, shift=(3, 2))
    for name, depth, window in VA_SERVE:
        x = IOAdapter(device="cpu").prepare_inputs(seq[:window])
        gpu_model, cpu_model = card_and_cpu(torch, name, x["images"].to(dev),
                                            served=False)
        want = cpu_model(x)
        got = gpu_model({"images": x["images"].to(dev)})
        diff = max((got[k].cpu() - want[k]).abs().max().item()
                   for k in ("flows", "flows_bw") if k in want)
        out["card_vs_cpu_px"][name] = diff
        log(f"[13 card vs cpu] {name} 256x320, {window} frames, {depth} "
            f"lookups: max |dflow| {diff:.3e} px (flow up to "
            f"{want['flows'].abs().max().item():.2f} px, tolerance "
            f"{ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        del cpu_model, gpu_model
    log(f"[13 card vs cpu] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # neuflow2 at 1 + 2 steps: 3 lookups, and as its lookups give the
    # coords a gradient, 4 more launches of the forward kernel each in the
    # backward
    # craft on batch seed 6: on seed 5 a ReLU input of the feature encoder
    # lies within rounding of 0, and the CPU with its input one rounding
    # off moves the whole gradient by 3.5e-3 (fnet.conv1), on seed 6 by
    # 6.6e-5
    out["train_step_card_vs_cpu"] = {
        "craft": train_step_card_vs_cpu(torch, "craft", dev, {"iters": 2},
                                        batch_seed=6),
        "neuflow2": train_step_card_vs_cpu(torch, "neuflow2", dev,
                                           {"iters_s8": 2}, (15, 3)),
        "streamflow": train_step_card_vs_cpu(torch, "streamflow", dev,
                                             {"iters": 2}, frames=4)}
    log(f"[13 train step card vs cpu] {time.perf_counter() - t0:.1f} s")

    # training at 368x496 (FlowFormer's optimizer of phase 10)
    th, tw = -(-TRAIN_H // 8), -(-TRAIN_W // 8)

    def pyramid_shapes(q_per_sample):
        def shapes(b):
            return [(b * q_per_sample * th * tw, th >> k, tw >> k)
                    for k in range(4)]
        return shapes

    depths = {n: d for n, d, _ in VA_SERVE}
    out["train"] = {}
    for name, args, batches, depth, frames_, launches, shapes in (
            ("craft", {"iters": ITERS}, VA_TRAIN_BATCHES["craft"], ITERS, 2,
             None, pyramid_shapes(1)),
            ("neuflow2", {}, (8,), depths["neuflow2"], 2,
             (5 * depths["neuflow2"], depths["neuflow2"]), None),
            ("streamflow", {}, VA_TRAIN_BATCHES["streamflow"],
             depths["streamflow"], 4, None, pyramid_shapes(3))):
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name, args=args)
        condition_video_and_attention(torch, name, model)
        tx = ttrain.make_optimizer(lr=2.5e-4, wdecay=1e-4,
                                   total_steps=120000, pct_start=0.05,
                                   grad_clip=1.0)
        out["train"][name] = train_at_largest_batch(
            torch, dev, tag, model, tx, batches, VA_TRAIN_STEPS, depth, name,
            13, level_shapes=shapes, profile_runs=0, frames=frames_,
            launches=launches)
        log(f"[13 train] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"profile")
        del model, tx
        torch.cuda.empty_cache()

    # both kernels at videoflow_mof's and streamflow's 4-level pyramid at
    # 1024x436 (Q = 21,120), L2 flushed per launch
    flush = flushes(torch, dev)["dirty"]
    b, h, w = VA_KERNEL_Q
    g = torch.Generator().manual_seed(13)
    f1 = torch.randn(b, 256, h, w, generator=g).to(dev)
    f2 = torch.randn(b, 256, h, w, generator=g).to(dev)
    levels = corr.build_corr_pyramid(f1, f2, 4)
    coords = (torch.rand(b, 2, h, w, generator=g).to(dev) * 1.2 - 0.1) \
        * torch.tensor([w, h], device=dev).view(1, 2, 1, 1)
    grad = torch.randn(b, 4 * 81, h, w, generator=g).to(dev)
    del f1, f2
    label = f"videoflow_mof/streamflow Q={b * h * w}"
    got = corr.corr_lookup_kernel(levels, coords, 4)
    err = (got - corr.corr_pyramid_lookup_plain(levels, coords, 4)).abs(
        ).max().item()
    if not err <= ATOL_FP32:
        raise AssertionError(f"{label}: lookup |err| {err}")
    out["kernels"] = {
        "corr_lookup": {label: lookup_record(torch, levels, coords, 4, err,
                                             flush)},
        "corr_lookup_backward": {label: backward_record(
            torch, levels, coords, grad, 4, flush, label)}}
    for kname, recs in out["kernels"].items():
        rec = recs[label]
        log(f"[13 kernels] [{tag}] {kname} at {label}, levels "
            f"{rec['levels']}, r=4, fp32, L2 flushed per launch: "
            f"{rec['ms']:.4f} ms by CUDA events, "
            f"{fmt_ms(rec['profiler_ms'])} device time by the profiler; "
            f"plain {rec['plain_ms']:.4f} ms; library "
            f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.5f} ms by "
            f"{rec['bound_by']} ({rec['bound_bytes']} bytes), kernel at "
            f"{rec['bound_ms'] / rec['ms']:.1%} of it")
    return out


def volume_and_backbone_phase(torch, dev, tag: str) -> dict:
    """Phase 14: MEMFOF, LLA-Flow (+RAFT), CSFlow, SplatFlow, ReCoVEr (mn,
    rn, cx) and Flow-Anything on the card at their registered depths
    (VB_SERVE), fp32, TF32 off.  Serves 3 consecutive windows of one
    sequence through each (``llaflow``, ``llaflow_raft`` and ``csflow``
    pairs each warm-started from the last's ``flow_small``; ``memfof`` 3
    frames at 1080x1920 and 436x1024; ``splatflow`` 3 frames at
    375x1242), counting the lookup launches of each forward and asserting
    no autograd graph; times each fp32 forward with its peak memory, and
    the ``validate --bf16`` casts of
    ``memfof`` and ``csflow``; holds the card against the CPU at 256x320
    for every name; holds both kernels against their plain versions on
    MEMFOF's 1080p levels (Q = 8160 on 68x120 ... 8x15) and on CSFlow's
    strip pyramid, and ``softsplat_average`` against the CPU at
    SplatFlow's 1/8 KITTI shape; one train step at 128x160 card against
    CPU (VB_STEP_CHECK); and trains VB_TRAIN at TRAIN_H x TRAIN_W at the
    first of VB_TRAIN_BATCHES that fits."""
    import copy

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.models.csflow.csflow import (
        CSFlowCorrBlock, StripCrossCorrMap_v2)
    from ptlflow_tpu_torch.models.memfof.memfof import MemfofCorrBlock
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.ops.warp import softsplat_average
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {},
           "card_vs_cpu_px": {}}
    model, built = None, None
    for name, depth, window, warm, (h, w) in VB_SERVE:
        t0 = time.perf_counter()
        frames = smooth_frames(141, h, w, window + 2, shift=(2, 1))
        if name != built:  # memfof serves two sizes on one model
            del model
            torch.cuda.empty_cache()
            model = ptlflow_tpu_torch.get_model(name)
            calib = IOAdapter(model).prepare_inputs(
                smooth_frames(142, H, W, window, shift=(2, 1)))["images"]
            parity_weights(torch, name, model, calib)
            damp_to_served_size(torch, name, model, calib)
            built = name
        n, x = serve_sequence(torch, name, model, frames, depth,
                              (1, 1, 2, h, w), 14, window=window, warm=warm)
        key = f"{name} serve at {w}x{h}, 3 windows"
        out["launches"][key] = n
        if n != 3 * depth:
            raise AssertionError(f"{key}: {n} lookup launches")
        label = f"{name} fp32" + (" 1080p" if (h, w) == (SPRING_H, SPRING_W)
                                  else "")
        time_forward(torch, model, x["images"], label, tag,
                     f"{depth} lookups", 14, out,
                     reps=FWD_REPS, warmups=FWD_WARMUPS, profiled=False)
        if name in ("memfof", "csflow") and (h, w) == (H, W):
            cast = copy.deepcopy(model)
            if not cast_to_bf16(cast, name):
                raise AssertionError(f"{name}: not on the allow-list")
            time_forward(torch, cast, x["images"], f"{name} bf16 cast", tag,
                         f"{depth} lookups", 14, out,
                         reps=FWD_REPS, warmups=FWD_WARMUPS, profiled=False)
            del cast
        log(f"[14 serve] {name} at {w}x{h}: {time.perf_counter() - t0:.1f} "
            f"s with its timing")
        del x
    del model
    torch.cuda.empty_cache()

    # card against CPU at 256x320, the registered depths
    t0 = time.perf_counter()
    seq = smooth_frames(7, 256, 320, 3, shift=(3, 2))
    for name, depth, window, _, _ in VB_SERVE:
        if name in out["card_vs_cpu_px"]:
            continue
        x = IOAdapter(device="cpu").prepare_inputs(seq[:window])
        gpu_model, cpu_model = card_and_cpu(torch, name,
                                            x["images"].to(dev))
        want = cpu_model(x)["flows"]
        got = gpu_model({"images": x["images"].to(dev)})["flows"].cpu()
        diff = (got - want).abs().max().item()
        out["card_vs_cpu_px"][name] = diff
        log(f"[14 card vs cpu] {name} 256x320, {window} frames, {depth} "
            f"lookups: max |dflow| {diff:.3e} px (flow up to "
            f"{want.abs().max().item():.2f} px, tolerance "
            f"{ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        del cpu_model, gpu_model
    log(f"[14 card vs cpu] {time.perf_counter() - t0:.1f} s")

    # both kernels on MEMFOF's 1080p levels and CSFlow's strip pyramid
    t0 = time.perf_counter()
    flush = flushes(torch, dev)["dirty"]
    g = torch.Generator().manual_seed(14)
    hf, wf = -(-SPRING_H // 32) * 2, -(-SPRING_W // 32) * 2  # 68 x 120
    f1 = torch.randn(1, 1024, hf, wf, generator=g).to(dev)
    f2 = torch.randn(1, 1024, hf, wf, generator=g).to(dev) + 0.5 * f1
    memfof_levels = MemfofCorrBlock(f1, f2, 4, 4).pyramid
    hp, wp = -(-H // 8), -(-W // 8)
    s1 = torch.randn(1, 256, hp, wp, generator=g).to(dev)
    s2 = torch.randn(1, 256, hp, wp, generator=g).to(dev)
    strip_block = StripCrossCorrMap_v2(256, 256).to(dev).eval()
    with torch.no_grad():
        strip = strip_block(s1, s2)[0]
        strip_levels = CSFlowCorrBlock(s1, s2, strip, 4, 4).pyramids[1]
    del f1, f2, s1, s2, strip
    out["kernels"] = {"corr_lookup": {}, "corr_lookup_backward": {}}
    for label, levels, (b, h1, w1) in (
            (f"memfof 1080p Q={hf * wf}", memfof_levels, (1, hf, wf)),
            (f"csflow strip Q={hp * wp}", strip_levels, (1, hp, wp))):
        coords = (torch.rand(b, 2, h1, w1, generator=g).to(dev) * 1.2
                  - 0.1) * torch.tensor([w1, h1], device=dev).view(
                      1, 2, 1, 1)
        got = corr.corr_lookup_kernel(levels, coords, 4)
        err = (got - corr.corr_pyramid_lookup_plain(levels, coords, 4)).abs(
            ).max().item()
        log(f"[14 kernel vs plain] {label}, levels "
            f"{[tuple(p.shape[1:]) for p in levels]}, r=4, fp32: max |err| "
            f"{err:.3e} (tolerance {ATOL_FP32})")
        if not err <= ATOL_FP32:
            raise AssertionError(f"{label}: lookup |err| {err}")
        grad = torch.randn(got.shape, generator=g).to(dev)
        out["kernels"]["corr_lookup"][label] = lookup_record(
            torch, levels, coords, 4, err, flush)
        out["kernels"]["corr_lookup_backward"][label] = backward_record(
            torch, levels, coords, grad, 4, flush, label)
        for kname, recs in out["kernels"].items():
            rec = recs[label]
            log(f"[14 kernels] [{tag}] {kname} at {label}, levels "
                f"{rec['levels']}, r=4, fp32, L2 flushed per launch: "
                f"{rec['ms']:.4f} ms by CUDA events, "
                f"{fmt_ms(rec['profiler_ms'])} device time by the profiler; "
                f"plain {rec['plain_ms']:.4f} ms; library "
                f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.5f} ms "
                f"by {rec['bound_by']} ({rec['bound_bytes']} bytes), kernel "
                f"at {rec['bound_ms'] / rec['ms']:.1%} of it")
        del got, grad, coords
    del memfof_levels, strip_levels, strip_block

    # softsplat_average at SplatFlow's 1/8 KITTI shape, card against CPU
    sh, sw = -(-KITTI_H // 8), -(-KITTI_W // 8)
    x = torch.randn(1, 128, sh, sw, generator=g)
    flow = 3 * torch.randn(1, 2, sh, sw, generator=g)
    want = softsplat_average(x, flow)
    xd, fd = x.to(dev), flow.to(dev)
    got = softsplat_average(xd, fd).cpu()
    err = (got - want).abs().max().item()
    splat_ms = timed_ms(torch, lambda: softsplat_average(xd, fd), 20, flush)
    out["softsplat"] = {"shape": [1, 128, sh, sw], "max_abs_err": err,
                        "ms": splat_ms}
    log(f"[14 softsplat] [{tag}] softsplat_average (1, 128, {sh}, {sw}), "
        f"card against CPU: max |err| {err:.3e} (tolerance {ATOL_SPLAT}); "
        f"{splat_ms:.4f} ms by CUDA events, L2 flushed")
    if not err <= ATOL_SPLAT:
        raise AssertionError(f"softsplat_average: card and CPU differ by "
                             f"{err}")
    log(f"[14 kernels] {time.perf_counter() - t0:.1f} s")

    # one train step card against CPU at 128x160, 2 iterations
    t0 = time.perf_counter()
    out["train_step_card_vs_cpu"] = {
        name: train_step_card_vs_cpu(torch, name, dev, {"iters": 2}, launches,
                                     batch_seed=seed)
        for name, launches, seed in VB_STEP_CHECK}
    log(f"[14 train step card vs cpu] {time.perf_counter() - t0:.1f} s")

    # training at 368x496 at the first batch that fits
    th, tw = -(-TRAIN_H // 8), -(-TRAIN_W // 8)
    mh, mw = -(-TRAIN_H // 32) * 2, -(-TRAIN_W // 32) * 2  # memfof's 1/16

    def pyramid_shapes(h, w, copies):
        def shapes(b):
            return [(b * h * w, h >> k, w >> k) for k in range(4)] * copies
        return shapes

    out["train"] = {}
    for name, args, depth in VB_TRAIN:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name, args=args)
        batch = train_batch(torch, 14, 2, TRAIN_H, TRAIN_W, dev)
        parity_weights(torch, name, model, batch["images"])
        del batch
        tx = ttrain.make_optimizer(lr=4e-4, wdecay=1e-4, total_steps=120000,
                                   pct_start=0.05, grad_clip=1.0)
        shapes = (pyramid_shapes(mh, mw, 2) if name == "memfof"
                  else pyramid_shapes(th, tw, 2 if name == "csflow" else 1))
        out["train"][name] = train_at_largest_batch(
            torch, dev, tag, model, tx, VB_TRAIN_BATCHES, VB_TRAIN_STEPS,
            depth, name, 14, level_shapes=shapes, profile_runs=0,
            launches=(depth, depth))
        log(f"[14 train] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"profile")
        del model, tx
        torch.cuda.empty_cache()
    return out


def slice13_phase(torch, dev, tag: str) -> dict:
    """Phase 15: WAFT (dav2_a1, dav2_a2, twins_a2), FlowSeek (t, m), DIP,
    Flow1D and GMFlowNet (+mix) on the card at their registered depths
    (S13_SERVE), fp32, TF32 off.  Serves 3 consecutive pairs of one
    sequence through each (``flow1d`` and ``gmflownet(_mix)`` each
    warm-started from the last's ``flow_small``; ``flow1d`` also at
    1920x1080), counting the lookup launches of each forward (4 for
    FlowSeek, 32 for GMFlowNet, 0 elsewhere) and asserting no autograd
    graph; times each fp32 forward with its peak memory (at 1080p one
    timed forward, and one update step),
    and the ``validate --bf16`` casts of the allow-list's names
    (S13_BF16);
    holds the card against the CPU at 256x320 for every name (GMFlowNet on
    frames shifted by whole feature pixels, printing how many of its
    initial matches differ); one train step at 128x160 card against CPU
    (S13_STEP_CHECK); both kernels against their plain versions and timed
    at GMFlowNet's training pyramid; and trains S13_TRAIN at TRAIN_H x
    TRAIN_W at the first of S13_TRAIN_BATCHES that fits (unprofiled)."""
    import copy

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {},
           "card_vs_cpu_px": {}, "match_differences": {}}
    # the models whose flows start elsewhere than at the flow head's steps:
    # DIP at a random field of up to 256 px, GMFlowNet at its matches
    undamped = ("dip", "gmflownet", "gmflownet_mix")
    model, built = None, None
    for name, depth, warm, (h, w) in S13_SERVE:
        t0 = time.perf_counter()
        big = (h, w) == (SPRING_H, SPRING_W)
        # 2 pairs at 1080p (the second warm-started), as phase 12 serves
        # dpflow there: ~8 s a forward
        frames = smooth_frames(151, h, w, 3 if big else 4, shift=(2, 1))
        if name != built:  # flow1d serves two sizes on one model
            del model
            torch.cuda.empty_cache()
            model = ptlflow_tpu_torch.get_model(name)
            calib = IOAdapter(model).prepare_inputs(
                smooth_frames(152, H, W, 2, shift=(2, 1)))["images"]
            parity_weights(torch, name, model, calib)
            if name not in undamped:
                damp_to_served_size(torch, name, model, calib)
            built = name
        timing = {} if big else None
        n, x = serve_sequence(torch, name, model, frames, depth,
                              (1, 1, 2, h, w), 15, window=2, warm=warm,
                              timing=timing)
        key = f"{name} serve at {w}x{h}, {len(frames) - 1} pairs"
        out["launches"][key] = n
        if n != (len(frames) - 1) * depth:
            raise AssertionError(f"{key}: {n} lookup launches")
        label = f"{name} fp32" + (" 1080p" if big else "")
        # flow1d at 1080p: ~8 s a forward (7.8-9.0 s in every run), a
        # million kernel launches (cuDNN picks an FFT convolution of GEMVs
        # for the motion encoder's 7x7 2->128 conv), which the profiler
        # cannot digest in the time budget: the second served pair is the
        # timed forward, and the profile is of one update step
        if big:
            record_served_forward(out, label, timing, tag,
                                  f"{depth} lookups", 15, (h, w))
        else:
            time_forward(torch, model, x["images"], label, tag,
                         f"{depth} lookups", 15, out, reps=FWD_REPS,
                         warmups=FWD_WARMUPS, profiled=False)
        if big:
            # the profile of one update step at 1080p's 1/8 level (136x240;
            # the correlation windows and the state random), as phase 12
            # profiles dpflow's
            g = torch.Generator().manual_seed(15)
            h8, w8 = -(-h // 8), -(-w // 8)
            step_in = [torch.randn(1, c, h8, w8, generator=g).to(dev)
                       for c in (128, 128, 2 * (2 * model.corr_radius + 1),
                                 2)]

            def update_step(_):
                return model.update_block(*step_in)

            with torch.no_grad():
                step_ms = timed_ms(torch, lambda: update_step(None), 3)
                step_label = f"{name} update step at 1080p's 1/8 level"
                out["forward_ms"][step_label] = step_ms
        if name in S13_BF16:
            cast = copy.deepcopy(model)
            if not cast_to_bf16(cast, name):
                raise AssertionError(f"{name}: not on the allow-list")
            time_forward(torch, cast, x["images"], f"{name} bf16 cast", tag,
                         f"{depth} lookups", 15, out, reps=FWD_REPS,
                         warmups=FWD_WARMUPS, profiled=False)
            del cast
        log(f"[15 serve] {name} at {w}x{h}: {time.perf_counter() - t0:.1f} "
            f"s with its timing")
        del x
    del model
    torch.cuda.empty_cache()

    # card against CPU at 256x320, the registered depths
    t0 = time.perf_counter()
    for name in S13_NAMES:
        shift = S13_MATCH_SHIFT if name.startswith("gmflownet") else (3, 2)
        pair = smooth_frames(7, 256, 320, 2, shift=shift)
        x = IOAdapter(device="cpu").prepare_inputs(pair)
        gpu_model, cpu_model = card_and_cpu(torch, name, x["images"].to(dev),
                                            served=name not in undamped)
        if name.startswith("gmflownet"):
            # the matches alone: no iteration
            iters = cpu_model.iters
            cpu_model.iters = gpu_model.iters = 0
            cm = cpu_model(x)["flow_small"]
            gm = gpu_model({"images": x["images"].to(dev)})[
                "flow_small"].cpu()
            cpu_model.iters = gpu_model.iters = iters
            moved = ((cm - gm).abs().amax(dim=1) > 0.5).sum().item()
            out["match_differences"][name] = moved
            log(f"[15 card vs cpu] {name} 256x320: {moved} of "
                f"{cm[0, 0].numel()} initial matches differ between the "
                f"card and the CPU ({(cm != 0).any(dim=1).float().mean():.1%} "
                f"of the pixels matched away from themselves)")
        want = cpu_model(x)["flows"]
        got = gpu_model({"images": x["images"].to(dev)})["flows"].cpu()
        diff = (got - want).abs().max().item()
        out["card_vs_cpu_px"][name] = diff
        log(f"[15 card vs cpu] {name} 256x320: max |dflow| {diff:.3e} px "
            f"(flow up to {want.abs().max().item():.2f} px, tolerance "
            f"{ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        del cpu_model, gpu_model
    log(f"[15 card vs cpu] {time.perf_counter() - t0:.1f} s")

    # one train step card against CPU at 128x160, 2 iterations
    t0 = time.perf_counter()
    out["train_step_card_vs_cpu"] = {
        name: train_step_card_vs_cpu(torch, name, dev, {"iters": 2}, launches,
                                     batch_seed=seed)
        for name, launches, seed in S13_STEP_CHECK}
    log(f"[15 train step card vs cpu] {time.perf_counter() - t0:.1f} s")

    # training at 368x496 at the first batch that fits; gmflownet's
    # pyramid pools its volume: 46x62, 23x31, 11x15, 5x7
    th, tw = -(-TRAIN_H // 8), -(-TRAIN_W // 8)

    def gm_shapes(b):
        return [(b * th * tw, th >> k, tw >> k) for k in range(4)]

    out["train"] = {}
    for name, args, launches in S13_TRAIN:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name, args=args)
        batch = train_batch(torch, 15, 2, TRAIN_H, TRAIN_W, dev)
        parity_weights(torch, name, model, batch["images"])
        del batch
        tx = ttrain.make_optimizer(lr=4e-4, wdecay=1e-4, total_steps=120000,
                                   pct_start=0.05, grad_clip=1.0)
        # unprofiled: the profiler's digest of a 32-iteration step's ~10^5
        # kernel records takes tens of seconds of the time budget
        out["train"][name] = train_at_largest_batch(
            torch, dev, tag, model, tx, S13_TRAIN_BATCHES, S13_TRAIN_STEPS,
            launches[0], name, 15,
            level_shapes=gm_shapes if launches[0] else (lambda b: []),
            profile_runs=0, launches=launches)
        log(f"[15 train] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"profile")
        del model, tx
        torch.cuda.empty_cache()

    # both kernels at gmflownet's training pyramid, at the batch that fit
    t0 = time.perf_counter()
    b = out["train"]["gmflownet"]["batch"]
    flush = flushes(torch, dev)["dirty"]
    g = torch.Generator().manual_seed(15)
    f1 = torch.randn(b, 256, th, tw, generator=g).to(dev)
    f2 = torch.randn(b, 256, th, tw, generator=g).to(dev) + 0.5 * f1
    levels = corr.pool_volume_pyramid(
        corr.all_pairs_correlation(f1, f2).reshape(b * th * tw, th, tw), 4)
    del f1, f2
    coords = (torch.rand(b, 2, th, tw, generator=g).to(dev) * 1.2 - 0.1) \
        * torch.tensor([tw, th], device=dev).view(1, 2, 1, 1)
    label = f"gmflownet train Q={b * th * tw}"
    got = corr.corr_lookup_kernel(levels, coords, 4)
    err = (got - corr.corr_pyramid_lookup_plain(levels, coords, 4)).abs(
        ).max().item()
    log(f"[15 kernel vs plain] {label}, levels "
        f"{[tuple(p.shape[1:]) for p in levels]}, r=4, fp32: max |err| "
        f"{err:.3e} (tolerance {ATOL_FP32})")
    if not err <= ATOL_FP32:
        raise AssertionError(f"{label}: lookup |err| {err}")
    grad = torch.randn(got.shape, generator=g).to(dev)
    out["kernels"] = {
        "corr_lookup": {label: lookup_record(torch, levels, coords, 4, err,
                                             flush)},
        "corr_lookup_backward": {label: backward_record(
            torch, levels, coords, grad, 4, flush, label)}}
    for kname, recs in out["kernels"].items():
        rec = recs[label]
        log(f"[15 kernels] [{tag}] {kname} at {label}, levels "
            f"{rec['levels']}, r=4, fp32, L2 flushed per launch: "
            f"{rec['ms']:.4f} ms by CUDA events, "
            f"{fmt_ms(rec['profiler_ms'])} device time by the profiler; "
            f"plain {rec['plain_ms']:.4f} ms; library "
            f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.5f} ms "
            f"by {rec['bound_by']} ({rec['bound_bytes']} bytes), kernel "
            f"at {rec['bound_ms'] / rec['ms']:.1%} of it")
    del got, grad, coords, levels
    torch.cuda.empty_cache()
    log(f"[15 kernels] {time.perf_counter() - t0:.1f} s")
    return out


def alt_corr_ms(torch, model, images):
    """Device ms of the ``AltCorrBlock`` lookups within one eval forward of
    ``images``, by CUDA events around each call (the calls' kernels run in
    order on the one stream), and the number of calls."""
    from ptlflow_tpu_torch.ops import correlation as corr

    call = corr.AltCorrBlock.__call__
    spans = []

    def timed(self, coords):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = call(self, coords)
        end.record()
        spans.append((start, end))
        return out

    corr.AltCorrBlock.__call__ = timed
    try:
        model({"images": images})
        torch.cuda.synchronize()
    finally:
        corr.AltCorrBlock.__call__ = call
    return sum(a.elapsed_time(b) for a, b in spans), len(spans)


def slice14_phase(torch, dev, tag: str) -> dict:
    """Phase 16: MatchFlow (+RAFT), SCV (4, 8), MS-RAFT+ and CCMR (+) on the
    card at their registered depths (S14_SERVE), fp32, TF32 off.  Serves 3
    consecutive pairs of one sequence at 436x1024 through each, each
    warm-started from the last's ``flow_small``, counting 32 lookup
    launches a forward for MatchFlow and none for SCV and the AltCorrBlock
    defaults, and asserting no autograd graph; times each fp32 forward
    with its peak memory (the AltCorrBlock lookups' device ms by CUDA
    events around each call); holds the card against the CPU at 256x320
    for every name, the CPU taking the card's top-k selections
    (``TopkReplay``) and the differing selections counted; builds
    ``ms_raft_p``, ``ccmr`` and ``ccmr_p`` with ``alternate_corr=False``,
    whose CorrBlock launches the lookup kernel once an iteration, and
    holds their flows to the AltCorrBlock defaults' at 256x320, and
    ``ccmr``'s at 436x1024 too; one train step at 128x160 card against
    CPU (S14_STEP_CHECK); trains S14_TRAIN at TRAIN_H x TRAIN_W at the
    first of each one's batches that fits (unprofiled); and both kernels
    against their plain versions and timed at ``ccmr``'s CorrBlock pyramid
    at 436x1024 (its 1/4 scale, padded to 448x1024: Q = 28,672 on 112x256
    and 56x128)."""
    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {},
           "card_vs_cpu_px": {}, "topk_rows_differing": {},
           "alt_corr_ms": {}, "dense_vs_alt_px": {}}
    dense_depth = dict(S14_DENSE)
    frames = smooth_frames(161, H, W, 4, shift=(2, 1))
    calib_frames = smooth_frames(162, H, W, 2, shift=(2, 1))
    for name, depth in S14_SERVE:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        calib = IOAdapter(model).prepare_inputs(calib_frames)["images"]
        parity_weights(torch, name, model, calib)
        if name not in S14_UNDAMPED:
            damp_to_served_size(torch, name, model, calib)
        n, x = serve_sequence(torch, name, model, frames, depth,
                              (1, 1, 2, H, W), 16, window=2, warm=True)
        key = f"{name} serve at {W}x{H}, 3 pairs"
        out["launches"][key] = n
        if n != 3 * depth:
            raise AssertionError(f"{key}: {n} lookup launches")
        label = f"{name} fp32"
        time_forward(torch, model, x["images"], label, tag,
                     f"{depth} lookups", 16, out,
                     reps=FWD_REPS, warmups=FWD_WARMUPS, profiled=False)
        if name in dense_depth:
            ms, calls = alt_corr_ms(torch, model, x["images"])
            fwd_ms = out["forward_ms"][label]
            out["alt_corr_ms"][label] = [ms, calls, ms / fwd_ms]
            log(f"[16 forward] [{tag}] {label}: {calls} AltCorrBlock lookups "
                f"take {ms:.3f} ms by CUDA events around each call, "
                f"{ms / fwd_ms:.1%} of the {fwd_ms:.3f} ms forward")
        if name == "ccmr":
            # the CorrBlock route at full size: the lookup kernel on its
            # 1/16-1/4 pyramids (the 1/4 volume is 4.1 GB)
            dense = ptlflow_tpu_torch.get_model(
                name, args={"alternate_corr": False})
            dense.load_state_dict(model.state_dict())
            corr.corr_lookup_kernel.launches = 0
            got = dense({"images": x["images"]})["flows"]
            torch.cuda.synchronize()
            nd = corr.corr_lookup_kernel.launches
            want = model({"images": x["images"]})["flows"]
            diff = (got - want).abs().max().item()
            out["dense_vs_alt_px"][f"{name} at {W}x{H}"] = diff
            out["launches"][f"{name} alternate_corr=False at {W}x{H}"] = nd
            log(f"[16 dense vs alt] {name} at {W}x{H}, CorrBlock (the lookup "
                f"kernel, {nd} launches) against AltCorrBlock: max |dflow| "
                f"{diff:.3e} px (tolerance {ATOL_CARD_CPU_PX} px)")
            if nd != dense_depth[name] or not diff <= ATOL_CARD_CPU_PX:
                raise AssertionError(f"{name} CorrBlock route: {nd} "
                                     f"launches, {diff} px")
            del dense, got, want
        log(f"[16 serve] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"timing")
        del model, x
        torch.cuda.empty_cache()

    # card against CPU at 256x320, the registered depths, the CPU on the
    # card's top-k selections; the CorrBlock route against AltCorrBlock
    t0 = time.perf_counter()
    pair = smooth_frames(7, 256, 320, 2, shift=(3, 2))
    x = IOAdapter(device="cpu").prepare_inputs(pair)
    xd = x["images"].to(dev)
    for name in S14_NAMES:
        gpu_model, cpu_model = card_and_cpu(torch, name, xd,
                                            served=name not in S14_UNDAMPED)
        replay = TopkReplay(torch)
        with replay.record():
            got = gpu_model({"images": xd})["flows"]
        with replay.replay():
            want = cpu_model(x)["flows"]
        diff = (got.cpu() - want).abs().max().item()
        out["card_vs_cpu_px"][name] = diff
        out["topk_rows_differing"][name] = [replay.differ, replay.rows]
        log(f"[16 card vs cpu] {name} 256x320: max |dflow| {diff:.3e} px "
            f"(flow up to {want.abs().max().item():.2f} px, tolerance "
            f"{ATOL_CARD_CPU_PX} px); {replay.differ} of {replay.rows} "
            f"top-k selections differ, the CPU took the card's")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        if name in dense_depth:
            dense = ptlflow_tpu_torch.get_model(
                name, args={"alternate_corr": False})
            dense.load_state_dict(gpu_model.state_dict())
            corr.corr_lookup_kernel.launches = 0
            got_dense = dense({"images": xd})["flows"]
            torch.cuda.synchronize()
            nd = corr.corr_lookup_kernel.launches
            diff = (got_dense - got).abs().max().item()
            out["dense_vs_alt_px"][f"{name} at 320x256"] = diff
            out["launches"][f"{name} alternate_corr=False at 320x256"] = nd
            log(f"[16 dense vs alt] {name} 256x320, CorrBlock (the lookup "
                f"kernel, {nd} launches) against AltCorrBlock on the card: "
                f"max |dflow| {diff:.3e} px (tolerance {ATOL_CARD_CPU_PX} "
                f"px)")
            if nd != dense_depth[name] or not diff <= ATOL_CARD_CPU_PX:
                raise AssertionError(f"{name} CorrBlock route: {nd} "
                                     f"launches, {diff} px")
            del dense, got_dense
        del cpu_model, gpu_model, got, want
    del xd
    log(f"[16 card vs cpu] {time.perf_counter() - t0:.1f} s")

    # one train step card against CPU at 128x160, 2 iterations (a scale)
    t0 = time.perf_counter()
    out["train_step_card_vs_cpu"] = {
        name: train_step_card_vs_cpu(torch, name, dev, args, launches,
                                     batch_seed=seed)
        for name, args, launches, seed in S14_STEP_CHECK}
    log(f"[16 train step card vs cpu] {time.perf_counter() - t0:.1f} s")

    # training at 368x496 at the first batch that fits
    out["train"] = {}
    for name, launches, batches in S14_TRAIN:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        batch = train_batch(torch, 16, 2, TRAIN_H, TRAIN_W, dev)
        parity_weights(torch, name, model, batch["images"])
        del batch
        tx = ttrain.make_optimizer(lr=4e-4, wdecay=1e-4, total_steps=120000,
                                   pct_start=0.05, grad_clip=1.0)
        out["train"][name] = train_at_largest_batch(
            torch, dev, tag, model, tx, batches, S14_TRAIN_STEPS,
            launches[0], name, 16, level_shapes=lambda b: [],
            profile_runs=0, launches=launches)
        log(f"[16 train] {name}: {time.perf_counter() - t0:.1f} s")
        del model, tx
        torch.cuda.empty_cache()

    # both kernels at ccmr's CorrBlock pyramid at 1024x448 (its 1/4 scale:
    # 96 channels, 2 levels)
    t0 = time.perf_counter()
    hq, wq = -(-H // 32) * 8, -(-W // 32) * 8
    flush = flushes(torch, dev)["dirty"]
    g = torch.Generator().manual_seed(16)
    f1 = torch.randn(1, 96, hq, wq, generator=g).to(dev)
    f2 = torch.randn(1, 96, hq, wq, generator=g).to(dev) + 0.5 * f1
    levels = corr.build_corr_pyramid(f1, f2, 2)
    del f1, f2
    coords = (torch.rand(1, 2, hq, wq, generator=g).to(dev) * 1.2 - 0.1) \
        * torch.tensor([wq, hq], device=dev).view(1, 2, 1, 1)
    label = f"ccmr CorrBlock 1/4 Q={hq * wq}"
    got = corr.corr_lookup_kernel(levels, coords, 4)
    err = (got - corr.corr_pyramid_lookup_plain(levels, coords, 4)).abs(
        ).max().item()
    log(f"[16 kernel vs plain] {label}, levels "
        f"{[tuple(p.shape[1:]) for p in levels]}, r=4, fp32: max |err| "
        f"{err:.3e} (tolerance {ATOL_FP32})")
    if not err <= ATOL_FP32:
        raise AssertionError(f"{label}: lookup |err| {err}")
    grad = torch.randn(got.shape, generator=g).to(dev)
    out["kernels"] = {
        "corr_lookup": {label: lookup_record(torch, levels, coords, 4, err,
                                             flush)},
        "corr_lookup_backward": {label: backward_record(
            torch, levels, coords, grad, 4, flush, label)}}
    for kname, recs in out["kernels"].items():
        rec = recs[label]
        log(f"[16 kernels] [{tag}] {kname} at {label}, levels "
            f"{rec['levels']}, r=4, fp32, L2 flushed per launch: "
            f"{rec['ms']:.4f} ms by CUDA events, "
            f"{fmt_ms(rec['profiler_ms'])} device time by the profiler; "
            f"plain {rec['plain_ms']:.4f} ms; library "
            f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.5f} ms "
            f"by {rec['bound_by']} ({rec['bound_bytes']} bytes), kernel "
            f"at {rec['bound_ms'] / rec['ms']:.1%} of it")
    del got, grad, coords, levels
    torch.cuda.empty_cache()
    log(f"[16 kernels] {time.perf_counter() - t0:.1f} s")
    return out


@contextlib.contextmanager
def timed_spans(torch, targets):
    """Within the block, each call of the functions ``targets`` ((module,
    attribute, label) each) runs in a ``record_function`` range named by
    its label and between two CUDA events (its kernels run in order on the
    one stream), appended to the yielded {label: [(start, end), ...]}."""
    from torch.profiler import record_function

    spans = {label: [] for _, _, label in targets}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def wrap(fn, label):
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with record_function(label):
                start.record()
                res = fn(*args, **kwargs)
                end.record()
            spans[label].append((start, end))
            return res
        return timed

    for (mod, attr, fn), (_, _, label) in zip(saved, targets):
        setattr(mod, attr, wrap(fn, label))
    try:
        yield spans
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def span_ms(torch, model, images, spans) -> dict:
    """Device ms and calls of each of ``timed_spans``' functions within
    one more eval forward of ``images``."""
    for recs in spans.values():
        recs.clear()
    model({"images": images})
    torch.cuda.synchronize()
    return {label: {"ms": sum(a.elapsed_time(b) for a, b in recs),
                    "calls": len(recs)} for label, recs in spans.items()}


def local_corr_card_vs_cpu(torch, dev, same: bool = False,
                           phase: int = 17) -> dict:
    """``local_correlation`` (unnormalised, as PWC calls it) and the
    gradients of both maps under a random cotangent, card against CPU at
    the LOCAL_CORR_CASES of two maps (or, where ``same``, of one map as
    both arguments, whose one gradient autograd sums from both), batch 1;
    the largest difference of the outputs, of each one's largest element,
    by case."""
    from ptlflow_tpu_torch.ops import local_correlation

    g = torch.Generator().manual_seed(173)
    res = {}
    for d, dil, st, c, h, w, one in LOCAL_CORR_CASES:
        if one != same:
            continue
        f1, f2 = (torch.randn(1, c, h, w, generator=g) for _ in range(2))
        cot = torch.randn(1, (2 * d + 1) ** 2, -(-h // st), -(-w // st),
                          generator=g)
        got = []
        for where in (dev, torch.device("cpu")):
            a, b = (t.to(where).requires_grad_() for t in (f1, f2))
            if same:
                b = a
            o = local_correlation(a, b, d, normalize=False, dilation=dil,
                                  stride=st)
            grads = torch.autograd.grad((o * cot.to(where)).sum(),
                                        (a,) if same else (a, b))
            got.append([t.detach().cpu() for t in (o, *grads)])
        rel = max((x - y).abs().max().item() / y.abs().max().item()
                  for x, y in zip(*got))
        key = (f"d={d} dilation={dil} stride={st} {c}x{h}x{w}"
               f"{' one map' if same else ''}")
        res[key] = rel
        log(f"[{phase} card vs cpu] local_correlation {key}: output and "
            f"{'its gradient' if same else 'both gradients'} max |d| / max "
            f"|v| {rel:.3e} (tolerance {RTOL_LOCAL_CORR})")
        if not rel <= RTOL_LOCAL_CORR:
            raise AssertionError(f"local_correlation {key}: {rel}")
    return res


def slice15_phase(torch, dev, tag: str) -> dict:
    """Phase 17: SeparableFlow, PWC-Net (+nodc) and IRR (``irr_pwc``,
    ``scopeflow``, ``irr_pwcnet``, ``irr_pwcnet_irr``) on the card at
    their registered depths (S15_SERVE), fp32, TF32 off.  Serves 3
    consecutive pairs of one sequence at 436x1024 through each, cold (none
    reads a previous prediction), counting 32 lookup launches a forward for
    SeparableFlow and none for the others, checking ``irr_pwc``'s and
    ``scopeflow``'s backward flows and occlusions; times each fp32 forward
    with its peak memory, with the device ms and calls of SeparableFlow's
    SGA and NLF recursions and of the PWC family's ``local_correlation``
    by CUDA events around their calls (``timed_spans``), profiles those of
    S15_PROFILED (the launches and kernel ms under the spans'
    ``record_function`` ranges too), and times the ``validate --bf16``
    casts of S15_BF16;
    holds the card against the CPU at 256x320 for every name
    (SeparableFlow's NLF-filtered volume and initial flow too), and
    ``local_correlation`` with its gradients at LOCAL_CORR_CASES; one train
    step card against CPU (S15_STEP_CHECK); trains
    S15_TRAIN at the first of S15_TRAIN_BATCHES that fits (unprofiled);
    and both kernels against their plain versions and timed at
    SeparableFlow's pyramid at 1024x448 (Q = 7168 on 56x128 ... 7x16) and
    its training pyramid (Q = 3072 x batch on 48x64 ... 6x8)."""
    import copy
    import importlib

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    sf = importlib.import_module(
        "ptlflow_tpu_torch.models.separableflow.separableflow")
    ca = importlib.import_module(
        "ptlflow_tpu_torch.models.separableflow.cost_agg")
    pwc = importlib.import_module("ptlflow_tpu_torch.models.pwcnet.pwcnet")
    irrm = importlib.import_module(
        "ptlflow_tpu_torch.models.irr.pwc_modules")
    spans = {"separableflow": [(ca, "sga", "sga"), (sf, "nlf_iter", "nlf")],
             "pwc": [(pwc, "local_correlation", "local_correlation")],
             "irr": [(irrm, "local_correlation", "local_correlation")]}
    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {},
           "spans": {}, "card_vs_cpu_px": {}, "separableflow_card_vs_cpu":
           {}}
    gemm = ("gemm", ("fprop", "dgrad", "wgrad", "conv", "implicit"))
    # cuBLAS (the NLF rows' products, the volume), cuDNN's implicit-GEMM
    # convolutions, the recursions' elementwise and reduction kernels
    named = {"GEMMs": gemm, "cuDNN fprop": "fprop",
             "elementwise": "elementwise_kernel", "reductions": "reduce",
             "cat": "CatArrayBatchedCopy"}
    frames = smooth_frames(171, H, W, 4, shift=(2, 1))
    calib = smooth_frames(172, H, W, 2, shift=(2, 1))
    for name, depth in S15_SERVE:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        parity_weights(torch, name, model, None)
        n, x = serve_sequence(torch, name, model, frames, depth,
                              (1, 1, 2, H, W), 17, window=2, warm=False)
        key = f"{name} serve at {W}x{H}, 3 pairs"
        out["launches"][key] = n
        if n != 3 * depth:
            raise AssertionError(f"{key}: {n} lookup launches")
        if name in ("irr_pwc", "scopeflow"):
            adapter = IOAdapter(model)
            res = adapter.unscale(model(adapter.prepare_inputs(calib)))
            check_flows(torch, name, {"flows": res["flows_b"]},
                        (1, 1, 2, H, W))
            for k in ("occs", "occs_b"):
                occ = res[k]
                if (tuple(occ.shape) != (1, 1, 1, H, W)
                        or not (0 <= occ.min() <= occ.max() <= 1)):
                    raise AssertionError(f"{name}: {k} {tuple(occ.shape)} "
                                         f"in [{occ.min()}, {occ.max()}]")
            log(f"[17 serve] {name}: flows_b {tuple(res['flows_b'].shape)} "
                f"finite, occs and occs_b {tuple(res['occs'].shape)} in "
                f"[{res['occs'].min().item():.3f}, "
                f"{res['occs'].max().item():.3f}] and "
                f"[{res['occs_b'].min().item():.3f}, "
                f"{res['occs_b'].max().item():.3f}]")
        label = f"{name} fp32"
        kind = ("separableflow" if name == "separableflow" else "pwc"
                if name.startswith("pwc") else "irr")
        with timed_spans(torch, spans[kind]) as recs:
            time_forward(torch, model, x["images"], label, tag,
                         f"{depth} lookups", 17, out, named,
                         reps=FWD_REPS, warmups=FWD_WARMUPS,
                         profiled=name in S15_PROFILED, ranges=list(recs),
                         profile_runs=1)
            rec = span_ms(torch, model, x["images"], recs)
        prof = out["profile"].get(label)
        out["spans"][label] = rec
        fwd_ms = out["forward_ms"][label]
        for span, r in rec.items():
            if prof is not None:
                r["launches"] = prof["range_launches"][span]
                r["kernel_ms"] = prof["range_kernel_ms"][span]
            log(f"[17 forward] [{tag}] {label}: {span} {r['calls']} calls, "
                f"{r['ms']:.3f} ms stream-elapsed by CUDA events around them "
                f"(the card's idle gaps included; {r['ms'] / fwd_ms:.1%} of "
                f"the {fwd_ms:.3f} ms forward)"
                + (f", {fmt_ms(r['kernel_ms'])} of kernel time under them by "
                   f"the profiler, {r['launches']} kernel launches"
                   if prof is not None else ""))
        if name in S15_BF16:
            cast = copy.deepcopy(model)
            if not cast_to_bf16(cast, name):
                raise AssertionError(f"{name}: not on the allow-list")
            time_forward(torch, cast, x["images"], f"{name} bf16 cast", tag,
                         f"{depth} lookups", 17, out, named,
                         reps=FWD_REPS, warmups=FWD_WARMUPS, profiled=False)
            del cast
        log(f"[17 serve] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"timing")
        del model, x
        torch.cuda.empty_cache()

    # card against CPU at 256x320, the registered depths; SeparableFlow's
    # NLF-filtered volume and initial flow too
    t0 = time.perf_counter()
    pair = smooth_frames(7, 256, 320, 2, shift=(3, 2))
    x = IOAdapter(device="cpu").prepare_inputs(pair)
    xd = x["images"].to(dev)
    nlf = sf.nlf_volume
    for name in S15_NAMES:
        gpu_model, cpu_model = card_and_cpu(torch, name, xd, served=False)
        seen = {}
        if name == "separableflow":
            def keep(corr_, guid, where=seen):
                res = nlf(corr_, guid)
                where["nlf"] = res.detach().cpu()
                return res

            def init(mod, args, res, where=seen):
                where.setdefault("init", []).append(res[-2].detach().cpu())

            sf.nlf_volume = keep
            hooks = [m.register_forward_hook(init) for model in (
                gpu_model, cpu_model) for m in (model.cost_agg1,
                                                model.cost_agg2)]
        try:
            got = gpu_model({"images": xd})["flows"].cpu()
            card = dict(seen)
            seen.clear()
            want = cpu_model(x)["flows"]
        finally:
            sf.nlf_volume = nlf
            if name == "separableflow":
                for h in hooks:
                    h.remove()
        diff = (got - want).abs().max().item()
        out["card_vs_cpu_px"][name] = diff
        log(f"[17 card vs cpu] {name} 256x320: max |dflow| {diff:.3e} px "
            f"(flow up to {want.abs().max().item():.2f} px, tolerance "
            f"{ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        if name == "separableflow":
            vol = (card["nlf"] - seen["nlf"]).abs().max().item() / max(
                seen["nlf"].abs().max().item(), 1e-30)
            fi = max((a - b).abs().max().item()
                     for a, b in zip(card["init"], seen["init"]))
            out["separableflow_card_vs_cpu"] = {"nlf_rel": vol,
                                                "flow_init_px": fi}
            log(f"[17 card vs cpu] separableflow 256x320: NLF-filtered "
                f"volume {tuple(seen['nlf'].shape)} max |d| / max |v| "
                f"{vol:.3e} (tolerance {RTOL_NLF}); the U-Nets' initial "
                f"flow (u, v at 8x) max |d| {fi:.3e} px (tolerance "
                f"{ATOL_CARD_CPU_PX} px)")
            if not (vol <= RTOL_NLF and fi <= ATOL_CARD_CPU_PX):
                raise AssertionError(f"separableflow: NLF {vol}, initial "
                                     f"flow {fi} px")
        del cpu_model, gpu_model, got, want
    del xd
    out["local_corr_card_vs_cpu"] = local_corr_card_vs_cpu(torch, dev)
    log(f"[17 card vs cpu] {time.perf_counter() - t0:.1f} s")

    # one train step card against CPU
    t0 = time.perf_counter()
    out["train_step_card_vs_cpu"] = {
        name: train_step_card_vs_cpu(torch, name, dev, args, launches,
                                     batch_seed=seed, size=size)
        for name, args, launches, seed, size in S15_STEP_CHECK}
    log(f"[17 train step card vs cpu] {time.perf_counter() - t0:.1f} s")

    # training at the first batch that fits
    out["train"] = {}
    for name, size, launches in S15_TRAIN:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        parity_weights(torch, name, model, None)
        tx = ttrain.make_optimizer(lr=4e-4, wdecay=1e-4, total_steps=120000,
                                   pct_start=0.05, grad_clip=1.0)
        out["train"][name] = train_at_largest_batch(
            torch, dev, tag, model, tx, S15_TRAIN_BATCHES, S15_TRAIN_STEPS,
            launches[0], name, 17, size=size, level_shapes=lambda b: [],
            profile_runs=0, launches=launches)
        out["train"][name]["size"] = list(size)
        log(f"[17 train] {name}: {time.perf_counter() - t0:.1f} s")
        del model, tx
        torch.cuda.empty_cache()

    # both kernels: the forward at separableflow's pyramid at 1024x448, the
    # backward at its training pyramid at the batch that fit
    t0 = time.perf_counter()
    flush = flushes(torch, dev)["dirty"]
    g = torch.Generator().manual_seed(17)
    out["kernels"] = {"corr_lookup": {}, "corr_lookup_backward": {}}
    hp, wp = -(-H // 64) * 8, -(-W // 64) * 8
    th, tw = -(-TRAIN_H // 64) * 8, -(-TRAIN_W // 64) * 8
    b = out["train"]["separableflow"]["batch"]
    for kname, (n, h, w) in (("corr_lookup", (1, hp, wp)),
                             ("corr_lookup_backward", (b, th, tw))):
        f1 = torch.randn(n, 256, h, w, generator=g).to(dev)
        f2 = torch.randn(n, 256, h, w, generator=g).to(dev) + 0.5 * f1
        levels = corr.build_corr_pyramid(f1, f2, 4)
        del f1, f2
        coords = (torch.rand(n, 2, h, w, generator=g).to(dev) * 1.2 - 0.1) \
            * torch.tensor([w, h], device=dev).view(1, 2, 1, 1)
        label = (f"separableflow Q={n * h * w}" if n == 1 else
                 f"separableflow train Q={n * h * w}")
        got = corr.corr_lookup_kernel(levels, coords, 4)
        err = (got - corr.corr_pyramid_lookup_plain(levels, coords, 4)).abs(
            ).max().item()
        log(f"[17 kernel vs plain] {label}, levels "
            f"{[tuple(p.shape[1:]) for p in levels]}, r=4, fp32: max |err| "
            f"{err:.3e} (tolerance {ATOL_FP32})")
        if not err <= ATOL_FP32:
            raise AssertionError(f"{label}: lookup |err| {err}")
        if kname == "corr_lookup":
            rec = lookup_record(torch, levels, coords, 4, err, flush)
        else:
            grad = torch.randn(got.shape, generator=g).to(dev)
            rec = backward_record(torch, levels, coords, grad, 4, flush,
                                  label)
            del grad
        out["kernels"][kname][label] = rec
        log(f"[17 kernels] [{tag}] {kname} at {label}, levels "
            f"{rec['levels']}, r=4, fp32, L2 flushed per launch: "
            f"{rec['ms']:.4f} ms by CUDA events, "
            f"{fmt_ms(rec['profiler_ms'])} device time by the profiler; "
            f"plain {rec['plain_ms']:.4f} ms; library "
            f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.5f} ms "
            f"by {rec['bound_by']} ({rec['bound_bytes']} bytes), kernel "
            f"at {rec['bound_ms'] / rec['ms']:.1%} of it")
        del got, coords, levels
        torch.cuda.empty_cache()
    log(f"[17 kernels] {time.perf_counter() - t0:.1f} s")
    return out


def slice16_phase(torch, dev, tag: str) -> dict:
    """Phase 18: FlowNet (``flownets``, ``flownetc``, ``flownetsd``,
    ``flownetcs``, ``flownetcss``, ``flownet2``), LiteFlowNet
    (``liteflownet``, ``liteflownet2`` (+``_pseudoreg``), ``liteflownet3``,
    ``liteflownet3s`` (each +``_pseudoreg``)) and FastFlowNet on the card,
    fp32, TF32 off, their flow heads damped (``condition_slice16``).
    Serves 3 consecutive pairs of one sequence at 436x1024 through each,
    cold, counting no lookup launch and checking no autograd graph (and
    LiteFlowNet3's ``confs``); times each fp32 forward with its peak memory,
    with the device ms and calls of ``local_correlation`` by CUDA events
    around its calls (``timed_spans``), profiles the forwards of
    S16_PROFILED once each (kernel ms, launches, idle share,
    ``local_correlation``'s kernel ms and launches under its range), and
    times the ``validate --bf16`` casts of S16_BF16 with their mean |flow|
    difference from fp32; holds the card against the CPU at 256x320 for
    every name (flows and ``confs``) and ``local_correlation`` with its
    gradient on LiteFlowNet3's self-correlation (LOCAL_CORR_CASES); one
    train step card against CPU (S16_STEP_CHECK); and trains S16_TRAIN at
    384x512 at the first of S16_TRAIN_BATCHES that fits (unprofiled)."""
    import copy
    import importlib

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.scripts.validate import cast_to_bf16
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    # the module whose ``local_correlation`` each family calls
    lfn = importlib.import_module(
        "ptlflow_tpu_torch.models.liteflownet.liteflownet")
    modules = {"flownet": importlib.import_module(
        "ptlflow_tpu_torch.models.flownet.flownet"), "liteflownet": lfn,
        "liteflownet23": lfn, "fastflownet": importlib.import_module(
            "ptlflow_tpu_torch.models.fastflownet.fastflownet")}
    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {}, "spans": {},
           "bf16_mean_abs_diff_px": {}, "card_vs_cpu_px": {},
           "confs_card_vs_cpu": {}}
    # cuDNN's convolution kernels, the correlation's unfold (im2col),
    # product and sum, the warps' samplers (PyTorch's or cuDNN's)
    named = {"cuDNN fprop": "fprop", "im2col": "im2col",
             "elementwise": "elementwise_kernel", "reductions": "reduce",
             "samplers": "sampler", "cat": "CatArrayBatchedCopy"}
    frames = smooth_frames(181, H, W, 4, shift=(2, 1))
    for name in S16_NAMES:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name, args=S16_ARGS.get(name))
        parity_weights(torch, name, model, None)
        n, x = serve_sequence(torch, name, model, frames, 0,
                              (1, 1, 2, H, W), 18, window=2, warm=False)
        key = f"{name} serve at {W}x{H}, 3 pairs"
        out["launches"][key] = n
        if n != 0:
            raise AssertionError(f"{key}: {n} lookup launches")
        if name.startswith("liteflownet3"):
            adapter = IOAdapter(model)
            res = adapter.unscale(model(adapter.prepare_inputs(frames[:2])))
            conf = res["confs"]
            if (tuple(conf.shape) != (1, 1, 1, H, W)
                    or not (0 <= conf.min() <= conf.max() <= 1)
                    or conf.grad_fn is not None):
                raise AssertionError(f"{name}: confs {tuple(conf.shape)} in "
                                     f"[{conf.min()}, {conf.max()}]")
            log(f"[18 serve] {name}: confs {tuple(conf.shape)} in "
                f"[{conf.min().item():.3f}, {conf.max().item():.3f}]")
        label = f"{name} fp32"
        correlates = name not in ("flownets", "flownetsd")
        spans = ([(modules[s16_family(name)], "local_correlation",
                   "local_correlation")] if correlates else [])
        profiled = name in S16_PROFILED
        with timed_spans(torch, spans) as recs:
            time_forward(torch, model, x["images"], label, tag,
                         "no lookups", 18, out, named, reps=FWD_REPS,
                         warmups=FWD_WARMUPS, profiled=profiled,
                         ranges=list(recs), profile_runs=1)
            rec = span_ms(torch, model, x["images"], recs) if spans else {}
        fwd_ms = out["forward_ms"][label]
        for span, r in rec.items():
            if profiled:
                prof = out["profile"][label]
                r["launches"] = prof["range_launches"][span]
                r["kernel_ms"] = prof["range_kernel_ms"][span]
            log(f"[18 forward] [{tag}] {label}: {span} {r['calls']} calls, "
                f"{r['ms']:.3f} ms stream-elapsed by CUDA events around them "
                f"(the card's idle gaps included; {r['ms'] / fwd_ms:.1%} of "
                f"the {fwd_ms:.3f} ms forward)"
                + (f", {fmt_ms(r['kernel_ms'])} of kernel time under them by "
                   f"the profiler, {r['launches']} kernel launches"
                   if profiled else ""))
        out["spans"][label] = rec
        if name in S16_BF16:
            cast = copy.deepcopy(model)
            if not cast_to_bf16(cast, name):
                raise AssertionError(f"{name}: not on the allow-list")
            time_forward(torch, cast, x["images"], f"{name} bf16 cast", tag,
                         "no lookups", 18, out, named, reps=FWD_REPS,
                         warmups=FWD_WARMUPS, profiled=False)
            with torch.no_grad():
                diff = (cast({"images": x["images"]})["flows"]
                        - model({"images": x["images"]})["flows"]).abs()
            out["bf16_mean_abs_diff_px"][name] = diff.mean().item()
            log(f"[18 forward] [{tag}] {name} bf16 cast: mean |dflow| "
                f"{diff.mean().item():.4e} px, max {diff.max().item():.4e} px "
                f"against the fp32 forward")
            del cast
        log(f"[18 serve] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"timing")
        del model, x
        torch.cuda.empty_cache()

    # card against CPU at 256x320; LiteFlowNet3's confs too
    t0 = time.perf_counter()
    pair = smooth_frames(7, 256, 320, 2, shift=(3, 2))
    x = IOAdapter(device="cpu").prepare_inputs(pair)
    xd = x["images"].to(dev)
    for name in S16_NAMES:
        gpu_model, cpu_model = card_and_cpu(torch, name, xd, served=False)
        got = gpu_model({"images": xd})
        want = cpu_model(x)
        diff = (got["flows"].cpu() - want["flows"]).abs().max().item()
        out["card_vs_cpu_px"][name] = diff
        extra = ""
        if "confs" in want:
            cd = (got["confs"].cpu() - want["confs"]).abs().max().item()
            out["confs_card_vs_cpu"][name] = cd
            extra = f"; confs max |d| {cd:.3e} (tolerance {ATOL_CONFS})"
            if not cd <= ATOL_CONFS:
                raise AssertionError(f"{name}: confs differ by {cd}")
        log(f"[18 card vs cpu] {name} 256x320: max |dflow| {diff:.3e} px "
            f"(flow up to {want['flows'].abs().max().item():.2f} px, "
            f"tolerance {ATOL_CARD_CPU_PX} px){extra}")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        del cpu_model, gpu_model, got, want
    del xd
    out["local_corr_card_vs_cpu"] = local_corr_card_vs_cpu(torch, dev, True,
                                                           18)
    log(f"[18 card vs cpu] {time.perf_counter() - t0:.1f} s")

    # one train step card against CPU
    t0 = time.perf_counter()
    out["train_step_card_vs_cpu"] = {
        name: train_step_card_vs_cpu(torch, name, dev, S16_ARGS.get(name, {}),
                                     (0, 0), batch_seed=seed, size=size)
        for name, seed, size in S16_STEP_CHECK}
    log(f"[18 train step card vs cpu] {time.perf_counter() - t0:.1f} s")

    # training at the first batch that fits
    out["train"] = {}
    for name in S16_TRAIN:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name, args=S16_ARGS.get(name))
        parity_weights(torch, name, model, None)
        tx = ttrain.make_optimizer(lr=1e-4, wdecay=4e-4, total_steps=120000,
                                   pct_start=0.05, grad_clip=1.0)
        out["train"][name] = train_at_largest_batch(
            torch, dev, tag, model, tx, S16_TRAIN_BATCHES, S16_TRAIN_STEPS,
            0, name, 18, size=S16_TRAIN_SIZE, level_shapes=lambda b: [],
            profile_runs=0, launches=(0, 0))
        out["train"][name]["size"] = list(S16_TRAIN_SIZE)
        log(f"[18 train] {name}: {time.perf_counter() - t0:.1f} s")
        del model, tx
        torch.cuda.empty_cache()
    return out


def deform_conv_card_vs_cpu(torch, dev, tag: str) -> dict:
    """The deformable convolution at MaskFlowNet's 1/4 level at 1024x436
    (resized to 1024x448: 32 channels of 112x256), offsets of a few
    pixels, some past the edges: its output and the gradients of the map,
    the offsets, the weight and the bias under a random cotangent, card
    against CPU, by each tensor's largest element; and its forward and
    forward-plus-backward ms on the card by CUDA events.  The offsets'
    fractions lie in [0.1, 0.9]: bilinear sampling's gradient in its
    coordinates jumps where a coordinate crosses a whole pixel, and the
    card and the CPU round a coordinate within ~1e-6 px of one to
    different cells (with unbounded fractions, the offsets' gradient was
    0.30 of its largest element apart at one such tap on an H100)."""
    from ptlflow_tpu_torch.ops.deform_conv import deform_conv2d

    g = torch.Generator().manual_seed(191)
    b, c, h, w = 1, 32, 112, 256
    x = torch.randn(b, c, h, w, generator=g)
    off = (torch.floor(3.0 * torch.randn(b, 18, h, w, generator=g))
           + 0.1 + 0.8 * torch.rand(b, 18, h, w, generator=g))
    weight = torch.randn(c, c, 3, 3, generator=g) / (9 * c) ** 0.5
    bias = torch.randn(c, generator=g)
    cot = torch.randn(b, c, h, w, generator=g)
    got = []
    for where in (dev, torch.device("cpu")):
        args = [t.to(where).requires_grad_() for t in (x, off, weight, bias)]
        out = deform_conv2d(*args)
        grads = torch.autograd.grad((out * cot.to(where)).sum(), args)
        got.append([t.detach().cpu() for t in (out, *grads)])
    names = ("output", "x", "offset", "weight", "bias")
    rel = {n: (a - r).abs().max().item() / r.abs().max().item()
           for n, a, r in zip(names, *got)}
    log(f"[19 card vs cpu] deform_conv2d {c}x{h}x{w}: max |d| / max |v| "
        + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
        + f" (tolerance {RTOL_DEFORM})")
    if not all(v <= RTOL_DEFORM for v in rel.values()):
        raise AssertionError(f"deform_conv2d card vs CPU: {rel}")
    args = [t.to(dev) for t in (x, off, weight, bias)]
    fwd_ms = timed_ms(torch, lambda: deform_conv2d(*args), 10)
    leaves = [t.requires_grad_() for t in args]
    cd = cot.to(dev)

    def fwd_bwd():
        torch.autograd.grad((deform_conv2d(*leaves) * cd).sum(), leaves)

    bwd_ms = timed_ms(torch, fwd_bwd, 10)
    log(f"[19 forward] [{tag}] deform_conv2d {c}x{h}x{w}: {fwd_ms:.3f} ms "
        f"forward, {bwd_ms:.3f} ms forward and backward by CUDA events "
        f"(median of 10)")
    return {"rel_err": rel, "ms": fwd_ms, "fwd_bwd_ms": bwd_ms,
            "shape": [b, c, h, w]}


def slice17_phase(torch, dev, tag: str) -> dict:
    """Phase 19: MaskFlowNet (``maskflownet_s``, ``maskflownet``), HD3
    (``hd3``, ``hd3_ctxt``), STaRFlow and DICL on the card, fp32, TF32
    off, conditioned as their CPU tests are (``condition_slice17``).
    Serves 3 cold pairs of one sequence at 436x1024 through each
    (STaRFlow: 3 windows of 4 frames), counting no lookup launch and
    checking no autograd graph, ``occs`` and STaRFlow's backward outputs;
    times each fp32 forward with the device ms and calls of its
    deformable convolutions, correlations, densities or matching volumes
    by CUDA events around their calls (``timed_spans``), profiles the
    forwards of S17_PROFILED once each; holds the deformable convolution
    and its gradients (``deform_conv_card_vs_cpu``) and every name's
    flows (and occlusions) at 256x320 card against CPU, HD3's argmax
    cells replayed on the CPU (``ArgmaxReplay``); one train step card
    against CPU (S17_STEP_CHECK); and trains S17_TRAIN at 384x512 at the
    first of S17_TRAIN_BATCHES that fits (unprofiled)."""
    import importlib

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    dcn = importlib.import_module("ptlflow_tpu_torch.ops.deform_conv")
    mfn = importlib.import_module(
        "ptlflow_tpu_torch.models.maskflownet.maskflownet")
    hd3 = importlib.import_module("ptlflow_tpu_torch.models.hd3.hd3")
    sfm = importlib.import_module("ptlflow_tpu_torch.models.starflow.starflow")
    dicl = importlib.import_module("ptlflow_tpu_torch.models.dicl.dicl")
    spans_of = {
        "maskflownet": [(dcn, "deform_conv2d", "deform_conv2d"),
                        (mfn, "local_correlation", "local_correlation")],
        "hd3": [(hd3, "density2vector", "density2vector"),
                (hd3, "local_correlation", "local_correlation"),
                (hd3, "hd3_flow_warp", "hd3_flow_warp")],
        "starflow": [(sfm, "compute_cost_volume", "local_correlation")],
        "dicl": [(dicl.DICL, "compute_cost", "matching_volume"),
                 (dicl, "flow_regression", "flow_regression")]}
    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {}, "spans": {},
           "card_vs_cpu_px": {}, "occs_card_vs_cpu": {}}
    # cuDNN's convolution kernels, the samplers (the deformable
    # convolution's taps, the warps), the correlation's unfold, products
    # and sums, softmaxes, gathers and scatters, concatenations
    named = {"cuDNN fprop": "fprop", "samplers": "sampler",
             "im2col": "im2col", "elementwise": "elementwise_kernel",
             "reductions": "reduce", "softmax": "softmax",
             "gather/scatter": "scatter_gather", "cat": "CatArrayBatchedCopy"}
    frames = smooth_frames(191, H, W, 6, shift=(2, 1))
    for name in S17_NAMES:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        window = S17_WINDOW.get(name, 2)
        seq = frames[:window + 2]
        parity_weights(torch, name, model,
                       IOAdapter(model).prepare_inputs(seq[:window])["images"])
        n, x = serve_sequence(torch, name, model, seq, 0,
                              (1, window - 1, 2, H, W), 19, window=window,
                              warm=False)
        key = f"{name} serve at {W}x{H}, 3 windows of {window} frames"
        out["launches"][key] = n
        if n != 0:
            raise AssertionError(f"{key}: {n} lookup launches")
        if name in ("maskflownet_s", "starflow"):
            adapter = IOAdapter(model)
            with torch.no_grad():
                res = adapter.unscale(model(adapter.prepare_inputs(
                    seq[:window])))
            for k in ("occs", "flows_b", "occs_b"):
                if k not in res:
                    continue
                v = res[k]
                want = (1, window - 1, 1 + k.startswith("flow"), H, W)
                if (tuple(v.shape) != want or not torch.isfinite(v).all()
                        or v.grad_fn is not None or (k.startswith("occ") and
                                                     not 0 <= v.min() <= v.max() <= 1)):
                    raise AssertionError(f"{name}: {k} {tuple(v.shape)} in "
                                         f"[{v.min()}, {v.max()}]")
                log(f"[19 serve] {name}: {k} {tuple(v.shape)} finite, in "
                    f"[{v.min().item():.3f}, {v.max().item():.3f}]")
        label = f"{name} fp32"
        profiled = name in S17_PROFILED
        with timed_spans(torch, spans_of[s17_family(name)]) as recs:
            time_forward(torch, model, x["images"], label, tag,
                         "no lookups", 19, out, named, reps=FWD_REPS,
                         warmups=FWD_WARMUPS, profiled=profiled,
                         ranges=list(recs), profile_runs=1)
            rec = span_ms(torch, model, x["images"], recs)
        fwd_ms = out["forward_ms"][label]
        for span, r in rec.items():
            if profiled:
                prof = out["profile"][label]
                r["launches"] = prof["range_launches"][span]
                r["kernel_ms"] = prof["range_kernel_ms"][span]
            log(f"[19 forward] [{tag}] {label}: {span} {r['calls']} calls, "
                f"{r['ms']:.3f} ms stream-elapsed by CUDA events around them "
                f"(the card's idle gaps included; {r['ms'] / fwd_ms:.1%} of "
                f"the {fwd_ms:.3f} ms forward)"
                + (f", {fmt_ms(r['kernel_ms'])} of kernel time under them by "
                   f"the profiler, {r['launches']} kernel launches"
                   if profiled else ""))
        out["spans"][label] = rec
        log(f"[19 serve] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"timing")
        del model, x
        torch.cuda.empty_cache()

    # card against CPU: the deformable convolution, then every name at
    # 256x320, HD3's argmax cells replayed
    t0 = time.perf_counter()
    out["deform_conv"] = deform_conv_card_vs_cpu(torch, dev, tag)
    out["argmax_differing"] = {}
    for name in S17_NAMES:
        window = S17_WINDOW.get(name, 2) - 1
        seq = smooth_frames(7, 256, 320, window + 1, shift=(3, 2))
        x = IOAdapter(device="cpu").prepare_inputs(seq)
        xd = x["images"].to(dev)
        gpu_model, cpu_model = card_and_cpu(torch, name, xd, served=False)
        replay = ArgmaxReplay(torch)
        with replay.record():
            got = gpu_model({"images": xd})
        with replay.replay():
            want = cpu_model(x)
        if replay.elements:
            out["argmax_differing"][name] = [replay.differ, replay.elements]
        diff = max((got[k].cpu() - want[k]).abs().max().item()
                   for k in want if k.startswith("flows"))
        out["card_vs_cpu_px"][name] = diff
        extra = ""
        occ = [k for k in want if k.startswith("occs")]
        if occ:
            od = max((got[k].cpu() - want[k]).abs().max().item()
                     for k in occ)
            out["occs_card_vs_cpu"][name] = od
            extra = (f"; {' and '.join(occ)} max |d| {od:.3e} (tolerance "
                     f"{ATOL_OCCS})")
            if not od <= ATOL_OCCS:
                raise AssertionError(f"{name}: occlusions differ by {od}")
        if replay.elements:
            extra += (f"; {replay.differ} of {replay.elements} argmax cells "
                      f"differ on the CPU's own, the CPU took the card's")
        log(f"[19 card vs cpu] {name} 256x320: max |dflow| {diff:.3e} px "
            f"(flow up to {want['flows'].abs().max().item():.2f} px, "
            f"tolerance {ATOL_CARD_CPU_PX} px){extra}")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        del cpu_model, gpu_model, got, want, xd
    log(f"[19 card vs cpu] {time.perf_counter() - t0:.1f} s")

    # one train step card against CPU
    t0 = time.perf_counter()
    out["train_step_card_vs_cpu"] = {
        name: train_step_card_vs_cpu(
            torch, name, dev, {}, (0, 0), batch_seed=seed, size=size,
            ill_conditioned=ill)
        for name, seed, size, ill in S17_STEP_CHECK}
    log(f"[19 train step card vs cpu] {time.perf_counter() - t0:.1f} s")

    # training at the first batch that fits
    out["train"] = {}
    for name in S17_TRAIN:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        parity_weights(torch, name, model, None)
        tx = ttrain.make_optimizer(lr=1e-4, wdecay=4e-4, total_steps=120000,
                                   pct_start=0.05, grad_clip=1.0)
        out["train"][name] = train_at_largest_batch(
            torch, dev, tag, model, tx, S17_TRAIN_BATCHES, S17_TRAIN_STEPS,
            0, name, 19, size=S17_TRAIN_SIZE, level_shapes=lambda b: [],
            profile_runs=0, launches=(0, 0))
        out["train"][name]["size"] = list(S17_TRAIN_SIZE)
        log(f"[19 train] {name}: {time.perf_counter() - t0:.1f} s")
        del model, tx
        torch.cuda.empty_cache()
    return out


def vcn_conv_forms(torch, dev, tag: str) -> dict:
    """VCN's two 4-D convolutions at its finest volume (``VCN_LEVEL2``:
    12 channels, 9 x 9 displacements, 112 x 256 pixels at 1024x448), fp32,
    in the two forms the port could take: the reference's ``Conv3d`` on a
    view of the (B, C, U, V, H, W) volume (the port's), and the JAX
    package's 2-D convolution with the complementary axes folded into the
    batch, with the transposes around it.  Each pair agrees (max |d| over
    max |v| within RTOL_DEFORM) and is timed by CUDA events."""
    import torch.nn.functional as F

    c, u, h, w = VCN_LEVEL2
    g = torch.Generator(device="cpu").manual_seed(20)
    x = torch.randn(1, c, u, u, h, w, generator=g).to(dev)
    wuv = (0.1 * torch.randn(c, c, 3, 3, 1, generator=g)).to(dev)
    whw = (0.1 * torch.randn(c, c, 1, 3, 3, generator=g)).to(dev)

    def uv3d():
        return F.conv3d(x.view(1, c, u, u, h * w), wuv,
                        padding=(1, 1, 0)).view(1, c, u, u, h, w)

    def uv2d():
        y = x.permute(0, 4, 5, 1, 2, 3).reshape(h * w, c, u, u)
        y = F.conv2d(y, wuv[..., 0], padding=1)
        return y.view(1, h, w, c, u, u).permute(0, 3, 4, 5, 1,
                                                2).contiguous()

    def hw3d():
        return F.conv3d(x.view(1, c, u * u, h, w), whw,
                        padding=(0, 1, 1)).view(1, c, u, u, h, w)

    def hw2d():
        y = x.view(c, u * u, h, w).transpose(0, 1).contiguous()
        y = F.conv2d(y, whw[:, :, 0], padding=1)
        return y.transpose(0, 1).contiguous().view(1, c, u, u, h, w)

    out = {}
    for axes, conv3d, folded in (("uv", uv3d, uv2d), ("hw", hw3d, hw2d)):
        with torch.no_grad():
            a, b = conv3d(), folded()
            err = ((a - b).abs().max() / a.abs().max()).item()
            ms3 = timed_ms(torch, conv3d, 20)
            ms2 = timed_ms(torch, folded, 20)
        if not err <= RTOL_DEFORM:
            raise AssertionError(f"VCN {axes} convolution forms differ by "
                                 f"{err}")
        out[axes] = {"conv3d_ms": ms3, "folded_conv2d_ms": ms2,
                     "max_rel_err": err}
        log(f"[20 forward] [{tag}] VCN {axes} convolution at {c}x{u}x{u}x"
            f"{h}x{w}: Conv3d on a view {ms3:.3f} ms, folded 2-D with its "
            f"transposes {ms2:.3f} ms; max |d| / max |v| {err:.2e}")
    return out


def slice18_phase(torch, dev, tag: str) -> dict:
    """Phase 20: VCN (``vcn``, ``vcn_small``), NeuFlow and GMFlow
    (``gmflow``, ``gmflow_refine``) on the card, fp32, TF32 off,
    conditioned as their CPU tests are (``condition_slice18``).  Serves 3
    cold pairs of one sequence at 436x1024 through each, counting no
    lookup launch and checking no autograd graph; times and profiles each
    fp32 forward once, with the device ms and calls of VCN's volume
    (``corrf``), filtering (each level's butterfly and separable
    convolution) and winner-take-all, NeuFlow's attentions and local
    correlation, GMFlow's transformer, matchings and propagation by CUDA
    events around their calls (``timed_spans``); times VCN's 4-D
    convolutions in the port's form and the folded one
    (``vcn_conv_forms``); holds every name's flows at 256x320 card against
    CPU, VCN's argmax indices replayed on the CPU (``ArgmaxReplay``); one
    train step a family card against CPU (S18_STEP_CHECK); and trains the
    five at 384x512 at the first of S18_TRAIN_BATCHES that fits
    (unprofiled)."""
    import importlib

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    vcn = importlib.import_module("ptlflow_tpu_torch.models.vcn.vcn")
    nfl = importlib.import_module("ptlflow_tpu_torch.models.neuflow.neuflow")
    gmf = importlib.import_module("ptlflow_tpu_torch.models.gmflow.gmflow")
    gmt = importlib.import_module(
        "ptlflow_tpu_torch.models.gmflow.transformer")
    spans_of = {
        "vcn": [(vcn, "corrf", "corrf"),
                (vcn.VCNSmall, "filter_volume", "butterfly4D + sepConv4d"),
                (vcn.flow_reg, "forward", "flow_reg")],
        "neuflow": [(nfl, "sdpa", "attention"),
                    (nfl, "local_correlation", "local_correlation")],
        "gmflow": [(gmt.FeatureTransformer, "forward", "transformer"),
                   (gmf, "global_correlation_softmax", "global_matching"),
                   (gmf, "local_correlation_softmax", "local_matching"),
                   (gmt.FeatureFlowAttention, "forward", "propagation")]}
    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {}, "spans": {},
           "card_vs_cpu_px": {}}
    # cuDNN's convolutions (3-D ones among them), cuBLAS GEMMs, softmaxes,
    # the trilinear (U, V) resizes, the samplers (the warps), reductions
    # (the argmaxes among them), elementwise kernels, concatenations
    named = {"cuDNN fprop": "fprop", "GEMMs": "gemm", "softmax": "softmax",
             "trilinear resize": "upsample_trilinear", "samplers": "sampler",
             "reductions": "reduce", "elementwise": "elementwise_kernel",
             "cat": "CatArrayBatchedCopy"}
    frames = smooth_frames(201, H, W, 4, shift=(2, 1))
    for name in S18_NAMES:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        parity_weights(torch, name, model, None)
        n, x = serve_sequence(torch, name, model, frames, 0, (1, 1, 2, H, W),
                              20, warm=False)
        key = f"{name} serve at {W}x{H}, 3 pairs"
        out["launches"][key] = n
        if n != 0:
            raise AssertionError(f"{key}: {n} lookup launches")
        label = f"{name} fp32"
        with timed_spans(torch, spans_of[s18_family(name)]) as recs:
            time_forward(torch, model, x["images"], label, tag,
                         "no lookups", 20, out, named, reps=FWD_REPS,
                         warmups=FWD_WARMUPS, profiled=True,
                         ranges=list(recs), profile_runs=1)
            rec = span_ms(torch, model, x["images"], recs)
        fwd_ms = out["forward_ms"][label]
        prof = out["profile"][label]
        for span, r in rec.items():
            r["launches"] = prof["range_launches"][span]
            r["kernel_ms"] = prof["range_kernel_ms"][span]
            log(f"[20 forward] [{tag}] {label}: {span} {r['calls']} calls, "
                f"{r['ms']:.3f} ms stream-elapsed by CUDA events around them "
                f"(the card's idle gaps included; {r['ms'] / fwd_ms:.1%} of "
                f"the {fwd_ms:.3f} ms forward), {fmt_ms(r['kernel_ms'])} of "
                f"kernel time under them by the profiler, {r['launches']} "
                f"kernel launches")
        out["spans"][label] = rec
        log(f"[20 serve] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"timing")
        del model, x
        torch.cuda.empty_cache()
    out["vcn_conv_forms"] = vcn_conv_forms(torch, dev, tag)

    # card against CPU at 256x320, VCN's argmax indices replayed
    t0 = time.perf_counter()
    out["argmax_differing"] = {}
    seq = smooth_frames(7, 256, 320, 2, shift=(3, 2))
    x = IOAdapter(device="cpu").prepare_inputs(seq)
    xd = x["images"].to(dev)
    for name in S18_NAMES:
        gpu_model, cpu_model = card_and_cpu(torch, name, xd, served=False)
        replay = ArgmaxReplay(torch)
        with replay.record():
            got = gpu_model({"images": xd})["flows"].cpu()
        with replay.replay():
            want = cpu_model(x)["flows"]
        if replay.elements:
            out["argmax_differing"][name] = [replay.differ, replay.elements]
        diff = (got - want).abs().max().item()
        out["card_vs_cpu_px"][name] = diff
        log(f"[20 card vs cpu] {name} 256x320: max |dflow| {diff:.3e} px "
            f"(flow up to {want.abs().max().item():.2f} px, tolerance "
            f"{ATOL_CARD_CPU_PX} px)"
            + (f"; {replay.differ} of {replay.elements} argmax indices "
               f"differ on the CPU's own, the CPU took the card's"
               if replay.elements else ""))
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        del cpu_model, gpu_model
    log(f"[20 card vs cpu] {time.perf_counter() - t0:.1f} s")

    # one train step a family card against CPU
    t0 = time.perf_counter()
    out["train_step_card_vs_cpu"] = {
        name: train_step_card_vs_cpu(
            torch, name, dev, {}, (0, 0), batch_seed=seed, size=size,
            ill_conditioned=ill)
        for name, seed, size, ill in S18_STEP_CHECK}
    log(f"[20 train step card vs cpu] {time.perf_counter() - t0:.1f} s")

    # training at the first batch that fits
    out["train"] = {}
    for name in S18_NAMES:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        parity_weights(torch, name, model, None)
        tx = ttrain.make_optimizer(lr=1e-4, wdecay=4e-4, total_steps=120000,
                                   pct_start=0.05, grad_clip=1.0)
        out["train"][name] = train_at_largest_batch(
            torch, dev, tag, model, tx, S18_TRAIN_BATCHES, S18_TRAIN_STEPS,
            0, name, 20, size=S18_TRAIN_SIZE, level_shapes=lambda b: [],
            profile_runs=0, launches=(0, 0))
        out["train"][name]["size"] = list(S18_TRAIN_SIZE)
        log(f"[20 train] {name}: {time.perf_counter() - t0:.1f} s")
        del model, tx
        torch.cuda.empty_cache()
    return out


def slice19_phase(torch, dev, tag: str) -> dict:
    """Phase 21: UniMatch (``unimatch``, ``unimatch_sc2``,
    ``unimatch_sc2_ref6``) and GMFlow+ (``gmflow_p*``, their twins'
    classes) on the card, fp32, TF32 off, conditioned as their CPU tests
    are (``condition_slice19``).  Serves 3 cold pairs of one sequence at
    436x1024 through ``unimatch_sc2_ref6`` (6 lookup launches a forward)
    and one through ``unimatch`` and ``unimatch_sc2`` (none), checking no
    autograd graph; times each fp32 forward once with the device ms and
    calls of the transformer, the matchings, the propagation and the
    refinement's volume, lookups and update blocks by CUDA events around
    their calls (``timed_spans``), and profiles ``unimatch_sc2_ref6``'s;
    holds both kernels on the refinement's 1/4 level against their plain
    versions (the lookup in fp32 and bf16, the backward bit for bit twice)
    and times them there; holds the three architectures' flows at 256x320
    card against CPU and each ``gmflow_p*`` name on the card to its twin on
    the same weights, bit for bit; one ``unimatch_sc2_ref6`` train step
    card against CPU at S19_STEP_SIZE (float32 and float64, 6 launches of
    each kernel); and trains ``unimatch_sc2_ref6`` at 384x512 at the first
    of S19_TRAIN_BATCHES that fits (unprofiled)."""
    import importlib

    import ptlflow_tpu_torch
    from ptlflow_tpu_torch.ops import correlation as corr
    from ptlflow_tpu_torch.parallel import train as ttrain
    from ptlflow_tpu_torch.utils.io_adapter import IOAdapter

    gmf = importlib.import_module("ptlflow_tpu_torch.models.gmflow.gmflow")
    gmt = importlib.import_module(
        "ptlflow_tpu_torch.models.gmflow.transformer")
    um = importlib.import_module(
        "ptlflow_tpu_torch.models.unimatch.unimatch")
    spans = [(gmt.FeatureTransformer, "forward", "transformer"),
             (gmf, "global_correlation_softmax", "global_matching"),
             (gmf, "local_correlation_softmax", "local_matching"),
             (gmt.FeatureFlowAttention, "forward", "propagation"),
             (um, "build_corr_pyramid", "refinement volume"),
             (corr._KernelLookup, "__call__", "lookups"),
             (um.BasicUpdateBlock, "forward", "update blocks")]
    out = {"forward_ms": {}, "forward_runs_ms": {}, "profile": {},
           "peak_gib": {}, "forward_gib": {}, "launches": {}, "spans": {},
           "card_vs_cpu_px": {}, "twins_equal": {}}
    named = {"GEMMs": "gemm", "cuDNN fprop": "fprop", "softmax": "softmax",
             "lookup": "corr_lookup", "elementwise": "elementwise_kernel",
             "cat": "CatArrayBatchedCopy"}
    frames = smooth_frames(211, H, W, 4, shift=(2, 1))
    for name, depth in S19_SERVE:
        t0 = time.perf_counter()
        model = ptlflow_tpu_torch.get_model(name)
        parity_weights(torch, name, model, None)
        seq = frames if depth else frames[:2]
        n, x = serve_sequence(torch, name, model, seq, depth,
                              (1, 1, 2, H, W), 21, warm=False)
        out["launches"][f"{name} serve at {W}x{H}, {len(seq) - 1} "
                        f"pair(s)"] = n
        label = f"{name} fp32"
        profiled = depth > 0
        with timed_spans(torch, spans) as recs:
            time_forward(torch, model, x["images"], label, tag,
                         f"{depth} lookups", 21, out, named, reps=FWD_REPS,
                         warmups=FWD_WARMUPS, profiled=profiled,
                         ranges=list(recs), profile_runs=1)
            rec = span_ms(torch, model, x["images"], recs)
        fwd_ms = out["forward_ms"][label]
        prof = out["profile"].get(label)
        for span, r in rec.items():
            if prof is not None:
                r["launches"] = prof["range_launches"][span]
                r["kernel_ms"] = prof["range_kernel_ms"][span]
            log(f"[21 forward] [{tag}] {label}: {span} {r['calls']} calls, "
                f"{r['ms']:.3f} ms stream-elapsed by CUDA events around them "
                f"(the card's idle gaps included; {r['ms'] / fwd_ms:.1%} of "
                f"the {fwd_ms:.3f} ms forward)"
                + (f", {fmt_ms(r['kernel_ms'])} of kernel time under them by "
                   f"the profiler, {r['launches']} kernel launches"
                   if prof is not None else ""))
        if rec["lookups"]["calls"] != depth:
            raise AssertionError(f"{label}: {rec['lookups']['calls']} "
                                 f"lookup calls, expected {depth}")
        out["spans"][label] = rec
        log(f"[21 serve] {name}: {time.perf_counter() - t0:.1f} s with its "
            f"timing")
        del model, x
        torch.cuda.empty_cache()

    # both kernels on the refinement's 1/4 level at 1024x448
    t0 = time.perf_counter()
    flush = flushes(torch, dev)["dirty"]
    b, c, h, w = UNIMATCH_LEVEL
    levels, coords, grad = level_inputs(torch, dev, 21, b, h, w, c)
    label = f"unimatch 1/4 Q={b * h * w}"
    got = corr.corr_lookup_kernel(levels, coords, 4)
    err = (got - corr.corr_pyramid_lookup_plain(levels, coords, 4)).abs(
        ).max().item()
    if not err <= ATOL_FP32:
        raise AssertionError(f"{label}: lookup |err| {err}")
    half = [lvl.to(torch.bfloat16) for lvl in levels]
    got = corr.corr_lookup_kernel(half, coords, 4).float()
    want = corr.corr_pyramid_lookup_plain(half, coords, 4).float()
    torch.testing.assert_close(got, want, rtol=RTOL_BF16, atol=ATOL_BF16)
    out["bf16_max_abs_err"] = (got - want).abs().max().item()
    del half, got, want
    out["kernels"] = {
        "corr_lookup": {label: lookup_record(torch, levels, coords, 4, err,
                                             flush)},
        "corr_lookup_backward": {label: backward_record(
            torch, levels, coords, grad, 4, flush, label)}}
    for kname, recs in out["kernels"].items():
        rec = recs[label]
        log(f"[21 kernels] [{tag}] {kname} at {label}, levels "
            f"{rec['levels']}, r=4, fp32, L2 flushed per launch: "
            f"{rec['ms']:.4f} ms by CUDA events, "
            f"{fmt_ms(rec['profiler_ms'])} device time by the profiler; "
            f"plain {rec['plain_ms']:.4f} ms; library "
            f"{rec['library_ms']:.4f} ms; bound {rec['bound_ms']:.5f} ms by "
            f"{rec['bound_by']} ({rec['bound_bytes']} bytes), kernel at "
            f"{rec['bound_ms'] / rec['ms']:.1%} of it")
    log(f"[21 kernels] bf16 lookup max |err| {out['bf16_max_abs_err']:.3e} "
        f"(rtol {RTOL_BF16}); {time.perf_counter() - t0:.1f} s")
    del levels, coords, grad
    torch.cuda.empty_cache()

    # card against CPU at 256x320; the GMFlow+ twins on the card
    t0 = time.perf_counter()
    seq = smooth_frames(7, 256, 320, 2, shift=(3, 2))
    x = IOAdapter(device="cpu").prepare_inputs(seq)
    xd = x["images"].to(dev)
    for twin, name in S19_TWINS.items():
        gpu_model, cpu_model = card_and_cpu(torch, name, xd, served=False)
        got = gpu_model({"images": xd})
        want = cpu_model(x)
        check_flows(torch, name, got, (1, 1, 2, 256, 320))
        diff = max((got[k].cpu() - want[k]).abs().max().item()
                   for k in ("flows", "flow_small"))
        out["card_vs_cpu_px"][name] = diff
        log(f"[21 card vs cpu] {name} 256x320: max |dflow| of flows and "
            f"flow_small {diff:.3e} px (flow up to "
            f"{want['flows'].abs().max().item():.2f} px, tolerance "
            f"{ATOL_CARD_CPU_PX} px)")
        if not diff <= ATOL_CARD_CPU_PX:
            raise AssertionError(f"{name}: card and CPU differ by {diff} px")
        other = ptlflow_tpu_torch.get_model(twin)
        if type(other).__mro__[1] is not type(gpu_model).__mro__[1]:
            raise AssertionError(f"{twin} is not {name}'s class")
        other.load_state_dict(gpu_model.state_dict(), strict=True)
        mine = other({"images": xd})
        same = all(torch.equal(mine[k], got[k])
                   for k in ("flows", "flow_small"))
        out["twins_equal"][twin] = same
        log(f"[21 twins] {twin} on {name}'s weights at 256x320: flows and "
            f"flow_small equal bit for bit: {same}")
        if not same:
            raise AssertionError(f"{twin} differs from {name}")
        del cpu_model, gpu_model, other
    log(f"[21 card vs cpu] {time.perf_counter() - t0:.1f} s")

    # one train step card against CPU
    t0 = time.perf_counter()
    out["train_step_card_vs_cpu"] = {
        "unimatch_sc2_ref6": train_step_card_vs_cpu(
            torch, "unimatch_sc2_ref6", dev, {}, (6, 6),
            batch_seed=S19_STEP_SEED, size=S19_STEP_SIZE,
            ill_conditioned=True)}
    log(f"[21 train step card vs cpu] {time.perf_counter() - t0:.1f} s")

    # training at the first batch that fits
    t0 = time.perf_counter()
    name = "unimatch_sc2_ref6"
    model = ptlflow_tpu_torch.get_model(name)
    parity_weights(torch, name, model, None)
    tx = ttrain.make_optimizer(lr=1e-4, wdecay=4e-4, total_steps=120000,
                               pct_start=0.05, grad_clip=1.0)
    th, tw = S19_TRAIN_SIZE[0] // 4, S19_TRAIN_SIZE[1] // 4
    out["train"] = {name: train_at_largest_batch(
        torch, dev, tag, model, tx, S19_TRAIN_BATCHES, S19_TRAIN_STEPS, 6,
        name, 21, size=S19_TRAIN_SIZE,
        level_shapes=lambda bs: [(bs * th * tw, th, tw)], profile_runs=0,
        launches=(6, 6))}
    out["train"][name]["size"] = list(S19_TRAIN_SIZE)
    log(f"[21 train] {name}: {time.perf_counter() - t0:.1f} s")
    del model, tx
    torch.cuda.empty_cache()
    return out


def profile_forward(torch, model, images, label: str, tag: str,
                    event_ms: float, phase: int = 5,
                    kernel_names=None, ranges=(), runs: int = 2) -> dict:
    """Device time by kernel over one forward (torch.profiler): busy ms,
    launches, idle share against the unprofiled ``event_ms``, the lookup's
    share, the top kernels and, for each ``kernel_names`` entry (label:
    substring), the ms and launches of the kernels whose name holds the
    substring (any case); for each of the ``record_function`` names
    ``ranges``, the kernel launches issued under it (``range_launches``).
    The last of ``runs`` profiled forwards is read: a first absorbs the
    tracer's start-up, which phase 17 finds done by the earlier phases'
    profiles.  A ``kernel_names`` substring may come
    with a tuple of substrings that exclude a kernel: (substring,
    excludes)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    for _ in range(runs):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model({"images": images})
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # a record_function range shows on the card as an annotation that
        # spans its kernels: not a kernel
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and e.key not in ranges):
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                rows.append((us / 1e3, e.count, e.key))
    in_ranges = range_launches(prof, ranges)
    range_ms = range_kernel_ms(prof, ranges)
    if not rows:
        log(f"[{phase} profile] [{tag}] {label}: no device time recorded: "
            f"not measured")
        return {"busy_ms": None, "range_launches": in_ranges,
                "range_kernel_ms": range_ms}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    lookup = sum(r[0] for r in rows if "corr_lookup" in r[2])
    launches = sum(r[1] for r in rows)
    log(f"[{phase} profile] [{tag}] {label} forward under the profiler: "
        f"{busy:.3f} ms of kernels ({launches} launches) in {wall_ms:.3f} ms "
        f"wall; against the unprofiled {event_ms:.3f} ms forward the card "
        f"idles {1 - busy / event_ms:.1%}; lookup kernel {lookup:.3f} ms "
        f"({lookup / busy:.1%} of kernel time)")
    for ms, count, key in rows[:12]:
        log(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}")
    by_name = {}
    for name, sub in (kernel_names or {}).items():
        sub, excludes = sub if isinstance(sub, tuple) else (sub, ())
        hits = [r for r in rows if sub.lower() in r[2].lower()
                and not any(x in r[2].lower() for x in excludes)]
        by_name[name] = [sum(r[0] for r in hits), sum(r[1] for r in hits)]
        log(f"  {name} (kernels named *{sub}*): {by_name[name][0]:.3f} ms in "
            f"{by_name[name][1]} launches ({by_name[name][0] / busy:.1%})")
    return {"busy_ms": busy, "launches": launches, "wall_ms": wall_ms,
            "idle": 1 - busy / event_ms, "lookup_ms": lookup,
            "lookup_share": lookup / busy, "by_name": by_name,
            "range_launches": in_ranges, "range_kernel_ms": range_ms,
            "top": [[ms, n, key[:80]] for ms, n, key in rows[:8]]}


LAUNCH_CALLS = ("LaunchKernel", "LaunchCooperativeKernel")


def range_launches(prof, ranges) -> dict:
    """The kernel launches (host-side launch calls) of a profile issued
    under each of the ``record_function`` names ``ranges``."""
    counts = dict.fromkeys(ranges, 0)
    if not counts:
        return counts
    for e in prof.events():
        if not any(k in e.name for k in LAUNCH_CALLS):
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in counts:
            parent = parent.cpu_parent
        if parent is not None:
            counts[parent.name] += 1
    return counts


def range_kernel_ms(prof, ranges) -> dict:
    """The device time of the kernels of a profile that ran under each of
    the ``record_function`` names ``ranges``: those that start within the
    range's annotation on the card (its kernels run in order on the one
    stream), summed; None where the card shows no annotation of the
    range."""
    import bisect

    spans = {r: [] for r in ranges}
    kernels = []
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = (e.time_range.start, e.time_range.end)
        (spans[e.name] if e.name in spans else kernels).append(t)
    out = {}
    for r, ivs in spans.items():
        if not ivs:
            out[r] = None
            continue
        ivs.sort()
        starts = [a for a, _ in ivs]
        us = 0.0
        for a, b in kernels:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < ivs[i][1]:
                us += b - a
        out[r] = us / 1e3
    return out


def profile_train_step(torch, step, state, batch, level_shapes, tag: str,
                       event_ms: float, label: str = "raft",
                       phase: int = 7, runs: int = 2) -> dict:
    """Device time by kernel over one train step (torch.profiler, shapes
    recorded), the last of ``runs`` profiled steps (a first absorbs the
    tracer's start-up): the idle share against the unprofiled step time
    ``event_ms``, the top kernels, both lookup kernels, and autograd's sums
    of dense level gradients (the adds whose inputs have a level's (Q, H2,
    W2) shape).  The weights move on by ``runs`` steps."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(runs):
        torch.cuda.synchronize()
        with profile(activities=acts, record_shapes=True) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e, self_only=True):
        names = (("self_device_time_total", "self_cuda_time_total")
                 if self_only else ("device_time_total", "cuda_time_total"))
        for n in names:
            v = getattr(e, n, None)
            if v:
                return v
        return 0

    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = dev_us(e)
            if us > 0:
                rows.append((us / 1e3, e.count, e.key))
    if not rows:
        log(f"[{phase} profile] [{tag}] {label} train step: no device time "
            f"recorded: not measured")
        return {"busy_ms": None}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    # kernels of several streams overlap (cuDNN's FFT convolutions), so the
    # card's busy time is the union of their intervals, not their sum
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA"))
    union, lo, hi = 0.0, None, None
    for start, end in spans:
        if hi is None or start > hi:
            union += 0.0 if hi is None else hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    union = (union + (0.0 if hi is None else hi - lo)) / 1e3
    fwd = sum(r[0] for r in rows if "corr_lookup" in r[2]
              and "backward" not in r[2])
    bwd = sum(r[0] for r in rows if "corr_lookup_backward" in r[2])
    shapes = {tuple(s) for s in level_shapes}
    sums_ms, sums_n = 0.0, 0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::add", "aten::add_") and any(
                tuple(s) in shapes for s in (e.input_shapes or [])):
            sums_ms += dev_us(e, self_only=False) / 1e3
            sums_n += e.count
    log(f"[{phase} profile] [{tag}] {label} train step under the profiler: "
        f"{busy:.3f} ms of kernels ({sum(r[1] for r in rows)} launches), "
        f"busy {union:.3f} ms (the union of their intervals), in "
        f"{wall_ms:.3f} ms wall; against the unprofiled {event_ms:.3f} ms "
        f"step the card idles {1 - union / event_ms:.1%}; lookup {fwd:.3f} "
        f"ms, lookup backward {bwd:.3f} ms, dense level-gradient sums "
        f"{sums_ms:.3f} ms in {sums_n} adds ({sums_ms / busy:.1%} of kernel "
        f"time)")
    for ms, count, key in rows[:15]:
        log(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}")
    return {"busy_ms": busy, "busy_union_ms": union, "wall_ms": wall_ms,
            "idle": 1 - union / event_ms,
            "lookup_ms": fwd, "lookup_backward_ms": bwd,
            "level_sums_ms": sums_ms, "level_sums_adds": sums_n,
            "top": [[ms, n, key[:80]] for ms, n, key in rows[:15]]}


if __name__ == "__main__":
    sys.exit(main())
