"""Drives the PyTorch port's main paths on one NVIDIA GPU and checks its kernels.

    python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which raises on failure:

1. device: the card's name and power limit from nvidia-smi; TF32 off;
2. build: compiles torchcde_tpu_torch/csrc with nvcc (one process per source)
   and, beside them, the host library (torchcde_tpu_torch/native/src with
   g++; its seconds and flags), and prints ptxas's registers and spills, by name for the team kernels
   (K2's and K9's forwards and backwards), and the team launches' plans
   (teams per block, lanes per team, shared memory) at the default
   configuration, at config 4 (B 256 and B 4096) and at the per-sample
   slice, and K8's forward and backward plans at config 5 at hidden 8, 16
   and 32 (the weights' path, blocks, warps, threads per lane, blocks an SM
   holds by the occupancy API, SMs, waves) with its kernels' ptxas lines by
   instance, K1's forward and backward plans at the flagship
   in both modes with their kernels' ptxas lines, and K6/K7's and K4's
   plans at config 3 with their kernels' ptxas lines;
3. K1 forward and 4. K1 backward: the fixed-step kernels against their plain
   PyTorch version on the card, at the flagship's operands at hidden 8, 16
   and 32 and at odd cases covering every tableau, up to 8 substeps, odd
   batches, hidden sizes and channel counts, and shapes at the JAX kernel's
   caps (weights streamed through shared memory), each launch counted and
   each forward and backward also against a second launch on the same
   inputs, bit for bit;
5. K1 slice: five Adam steps of the spiral Neural CDE at the flagship
   configuration (rk4, step 1) through the public entry points, with the K1
   launch counts read around that run, then one ``accuracy`` call; then the
   same at hidden 16 with every plain version patched to raise;
6. K2 forward and backward: the adaptive dopri5 kernels against their plain
   version, per realised mesh, on every launch of ten cases (the default
   configuration at batch 4096 and 256, two groups, three chunks, 20 output
   times, the caps, tight tolerances, an odd shape, an exhausted budget, a
   width of 32, where the team forward takes one first-layer row per thread),
   each backward also against a second launch on the same inputs, bit for
   bit;
7. K2 slice: five Adam steps of the default Neural CDE configuration (dopri5,
   adjoint) at batch 4096 and at batch 256, each with the K2 launch counts
   read around it, then one ``accuracy`` call each;
8. timing: K1 and its train step at hidden 8, 16 and 32, K2 and the default
   train step against the plain version, by CUDA events;
9. profile: torch.profiler over train steps of both configurations: the
   device's busy share, kernels per step and the fused kernels' device time;
10. K3-K7 checks: the fill (K3), tridiagonal (K4), gappy tridiagonal (K5)
   and masked cubic fit (K6/K7) kernels against their plain versions run in
   float64 on the same inputs: lengths 2 to 4097 (K6/K7's plan boundaries:
   one row of one warp at 512, a row of two warps at 513, the resident
   maximum 4096 and the cluster route at 4097), odd row counts, NaN
   densities 0 to 1, leading and trailing NaN runs, single-observation and
   all-NaN rows, both imputation versions, irregular times, each K4 (both
   routes: bands shared by every row and bands per row), K5 and K6/K7 case
   also against a second launch, bit for bit; K4, K5 and K6/K7 also over
   thread block clusters (lengths 4097 to 32 768) and segmented past them
   (32 769, 65 536 and 65 537, K6/K7's with whole segments empty; K5's
   densities stacked into one launch a length past 4097);
   and the public fit on bfloat16 values (upcast at the kernels' boundary);
11. fit slice: BASELINE config 3 (8192 series of length 4096, one channel,
   20 % NaN, as benchmarks/run_benchmarks.py's bench_cubic_fit makes them)
   through the public natural_cubic_coeffs, forward and gradient, with and
   without NaNs, launch counts asserted, against the float64 plain path,
   and K5 on the masked gradient's own operands against its float64 plain
   version and a second launch;
12. NaN spiral slice: natural cubic coefficients of the spiral data with 30 %
   of the values missing, then five Adam steps of the default Neural CDE;
   phases 11 and 12 run with every kernel's plain version patched to raise;
13. timing of the new kernels, their plain versions and K4's library call
   (torch.linalg.solve of the shared dense system) at config 3, and a
   torch.profiler reading of the NaN-masked fit's gradient;
14. K2 linear mode: the adaptive kernels over a LinearInterpolation against
   their plain version, per realised mesh as in phase 6, on every launch of
   the config-4 control's solve and of six cases (the specialised variant,
   16 channels, three chunks with lead and output times on chunk-boundary
   knots, two groups, an exhausted budget, config 4's widths at the group
   cap B 4096, where each team of the forward walks two lanes on an H100),
   the config-4 launch's forward again, bit for bit, and the slope chosen at
   exact knots (hand-made one-step meshes through the backward kernel);
15. log-ODE slice: BASELINE config 4 (256 spirals of length 10 000,
   logsig_windows at depth 3, window 100, linear_interpolation_coeffs, the
   linear Neural CDE with dopri5 and the adjoint): five Adam steps and one
   accuracy call, without and with 30 % NaN, every plain version patched to
   raise, launch counts asserted (K2 linear 6 forward, 5 backward; K3 2 for
   the NaN infill);
16. irregular slice: BASELINE config 2's preprocessing (1024 x 256 x 9, 30 %
   NaN) with and without rectilinear=0, against the float64 plain path (K3
   2 and 3 launches);
17. timing of K2-linear at config 4 against its plain version, the config-4
   train step, logsig_windows alone, and a torch.profiler reading of the
   train step;
18. K8 forward and backward: the reversible-Heun kernels against their plain
   version run in float64 (forward y and ŷ within FWD_RTOL of the largest
   magnitude; backward after the lane screen, relative Frobenius error
   within BWD_RTOL in each gradient; each forward and backward also against
   a second launch, bit for bit), at config 5's operands at hidden 8, 16
   and 32 and at odd cases (m 1, 2 and 8, shapes at the caps, H 7, 16 and
   100 with C 2 and 5, batches that are not a multiple of the backward's
   128-lane blocks, W 200, 500 and 512, weights streamed through shared
   memory, a batch whose lane groups outnumber the resident blocks, so that
   blocks stride, cotangents on all, the terminal or some interior knots),
   each asserted to launch one forward and one backward kernel;
19. config-5 slice: BASELINE config 5 (16384 spirals of length 100, Hermite
   coefficients, reversible Heun at step 1.0), with direct backpropagation
   and with the adjoint: the logits against the plain version, then five
   Adam steps and one accuracy call each with every plain version patched
   to raise, K8 launches asserted (6 forward, 5 backward per mode); and
   the same slice at hidden 16;
20. timing of K8 at config 5's operands at hidden 8, 16 and 32 against its
   plain version and of the config-5 train step of each mode at each hidden
   size against the same step with the plain version; 21. a torch.profiler
   reading of each mode's train step;
22. K9 forward and backward: the per-sample adaptive kernels against their
   plain version per realised per-lane mesh (forward against the float64
   replay, accuracy against a tight float64 solve, backward after the lane
   screen, and against a second launch, bit for bit) on the per-sample
   slice's first launch (its forward also against a second launch, bit for
   bit) and on seven odd cases (linear with
   lead over three chunks, batched rows, 64 output rows, an exhausted
   max_steps, H 4 C 3 W 8, C 16 linear, a batch that is not a multiple of
   32);
23. per-sample slice: benchmarks/run_benchmarks.py's bench_per_sample at its
   TPU shapes (256 series of length 1024, hidden 8, width 32, dopri5) through
   cdeint(..., options={'per_sample': True}) with every plain version
   patched to raise: the forward (its first 16 series against a float64
   solve), five Adam steps on z0 and the field under each adjoint mode, and
   a solve with batched output times and its gradient, K9 launches asserted
   (8 per solve, 8 per gradient);
24. timing of K9 over the slice's launches against its plain version, and of
   the slice's solve and gradient against the same with the plain version;
   25. a torch.profiler reading of the slice's gradient;
26. K1's bfloat16 mode (bench.py's ``compute_dtype="bfloat16"``): its
   forward and backward against its plain version on the card, run with the
   same bfloat16 rounding points in float64 and float32 (see BF16_ORDER), at
   the flagship's operands at hidden 8 and 16, at H 5 (H % 8 != 0: the
   selection products round), at H 16, C 5, W 512, and at four H 8 shapes
   (a part block, striding blocks, W 512, 8 substeps), each forward and
   backward also against a second launch, bit for bit;
27. the bfloat16 slices: bench.py's configuration (the flagship in
   bfloat16) through the public entry points, its logits against the plain
   version and the float32 solve of the same quantized problem, five Adam
   steps and one accuracy call with every plain version patched to raise
   (K1 launches asserted, 6 forward and 5 backward, all in the bfloat16
   mode; master gradients float32); one bfloat16 default-configuration
   step (dopri5, adjoint, B 256) through K2, and one small bfloat16 solve
   and gradient each through K8 and K9 (route, dtype, closeness);
28. timing of K1's bfloat16 mode and its plain version at hidden 8, 16 and
   32, and of the bfloat16
   flagship step beside the float32 one and the plain bfloat16 step, in
   turns, and a torch.profiler reading of the bfloat16 step;
29. the rest of the solver surface, plain PyTorch ops on the card: the
   spiral problem at the flagship's width (an MLPVectorField over Hermite
   coefficients, float32), its length cut to 10, through heun3, bosh3,
   dopri5_nofsal, dopri8, adaptive_heun, fehlberg2, explicit_adams and
   implicit_adams (forwards at B 4096, one direct gradient each at B 256),
   dopri5 with a jump at every interior knot in both adjoint modes, a
   two-member TupleControl state and scipy_solver at B 16, each held against
   the port's float64 solve (see SURFACE_FIXED_RTOL, SURFACE_ADAPTIVE_RTOL,
   SURFACE_BACKSOLVE_RTOL and SURFACE_SCIPY_RTOL), with K1, K2, K8 and K9
   launched zero times, as the JAX package declines them;
30. the example examples/torch_time_series_classification.py on the card
   for one epoch: a finite accuracy and K2 launched forward and backward;
31. the host runtime (torchcde_tpu_torch.native, C++ through ctypes) on the
   loader routes' full-width data against the port's public functions on
   the card, within FWD_RTOL of the largest magnitude: Hermite coefficients
   of the flagship spirals, the masked cubic fit of phase 12's NaN spirals
   (the card's K6/K7), and logsig_windows of config 4's spirals without and
   with 30 % NaN (the card's K3), every plain version patched to raise; the
   host's CPU model and threads and its ms per batch of each route;
32. loader-fed slices: CoefficientDataLoader(num_workers=4, prefetch=2)
   feeding five Adam steps each of the flagship (Hermite route; K1 5 and 5
   launches), the default configuration on 30 %-NaN spirals (cubic route;
   K2 5 and 5) and config 4 (logsig route; K2's linear mode 5 and 5), every
   plain version patched to raise; the first batch's coefficients within
   FWD_RTOL of the card's own coefficients of its rows, and its logits
   against the logits on those (FWD_RTOL; for the adaptive slices, see
   loader_slices);
33. observability on the loader-fed flagship: trace() of two steps with
   annotate("train_step") naming K1's kernels and the annotation, a
   checkpoint after step 3 from which steps 4-5 repeat bit for bit,
   device_profile listing K1's kernels with a device time within 25 % of
   phase 9's; then the loader-fed step against the in-memory step on the
   same batches, in turns, with each one's device-idle share;
34-37. parallelism, four ranks on the one card joined by gloo (spawned once
   by parallel.launch.run_ranks, after the parent has built the kernels and
   the host library): five data-parallel Adam steps of the flagship (B 4096,
   1024 rows a rank, K1 on each rank: 5 and 5 launches asserted) and of
   config 5's widths at B 4096 in both adjoint modes (K8), each against the
   one-process run of the same steps on the card (first-step gradients
   within BWD_RTOL, losses within PAR_LOSS_RTOL); tensor parallelism at
   data 2 x model 2, B 1024, in float32 and float64 (no K1 launch
   asserted; logits within FWD_RTOL and gradients within BWD_RTOL of the
   one-process float64 solve); config 3's fits with the
   length over the four ranks (1024 positions each): the masked fit (K3
   and K5 on each shard) against the one-process fit (K6/K7), the dense
   system by SPIKE (K4 on each shard) and by distributed PCR against K4 on
   the whole rows, within FWD_RTOL, and the masked fit's gradient at B
   1024 within PAR_FIT_GRAD_RTOL; per phase and rank the wall and
   CUDA-event ms, the launches and the bytes gloo staged through the host;
38. one rank in an NCCL group: the data-parallel flagship step and both
   one-shard fits bit for bit the one-process ones; then
   examples/torch_parallel_training.py for one epoch on four gloo ranks.
   A rank that raises makes the script exit non-zero;
39. per-sample solves that K9 declines, every lane in one lockstep solve
   (solvers/per_sample.py, plain PyTorch ops on the card): bench_per_sample's
   problem at its full shape (256 lanes, length 1024, hidden 8, width 32)
   with return_stats, through dopri5 with the MLPVectorField and with a
   field that reads t, bosh3, and dopri5 with a jump at every 64th knot;
   dopri8, adaptive_heun and fehlberg2 at length 128; a direct and an
   adjoint gradient at length 8.  Each is held against a solve at tighter
   tolerances (SURFACE_ADAPTIVE_RTOL, gradients SURFACE_BACKSOLVE_RTOL for
   the adjoint): the MLP's by K9 in float32, the t-reading field's by the
   lockstep solve in float64, the gradients by direct backpropagation of the
   whole batch under one controller (integrate.odeint) in float64; every
   lane finite, K1, K2, K8 and K9 launched zero times on the lockstep
   solves; and at length 128 in float64, on
   controls linear in time with an output at every knot, the first 8 lanes
   (MLP, t-reading field) or 4 (a jump every 16th knot, dopri8) against
   each lane solved alone by integrate.odeint, as the port solved a
   per-sample batch before: the same statistics, values within PS39_EXACT
   of the largest magnitude.  On bench_per_sample's controls the first 8
   lanes alone through integrate.odeint, within SURFACE_ADAPTIVE_RTOL, and
   the replayed CUDA graphs against eager iterations.  Each solve prints its
   per-lane NFE, wall and CUDA-event ms, host reads and iterations; the 8
   lanes' time in integrate.odeint, scaled to 256, as the extrapolated time
   of that loop over the lanes; and, by batch size, whether the lanes'
   right-hand side rounds as in a batch of 64;
40. the flagship step with the fused kernels switched off;
41. the long rows (LONG_ROW_CASES): K4's per-row and shared bands, K5 in
   the masked fit's gradient and K6/K7 past 4096 positions, over clusters
   and segmented, through the public entry points with every plain version
   patched to raise, launches counted by route, outputs against float64;
   then each case's device kernels from the profiler in a new process,
   which fails on any one-thread kernel of K4, K5 or K6/K7.

The last line is the JSON object {"ok": true, "device": {...}}; the line
before it lists every kernel of the paths.  Without a CUDA device the script
exits non-zero before building anything.
"""

import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import glob
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from unittest import mock

import numpy as np
import torch

BATCH, LENGTH, HIDDEN, WIDTH, CHANNELS = 4096, 100, 8, 128, 3
FLAGSHIP = dict(input_channels=CHANNELS, hidden_channels=HIDDEN, output_channels=1,
                width=WIDTH, interpolation="cubic", solver="rk4", adjoint=False,
                step_size=1.0)
# The kernels run in float32; they are held against the plain version run in
# float64 on the same (float32) inputs, and the plain version in float32 is
# reported beside them.  The forward is continuous in its inputs: its largest
# error must stay within FWD_RTOL of the largest magnitude.  The backward is
# not: ReLU's derivative jumps where a pre-activation crosses zero, so where
# rounding puts a pre-activation on the other side of zero a lane's gradient
# differs by a whole term, in any two float32 summation orders (the plain
# version in float32 shows the same jumps).  Such crossings are rare and
# isolated.  On an H100 the relative error of a lane's own gradients (dct,
# dz0) was at most 7e-6 in lanes without a crossing and 9e-5 to 8e-3 in
# lanes with one, about one lane per 1e7 ReLU evaluations.  So a lane past
# LANE_RTOL is taken for a crossing, if its error stays under LANE_GROSS and
# there are no more than KINKED_PER_RELU times the ReLU evaluations of the
# case, plus 2; with those lanes' cotangents set to zero, the six gradients
# must agree to BWD_RTOL in the Frobenius norm.
FWD_RTOL = 1e-4
LANE_RTOL = 1e-5
LANE_GROSS = 5e-2
KINKED_PER_RELU = 3e-7
BWD_RTOL = 1e-5
# K2 realises its own step mesh, and the plain version in float32 another:
# accept/reject decisions and step sizes hang on an error estimate that
# magnifies rounding wherever a step ends just past a knot (a cubic spline's
# second derivative jumps there) or a ReLU switches, so the two meshes part
# and their outputs differ by the solution's own error (up to ~1e-2 of the
# largest magnitude on the spiral data at rtol 1e-4, on an H100).
# So beyond the replay of its own mesh, the kernel's output must be as
# accurate as the plain float32 solve's: each is held against a float64
# solve at EXACT_TOL times the tolerances.  The two errors scatter by a
# factor of ~3 either way from mesh to mesh (on an H100), so one
# launch fails only past ten times the plain solve's error (a gross fault),
# and the sum over all launches of each error, in units of rtol times the
# largest magnitude, may not exceed twice the plain solve's.
EXACT_TOL = 1e-2
EXACT_CAP = 16384
# The per-sample slice's small input (batch, length, hidden, channels, width):
# at rtol 1e-4 the slice's own global error reaches a few percent of the
# largest magnitude over 1023 intervals, and a float64 solve tight enough to
# hold it against needs more steps than a chunk stores.
PS_CHECK = (16, 33, 8, 3, 32)
SOURCE = "torchcde_tpu_torch/csrc/fused_fixed.cu"
SOURCE_BWD = "torchcde_tpu_torch/csrc/fused_fixed_bwd.cu"
# K1's kernels as the profiler names them.
K1_FWD_KERNEL, K1_BWD_KERNEL = "fwd_slice_kernel", "bwd_slice_kernel"
K1_KINDS = {"k1_fwd": rf"\b{K1_FWD_KERNEL}\b", "k1_bwd": rf"\b{K1_BWD_KERNEL}\b"}
# The flagship's operands at these hidden sizes (phases 3, 8 and 28).
K1_HIDDEN = (HIDDEN, 16, 32)
# Odd K1 cases: (batch, intervals, hidden, channels, width, method, substeps,
# output knots).  Shapes up to the JAX kernel's caps (C * H <= 512,
# 3 * C <= 16, width <= 512, 8 substeps), every one through the same two
# kernels: H 8, C 3 at every width of the caps (the forward in blocks of 8
# lanes and the backward in blocks of 32: batches of 4090 and 33 end in a
# part block, one of 40000 has its blocks stride over the lane groups) and
# up to 8 substeps; H 5 and 7 (padded to a slice of 8), H 16 (two slices),
# H 100 (sixteen slices, weights streamed), C 2 and 5, small batches (fewer
# lanes a block); every tableau.
ODD_CASES = [
    (1000, 99, 5, 3, 128, "euler", 2, "all"),
    (520, 40, 8, 3, 64, "euler", 1, "all"),
    (1000, 99, 8, 3, 128, "heun", 4, "subset"),
    (1000, 99, 8, 3, 128, "midpoint", 3, "terminal"),
    (300, 20, 8, 3, 500, "rk4", 2, "subset"),
    (333, 24, 16, 5, 512, "rk4", 1, "all"),
    (300, 12, 100, 5, 512, "midpoint", 8, "subset"),
    (77, 30, 7, 2, 64, "heun", 1, "all"),
    (4090, 30, 8, 3, 128, "rk4", 1, "subset"),
    (33, 40, 8, 3, 128, "midpoint", 2, "all"),
    (40000, 12, 8, 3, 128, "rk4", 1, "terminal"),
    (200, 16, 8, 3, 512, "heun", 2, "all"),
    (600, 20, 8, 3, 128, "rk4", 8, "subset"),
]


def spiral_data(batch, length, seed=0):
    """The spiral classification data of the repository's benchmark."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 4 * math.pi, length)
    phase = rng.uniform(0, 2 * math.pi, size=(batch, 1))
    y = (rng.random(batch) > 0.5).astype(np.float32)
    direction = np.where(y > 0.5, 1.0, -1.0)[:, None]
    radius = 0.5 + t / (4 * math.pi)
    x1 = radius * np.cos(direction * t + phase)
    x2 = radius * np.sin(direction * t + phase)
    X = np.stack([np.broadcast_to(t, x1.shape), x1, x2], axis=-1).astype(np.float32)
    return X, y


def nan_spiral_data(batch, length, seed=0):
    """spiral_data with SPIRAL_NAN of the two value channels' entries
    missing (numpy rng seed 1; the time channel stays observed)."""
    X, y = spiral_data(batch, length, seed)
    values = X[..., 1:]
    values[np.random.default_rng(1).random(values.shape) < SPIRAL_NAN] = np.nan
    return X, y


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, torch.device("cuda", 0)


def phase_build():
    from torchcde_tpu_torch import _build
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8
    from torchcde_tpu_torch.solvers.team import team_forward_plan, team_plan

    from torchcde_tpu_torch import native

    # The host library's g++ runs beside the kernels' nvcc processes.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(native.build)
        path, seconds, log = _build.build()
        host_path, host_seconds = host_build.result()
    if not native.available():
        raise AssertionError(f"the host library {host_path} does not load")
    print(f"build: host library {host_path.name} in {host_seconds:.1f} s: "
          f"{native.CXX} {' '.join(native.CXX_FLAGS + native.LIBS)}", flush=True)
    k1._library()
    k2._library()
    k8._library()
    k9._library()
    for module in fit_kernel_modules().values():
        module._library()
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    print(f"build: {path.name} in {seconds:.1f} s", flush=True)
    for line in log.splitlines():
        if re.fullmatch(r"nvcc \S+\.cu: [\d.]+ s", line):
            print(f"  {line}")
    for line in ptxas:
        print(f"  ptxas: {line}")
    for name, lines in team_kernels_ptxas(log).items():
        print(f"  team kernel {name}: {'; '.join(lines)}")
    for label, shape in (("the default B4096", (4096, HIDDEN, CHANNELS, WIDTH)),
                         ("config 4", (LOG_ODE_BATCH, HIDDEN, LOG_ODE_CHANNELS, WIDTH)),
                         ("per-sample slice", (PS_BATCH, PS_HIDDEN, CHANNELS, PS_WIDTH))):
        print(f"  team backward at {label} (B H C W {shape}): {team_plan(*shape)}")
    for label, shape, cooperative in (
            ("the default B4096", (4096, HIDDEN, CHANNELS, WIDTH), True),
            ("the default B256", (256, HIDDEN, CHANNELS, WIDTH), True),
            ("config 4", (LOG_ODE_BATCH, HIDDEN, LOG_ODE_CHANNELS, WIDTH), True),
            ("config 4's widths at B4096", (4096, HIDDEN, LOG_ODE_CHANNELS, WIDTH), True),
            ("per-sample slice", (PS_BATCH, PS_HIDDEN, CHANNELS, PS_WIDTH), False)):
        print(f"  team forward at {label} (B H C W {shape}): "
              f"{team_forward_plan(*shape, cooperative)}")
    for hidden in K8_HIDDEN:
        print(f"  K8 at config 5, hidden {hidden}: {k8_plan_line(hidden)}")
    for name, lines in ptxas_lines(log, k8_label).items():
        print(f"  K8 kernel {name}: {'; '.join(lines)}")
    for mode in (0, 1):
        for hidden in K1_HIDDEN:
            for which in ("forward", "backward"):
                print(f"  K1 {which} at the flagship, hidden {hidden}, mode {mode}: "
                      f"{k1_plan_line(mode, which, hidden)}")
    for name, lines in k1_ptxas(log).items():
        print(f"  K1 kernel {name}: {'; '.join(lines)}")
    from torchcde_tpu_torch.ops import masked_tridiagonal_kernel
    from torchcde_tpu_torch.ops.masked_cubic_kernel import fit_plan
    from torchcde_tpu_torch.ops.tridiagonal_kernel import solve_plan

    print(f"  K6/K7 at config 3 (k {FIT_LENGTH}): {fit_plan(FIT_LENGTH)}")
    for length in LONG_FIT_LENGTHS + SEGMENTED_LENGTHS:
        print(f"  K6/K7 at k {length}: {fit_plan(length)}")
    for name, lines in ptxas_lines(log, fit_kernel_label).items():
        print(f"  K6/K7 kernel {name}: {'; '.join(lines)}")
    print(f"  K4 at config 3 (k {FIT_LENGTH}, shared bands): {solve_plan(FIT_LENGTH, True)}")
    print(f"  K4 at config 3 (k {FIT_LENGTH}, per-row bands): {solve_plan(FIT_LENGTH, False)}")
    for length in LONG_FIT_LENGTHS + SEGMENTED_LENGTHS:
        for shared in (True, False):
            print(f"  K4 at k {length}, {'shared' if shared else 'per-row'} bands: "
                  f"{solve_plan(length, shared)}")
    for name, lines in ptxas_lines(log, k4_label).items():
        print(f"  K4 kernel {name}: {'; '.join(lines)}")
    for length in (FIT_LENGTH,) + LONG_FIT_LENGTHS + SEGMENTED_LENGTHS:
        print(f"  K5 at k {length}: {masked_tridiagonal_kernel.solve_plan(length)}")
    for name, lines in ptxas_lines(log, k5_label).items():
        print(f"  K5 kernel {name}: {'; '.join(lines)}")


def k1_plan(mode, which, hidden=HIDDEN):
    """K1's forward or backward launch at the flagship's shapes at this
    hidden size in mode 0 (float32) or 1 (bfloat16), from the occupancy API
    of the kernel it launches."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    planner = k1.backward_plan if which == "backward" else k1.forward_plan
    return planner(BATCH, hidden, CHANNELS, WIDTH, k1._Plan("rk4", 1, 1.0, (LENGTH - 1,)), mode,
                   torch.device("cuda", 0))


def k1_plan_line(mode, which, hidden=HIDDEN):
    """k1_plan as one line of text."""
    p = k1_plan(mode, which, hidden)
    groups = math.ceil(BATCH / p["lanes_per_block"])
    waves = math.ceil(groups / (p["resident_per_sm"] * p["sms"]))
    return (f"B {BATCH} H {hidden} C {CHANNELS} W {WIDTH}: {p['blocks']} blocks of "
            f"{p['threads'] // 32} warps ({p['lanes_per_block']} lanes, "
            f"{p['threads_per_lane']} threads per lane in {p['slices']} slice(s)), "
            f"{p['resident_per_sm']} resident per SM x {p['sms']} SMs, {groups} lane groups, "
            f"{waves} wave(s), weights {'streamed' if p['streamed'] else 'resident'}, "
            f"{p['shared_bytes']} shared bytes a block")


def k1_ptxas(log):
    """{fwd_slice_kernel<C, HS, GW, sliced, slab type> or bwd_slice_kernel<C,
    HS, GW, sliced, register units, slab type>: ptxas's lines}."""
    def label(name):
        kernel = re.search(r"(fwd|bwd)_slice_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb([01])E"
                           r"(?:Li(\d)E)?(f|13__nv_bfloat16)", name)
        if not kernel:
            return None
        which, c, hs, gw, sliced, nreg, slabs = kernel.groups()
        sizes = [c, hs, gw, "true" if sliced == "1" else "false"] + ([nreg] if nreg else [])
        return (f"{which}_slice_kernel<{', '.join(sizes)}, "
                f"{'float' if slabs == 'f' else 'bfloat16'}>")

    return ptxas_lines(log, label)


def _instance(kernel, name):
    """kernel, with the template argument that name instantiates it with:
    <false> or <true> for the cluster level (a mangled ILb0E / ILb1E), <m>
    for a RowMode (ILi<m>E)."""
    level = re.search(r"IL([bi])(\d)E", name)
    if not level:
        return kernel
    if level.group(1) == "i":
        return f"{kernel}<{level.group(2)}>"
    return f"{kernel}<{'true' if level.group(2) == '1' else 'false'}>"


def fit_kernel_label(name):
    """K6/K7's kernels' names in ptxas's log, or None."""
    kernel = re.search(r"(resident|span)_fit_kernel", name)
    return _instance(kernel.group(0), name) if kernel else None


def k4_label(name):
    """K4's kernels' names in ptxas's log, with their RowMode, or None."""
    kernel = re.search(r"\d(shared_band|band_pivot|per_row)_kernel", name)
    return _instance(kernel.group(1) + "_kernel", name) if kernel else None


def k5_label(name):
    """K5's kernel's names in ptxas's log, with their RowMode, or None."""
    return _instance("gappy_kernel", name) if "gappy_kernel" in name else None


def k8_label(name):
    """K8's kernel instances' names in ptxas's log (rev_fwd_kernel<C, tiles>,
    rev_fwd_split_kernel<C, tiles a warp>, rev_bwd_kernel<C, components a
    thread, group, register units>), or None."""
    fwd = re.search(r"(rev_fwd_(?:split_)?kernel)ILi(\d)ELi(\d)E", name)
    if fwd:
        return f"{fwd.group(1)}<{fwd.group(2)}, {fwd.group(3)}>"
    bwd = re.search(r"rev_bwd_kernelILi(\d)ELi(\d+)ELb(\d)ELi(\d)E", name)
    if bwd:
        return (f"rev_bwd_kernel<{bwd.group(1)}, {bwd.group(2)}, {bool(int(bwd.group(3)))}, "
                f"{bwd.group(4)}>")
    return None


def k8_plan_line(hidden):
    """K8's forward and backward launches at config 5 at this hidden size,
    from the plans and the occupancy API of the kernels they launch, as one
    line of text."""
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    f = k8.forward_plan(CONFIG5_BATCH, hidden, CHANNELS, WIDTH)
    b = k8.backward_plan(CONFIG5_BATCH, hidden, CHANNELS, WIDTH, torch.device("cuda", 0))
    waves = math.ceil(b["lane_groups"] / (b["resident_per_sm"] * b["sms"]))
    path = ("resident", "streamed")
    return (f"B {CONFIG5_BATCH} H {hidden} C {CHANNELS} W {WIDTH}: forward {f['blocks']} blocks "
            f"of {f['threads'] // 32} warps ({f['lanes_per_block']} lanes, "
            f"{f['warps_per_lane_group']} warp(s) a 16-lane group, H padded to "
            f"{f['padded_hidden']}), weights {path[f['streamed']]}, {f['shared_bytes']} shared "
            f"bytes a block; backward {b['blocks']} blocks of {b['threads'] // 32} warps "
            f"({b['lanes_per_block']} lanes, {b['threads'] // b['lanes_per_block']} thread(s) "
            f"a lane), weights {path[b['variant']]}, {b['resident_per_sm']} resident per SM x "
            f"{b['sms']} SMs, {b['lane_groups']} lane groups, {waves} wave(s), "
            f"{b['shared_bytes']} shared bytes a block")


def ptxas_lines(log, label):
    """{label(entry): ptxas's lines} (registers, spills, stack frame) of the
    compiled entry functions that label names (it returns None for the
    others)."""
    report, entry = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = label(found.group(1))
        elif entry and ("registers" in line or "spill" in line):
            report.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return report


def team_kernels_ptxas(log):
    """{kernel<shared, rows>: ptxas's lines} of the team kernels, K2's and
    K9's forwards and backwards."""
    def label(name):
        kernel = re.search(r"(dopri_(?:fwd|bwd)_team_kernel|ps_(?:fwd|bwd)_kernel)"
                           r"ILb(\d)ELi(\d)E(?:Lb(\d)E)?", name)
        if not kernel:
            return None
        narrow = f", row per thread={kernel.group(4)}" if kernel.group(4) else ""
        return f"{kernel.group(1)}<shared={kernel.group(2)}, rows={kernel.group(3)}{narrow}>"

    return ptxas_lines(log, label)


def make_model(device, seed=0, config=FLAGSHIP):
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig

    gen = torch.Generator().manual_seed(seed)
    return NeuralCDE(NeuralCDEConfig(**config), generator=gen).to(device)


def packed_operands(model, coeffs):
    """The K1 operands exactly as the model's forward builds them (for a
    model with a compute_dtype, from its views of the layers)."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models.neural_cde import _field_as, _linear_as
    from torchcde_tpu_torch.solvers.fused_fixed_kernel import pack_operands

    initial, func = model.initial, model.func
    if model.cfg.compute_dtype is not None:
        dtype = getattr(torch, model.cfg.compute_dtype)
        initial, func, coeffs = _linear_as(initial, dtype), _field_as(func, dtype), coeffs.to(dtype)
    X = tt.CubicSpline(coeffs)
    z0 = initial(X.evaluate(X.interval[0]))
    return pack_operands(X._b, X._two_c, X._three_d, z0, func, ct_store="native")


def plain_forward(model, coeffs):
    """The model's forward with the solve in the kernels' plain version."""
    from torchcde_tpu_torch.solvers.fused_fixed_kernel import fused_fixed_solve_reference

    p = packed_operands(model, coeffs)
    n = p.ct.shape[0]
    out = fused_fixed_solve_reference(p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2,
                                      "rk4", 1, 1.0, (n,))
    return model.readout(out[0].t())


def _err(got, ref):
    return float((got - ref).abs().max()), float(ref.abs().max())


def random_operands(B, n, H, C, W, seed, device):
    """K1 operands (ct, z0t, w1t, b1, w2t, b2) at the model's initial scales."""
    rng = np.random.default_rng(seed)

    def uniform(shape, fan_in):
        return rng.uniform(-1.0, 1.0, shape) / math.sqrt(fan_in)

    arrays = (0.3 * rng.standard_normal((n, 3, C, B)), rng.standard_normal((H, B)),
              uniform((W, H), H), uniform(W, H), uniform((C * H, W), W), uniform(C * H, W))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in arrays)


def knot_set(which, n):
    return {"all": tuple(range(1, n + 1)), "terminal": (n,),
            "subset": (2, n // 2, n // 2 + 1, n - 1)}[which]


def _rel_l2(got, ref):
    return float(torch.linalg.vector_norm(got.double() - ref) / torch.linalg.vector_norm(ref))


def _lane_rel_l2(got, ref):
    """Relative error of each batch lane (the last axis)."""
    diff = (got.double() - ref).reshape(-1, ref.shape[-1])
    return diff.norm(dim=0) / ref.reshape(-1, ref.shape[-1]).norm(dim=0).clamp_min(1e-300)


def _gradients(operands, zres, gz, plan):
    """The backward kernel's gradients and the plain version's, float64 and float32."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    grads = k1_launched(
        lambda: k1.launch_backward(operands[0], zres, operands[1], gz, *operands[2:], plan), "bwd")
    plain = []
    for dtype in (torch.float64, torch.float32):
        leaves = [t.detach().to(dtype).requires_grad_() for t in operands]
        ref = k1.fused_fixed_solve_reference(*leaves, plan.method, plan.m, plan.dt_sub,
                                             plan.out_knots)
        plain.append(torch.autograd.grad(ref, leaves, gz.to(dtype)))
    torch.cuda.synchronize()
    return grads, plain[0], plain[1]


def k1_label(label, operands, plan):
    """label with the launch both K1 kernels take for these operands."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    H, (n, _, C, B), W = operands[1].shape[0], operands[0].shape, operands[2].shape[0]
    mode = int(operands[0].dtype == torch.bfloat16)
    parts = []
    for which, planner in (("fwd", k1.forward_plan), ("bwd", k1.backward_plan)):
        p = planner(B, H, C, W, plan, mode, operands[0].device)
        parts.append(f"{which} {p['threads_per_lane']} threads x {p['slices']} slices a lane, "
                     f"{p['lanes_per_block']} lanes a block, {p['blocks']} blocks, "
                     f"{'streamed' if p['streamed'] else 'resident'}")
    return f"{label} [{'; '.join(parts)}]"


def k1_launched(launch, which):
    """launch()'s result; raises unless it launched K1's forward (which
    "fwd") or backward kernel exactly once."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    name = "FWD_LAUNCHES" if which == "fwd" else "BWD_LAUNCHES"
    before = getattr(k1, name)
    result = launch()
    if getattr(k1, name) != before + 1:
        raise AssertionError(f"K1's {which} kernel did not launch once")
    return result


def check_k1(label, operands, plan):
    """Kernel forward and backward against autograd through the plain version."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    B, n, W = operands[0].shape[3], operands[0].shape[0], operands[2].shape[0]
    label = k1_label(label, operands, plan)
    out, zres = k1_launched(lambda: k1.launch_forward(*operands, plan), "fwd")
    with torch.no_grad():
        refs = [k1.fused_fixed_solve_reference(*(t.to(dtype) for t in operands), plan.method,
                                               plan.m, plan.dt_sub, plan.out_knots)
                for dtype in (torch.float64, torch.float32)]
    torch.cuda.synchronize()
    failures = []
    fwd_err, fwd_scale = _err(out.double(), refs[0])
    print(f"K1-fwd {label}: max_abs_err {fwd_err:.3e} (largest |value| {fwd_scale:.3e}; "
          f"plain float32 {_err(refs[1].double(), refs[0])[0]:.3e})", flush=True)
    if not torch.isfinite(out).all() or fwd_err > FWD_RTOL * max(fwd_scale, 1.0):
        failures.append(f"K1 forward ({label})")

    gz = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(1),
                     device=out.device)
    relu_evals = B * n * plan.m * len(k1._chain_form(plan.method)[2]) * W
    bwd_err, bwd_failures = screened_backward(
        "K1", label, lambda g: _gradients(operands, zres, g, plan), gz, relu_evals)
    return fwd_err, bwd_err, (failures + bwd_failures
                              + k1_forward_bit_identical("K1", label, operands, (out, zres), plan)
                              + k1_bit_identical("K1", label, operands, zres, gz, plan))


def k1_forward_bit_identical(kernel, label, operands, first, plan):
    """Two K1 forward launches on the same inputs give the same bits."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    return forward_bit_identical(kernel, label, first, lambda: k1.launch_forward(*operands, plan),
                                 lambda o: {"out": o[0], "zres": o[1]})


def k1_bit_identical(kernel, label, operands, zres, gz, plan):
    """Two K1 backward launches on the same inputs give the same bits."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    def launch():
        return k1.launch_backward(operands[0], zres, operands[1], gz, *operands[2:], plan)

    return bit_identical(kernel, label, launch(), launch)


def screened_backward(kernel, label, gradients, gz, relu_evals):
    """A backward kernel's six gradients (ct, z0, w1, b1, w2, b2) against
    autograd through its plain version in float64; ``gradients(gz)`` returns
    the kernel's and the plain version's in float64 and float32 (or None,
    not printed).  Lanes
    where rounding crossed a ReLU kink differ by a whole term (see
    BWD_RTOL); they are found by their own gradients (dct, dz0), and the
    comparison is repeated with their cotangent set to zero.  Returns the
    largest error and the failures."""
    grads, ref_grads, _ = gradients(gz)
    lane_err = torch.maximum(_lane_rel_l2(grads[0], ref_grads[0]),
                             _lane_rel_l2(grads[1], ref_grads[1]))
    kinked = torch.nonzero(lane_err > LANE_RTOL).flatten().tolist()
    allowed = 2 + int(KINKED_PER_RELU * relu_evals)
    worst = float(lane_err.max())
    print(f"{kernel}-bwd {label}: {len(kinked)} lanes past {LANE_RTOL:g} (limit {allowed}), "
          f"largest lane error {worst:.2e}, largest of the other lanes "
          f"{float(lane_err.masked_fill(lane_err > LANE_RTOL, 0.0).max()):.2e}")
    failures = []
    if len(kinked) > allowed or worst > LANE_GROSS:
        failures.append(f"{kernel} backward: lanes disagree ({label})")
    gz[..., kinked] = 0.0
    grads, ref_grads, ref32_grads = gradients(gz)

    bwd_err = 0.0
    for i, (name, g, r) in enumerate(zip(["ct", "z0", "w1", "b1", "w2", "b2"], grads, ref_grads)):
        err, scale = _err(g.double(), r)
        rel = _rel_l2(g, r)
        plain = ""
        if ref32_grads is not None:
            r32 = ref32_grads[i]
            plain = (f"; plain float32 rel_l2 {_rel_l2(r32, r):.3e} max_abs_err "
                     f"{_err(r32.double(), r)[0]:.3e}")
        print(f"{kernel}-bwd {label} d{name}: rel_l2 {rel:.3e} max_abs_err {err:.3e} "
              f"(largest |value| {scale:.3e}{plain})")
        if not torch.isfinite(g).all() or rel > BWD_RTOL:
            failures.append(f"{kernel} backward d{name} ({label})")
        bwd_err = max(bwd_err, err)
    return bwd_err, failures


def _event_ms(fn, repeats):
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def flagship_model(device, hidden=HIDDEN, config=FLAGSHIP):
    """The flagship's model (config) at this hidden size, from seed 0."""
    return make_model(device, config=dict(config, hidden_channels=hidden))


def time_k1_kernels(model, coeffs):
    """K1 at the model's packed operands on coeffs (the flagship's shapes):
    {k1_fwd_ms, k1_bwd_ms, k1_fwd_plain_ms, k1_bwd_plain_ms}, by CUDA events;
    the plain version runs on the same operands (a bfloat16 model's in its
    bfloat16 mode)."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    with torch.no_grad():
        p = packed_operands(model, coeffs)
    n = p.ct.shape[0]
    ops = (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2)
    plan = k1._Plan("rk4", 1, 1.0, (n,))
    out, zres = k1.launch_forward(*ops, plan)
    gz = torch.ones_like(out)
    timing = {"k1_fwd_ms": _event_ms(lambda: k1.launch_forward(*ops, plan), 10),
              "k1_bwd_ms": _event_ms(
                  lambda: k1.launch_backward(p.ct, zres, p.z0t, gz, *ops[2:], plan), 5)}
    leaves = [t.detach().clone().requires_grad_() for t in ops]
    with torch.no_grad():
        timing["k1_fwd_plain_ms"] = _event_ms(
            lambda: k1.fused_fixed_solve_reference(*ops, "rk4", 1, 1.0, (n,)), 3)
    ref = k1.fused_fixed_solve_reference(*leaves, "rk4", 1, 1.0, (n,))
    timing["k1_bwd_plain_ms"] = _event_ms(
        lambda: torch.autograd.grad(ref, leaves, gz, retain_graph=True), 3)
    return timing


def time_k1(device, coeffs, labels):
    """Phase 8: K1's forward and backward and the flagship's train step,
    kernel and plain version in turns, at each of K1_HIDDEN: {hidden:
    timing}."""
    from torchcde_tpu_torch.models.neural_cde import bce_with_logits

    timing = {}
    for hidden in K1_HIDDEN:
        model = flagship_model(device, hidden)
        timing[hidden] = time_k1_kernels(model, coeffs)
        medians, samples = time_train_steps(
            model, coeffs, labels,
            lambda m: bce_with_logits(plain_forward(m, coeffs)[..., 0], labels))
        timing[hidden].update(train_step_ms=medians, train_step_samples_ms=samples)
        timing[hidden]["fwd_plan"] = k1_plan(0, "forward", hidden)
        timing[hidden]["bwd_plan"] = k1_plan(0, "backward", hidden)
    return timing


def k1_hidden_slice(device, coeffs, labels, hidden=16):
    """Phase 5's second part: the flagship at this hidden size through the
    public entry points: the logits against the plain version, five Adam
    steps and one accuracy call with every plain version patched to raise,
    K1's launches counted."""
    from torchcde_tpu_torch.models import accuracy, make_train_step
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    model = flagship_model(device, hidden)
    with torch.no_grad():
        logits = model(coeffs)
        plain_logits = plain_forward(model, coeffs)
    err, scale = _err(logits, plain_logits)
    with plain_versions_raise():
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
        k1.reset_launch_counts()
        losses = [float(step(coeffs, labels)) for _ in range(5)]
        acc = float(accuracy(model, coeffs, labels))
        torch.cuda.synchronize()
        counts = {"fwd": k1.FWD_LAUNCHES, "bwd": k1.BWD_LAUNCHES}
    print(f"slice at hidden {hidden}: logits vs plain version max_abs_err {err:.3e} (largest "
          f"|value| {scale:.3e}); 5 Adam steps, losses {losses}, accuracy {acc:.4f}, K1 "
          f"launches {counts}", flush=True)
    failures = []
    if (logits.shape != (BATCH, 1) or not torch.isfinite(logits).all()
            or err > FWD_RTOL * max(scale, 1.0)):
        failures.append("the logits disagree with the plain version")
    if not all(math.isfinite(v) for v in losses) or losses[-1] == losses[0]:
        failures.append(f"the loss is not finite or does not change: {losses}")
    if counts != {"fwd": 6, "bwd": 5}:
        failures.append(f"the steps did not run K1 once per step: {counts}")
    if failures:
        raise AssertionError(f"the hidden-{hidden} flagship slice failed: " + "; ".join(failures))
    return {"logits_max_abs_err": err, "losses": losses, "accuracy": acc, "k1_launches": counts}


def time_train_steps(model, coeffs, labels, plain_loss, counts=(5, 2)):
    """Median train-step ms, kernel path and plain version (whose loss
    plain_loss(model) gives), in turns."""
    from torchcde_tpu_torch.models import make_train_step

    kernel_model, plain_model = copy.deepcopy(model), copy.deepcopy(model)
    kernel_step = make_train_step(
        kernel_model, torch.optim.Adam(kernel_model.parameters(), lr=1e-3, eps=1e-8))
    plain_opt = torch.optim.Adam(plain_model.parameters(), lr=1e-3, eps=1e-8)

    def plain_step():
        plain_opt.zero_grad(set_to_none=True)
        plain_loss(plain_model).backward()
        plain_opt.step()

    samples = {"kernel": [], "plain": []}

    def run(name, fn, count):
        for _ in range(count):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            samples[name].append(start.elapsed_time(end))

    kernel_fn = lambda: kernel_step(coeffs, labels)
    run("kernel", kernel_fn, 1)  # warm-up, dropped below
    run("plain", plain_step, 1)
    samples = {"kernel": [], "plain": []}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for name in order:
            run(name, kernel_fn if name == "kernel" else plain_step,
                counts[0] if name == "kernel" else counts[1])
    return {k: statistics.median(v) for k, v in samples.items()}, samples


def profile_calls(fn, kinds, calls):
    """torch.profiler over calls of fn, after one warm-up call: the device's
    busy share, kernels and copies per call, and the device ms per call of
    the kernels whose names match kinds' patterns and of all other kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    device = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    if not device:
        return {"device_events": 0, "note": "the profiler recorded no device time: not measured"}
    busy_us, reach = 0.0, -math.inf
    for start_us, end_us, _ in device:  # the union of device intervals
        busy_us += max(0.0, end_us - max(start_us, reach))
        reach = max(reach, end_us)
    kernels = [e for e in device if not e[2].startswith(("Memcpy", "Memset"))]
    kind_us = {name: sum(e[1] - e[0] for e in kernels if re.search(pattern, e[2]))
               for name, pattern in kinds.items()}
    other_us = sum(e[1] - e[0] for e in kernels
                   if not any(re.search(pattern, e[2]) for pattern in kinds.values()))
    return {
        "calls": calls, "wall_ms_per_call": wall_ms / calls,
        "device_busy_ms_per_call": busy_us / 1e3 / calls,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "device_kernels_per_call": len(kernels) / calls,
        "device_copies_per_call": (len(device) - len(kernels)) / calls,
        **{f"{name}_ms_per_call": us / 1e3 / calls for name, us in kind_us.items()},
        "other_kernels_ms_per_call": other_us / 1e3 / calls,
    }


def profile_train_steps(model, coeffs, labels, kinds, steps=3):
    """profile_calls over a few train steps of a copy of model."""
    from torchcde_tpu_torch.models import make_train_step

    model = copy.deepcopy(model)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
    return profile_calls(lambda: step(coeffs, labels), kinds, steps)


K2_SOURCE = "torchcde_tpu_torch/csrc/fused_dopri.cu"
# The default Neural CDE configuration: cubic control, dopri5, adjoint,
# rtol 1e-4, atol 1e-6 (NeuralCDEConfig's defaults), at the width of the
# repository's benchmark.
DEFAULT = dict(input_channels=CHANNELS, hidden_channels=HIDDEN, output_channels=1, width=WIDTH)
DEFAULT_BATCHES = (4096, 256)
# K2 cases: (label, batch, length, hidden, channels, width, output times,
# solver options).  Each launch of each case is checked against the plain
# version on its own realised mesh; the default cells' forwards also against
# a second launch, bit for bit (K2_REPEATED).
K2_CASES = [
    ("default B4096", 4096, LENGTH, HIDDEN, CHANNELS, WIDTH, "terminal", {}),
    ("default B256", 256, LENGTH, HIDDEN, CHANNELS, WIDTH, "terminal", {}),
    ("two groups B5000", 5000, LENGTH, HIDDEN, CHANNELS, WIDTH, "terminal", {}),
    ("three chunks n300", 512, 301, HIDDEN, CHANNELS, WIDTH, "terminal", {}),
    ("20 output times", 256, LENGTH, HIDDEN, CHANNELS, WIDTH, "twenty", {}),
    ("caps W512 H16 C5", 300, 30, 16, 5, 512, "terminal", {}),
    ("tight rtol 1e-6", 256, LENGTH, HIDDEN, CHANNELS, WIDTH, "terminal",
     dict(rtol=1e-6, atol=1e-8)),
    ("odd H5 C2 B77", 77, 40, 5, 2, 64, "terminal", {}),
    ("exhausted budget", 256, LENGTH, HIDDEN, CHANNELS, WIDTH, "twenty", dict(max_steps=8)),
    ("narrow W32 H6 C4 B200", 200, 60, 6, 4, 32, "twenty", {}),
]
K2_REPEATED = ("default B4096", "default B256")


def paths(batch, length, channels, seed):
    """Smooth paths: the spiral data for 3 channels; otherwise time and
    channels - 1 rotating coordinates."""
    if channels == CHANNELS:
        return spiral_data(batch, length, seed)[0]
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 4 * math.pi, length)
    cols = [np.broadcast_to(t, (batch, length))]
    for c in range(1, channels):
        rate, phase = rng.uniform(0.5, 1.5, (batch, 1)), rng.uniform(0, 2 * math.pi, (batch, 1))
        cols.append((0.5 + t / (4 * math.pi)) * np.sin(rate * t + phase + c))
    return np.stack(cols, axis=-1).astype(np.float32)


def k2_problem(batch, length, hidden, channels, width, seed, device, interpolation="cubic"):
    """(control, vector field, z0) of a seeded NeuralCDE on smooth paths, as
    the model's forward builds them: a Hermite ``CubicSpline``, or a
    ``LinearInterpolation`` of the paths' knots."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig

    model = NeuralCDE(NeuralCDEConfig(channels, hidden, 1, width=width,
                                      interpolation=interpolation),
                      generator=torch.Generator().manual_seed(seed)).to(device)
    x = torch.from_numpy(paths(batch, length, channels, seed)).to(device)
    if interpolation == "linear":
        X = tt.LinearInterpolation(tt.linear_interpolation_coeffs(x))
    else:
        X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x))
    with torch.no_grad():
        z0 = model.initial(X.evaluate(X.interval[0]))
    return X, model.func, z0


def k2_backward(ops, plan, store, gz, gzfin):
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    return k2.launch_backward(ops[0], store, gz, gzfin, *ops[2:], plan)


def _same_bits(a, b):
    """Whether two tensors hold the same bits (NaN included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def forward_bit_identical(kernel, label, first, launch, parts):
    """A second forward launch on the same inputs must give the same bits:
    ``parts(outputs)`` names the outputs and the written part of the store
    (the realised mesh and its states) of each launch."""
    again = launch()
    torch.cuda.synchronize()
    a, b = parts(first), parts(again)
    differ = [name for name in a if not _same_bits(a[name], b[name])]
    print(f"{kernel}-fwd {label}: a second launch bit-identical in {sorted(a)}: "
          f"{not differ}")
    return [f"{kernel} forward's {differ} differ between two launches ({label})"] if differ else []


def k2_forward_parts(out):
    """K2's outputs and the written rows of its store."""
    zout, zfin, dtfin, (zst, tst, dtst, stats) = out
    cnt = int(stats[0])
    return {"zout": zout, "zfin": zfin, "dtfin": dtfin, "stats": stats, "zst": zst[:cnt],
            "tst": tst[:cnt], "dtst": dtst[:cnt]}


def k9_forward_parts(out):
    """K9's outputs and each lane's written rows of its store."""
    zout, zfin, ctlout, nacc, natt, (zst, tst, dtst, cnt) = out
    written = torch.arange(zst.shape[0], device=cnt.device)[:, None] < cnt[None, :]
    return {"zout": zout, "zfin": zfin, "ctlout": ctlout, "nacc": nacc, "natt": natt,
            "cnt": cnt, "tst": tst[written], "dtst": dtst[written],
            "zst": zst.transpose(1, 2)[written]}


def bit_identical(kernel, label, grads, launch):
    """A second backward launch on the same inputs must give the same bits
    (the weight gradients are summed in one fixed order, without atomics)."""
    again = launch()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    print(f"{kernel}-bwd {label}: a second launch bit-identical: {same}")
    return [] if same else [f"{kernel} backward differs between two launches ({label})"]


def _k2_grads(ops, plan, store, mesh, gz, gzfin):
    """The backward kernel's gradients and autograd's through the float64
    replay of the kernel's mesh."""
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    grads = k2_backward(ops, plan, store, gz, gzfin)
    leaves = [t.detach().double().requires_grad_() for t in ops]
    outs = k2.fused_dopri5_replay(*leaves, mesh, plan)
    pairs = [(o, g.double()) for o, g in zip(outs, (gz, gzfin)) if o.numel()]
    ref = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])
    torch.cuda.synchronize()
    return grads, ref


def check_k2_launch(label, ops, dt0, plan, repeat=False):
    """One K2 launch against the plain version: the forward against the
    float64 replay of the kernel's own mesh, the kernel's mesh against the
    plain float32 solve's, and the backward against autograd through the
    replay (with K1's ReLU-kink lane screen); with ``repeat`` the forward
    also against a second launch, bit for bit."""
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    from torchcde_tpu_torch.solvers.team import team_forward_plan

    H, (n, _, C, B), W = ops[1].shape[0], ops[0].shape, ops[2].shape[0]
    label = f"{label} [{team_forward_plan(B, H, C, W, True)['lanes_per_team']} lane(s) per team]"
    first = k2.launch_forward(*ops, dt0, plan)
    zout, zfin, _dtfin, store = first
    repeated = forward_bit_identical("K2", label, first, lambda: k2.launch_forward(
        *ops, dt0, plan), k2_forward_parts) if repeat else []
    mesh = k2.read_mesh(store)
    ops64 = [t.double() for t in ops]
    with torch.no_grad():
        ref = k2.fused_dopri5_replay(*ops64, mesh, plan)
        p_out, p_fin, _, p_mesh = k2.fused_dopri5_solve_reference(*ops, dt0, plan)
    got, ref = torch.cat([zout.flatten(), zfin.flatten()]), torch.cat([r.flatten() for r in ref])
    plain = torch.cat([p_out.flatten(), p_fin.flatten()])
    counts = f"kernel {len(mesh.t)}/{mesh.attempted}, plain float32 {len(p_mesh.t)}/{p_mesh.attempted}"
    if not k2.reaches_end(mesh, plan):
        nan = bool(torch.isnan(got).all() and torch.isnan(plain).all() and torch.isnan(ref).all())
        print(f"K2 {label}: budget exhausted ({counts} accepted/attempted), all NaN: {nan}")
        return 0.0, 0.0, (0.0, 0.0), repeated + (
            [] if nan else [f"K2 exhausted budget not NaN ({label})"])
    failures = repeated
    fwd_err, scale = _err(got.double(), ref)
    # The two float32 solves take different meshes (see EXACT_TOL), so each
    # is held against a float64 solve at a hundredth of the tolerances.
    tight = plan._replace(rtol=plan.rtol * EXACT_TOL, atol=plan.atol * EXACT_TOL, cap=EXACT_CAP)
    with torch.no_grad():
        e_out, e_fin, _, e_mesh = k2.fused_dopri5_solve_reference(*ops64, dt0.double(), tight)
    exact = torch.cat([e_out.flatten(), e_fin.flatten()])
    kernel_err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    unit = plan.rtol * max(scale, 1.0)
    limit = 10 * plain_err + unit
    print(f"K2-fwd {label}: max_abs_err {fwd_err:.3e} (largest |value| {scale:.3e}); steps "
          f"accepted/attempted {counts}, float64 at {EXACT_TOL:g} x tolerances "
          f"{len(e_mesh.t)}/{e_mesh.attempted}; error against it: kernel {kernel_err:.3e}, "
          f"plain float32 {plain_err:.3e} (limit {limit:.3e}); kernel vs plain float32 "
          f"{float((got - plain).abs().max()):.3e}", flush=True)
    if not torch.isfinite(got).all() or fwd_err > FWD_RTOL * max(scale, 1.0):
        failures.append(f"K2 forward ({label})")
    if not kernel_err <= limit:
        failures.append(f"K2 forward less accurate than the plain float32 solve ({label})")
    accuracy = (kernel_err / unit, plain_err / unit)

    gen = torch.Generator(device=got.device).manual_seed(2)
    gz = torch.randn(zout.shape, generator=gen, device=got.device)
    gzfin = torch.randn(zfin.shape, generator=gen, device=got.device)
    bwd_err, bwd_failures = check_k2_backward(label, ops, plan, store, mesh, gz, gzfin)
    return fwd_err, bwd_err, accuracy, failures + bwd_failures


def check_k2_backward(label, ops, plan, store, mesh, gz, gzfin):
    """The backward kernel over a stored mesh against autograd through the
    float64 replay, with K1's ReLU-kink lane screen, and against a second
    launch on the same inputs, bit for bit."""
    H, (n, _, C, B), W = ops[1].shape[0], ops[0].shape, ops[2].shape[0]
    grads, ref_grads = _k2_grads(ops, plan, store, mesh, gz, gzfin)
    lane_err = torch.maximum(_lane_rel_l2(grads[0], ref_grads[0]),
                             _lane_rel_l2(grads[1], ref_grads[1]))
    kinked = torch.nonzero(lane_err > LANE_RTOL).flatten().tolist()
    allowed = 2 + int(KINKED_PER_RELU * B * len(mesh.t) * 7 * W)
    worst = float(lane_err.max())
    print(f"K2-bwd {label}: {len(kinked)} lanes past {LANE_RTOL:g} (limit {allowed}), "
          f"largest lane error {worst:.2e}")
    failures = []
    if len(kinked) > allowed or worst > LANE_GROSS:
        failures.append(f"K2 backward: lanes disagree ({label})")
    gz[..., kinked] = 0.0
    gzfin[..., kinked] = 0.0
    grads, ref_grads = _k2_grads(ops, plan, store, mesh, gz, gzfin)
    failures += bit_identical("K2", label, grads, lambda: k2_backward(ops, plan, store, gz, gzfin))
    bwd_err = 0.0
    for name, g, r in zip(["ct", "z0", "w1", "b1", "w2", "b2"], grads, ref_grads):
        err, scale = _err(g.double(), r)
        rel = _rel_l2(g, r)
        print(f"K2-bwd {label} d{name}: rel_l2 {rel:.3e} max_abs_err {err:.3e} "
              f"(largest |value| {scale:.3e})")
        if not torch.isfinite(g).all() or rel > BWD_RTOL:
            failures.append(f"K2 backward d{name} ({label})")
        bwd_err = max(bwd_err, err)
    return bwd_err, failures


def recorded_k2_launches(X, field, z0, ts, cfg):
    """The arguments of every K2 forward launch of one fused solve."""
    from torchcde_tpu_torch.solvers import fused_dopri, fused_dopri_kernel as k2

    calls = []
    launch = k2.launch_forward

    def record(*args, **kwargs):
        calls.append(args)
        return launch(*args, **kwargs)

    with mock.patch.object(k2, "launch_forward", record), torch.no_grad():
        if fused_dopri.try_fused_dopri5(X, field, z0, ts, cfg) is None:
            raise AssertionError("the fused dopri5 solve declined")
    return calls


def output_times(which, n):
    """A case's output times over n intervals: the two ends, twenty times
    off the knots, or times on the chunk-boundary knots 128 and 256."""
    if which == "terminal":
        return np.array([0.0, float(n)])
    if which == "boundaries":
        return np.array([0.0, 50.5, 128.0, 200.0, 256.0, float(n)])
    return np.concatenate([[0.0], np.linspace(n / 20, n, 20) - 0.37 * (np.arange(20) % 2)])


def k2_accuracy_failures(errors):
    """The sum over all launches of the kernel's and the plain float32
    solve's errors against the float64 solve (see EXACT_TOL)."""
    kernel_sum, plain_sum = (sum(e[2][i] for e in errors) for i in (0, 1))
    print(f"K2 accuracy over all launches, in units of rtol x largest magnitude: "
          f"kernel {kernel_sum:.3f}, plain float32 {plain_sum:.3f} (limit {2 * plain_sum:.3f})")
    if not kernel_sum <= 2 * plain_sum:
        return ["K2 forward less accurate than the plain float32 solve over all launches"]
    return []


def check_k2(device):
    """Phase 6: every K2 case, every launch."""
    from torchcde_tpu_torch.solvers import SolverConfig

    errors = []
    for seed, (label, B, L, H, C, W, which, options) in enumerate(K2_CASES, start=1):
        X, field, z0 = k2_problem(B, L, H, C, W, seed, device)
        n = L - 1
        ts = output_times(which, n)
        calls = recorded_k2_launches(X, field, z0, ts, SolverConfig(**options))
        print(f"K2 {label}: B{B} n{n} H{H} C{C} W{W}, {len(ts)} output times, "
              f"{len(calls)} launches", flush=True)
        for i, (*ops, dt0, plan) in enumerate(calls):
            errors.append(check_k2_launch(f"{label} #{i}", tuple(ops), dt0, plan,
                                          repeat=label in K2_REPEATED))
    failures = [f for e in errors for f in e[3]] + k2_accuracy_failures(errors)
    if failures:
        raise AssertionError("K2 disagrees with the plain version: " + "; ".join(failures))
    return max(e[0] for e in errors), max(e[1] for e in errors)


def default_model(device, batch, seed=0, config=DEFAULT):
    """A configuration (the default one unless given), built on the card, and
    its spiral data's Hermite coefficients and labels."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig

    model = NeuralCDE(NeuralCDEConfig(**config), generator=torch.Generator().manual_seed(seed))
    X_np, y_np = spiral_data(batch, LENGTH, seed)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(X_np).to(device))
    return model.to(device), coeffs, torch.from_numpy(y_np).to(device)


def k2_slice(device):
    """Phase 7: five Adam steps and one accuracy per batch size, counting the
    K2 launches of each."""
    from torchcde_tpu_torch.models import accuracy, make_train_step
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    launches = {}
    for batch in DEFAULT_BATCHES:
        model, coeffs, labels = default_model(device, batch)
        assert (model.cfg.solver, model.cfg.adjoint) == ("dopri5", True)
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
        k2.reset_launch_counts()
        losses = [float(step(coeffs, labels)) for _ in range(5)]
        acc = float(accuracy(model, coeffs, labels))
        torch.cuda.synchronize()
        launches[batch] = {"fwd": k2.FWD_LAUNCHES, "bwd": k2.BWD_LAUNCHES}
        print(f"K2 slice B{batch}: 5 Adam steps, losses {losses}, accuracy {acc:.4f}, "
              f"launches {launches[batch]}", flush=True)
        if not all(math.isfinite(v) for v in losses) or losses[-1] == losses[0]:
            raise AssertionError(f"the loss is not finite or does not change: {losses}")
        if launches[batch] != {"fwd": 6, "bwd": 5}:
            raise AssertionError(f"the default path did not run K2 once per step: {launches}")
    return launches


def plain_k2_loss(coeffs, labels):
    """The loss with K2's plain versions in place of the kernels."""
    from torchcde_tpu_torch.models.training import loss_fn
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    def loss(model):
        with mock.patch.object(k2, "_runs_kernel", lambda ct: False):
            return loss_fn(model, coeffs, labels)

    return loss


def time_k2(device):
    """K2 ms at the default configuration, batch 4096, and its plain version's."""
    import torchcde_tpu_torch as tt

    model, coeffs, _ = default_model(device, 4096)
    return time_k2_solve(tt.CubicSpline(coeffs), model)


def time_k2_solve(X, model):
    """K2 ms of the model's one-launch solve over X, forward and backward,
    and its plain version's (float32, on the card)."""
    from torchcde_tpu_torch.solvers import SolverConfig
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    with torch.no_grad():
        z0 = model.initial(X.evaluate(X.interval[0]))
    (*ops, dt0, plan), = recorded_k2_launches(X, model.func, z0, X.interval, SolverConfig())
    zout, zfin, _, store = k2.launch_forward(*ops, dt0, plan)
    gz, gzfin = torch.ones_like(zout), torch.ones_like(zfin)
    fwd_ms = _event_ms(lambda: k2.launch_forward(*ops, dt0, plan), 5)
    bwd_ms = _event_ms(lambda: k2.launch_backward(ops[0], store, gz, gzfin, *ops[2:], plan), 5)
    with torch.no_grad():
        plain_fwd_ms = _event_ms(lambda: k2.fused_dopri5_solve_reference(*ops, dt0, plan), 2)
    mesh = k2.read_mesh(store)
    leaves = [t.detach().clone().requires_grad_() for t in ops]

    def plain_bwd():
        outs = k2.fused_dopri5_replay(*leaves, mesh, plan)
        torch.autograd.grad(outs, leaves, (gz, gzfin))

    plain_bwd_ms = _event_ms(plain_bwd, 2)
    return {"k2_fwd_ms": fwd_ms, "k2_fwd_plain_ms": plain_fwd_ms, "k2_bwd_ms": bwd_ms,
            "k2_bwd_plain_ms": plain_bwd_ms, "k2_steps_accepted": len(mesh.t),
            "k2_steps_attempted": mesh.attempted}


# --------------------------------------------------------------------------
# The natural cubic fit: K3 (fill), K4 (tridiagonal), K5 (gappy tridiagonal),
# K6/K7 (the fused masked fit).
# --------------------------------------------------------------------------

FIT_SOURCES = {
    "K3": "torchcde_tpu_torch/csrc/masked_fill.cu",
    "K4": "torchcde_tpu_torch/csrc/tridiagonal.cu",
    "K5": "torchcde_tpu_torch/csrc/masked_tridiagonal.cu",
    "K6/K7": "torchcde_tpu_torch/csrc/masked_cubic.cu",
}
FIT_REPLACES = {
    "K3": "torchcde_tpu/ops/fill_pallas.py:37",
    "K4": "torchcde_tpu/ops/tridiagonal_pallas.py:70",
    "K5": "torchcde_tpu/ops/masked_tridiagonal_pallas.py:69",
    # K6's streaming kernels start at masked_cubic_pallas.py:148; at config
    # 3's length the TPU runs the resident K7, which the same kernel replaces.
    "K6/K7": "torchcde_tpu/ops/masked_cubic_resident.py:68",
}
# BASELINE config 3 (benchmarks/run_benchmarks.py:389-419, bench_cubic_fit).
FIT_BATCH, FIT_LENGTH, FIT_NAN = 8192, 4096, 0.2
# The lengths after 4096 are K6/K7's plan boundaries (a row of one warp,
# 16 x 32 positions, and one past it), one past the resident maximum, the
# cluster routes' (two blocks a row, three, four, eight: the reach) and one
# past the reach, which takes the segmented routes; they come last so that
# the earlier lengths keep their seeds.  K3 and K5, whose routes do not
# change past 4097, keep the lengths up to it.
FIT_LENGTHS = (2, 3, 17, 100, 1025, 4096, 511, 512, 513, 4097, 8192, 8193, 16384, 32768,
               32769)
SHORT_FIT_LENGTHS = FIT_LENGTHS[:FIT_LENGTHS.index(4097) + 1]
LONG_FIT_LENGTHS = FIT_LENGTHS[len(SHORT_FIT_LENGTHS):]
# The segmented lengths past 65 536: 17 segments of 3856, then 16 whole
# segments of 4096, the split that phases 13 and 41 time; last, so that the
# earlier lengths keep their seeds.
SEGMENTED_LENGTHS = (65537, 65536)
# K6/K7's rows of each NaN density at SEGMENTED_LENGTHS.  Past 4097, the
# lengths of each group share one float64 plain walk (a walk's time goes with
# its length, its peak memory, some 35 times its input's, with its rows).
SEGMENTED_FIT_ROWS = 125
K6_WALK_GROUPS = ((8192, 8193, 16384), (32768, 32769), SEGMENTED_LENGTHS)
# Rows of each NaN density in K6/K7's cases past 4097, where the four
# densities share one launch a version: the float64 plain version walks
# the positions one at a time, so one walk holds every density.
LONG_FIT_ROWS = 251
# The largest error of each route in phase 10: {"K4", "K5" or "K6/K7": {variant: error}}.
ROUTE_ERRORS = {"K4": {}, "K5": {}, "K6/K7": {}}
FIT_DENSITIES = (0.0, 0.2, 0.8, 1.0)
SPIRAL_NAN = 0.3
# The H100 SXM's datasheet rates: HBM bytes per second, float32 operations
# per second outside the tensor cores, and dense bfloat16 and TF32
# operations (float32 sums) per second on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
BF16_RTOL = 1e-2
# The fills are selections: the kernel must reproduce the plain version
# exactly.  The solves and the fit are held, like K1's forward, within
# FWD_RTOL of the largest magnitude (or 1) against the plain version in
# float64: float32 rounding in a stable elimination stays orders below it.
# Each of the fit's four outputs is held to its own largest magnitude: on
# irregular times three_d reaches ~1e3 while a and b stay ~1.
FIT_PARTS = ("a", "b", "two_c", "three_d")
# K5's kernel for each route of its solve_plan (gappy_kernel's RowMode:
# 0 RESIDENT_ROWS, 1 CLUSTERED, 2-4 the three launches of a segmented row).
K5_VARIANTS = {"resident": "gappy_kernel<0>", "cluster": "gappy_kernel<1>",
               "segmented": "gappy_kernel<2>, <3>, <4>"}
# The fit kernels' names as the profiler reports them (csrc/*.cu).
FIT_KERNEL_NAMES = {"K3": r"\bfill_kernel\b",
                    "K4": r"\b(?:shared_band|band_pivot|per_row)_kernel\b",
                    "K5": r"\bgappy_kernel\b",
                    "K6/K7": r"\b(?:resident|span)_fit_kernel\b"}


def fit_kernel_modules():
    from torchcde_tpu_torch.ops import (
        fill_kernel,
        masked_cubic_kernel,
        masked_tridiagonal_kernel,
        tridiagonal_kernel,
    )

    return {"K3": fill_kernel, "K4": tridiagonal_kernel, "K5": masked_tridiagonal_kernel,
            "K6/K7": masked_cubic_kernel}


def reset_fit_counts():
    for module in fit_kernel_modules().values():
        module.reset_launch_counts()


def fit_counts():
    return {name: module.LAUNCHES for name, module in fit_kernel_modules().items()}


def plain_versions_raise():
    """Patches every kernel's plain version to raise, so a run inside shows
    that nothing on the path fell back to one."""
    import importlib

    from torchcde_tpu_torch.interpolation import cubic
    from torchcde_tpu_torch.ops import fill, tridiagonal
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8
    from torchcde_tpu_torch.solvers import reversible_adjoint, runge_kutta

    cdeint_module = importlib.import_module("torchcde_tpu_torch.solvers.cdeint")
    mods = fit_kernel_modules()
    targets = [(fill, "masked_fill_scan"), (mods["K3"], "masked_fill_scan"),
               (tridiagonal, "tridiagonal_solve_thomas"), (tridiagonal, "tridiagonal_solve_pcr"),
               (mods["K4"], "tridiagonal_solve_thomas"),
               (cubic, "_masked_thomas_observed"), (mods["K5"], "_masked_thomas_observed"),
               (cubic, "_masked_fit_plain"), (mods["K6/K7"], "_masked_fit_plain"),
               (k1, "fused_fixed_solve_reference"), (k2, "fused_dopri5_solve_reference"),
               (k2, "fused_dopri5_replay"), (k9, "fused_dopri5_per_sample_reference"),
               (k9, "fused_dopri5_per_sample_replay"), (k8, "fused_reversible_solve_reference"),
               (k8, "fused_reversible_backward_reference"),
               (reversible_adjoint, "reversible_heun_solve"),
               (cdeint_module, "reversible_heun_solve")]

    def raiser(name):
        def fail(*args, **kwargs):
            raise AssertionError(f"the plain version {name} ran on the kernel path")
        return fail

    stack = contextlib.ExitStack()
    for module, name in targets:
        stack.enter_context(mock.patch.object(module, name, raiser(f"{module.__name__}.{name}")))
    # The reversible-Heun stepper of the plain (odeint) path.
    stepper = runge_kutta.STEPPERS["reversible_heun"]
    stack.enter_context(mock.patch.dict(runge_kutta.STEPPERS, {"reversible_heun": stepper._replace(
        init=raiser("the reversible-Heun stepper"), step=raiser("the reversible-Heun stepper"))}))
    return stack


def kernels_off():
    """Routes every fit-path call to its plain version (for timing it)."""
    from torchcde_tpu_torch.ops import dispatch

    return mock.patch.object(dispatch, "runs_kernel", lambda *tensors: False)


def _rel(got, ref):
    """(max abs error, largest |ref|) of got against a float64 reference."""
    err = float((got.double() - ref).abs().max()) if ref.numel() else 0.0
    return err, float(ref.abs().max()) if ref.numel() else 0.0


def _report(label, err, scale, limit, failures, finite=True):
    print(f"{label}: max_abs_err {err:.3e} (largest |value| {scale:.3e}; limit {limit:.3e})",
          flush=True)
    if not finite or not err <= limit:
        failures.append(label)


def _report_parts(label, got, ref, rtol, failures):
    """The fit's four outputs (a, b, two_c, three_d) against their float64
    references, each within rtol of its own largest magnitude (or 1).
    Returns the largest error."""
    line, worst = [], 0.0
    for name, g, r in zip(FIT_PARTS, got, ref):
        err, scale = _rel(g, r)
        limit = rtol * max(scale, 1.0)
        line.append(f"{name} {err:.3e} (largest |value| {scale:.3e}; limit {limit:.3e})")
        worst = max(worst, err)
        if not bool(g.isfinite().all()) or not err <= limit:
            failures.append(f"{label} {name}")
    print(f"{label}: max_abs_err " + ", ".join(line), flush=True)
    return worst


def nan_rows(rows, length, density, seed):
    """float32 values (rows, length), NaN at the given density; with enough
    rows, a leading and a trailing NaN run, a single-observation row and an
    all-NaN row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, length)).astype(np.float32)
    x[rng.random(x.shape) < density] = np.nan
    if rows >= 4 and length >= 3:
        run = max(1, length // 5)
        x[0, :run] = np.nan
        x[1, -run:] = np.nan
        x[2] = np.nan
        x[2, length // 2] = 1.5
        x[3] = np.nan
    return x


def irregular_times(length, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.uniform(0.2, 1.5, length)).astype(np.float32)


def _rows_for(length, i):
    return 1001 if length >= 1025 else 77 + 2 * i  # odd row counts


def route_text(plan, launches=3):
    """A K4's, K5's or K6/K7's plan's route, threads and segments, as text
    (a segmented route in this many launches)."""
    if plan.variant.endswith("segmented"):
        return (f"{plan.variant}, {plan.cluster} segments a row of {plan.segment} positions, "
                f"a block each, {launches} launches")
    if plan.cluster > 1:
        return (f"{plan.variant}, a cluster of {plan.cluster} blocks a row, {plan.segment} "
                f"positions a block")
    return f"{plan.variant}, {plan.threads_per_row} threads a row"


def check_k3(device):
    from torchcde_tpu_torch.ops import fill, fill_kernel

    failures, worst = [], 0.0
    for i, length in enumerate(SHORT_FIT_LENGTHS):
        rows = FIT_BATCH if length == FIT_LENGTH else _rows_for(length, i)
        for n_values in (1, 2, 5):
            for reverse in (False, True):
                density = FIT_DENSITIES[(i + n_values + reverse) % len(FIT_DENSITIES)]
                x = torch.from_numpy(nan_rows(rows, length, density, seed=i)).to(device)
                obs = ~torch.isnan(x)
                gen = torch.Generator(device=device).manual_seed(n_values)
                vals = (torch.where(obs, x, 0.0),) + tuple(
                    torch.randn(x.shape, generator=gen, device=device) for _ in range(n_values - 1))
                got = fill_kernel.masked_fill_kernel(vals, obs, reverse)
                ref = fill.masked_fill_scan(tuple(v.double() for v in vals), obs, -1, reverse)
                err = max(_rel(g, r)[0] for g, r in zip(got, ref))
                worst = max(worst, err)
                _report(f"K3 fill {rows}x{length} values {n_values} reverse {reverse} "
                        f"NaN {density:g}", err, max(_rel(g, r)[1] for g, r in zip(got, ref)),
                        0.0, failures)
    return worst, failures


def hold_route(family, label, plan, got, ref, again, failures):
    """One K4 or K5 case: got against its float64 reference within FWD_RTOL
    of the largest magnitude (or 1), finite, and bit for bit a second
    launch's; the route's largest error kept in ROUTE_ERRORS.  Returns the
    error."""
    err, scale = _rel(got, ref)
    _report(label, err, scale, FWD_RTOL * max(scale, 1.0), failures, bool(got.isfinite().all()))
    routes = ROUTE_ERRORS[family]
    routes[plan.variant] = max(routes.get(plan.variant, 0.0), err)
    if not _same_bits(got, again):
        failures.append(f"{label}: a second launch differs")
    return err


def k4_system(length, i, shared, device):
    """Phase 10's K4 system at FIT_LENGTHS-style index i: (b, u, d, l), the
    dense spline fit's bands from irregular times (one band for every row)
    or diagonally dominant bands per row."""
    rows = FIT_BATCH if (length == FIT_LENGTH and shared) else _rows_for(length, i)
    gen = torch.Generator(device=device).manual_seed(i)
    b = torch.randn((rows, length), generator=gen, device=device)
    if shared:
        t = torch.from_numpy(irregular_times(length, i)).to(device)
        hr = 1.0 / (t[1:] - t[:-1])
        zero = hr.new_zeros(1)
        return b, hr, 2 * (torch.cat([zero, hr]) + torch.cat([hr, zero])), hr
    u = torch.randn((rows, length - 1), generator=gen, device=device)
    l = torch.randn((rows, length - 1), generator=gen, device=device)
    pad = u.new_zeros((rows, 1))
    return b, u, 1.0 + torch.cat([u.abs(), pad], -1) + torch.cat([pad, l.abs()], -1), l


def check_k4(device):
    """K4 at every length of phase 10 and at SEGMENTED_LENGTHS, both band
    kinds.  Past 4097 one float64 Thomas walk a band kind serves every
    length: each length's rows padded to the longest with identity rows (d
    1, u = l = b = 0), which leave the walk's values before them unchanged,
    so a row's first k positions are its own solve's, bit for bit."""
    from torchcde_tpu_torch.ops import tridiagonal_kernel
    from torchcde_tpu_torch.ops.tridiagonal import tridiagonal_solve_thomas

    failures, worst = [], 0.0

    def label(rows, length, shared, plan):
        return (f"K4 tridiagonal {rows}x{length} {'shared' if shared else 'per-row'} bands "
                f"[{route_text(plan)}]")

    for i, length in enumerate(SHORT_FIT_LENGTHS):
        for shared in (True, False):
            system = k4_system(length, i, shared, device)
            got = tridiagonal_kernel.launch(*system)
            ref = tridiagonal_solve_thomas(*(a.double() for a in system))
            again = tridiagonal_kernel.launch(*system)
            torch.cuda.synchronize()
            plan = tridiagonal_kernel.solve_plan(length, shared)
            worst = max(worst, hold_route("K4", label(system[0].shape[0], length, shared, plan),
                                          plan, got, ref, again, failures))

    start = time.perf_counter()
    lengths = LONG_FIT_LENGTHS + SEGMENTED_LENGTHS
    longest = max(lengths)
    for shared in (True, False):
        launched, blocks = [], []
        for at, length in enumerate(lengths):
            system = k4_system(length, len(SHORT_FIT_LENGTHS) + at, shared, device)
            launched.append((length, tridiagonal_kernel.launch(*system),
                             tridiagonal_kernel.launch(*system)))
            blocks.append(system)
        offsets = [0]
        for system in blocks:
            offsets.append(offsets[-1] + system[0].shape[0])
        stacked = [torch.zeros((offsets[-1], longest - (a in (1, 3))), dtype=torch.float64,
                               device=device) for a in range(4)]
        stacked[2].fill_(1.0)
        for at, ((length, _, _), system) in enumerate(zip(launched, blocks)):
            for a, (whole, part) in enumerate(zip(stacked, system)):
                whole[offsets[at]:offsets[at + 1], :length - (a in (1, 3))] = part
        del blocks, system
        ref = tridiagonal_solve_thomas(*stacked)
        del stacked
        torch.cuda.synchronize()
        for at, (length, got, again) in enumerate(launched):
            plan = tridiagonal_kernel.solve_plan(length, shared)
            worst = max(worst, hold_route("K4", label(got.shape[0], length, shared, plan), plan,
                                          got, ref[offsets[at]:offsets[at + 1], :length], again,
                                          failures))
        del launched, ref
    print(f"K4 past 4097 (clusters and segmented rows): {time.perf_counter() - start:.1f} s",
          flush=True)
    return worst, failures


def k5_system(rows, length, density, seed, device):
    """K5's operands on the card: a random gappy system, every coupling in
    [0.2, 1.2), the mask from nan_rows."""
    obs = ~torch.isnan(torch.from_numpy(nan_rows(rows, length, density, seed=seed)).to(device))
    gen = torch.Generator(device=device).manual_seed(seed)
    hr = torch.where(obs, torch.rand(obs.shape, generator=gen, device=device) + 0.2, 0.0)
    hr_prev = torch.rand(obs.shape, generator=gen, device=device) + 0.2
    diag = 2 * (hr + hr_prev) + 0.5
    rhs = torch.randn(obs.shape, generator=gen, device=device)
    return diag, rhs, hr, hr_prev, obs


def check_k5(device):
    """K5 at every length of phase 10 and at SEGMENTED_LENGTHS.  Up to 4097
    one launch a density; past it the densities' rows stacked into one
    launch a length.  One float64 plain walk serves each of the two groups
    of lengths: each length's rows padded to the group's longest with
    missing positions, which pass the walk's carries through unchanged, so
    a row's first k positions are its own solve's, bit for bit.  Each
    density is held on its own rows."""
    from torchcde_tpu_torch.interpolation.cubic import _masked_thomas_observed
    from torchcde_tpu_torch.ops import masked_tridiagonal_kernel

    failures, worst = [], 0.0
    start = time.perf_counter()
    for lengths, stacked_launch in ((SHORT_FIT_LENGTHS, False),
                                    (LONG_FIT_LENGTHS + SEGMENTED_LENGTHS, True)):
        first = 0 if lengths is SHORT_FIT_LENGTHS else len(SHORT_FIT_LENGTHS)
        cases = []  # (length, rows, densities' rows in the walk, got, again)
        parts_of = []
        for at, length in enumerate(lengths):
            i = first + at
            rows = LONG_FIT_ROWS if stacked_launch else _rows_for(length, i)
            parts = [k5_system(rows, length, density, 10 * i + j, device)
                     for j, density in enumerate(FIT_DENSITIES)]
            groups = [parts] if stacked_launch else [[part] for part in parts]
            for group in groups:
                operands = tuple(torch.cat([part[a] for part in group]) for a in range(5))
                cases.append((length, rows, len(group),
                              masked_tridiagonal_kernel.launch(*operands),
                              masked_tridiagonal_kernel.launch(*operands)))
            parts_of.append(parts)
        total = sum(case[1] * case[2] for case in cases)
        shape = (total, max(lengths))
        stacked = [torch.zeros(shape, dtype=torch.float64, device=device) for _ in range(4)]
        stacked.append(torch.zeros(shape, dtype=torch.bool, device=device))
        row = 0
        for length, parts in zip(lengths, parts_of):
            for part in parts:
                for whole, a in zip(stacked, part):
                    whole[row:row + a.shape[0], :length] = a
                row += part[0].shape[0]
        del parts_of, parts
        ref = _masked_thomas_observed(*stacked)
        del stacked
        torch.cuda.synchronize()
        row, j = 0, 0
        for length, rows, count, got, again in cases:
            plan = masked_tridiagonal_kernel.solve_plan(length)
            for at in range(count):
                mine = slice(at * rows, (at + 1) * rows)
                label = (f"K5 gappy tridiagonal {rows}x{length} "
                         f"NaN {FIT_DENSITIES[j % len(FIT_DENSITIES)]:g} [{route_text(plan)}]")
                worst = max(worst, hold_route("K5", label, plan, got[mine],
                                              ref[row:row + rows, :length], again[mine],
                                              failures))
                row, j = row + rows, j + 1
        del cases, ref
        print(f"K5 {'past' if stacked_launch else 'up to'} 4097: "
              f"{time.perf_counter() - start:.1f} s", flush=True)
        start = time.perf_counter()
    return worst, failures


def check_k5_case(label, operands, failures):
    """One K5 launch on float32 operands (and the mask) against the float64
    plain version, and a second launch bit for bit.  Returns the error."""
    from torchcde_tpu_torch.interpolation.cubic import _masked_thomas_observed
    from torchcde_tpu_torch.ops import masked_tridiagonal_kernel

    operands = tuple(a.detach() for a in operands)
    got = masked_tridiagonal_kernel.launch(*operands)
    ref = _masked_thomas_observed(*(a.double() for a in operands[:4]), operands[4])
    err, scale = _rel(got, ref)
    _report(label, err, scale, FWD_RTOL * max(scale, 1.0), failures, bool(got.isfinite().all()))
    again = masked_tridiagonal_kernel.launch(*operands)
    torch.cuda.synchronize()
    if not _same_bits(got, again):
        failures.append(f"{label}: a second launch differs")
    return err


def segment_gaps(x):
    """Segmented rows (float32 (rows, length), from nan_rows) with whole
    segments empty: row 4 without an observation over a quarter of the row
    (several whole segments), row 5 with its observations in one stretch of
    1000 positions at the middle."""
    length = x.shape[1]
    if x.shape[0] >= 6:
        x[4, length // 4:length // 2] = np.nan
        keep = x[5, length // 2:length // 2 + 1000].copy()
        x[5] = np.nan
        x[5, length // 2:length // 2 + 1000] = keep
    return x


def check_k6(device):
    """K6/K7 at every length of phase 10 and at SEGMENTED_LENGTHS, both
    imputation versions.  Both versions' float64 references come from one
    plain pipeline call on the two imputations' rows stacked: its rows are
    independent, so each half is _masked_fit_plain's for its version, bit
    for bit.  A length's densities share one plain walk (past 4097 one
    launch a version too), and past 4097 the lengths of each of
    K6_WALK_GROUPS share one: each row takes its own times, and its imputed
    values, padded with missing positions to the group's longest length,
    fit as they do alone, bit for bit.  The segmented lengths' rows are
    SEGMENTED_FIT_ROWS a density, with whole segments left empty
    (segment_gaps).  Each density is held on its own rows."""
    from torchcde_tpu_torch.interpolation.cubic import _impute_endpoints, _masked_coeffs_plain
    from torchcde_tpu_torch.ops import masked_cubic_kernel

    def launches(i, length):
        """(length, times, rows a density, [[(density index, rows of x)]]):
        the densities' launches at this length."""
        rows = (SEGMENTED_FIT_ROWS if length in SEGMENTED_LENGTHS else
                LONG_FIT_ROWS if length in LONG_FIT_LENGTHS else _rows_for(length, i))
        parts = [(j, nan_rows(rows, length, density, seed=100 + 10 * i + j))
                 for j, density in enumerate(FIT_DENSITIES)]
        if length in SEGMENTED_LENGTHS:
            parts = [(j, segment_gaps(x)) for j, x in parts]
        short = length in SHORT_FIT_LENGTHS
        return length, irregular_times(length, i), rows, [[p] for p in parts] if short else [parts]

    lengths = FIT_LENGTHS + SEGMENTED_LENGTHS
    walks = [[launches(i, length)] for i, length in enumerate(SHORT_FIT_LENGTHS)]
    walks += [[launches(lengths.index(length), length) for length in group]
              for group in K6_WALK_GROUPS]
    failures, worst = [], 0.0
    for walk in walks:
        start = time.perf_counter()
        longest = max(length for length, *_ in walk)
        # Each launch's rows of x, and of every row's times (zero past its
        # length), in the walk's order: a launch's rows imputed by version
        # 0, then by version 1.
        runs, imputed, times = [], [], []
        for length, t, rows, groups in walk:
            t = torch.from_numpy(t).to(device)
            for parts in groups:
                x = torch.from_numpy(np.concatenate([x for _, x in parts])).to(device)
                runs.append((length, t, rows, parts, x))
                for version in (0, 1):
                    imputed.append(torch.nn.functional.pad(
                        _impute_endpoints(x.double(), version), (0, longest - length),
                        value=float("nan")))
                    times.append(torch.nn.functional.pad(t.double(), (0, longest - length))
                                 .expand(x.shape[0], -1))
        both = _masked_coeffs_plain(torch.cat(times), torch.cat(imputed))
        del imputed, times
        row = 0
        for length, t, rows, parts, x in runs:
            plan = masked_cubic_kernel.fit_plan(length)
            for version in (0, 1):
                got = masked_cubic_kernel.launch(t, x, version)
                ref = [r[row:row + x.shape[0], :length - 1] for r in both]
                row += x.shape[0]
                again = masked_cubic_kernel.launch(t, x, version)
                torch.cuda.synchronize()
                for at, (j, _) in enumerate(parts):
                    rows_of = slice(at * rows, (at + 1) * rows)
                    label = (f"K6/K7 masked fit {rows}x{length} NaN {FIT_DENSITIES[j]:g} version "
                             f"{version} [{route_text(plan, 4)}]")
                    err = _report_parts(label, [g[rows_of] for g in got],
                                        [r[rows_of] for r in ref], FWD_RTOL, failures)
                    worst = max(worst, err)
                    routes = ROUTE_ERRORS["K6/K7"]
                    routes[plan.variant] = max(routes.get(plan.variant, 0.0), err)
                    if not all(_same_bits(a[rows_of], b[rows_of]) for a, b in zip(got, again)):
                        failures.append(f"{label}: a second launch differs")
                del got, ref, again
        del both, runs
        if longest > 4097:
            print(f"K6/K7 at {', '.join(str(length) for length, *_ in walk)}: "
                  f"{time.perf_counter() - start:.1f} s", flush=True)
    return worst, failures


def check_bf16_fit(device):
    """bfloat16 values enter the fit's kernels as float32 and leave as
    bfloat16: the public fit, masked (K6/K7) and dense (K4), against the
    float64 plain path on the same (bfloat16) values, within BF16_RTOL of
    each output's largest magnitude (the output's own rounding is 2**-8 of
    each value)."""
    import torchcde_tpu_torch as tt

    failures = []
    for density in (0.2, 0.0):
        x = torch.from_numpy(nan_rows(77, 100, density, seed=7)).to(device).bfloat16()[..., None]
        got = tt.natural_cubic_coeffs(x)
        ref = tt.natural_cubic_coeffs(x.double())
        label = f"bfloat16 fit 77x100 NaN {density:g}"
        if got.dtype != torch.bfloat16:
            failures.append(f"{label}: dtype {got.dtype}")
        _report_parts(label, got.chunk(4, dim=-1), ref.chunk(4, dim=-1), BF16_RTOL, failures)
    return failures


def check_fit_kernels(device):
    """Phase 10: K3, K4, K5 and K6/K7 against their plain versions."""
    errors, failures = {}, []
    for name, check in (("K3", check_k3), ("K4", check_k4), ("K5", check_k5),
                        ("K6/K7", check_k6)):
        start = time.perf_counter()
        errors[name], failed = check(device)
        failures += failed
        print(f"{name} checks: {time.perf_counter() - start:.1f} s", flush=True)
    failures += check_bf16_fit(device)
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("fit kernels disagree with the plain version: " + "; ".join(failures))
    return errors


def config3_data():
    """x (8192, 4096, 1) float32 as bench_cubic_fit makes it, and the same
    draw before the NaNs went in."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((FIT_BATCH, FIT_LENGTH, 1)).astype(np.float32)
    dense = x.copy()
    x[rng.random(x.shape) < FIT_NAN] = np.nan
    return x, dense


def fit_slice(device, recorded):
    """Phase 11: the config-3 fit through natural_cubic_coeffs, forward and
    gradient, masked and dense.  ``recorded`` collects the arguments of the
    K3 and K5 launches of the masked gradient, for the timing phase; K5 is
    held against its float64 plain version on the last of them."""
    import torchcde_tpu_torch as tt

    masked, dense = config3_data()
    w = torch.randn((FIT_BATCH, FIT_LENGTH - 1, 4),
                    generator=torch.Generator(device=device).manual_seed(3), device=device)
    expected = {"masked": ({"K3": 0, "K4": 0, "K5": 0, "K6/K7": 1},
                           {"K3": 10, "K4": 0, "K5": 2, "K6/K7": 1}),
                "dense": ({"K3": 0, "K4": 1, "K5": 0, "K6/K7": 0},
                          {"K3": 0, "K4": 2, "K5": 0, "K6/K7": 0})}
    launches, errors, failures = {"K3": 0, "K4": 0, "K5": 0, "K6/K7": 0}, {}, []
    mods = fit_kernel_modules()
    fill_launch, solve_launch = mods["K3"].launch, mods["K5"].launch

    def record_fill(values, observed, reverse):
        if len(values) == 5:
            recorded["K3"] = (values, observed, reverse)
        return fill_launch(values, observed, reverse)

    def record_solve(*args):
        recorded["K5"] = args
        return solve_launch(*args)

    for label, data in (("masked", masked), ("dense", dense)):
        x = torch.from_numpy(data).to(device)
        # The float64 plain path (the dtype rule), before the plain versions
        # are patched to raise.
        x64 = x.double().requires_grad_()
        ref = tt.natural_cubic_coeffs(x64)
        (ref_grad,) = torch.autograd.grad((ref * w.double()).sum(), x64)
        ref = ref.detach()
        with plain_versions_raise(), \
                mock.patch.object(mods["K3"], "launch", record_fill), \
                mock.patch.object(mods["K5"], "launch", record_solve):
            reset_fit_counts()
            coeffs = tt.natural_cubic_coeffs(x)
            torch.cuda.synchronize()
            fwd = fit_counts()
            reset_fit_counts()
            xg = x.clone().requires_grad_()
            (grad,) = torch.autograd.grad((tt.natural_cubic_coeffs(xg) * w).sum(), xg)
            torch.cuda.synchronize()
            bwd = fit_counts()
        print(f"fit slice {label} {tuple(x.shape)}: launches forward {fwd}, gradient {bwd}",
              flush=True)
        if (fwd, bwd) != expected[label]:
            raise AssertionError(f"the {label} fit did not launch {expected[label]}: {fwd}, {bwd}")
        for name in launches:
            launches[name] += fwd[name] + bwd[name]
        if coeffs.shape != (FIT_BATCH, FIT_LENGTH - 1, 4):
            raise AssertionError(f"coefficients of shape {tuple(coeffs.shape)}")
        # The packed coefficients' four blocks (one channel each).
        errors[(label, "coefficients")] = _report_parts(
            f"fit slice {label} coefficients vs plain float64", coeffs.chunk(4, dim=-1),
            ref.chunk(4, dim=-1), FWD_RTOL, failures)
        err, scale = _rel(grad, ref_grad)
        errors[(label, "gradient")] = err
        _report(f"fit slice {label} gradient vs plain float64", err, scale,
                FWD_RTOL * max(scale, 1.0), failures, bool(grad.isfinite().all()))
    # K5 on the masked gradient's own operands (its transpose solve).
    errors[("masked", "K5")] = check_k5_case(
        f"K5 gappy tridiagonal on the config-3 masked gradient's operands "
        f"{tuple(recorded['K5'][0].shape)}", recorded["K5"], failures)
    if failures:
        raise AssertionError("the config-3 fit disagrees with the plain path: " + "; ".join(failures))
    return launches, errors


def nan_spiral_slice(device):
    """Phase 12: the spiral data with 30 % of the values missing, natural
    cubic coefficients, five Adam steps of the default Neural CDE."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, make_train_step
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    X_np, y_np = nan_spiral_data(BATCH, LENGTH)
    X, labels = torch.from_numpy(X_np).to(device), torch.from_numpy(y_np).to(device)
    ref = tt.natural_cubic_coeffs(X.double())
    with plain_versions_raise():
        reset_fit_counts()
        coeffs = tt.natural_cubic_coeffs(X)
        torch.cuda.synchronize()
        fit = fit_counts()
        model = NeuralCDE(NeuralCDEConfig(**DEFAULT), generator=torch.Generator().manual_seed(0))
        if next(model.parameters()).device.type != device.type or model.cfg.solver != "dopri5":
            raise AssertionError("the default Neural CDE is not the card's dopri5 model")
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
        k2.reset_launch_counts()
        losses = [float(step(coeffs, labels)) for _ in range(5)]
        torch.cuda.synchronize()
        k2_counts = {"fwd": k2.FWD_LAUNCHES, "bwd": k2.BWD_LAUNCHES}
    failures = []
    err = _report_parts(f"NaN spiral slice B{BATCH} coefficients {tuple(coeffs.shape)} vs plain "
                        "float64", coeffs.chunk(4, dim=-1), ref.chunk(4, dim=-1), FWD_RTOL,
                        failures)
    print(f"NaN spiral slice: fit launches {fit}; 5 Adam steps, losses {losses}, "
          f"K2 launches {k2_counts}", flush=True)
    if fit != {"K3": 0, "K4": 0, "K5": 0, "K6/K7": 1}:
        raise AssertionError(f"the NaN spiral fit did not launch K6/K7 once: {fit}")
    if failures:
        raise AssertionError("the NaN spiral coefficients disagree with the plain path: "
                             + "; ".join(failures))
    if not all(math.isfinite(v) for v in losses) or losses[-1] == losses[0]:
        raise AssertionError(f"the loss is not finite or does not change: {losses}")
    if k2_counts != {"fwd": 5, "bwd": 5}:
        raise AssertionError(f"the NaN spiral steps did not run K2 once per step: {k2_counts}")
    return fit, k2_counts, err


# --------------------------------------------------------------------------
# The log-ODE Neural RDE path (BASELINE config 4) and the irregular
# preprocessing (config 2): K2's linear-control mode, and K3 in the NaN
# infill of linear interpolation.
# --------------------------------------------------------------------------

# BASELINE config 4 (benchmarks/run_benchmarks.py:451-497, bench_log_ode_train):
# depth-3 windowed logsignatures of 256 spirals of length 10 000, window 100
# (101 knots of 14 channels), linear interpolation, dopri5 with the adjoint,
# hidden 8, width 128.
LOG_ODE_BATCH, LOG_ODE_LENGTH, LOG_ODE_DEPTH, LOG_ODE_WINDOW = 256, 10000, 3, 100.0
LOG_ODE_CHANNELS = 14
LOG_ODE = dict(input_channels=LOG_ODE_CHANNELS, hidden_channels=HIDDEN, output_channels=1,
               width=WIDTH, interpolation="linear")
# BASELINE config 2 (run_benchmarks.py:348-386, bench_irregular): 1024 series
# of length 256, a time channel and 8 values of which 30 % are missing.
IRREGULAR_BATCH, IRREGULAR_LENGTH, IRREGULAR_VALUES, IRREGULAR_NAN = 1024, 256, 8, 0.3
# K2 linear-mode cases beside the config-4 control itself: (label, batch,
# length, hidden, channels, width, output times, solver options).
K2_LINEAR_CASES = [
    ("specialised H8 C3 B4096", 4096, LENGTH, HIDDEN, CHANNELS, WIDTH, "terminal", {}),
    ("cap C16 B300", 300, 60, HIDDEN, 16, WIDTH, "terminal", {}),
    ("chunks with lead n300", 256, 301, HIDDEN, LOG_ODE_CHANNELS, WIDTH, "boundaries", {}),
    ("two groups B5000", 5000, LENGTH, HIDDEN, CHANNELS, WIDTH, "terminal", {}),
    ("exhausted budget", 256, LENGTH, HIDDEN, LOG_ODE_CHANNELS, WIDTH, "twenty",
     dict(max_steps=8)),
    ("config-4 widths B4096", 4096, LENGTH, HIDDEN, LOG_ODE_CHANNELS, WIDTH, "terminal", {}),
]
K2_KINDS = {"k2_fwd": r"\bdopri_fwd_team_kernel\b", "k2_bwd": r"\bdopri_bwd_team_kernel\b"}


def log_ode_data(device, nan):
    """Config 4's spirals (256 x 10 000 x 3) on the card; with ``nan``, 30 %
    of the two value channels' entries missing (numpy rng seed 1, as phase
    12; the time channel stays observed)."""
    data = nan_spiral_data if nan else spiral_data
    X_np, y_np = data(LOG_ODE_BATCH, LOG_ODE_LENGTH)
    return torch.from_numpy(X_np).to(device), torch.from_numpy(y_np).to(device)


def log_ode_model(device, seed=0):
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig

    model = NeuralCDE(NeuralCDEConfig(**LOG_ODE), generator=torch.Generator().manual_seed(seed))
    return model.to(device)


def probe_knot_slopes(X, field, z0):
    """K2-linear's choice of slope at exact knots: the backward kernel over
    hand-made one-step meshes whose stages land on knots, from knot 1 to
    knot 2 (stage times 1, 1.2, 1.3, 1.8, 1.89, 2, 2) and, in a chunk that
    starts at knot 2 with ``lead``, from knot 2 to knot 3.  The slope rows
    its dct touches must be those that ``LinearInterpolation.derivative``
    reads at the stage times (the left one at a knot), and its gradients
    must agree with the float64 replay."""
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
    from torchcde_tpu_torch.solvers.fused_fixed_kernel import pack_operands
    from torchcde_tpu_torch.solvers.runge_kutta import DOPRI5

    with torch.no_grad():
        p = pack_operands(X._derivs, None, None, z0, field, linear=True)
    device, (H, B) = p.ct.device, p.z0t.shape
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    errors, failures = [], []
    # (step start, the chunk's first interval j0 on the grid 0, 1, ..., lead)
    for t0, j0, lead in ((1.0, 0, False), (2.0, 2, True)):
        base = j0 - lead  # the table's first row is interval base
        ct = p.ct[base:].contiguous()
        plan = k2.Plan((), t0, t0 + 1.0, float(j0), 1.0, 1e-4, 1e-6, 1, linear=True, lead=lead)
        stage_times = np.float32(t0) + np.float32([0.0] + list(DOPRI5.alpha)) * np.float32(1.0)
        store = (p.z0t[None].contiguous(), f32([t0]), f32([1.0]),
                 torch.tensor([1, 1], dtype=torch.int32, device=device))
        mesh = k2.Mesh(np.float32([t0]), np.float32([1.0]), 1)
        gzout = torch.zeros((0, H, B), device=device)
        gzfin = torch.randn((H, B), generator=gen, device=device)
        ops = (ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2)
        dct = k2.launch_backward(ct, store, gzout, gzfin, *ops[2:], plan)[0]
        touched = torch.nonzero(dct.abs().sum(dim=(1, 2, 3)) > 0).flatten().tolist()
        _, index = X._interpret_t(torch.from_numpy(stage_times).to(device))
        expected = sorted(set((index - base).tolist()))
        label = f"linear knot probe t {t0:g} to {t0 + 1:g}, lead {lead}"
        print(f"K2-bwd {label}: slope rows touched {touched}, LinearInterpolation.derivative "
              f"reads {expected}", flush=True)
        if touched != expected:
            failures.append(f"K2 linear slope choice at knots ({label})")
        err, failed = check_k2_backward(label, ops, plan, store, mesh, gzout, gzfin)
        errors.append(err)
        failures += failed
    return max(errors), failures


def check_k2_linear(device, coeffs, model):
    """Phase 14: K2's linear mode against its plain version, per realised
    mesh as phase 6 holds the cubic mode, on every launch of the config-4
    control's solve and of the K2_LINEAR_CASES, then the slope chosen at
    exact knots.  Returns the largest forward and backward errors."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers import SolverConfig

    X = tt.LinearInterpolation(coeffs)
    with torch.no_grad():
        z0 = model.initial(X.evaluate(X.interval[0]))
    problems = [("config 4", X, model.func, z0, X.interval, {})]
    for seed, (label, B, L, H, C, W, which, options) in enumerate(K2_LINEAR_CASES, start=1):
        Xc, field, z0c = k2_problem(B, L, H, C, W, seed, device, "linear")
        problems.append((label, Xc, field, z0c, output_times(which, L - 1), options))
    errors, failures, leads = [], [], 0
    for label, Xc, field, z0c, ts, options in problems:
        calls = recorded_k2_launches(Xc, field, z0c, ts, SolverConfig(**options))
        (B, H), (n, C) = z0c.shape, Xc._derivs.shape[-2:]
        print(f"K2-linear {label}: B{B} n{n} H{H} C{C} W{field.linear1.out_features}, "
              f"{len(ts)} output times, {len(calls)} launches, lead "
              f"{[plan.lead for *_, plan in calls]}", flush=True)
        if not all(plan.linear for *_, plan in calls):
            failures.append(f"K2 linear mode not taken ({label})")
        leads += sum(plan.lead for *_, plan in calls)
        for i, (*ops, dt0, plan) in enumerate(calls):
            errors.append(check_k2_launch(f"linear {label} #{i}", tuple(ops), dt0, plan,
                                          repeat=label == "config 4"))
    failures += [f for e in errors for f in e[3]] + k2_accuracy_failures(errors)
    if not leads:
        failures.append("no K2 linear launch ran with lead")
    probe_err, probe_failures = probe_knot_slopes(X, model.func, z0)
    failures += probe_failures
    if failures:
        raise AssertionError("K2's linear mode disagrees with the plain version: "
                             + "; ".join(failures))
    return max(e[0] for e in errors), max(max(e[1] for e in errors), probe_err)


def log_ode_slice(device):
    """Phase 15: config 4 through the public entry points, without and with
    30 % NaN: logsig_windows on the card against the same code in float64,
    linear_interpolation_coeffs, then five Adam steps and one accuracy call
    of the linear Neural CDE (dopri5, adjoint), with K2's and K3's launches
    counted and every plain version patched to raise."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import accuracy, make_train_step
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    results = {}
    for label, nan in (("dense", False), ("30 % NaN", True)):
        x, labels = log_ode_data(device, nan)
        ref = tt.logsig_windows(x.double(), LOG_ODE_DEPTH, LOG_ODE_WINDOW)
        with plain_versions_raise():
            reset_fit_counts()
            logsig = tt.logsig_windows(x, LOG_ODE_DEPTH, LOG_ODE_WINDOW)
            coeffs = tt.linear_interpolation_coeffs(logsig)
            torch.cuda.synchronize()
            fit = fit_counts()
            model = log_ode_model(device)
            step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
            k2.reset_launch_counts()
            losses = [float(step(coeffs, labels)) for _ in range(5)]
            acc = float(accuracy(model, coeffs, labels))
            torch.cuda.synchronize()
            counts = {"fwd": k2.FWD_LAUNCHES, "bwd": k2.BWD_LAUNCHES,
                      "linear_fwd": k2.LINEAR_FWD_LAUNCHES, "linear_bwd": k2.LINEAR_BWD_LAUNCHES}
        failures = []
        err, scale = _rel(logsig, ref)
        _report(f"log-ODE slice {label}: logsig_windows {tuple(logsig.shape)} vs plain float64",
                err, scale, FWD_RTOL * max(scale, 1.0), failures, bool(logsig.isfinite().all()))
        print(f"log-ODE slice {label}: fit launches {fit}; 5 Adam steps, losses {losses}, "
              f"accuracy {acc:.4f}, K2 launches {counts}", flush=True)
        expected_fit = {"K3": 2 if nan else 0, "K4": 0, "K5": 0, "K6/K7": 0}
        if logsig.shape != (LOG_ODE_BATCH, LOG_ODE_LENGTH // 100 + 1, LOG_ODE_CHANNELS):
            failures.append(f"logsig_windows of shape {tuple(logsig.shape)}")
        if fit != expected_fit:
            failures.append(f"the fills did not launch {expected_fit}: {fit}")
        if not all(math.isfinite(v) for v in losses) or losses[-1] == losses[0]:
            failures.append(f"the loss is not finite or does not change: {losses}")
        if counts != {"fwd": 6, "bwd": 5, "linear_fwd": 6, "linear_bwd": 5}:
            failures.append(f"the steps did not run K2's linear mode once per step: {counts}")
        if failures:
            raise AssertionError(f"the log-ODE slice ({label}) failed: " + "; ".join(failures))
        results[label] = {"logsig_max_abs_err": err, "losses": losses, "accuracy": acc,
                          "k2_launches": counts, "fit_launches": fit}
    return results


def irregular_data():
    """x (1024, 256, 9) float32 as bench_irregular makes it: a time channel,
    then 8 values with 30 % NaN."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((IRREGULAR_BATCH, IRREGULAR_LENGTH, IRREGULAR_VALUES)).astype(np.float32)
    x[rng.random(x.shape) < IRREGULAR_NAN] = np.nan
    t_chan = np.broadcast_to(np.linspace(0, 1, IRREGULAR_LENGTH)[:, None],
                             (IRREGULAR_BATCH, IRREGULAR_LENGTH, 1)).astype(np.float32)
    return np.concatenate([t_chan, x], axis=-1)


def irregular_slice(device):
    """Phase 16: config 2's preprocessing, linear_interpolation_coeffs with
    and without rectilinear=0, against the float64 plain path, with K3's
    launches counted and every plain version patched to raise: two fills
    for the infill, and a forward fill before it for rectilinear."""
    import torchcde_tpu_torch as tt

    x = torch.from_numpy(irregular_data()).to(device)
    launches, errors, failures = 0, {}, []
    for label, kwargs, expected_k3, length in (
            ("linear", {}, 2, IRREGULAR_LENGTH),
            ("rectilinear", dict(rectilinear=0), 3, 2 * IRREGULAR_LENGTH - 1)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ref = tt.linear_interpolation_coeffs(x.double(), **kwargs)
            with plain_versions_raise():
                reset_fit_counts()
                got = tt.linear_interpolation_coeffs(x, **kwargs)
                torch.cuda.synchronize()
                fit = fit_counts()
        err, scale = _rel(got, ref)
        errors[label] = err
        _report(f"irregular slice {label} {tuple(got.shape)} vs plain float64 (fit launches "
                f"{fit}, {len(caught)} warnings)", err, scale, FWD_RTOL * max(scale, 1.0),
                failures, bool(got.isfinite().all()))
        if got.shape != (IRREGULAR_BATCH, length, IRREGULAR_VALUES + 1):
            failures.append(f"{label} coefficients of shape {tuple(got.shape)}")
        if fit != {"K3": expected_k3, "K4": 0, "K5": 0, "K6/K7": 0}:
            failures.append(f"{label}: the fills did not launch K3 {expected_k3} times: {fit}")
        launches += fit["K3"]
    if failures:
        raise AssertionError("the config-2 preprocessing failed: " + "; ".join(failures))
    return launches, errors


def time_log_ode(device, coeffs, labels, x):
    """Phase 17: K2-linear at config 4 against its plain version (float32,
    on the card) and its bound, the config-4 train step against the plain
    version, logsig_windows by itself, and a profile of the train step."""
    import torchcde_tpu_torch as tt

    model = log_ode_model(device)
    k2_ms = time_k2_solve(tt.LinearInterpolation(coeffs), model)
    fwd_bound, bwd_bound = k2_bounds(k2_ms, LOG_ODE_BATCH, coeffs.shape[-2] - 1, LOG_ODE_CHANNELS, 1)
    medians, samples = time_train_steps(model, coeffs, labels, plain_k2_loss(coeffs, labels),
                                        counts=(5, 1))
    with torch.no_grad():
        logsig_ms = _event_ms(lambda: tt.logsig_windows(x, LOG_ODE_DEPTH, LOG_ODE_WINDOW), 3)
    profile = profile_train_steps(model, coeffs, labels, K2_KINDS)
    if "device_busy_ms_per_call" in profile:
        profile["k2_share_of_busy"] = ((profile["k2_fwd_ms_per_call"] + profile["k2_bwd_ms_per_call"])
                                       / profile["device_busy_ms_per_call"])
    timing = {f"linear_{k}": v for k, v in k2_ms.items()}
    timing.update({"linear_k2_fwd_bound_ms": fwd_bound[0], "linear_k2_bwd_bound_ms": bwd_bound[0],
                   "log_ode_train_step_ms": medians, "log_ode_train_step_samples_ms": samples,
                   "logsig_windows_ms": logsig_ms})
    return timing, (fwd_bound, bwd_bound), profile


# --------------------------------------------------------------------------
# The reversible-Heun Neural CDE (BASELINE config 5): K8.
# --------------------------------------------------------------------------

K8_SOURCE = "torchcde_tpu_torch/csrc/fused_reversible.cu"
K8_BWD_SOURCE = "torchcde_tpu_torch/csrc/fused_reversible_bwd.cu"
# BASELINE config 5 (benchmarks/run_benchmarks.py:500-578, bench_rev_heun):
# the spiral data at batch 16384, Hermite coefficients, reversible Heun at
# step 1.0, hidden 8, width 128, with direct backpropagation and with the
# exact inverse-map adjoint.
CONFIG5_BATCH = 16384
CONFIG5 = dict(input_channels=CHANNELS, hidden_channels=HIDDEN, output_channels=1, width=WIDTH,
               interpolation="cubic", solver="reversible_heun", step_size=1.0)
# Odd K8 cases: (batch, intervals, hidden, channels, width, substeps, knots
# whose cotangent is nonzero).  Every m in {1, 2, 8}, shapes at the caps
# (C * H <= 512, 3 * C <= 16, width <= 512), batches that are not a multiple
# of 32 or of the specialised backward's 128-lane blocks, H 8, C 3 at widths
# of two (W 200) and four (W 500, and the top of the range, W 512) chunks of
# the backward's 128 staged rows, and a batch of 313 lane groups, more than
# an H100's SMs hold at once, so that the backward's blocks stride.
K8_CASES = [
    (1000, 99, 8, 3, 128, 2, "terminal"),
    (333, 20, 8, 3, 128, 8, "subset"),
    (300, 12, 100, 5, 512, 8, "subset"),
    (520, 40, 16, 5, 512, 2, "terminal"),
    (77, 30, 7, 2, 64, 1, "all"),
    (250, 30, 8, 3, 500, 1, "all"),
    (16300, 20, 8, 3, 128, 1, "all"),
    (700, 12, 8, 3, 512, 2, "subset"),
    (400, 10, 8, 3, 200, 1, "all"),
    (40000, 6, 8, 3, 128, 1, "terminal"),
]
K8_KINDS = {"k8_fwd": r"\brev_fwd_(?:split_)?kernel\b", "k8_bwd": r"\brev_bwd_kernel\b"}
# Config 5 at its hidden size and at 16 and 32: every other width as BASELINE
# config 5 has it.
K8_HIDDEN = (HIDDEN, 16, 32)


def _k8_gradients(operands, y, yhat, gy, plan):
    """The backward kernel's gradients, and autograd's through the plain
    version in float64 and in float32."""
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    grads = k8.launch_backward(operands[0], y, yhat, gy, *operands[2:], plan)
    plain = []
    for dtype in (torch.float64, torch.float32):
        leaves = [t.detach().to(dtype).requires_grad_() for t in operands]
        ref, _ = k8.fused_reversible_solve_reference(*leaves, plan.m, plan.dt_sub)
        plain.append(torch.autograd.grad(ref, leaves, gy.to(dtype)))
    torch.cuda.synchronize()
    return grads, plain[0], plain[1]


def check_k8(label, operands, plan, which):
    """K8 forward (y and ŷ) against the plain version in float64, and the
    backward, for a cotangent on the knots ``which``, against autograd
    through it (``screened_backward``)."""
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    H, (n, _, C, B), W = operands[1].shape[0], operands[0].shape, operands[2].shape[0]
    fwd_plan = k8.forward_plan(B, H, C, W)
    bwd_plan = k8.backward_plan(B, H, C, W, operands[0].device)
    path = ("resident", "streamed")
    label = (f"{label} [forward: weights {path[fwd_plan['streamed']]}, "
             f"{fwd_plan['warps_per_lane_group']} warp(s) a lane group; backward: weights "
             f"{path[bwd_plan['variant']]}, {bwd_plan['threads'] // bwd_plan['lanes_per_block']} "
             f"thread(s) a lane]")
    k8.reset_launch_counts()
    y, yhat = k8.launch_forward(*operands, plan)
    with torch.no_grad():
        refs = [torch.cat(k8.fused_reversible_solve_reference(
            *(t.to(dtype) for t in operands), plan.m, plan.dt_sub))
            for dtype in (torch.float64, torch.float32)]
    torch.cuda.synchronize()
    got = torch.cat([y, yhat])
    failures = []
    fwd_err, fwd_scale = _err(got.double(), refs[0])
    print(f"K8-fwd {label}: max_abs_err {fwd_err:.3e} (largest |value| {fwd_scale:.3e}; "
          f"plain float32 {_err(refs[1].double(), refs[0])[0]:.3e})", flush=True)
    if not torch.isfinite(got).all() or fwd_err > FWD_RTOL * max(fwd_scale, 1.0):
        failures.append(f"K8 forward ({label})")
    failures += forward_bit_identical("K8", label, (y, yhat),
                                      lambda: k8.launch_forward(*operands, plan),
                                      lambda out: {"y": out[0], "yhat": out[1]})

    gy = torch.zeros_like(y)
    knots = [k - 1 for k in knot_set(which, n)]
    gy[knots] = torch.randn(gy[knots].shape, device=y.device,
                            generator=torch.Generator(device=y.device).manual_seed(1))
    bwd_err, bwd_failures = screened_backward(
        "K8", label, lambda g: _k8_gradients(operands, y, yhat, g, plan), gy,
        B * n * (plan.m + 1) * W)

    def backward():
        return k8.launch_backward(operands[0], y, yhat, gy, *operands[2:], plan)

    first = backward()
    failures += bit_identical("K8", label, first, backward)
    # Every call launched its kernel, no fallback: two forwards, and four
    # backwards (two in the screen, the first and the second of the pair).
    if (k8.FWD_LAUNCHES, k8.BWD_LAUNCHES) != (2, 4):
        failures.append(f"K8 launches ({label}): {(k8.FWD_LAUNCHES, k8.BWD_LAUNCHES)}")
    return fwd_err, bwd_err, failures + bwd_failures


def config5_problem(device, adjoint, hidden=HIDDEN):
    """Config 5's model (at this hidden size), Hermite coefficients of its
    spiral data, and labels."""
    return default_model(device, CONFIG5_BATCH,
                         config=dict(CONFIG5, adjoint=adjoint, hidden_channels=hidden))


def check_k8_cases(device):
    """Phase 18: K8 against its plain version at config 5's operands at each
    of K8_HIDDEN, and at the odd cases."""
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    errors = []
    for hidden in K8_HIDDEN:
        model, coeffs, _ = config5_problem(device, adjoint=True, hidden=hidden)
        with torch.no_grad():
            p = packed_operands(model, coeffs)
        errors.append(check_k8(f"config 5 B{CONFIG5_BATCH} H{hidden} C{CHANNELS} W{WIDTH} m1 "
                               f"terminal", (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2),
                               k8._Plan(1, 1.0), "terminal"))
    for seed, (B, n, H, C, W, m, which) in enumerate(K8_CASES, start=1):
        errors.append(check_k8(f"odd B{B} n{n} H{H} C{C} W{W} m{m} {which}",
                               random_operands(B, n, H, C, W, seed, device),
                               k8._Plan(m, 1.0 / m), which))
    failures = [f for e in errors for f in e[2]]
    if failures:
        raise AssertionError("K8 disagrees with the plain version: " + "; ".join(failures))
    return max(e[0] for e in errors), max(e[1] for e in errors)


def plain_k8():
    """Routes the fused reversible solve to K8's plain version (for timing
    and checking it on the card)."""
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    reference = k8.fused_reversible_solve_reference
    return mock.patch.object(k8, "fused_reversible_solve", lambda *a: reference(*a)[0])


def config5_slice(device, hidden=HIDDEN):
    """Phase 19: config 5 (at this hidden size) through the public entry
    points, with direct backpropagation and with the adjoint: the logits
    against the plain version, five Adam steps and one accuracy call with
    every plain version patched to raise, K8's launches counted."""
    from torchcde_tpu_torch.models import accuracy, make_train_step
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    results = {}
    for adjoint in (False, True):
        model, coeffs, labels = config5_problem(device, adjoint, hidden)
        with torch.no_grad():
            with plain_k8():
                plain_logits = model(coeffs)
            logits = model(coeffs)
        err, scale = _err(logits, plain_logits)
        with plain_versions_raise():
            step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
            k8.reset_launch_counts()
            losses = [float(step(coeffs, labels)) for _ in range(5)]
            acc = float(accuracy(model, coeffs, labels))
            torch.cuda.synchronize()
            counts = {"fwd": k8.FWD_LAUNCHES, "bwd": k8.BWD_LAUNCHES}
        label = f"config 5 B{CONFIG5_BATCH} H{hidden} adjoint={adjoint}"
        print(f"{label}: logits vs plain version max_abs_err {err:.3e} (largest |value| "
              f"{scale:.3e}); 5 Adam steps, losses {losses}, accuracy {acc:.4f}, K8 launches "
              f"{counts}", flush=True)
        failures = []
        if (logits.shape != (CONFIG5_BATCH, 1) or not torch.isfinite(logits).all()
                or err > FWD_RTOL * max(scale, 1.0)):
            failures.append("the logits disagree with the plain version")
        if not all(math.isfinite(v) for v in losses) or losses[-1] == losses[0]:
            failures.append(f"the loss is not finite or does not change: {losses}")
        if counts != {"fwd": 6, "bwd": 5}:
            failures.append(f"the steps did not run K8 once per step: {counts}")
        if failures:
            raise AssertionError(f"the config-5 slice ({label}) failed: " + "; ".join(failures))
        results[adjoint] = {"logits_max_abs_err": err, "losses": losses, "accuracy": acc,
                            "k8_launches": counts}
    return results


def time_k8(device):
    """Phase 20: K8 at config 5's operands at each of K8_HIDDEN against its
    plain version (float32, on the card), and the config-5 train step of
    each adjoint mode against the same step with the plain version."""
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    timing = {}
    for hidden in K8_HIDDEN:
        key = "k8" if hidden == HIDDEN else f"k8_H{hidden}"
        model, coeffs, labels = config5_problem(device, adjoint=True, hidden=hidden)
        with torch.no_grad():
            p = packed_operands(model, coeffs)
        ops = (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2)
        plan = k8._Plan(1, 1.0)
        timing[f"{key}_plan"] = k8_plan_line(hidden)
        y, yhat = k8.launch_forward(*ops, plan)
        gy = torch.ones_like(y)
        timing[f"{key}_fwd_ms"] = _event_ms(lambda: k8.launch_forward(*ops, plan), 10)
        timing[f"{key}_bwd_ms"] = _event_ms(
            lambda: k8.launch_backward(p.ct, y, yhat, gy, *ops[2:], plan), 5)
        with torch.no_grad():
            timing[f"{key}_fwd_plain_ms"] = _event_ms(
                lambda: k8.fused_reversible_solve_reference(*ops, 1, 1.0), 3)
        leaves = [t.detach().clone().requires_grad_() for t in ops]
        ref, _ = k8.fused_reversible_solve_reference(*leaves, 1, 1.0)
        timing[f"{key}_bwd_plain_ms"] = _event_ms(
            lambda: torch.autograd.grad(ref, leaves, gy, retain_graph=True), 3)
        del ref, leaves
        fwd_bound, bwd_bound, fwd_fp32_bound = k8_bounds(CONFIG5_BATCH, LENGTH - 1, 1, hidden,
                                                         CHANNELS)
        timing.update({f"{key}_fwd_bound_ms": fwd_bound[0], f"{key}_bwd_bound_ms": bwd_bound[0],
                       f"{key}_fwd_fp32_bound_ms": fwd_fp32_bound[0]})

        def plain_loss(m):
            from torchcde_tpu_torch.models.training import loss_fn

            with plain_k8():
                return loss_fn(m, coeffs, labels)

        for adjoint in (False, True):
            medians, samples = time_train_steps(
                config5_problem(device, adjoint, hidden)[0], coeffs, labels, plain_loss,
                counts=(5, 2))
            name = "config5" if hidden == HIDDEN else f"config5_H{hidden}"
            timing[f"{name}_adjoint_{adjoint}_train_step_ms"] = medians
            timing[f"{name}_adjoint_{adjoint}_train_step_samples_ms"] = samples
    return timing


# --------------------------------------------------------------------------
# Per-sample adaptive stepping (options={'per_sample': True}): K9.
# --------------------------------------------------------------------------

K9_SOURCE = "torchcde_tpu_torch/csrc/fused_dopri_persample.cu"
K9_KINDS = {"k9_fwd": r"\bps_fwd_kernel\b", "k9_bwd": r"\bps_bwd_kernel\b"}
# benchmarks/run_benchmarks.py:652-772, bench_per_sample, at its TPU shapes:
# 256 series of length 1024 with 3 channels, x = N(0, 1) * 0.06 * 10^s with s
# spread over -0.5..0.5 across the series (numpy rng seed 0), Hermite
# coefficients, an MLPVectorField of hidden 8 and width 32 whose weights are
# N(0, 1) * 0.2 from the same rng, z0 standard normal, dopri5 at rtol 1e-4 and
# atol 1e-6 over X.interval: 1023 intervals, eight chunks.
PS_BATCH, PS_LENGTH, PS_HIDDEN, PS_WIDTH, PS_STEPS = 256, 1024, 8, 32, 5
# Batched output times: five per series over [0, t_end], t_end spread from
# 511 to 1023 (examples/irregular_data.py's variable-length use).
PS_ENDS = (511.0, 1023.0)
# Odd K9 cases: (label, batch, length, hidden, channels, width, control,
# output times, solver options, intervals per chunk).  Every launch of each
# case is held against the plain version on its own realised per-lane mesh;
# the short chunks make three chunks of a short table (the plain version's
# lockstep replay costs a pass of small launches per step of the longest
# lane, so the cases are kept short).
K9_CASES = [
    ("linear lead, 3 chunks", 64, 13, 8, 3, 32, "linear", "knots", {}, 4),
    ("batched rows", 96, 13, 8, 3, 32, "cubic", "rows", {}, 128),
    ("64 output rows", 64, 5, 8, 3, 32, "cubic", "sixty-four", {}, 128),
    ("exhausted max_steps, 3 chunks", 64, 13, 8, 3, 32, "cubic", "five", dict(max_steps=20), 4),
    ("H4 C3 W8", 70, 13, 4, 3, 8, "cubic", "five", {}, 128),
    ("C16 linear", 50, 7, 8, 16, 32, "linear", "five", {}, 128),
    ("odd batch B77", 77, 13, 8, 3, 32, "cubic", "five", {}, 128),
]
# The slice's launches held against the plain version, as (launch, accuracy,
# backward, repeat): forward and backward against the replay of the kernel's
# own meshes on the first chunk, and its forward against a second launch,
# bit for bit; on the last chunk (the state and controller rows carried in
# from seven chunks) the forward, and its accuracy against a float64 solve
# beside the plain float32 solve's.
K9_SLICE_CHECKS = ((0, False, True, True), (-1, True, False, False))
# A lane whose poison flag differs between the kernel and the plain float32
# solve (their meshes part) must be at the edge of its attempt limit: within
# this many attempts of it, or this share of the chunk's allowance if
# larger, in the plain float64 solve (one ulp on z0 moves a lane of the
# exhausted-budget case by 4 attempts in the plain float32 solve).
K9_EDGE_STEPS, K9_EDGE_SHARE = 4, 0.25


def per_sample_problem(device, shape=None, interpolation="cubic", seed=0):
    """(control, vector field, z0) of bench_per_sample's problem at shape
    (batch, length, hidden, channels, width), by default the slice's."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers.terms import MLPVectorField

    batch, length, hidden, channels, width = shape or (PS_BATCH, PS_LENGTH, PS_HIDDEN, 3,
                                                       PS_WIDTH)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, length, channels)).astype(np.float32) * 0.06
    x *= (10.0 ** np.linspace(-0.5, 0.5, batch))[:, None, None].astype(np.float32)
    w1, b1, w2, b2 = (rng.standard_normal(shape) * 0.2 for shape in (
        (hidden, width), (width,), (width, hidden * channels), (hidden * channels,)))
    z0 = rng.standard_normal((batch, hidden)).astype(np.float32)
    field = MLPVectorField(hidden, channels, width, device=device)
    with torch.no_grad():
        for layer, w, b in ((field.linear1, w1, b1), (field.linear2, w2, b2)):
            layer.weight.copy_(torch.tensor(w.T, dtype=torch.float32))
            layer.bias.copy_(torch.tensor(b, dtype=torch.float32))
    xt = torch.from_numpy(x).to(device)
    if interpolation == "linear":
        X = tt.LinearInterpolation(tt.linear_interpolation_coeffs(xt))
    else:
        X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(xt))
    return X, field, torch.from_numpy(z0).to(device)


def per_sample_times(which, batch, n, seed=0):
    """A K9 case's output times: (t, t_rows) for shared times or per-series rows."""
    if which == "rows" or which == "slice rows":
        lo, hi = PS_ENDS if which == "slice rows" else (n / 2, float(n))
        ends = np.random.default_rng(seed).uniform(lo, hi, batch)
        ends[np.argmax(ends)] = hi
        return None, np.stack([np.linspace(0.0, e, 5) for e in ends]).astype(np.float32)
    if which == "sixty-four":
        return np.linspace(0.0, float(n), 64), None
    if which == "knots":  # on the chunk-boundary knots of 4-interval chunks
        return np.array([0.0, 2.5, 4.0, 8.0, float(n)]), None
    return np.linspace(0.0, float(n), 5), None


def recorded_k9_launches(X, field, z0, ts, t_rows, options):
    """The arguments of every K9 forward launch of one fused per-sample solve."""
    from torchcde_tpu_torch.solvers import fused_dopri_persample as fdps
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9

    calls = []
    launch = k9.launch_forward

    def record(*args, **kwargs):
        calls.append(args)
        return launch(*args, **kwargs)

    with mock.patch.object(k9, "launch_forward", record), torch.no_grad():
        if fdps.try_fused_dopri5_per_sample(
                X, field, z0, ts, rtol=options.get("rtol", 1e-4), atol=options.get("atol", 1e-6),
                max_steps=options.get("max_steps"),
                t_rows=None if t_rows is None else torch.from_numpy(t_rows)) is None:
            raise AssertionError("the fused per-sample solve declined")
    return calls


def _k9_gradients(ops, plan, store, mesh, g, dzin):
    """K9's backward gradients and autograd's through the float64 replay of
    the kernel's meshes; g stacks the cotangents of the output rows and of
    the state.  Returns the six (dct, dz0, dw1, db1, dw2, db2) of each, and
    None for the float32 replay, which is not run; appends the kernel's and
    the replay's dzout_in to dzin."""
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9

    gz, gzfin = g[:-1].contiguous(), g[-1].contiguous()
    *grads, dzin_k = k9.launch_backward(ops[0], store, ops[7], gz, gzfin, *ops[2:6], plan)
    leaves = [t.detach().double().requires_grad_() for t in (*ops[:6], ops[9])]
    outs = k9.fused_dopri5_per_sample_replay(*leaves[:6], ops[6].double(), ops[7].double(),
                                             leaves[6], mesh, plan)
    ref = torch.autograd.grad(outs, leaves, (gz.double(), gzfin.double()), allow_unused=True)
    torch.cuda.synchronize()
    dzin.append((dzin_k, ref[6]))
    return grads, ref[:6], None


def check_k9_launch(label, args, accuracy=True, backward=True, repeat=False):
    """One K9 launch against the plain version: the forward against the
    float64 replay of the kernel's own per-lane meshes, the kernel's and the
    plain float32 solve's accuracy against a float64 solve at EXACT_TOL x the
    tolerances, and the backward against autograd through the replay (with
    the ReLU-kink lane screen; not with backward false); with ``repeat`` the
    forward also against a second launch, bit for bit.  Returns (forward
    error, backward error (0 without the backward),
    (kernel, plain) accuracy, steps attempted, failures)."""
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9

    *ops, plan = args
    # A lane that entered poisoned carries NaN; it only idles, and zeros keep
    # the plain version's replay (whose masked lanes still multiply their
    # state into the weight gradients) finite.
    ops[1], ops[9] = torch.nan_to_num(ops[1]), torch.nan_to_num(ops[9])
    H, (n, _, C, B), W = ops[1].shape[0], ops[0].shape, ops[2].shape[0]
    first = k9.launch_forward(*ops, plan)
    zout, zfin, ctlout, nacc, natt, store = first
    repeated = forward_bit_identical("K9", label, first, lambda: k9.launch_forward(*ops, plan),
                                     k9_forward_parts) if repeat else []
    mesh = k9.read_mesh(store, ctlout)
    ops64 = [t.double() for t in ops]
    with torch.no_grad():
        ref = k9.fused_dopri5_per_sample_replay(*ops64[:8], ops64[9], mesh, plan)
        if accuracy:
            p_out, p_fin, p_ctl, _, p_natt, _ = k9.fused_dopri5_per_sample_reference(*ops, plan)
            tight = plan._replace(rtol=plan.rtol * EXACT_TOL, atol=plan.atol * EXACT_TOL,
                                  cap=EXACT_CAP, budget=float(1 << 30))
            # On the host's CPU, where the plain version's lockstep loop runs
            # several times faster than its small launches on the card.
            e_out, e_fin = (t.to(zout.device) for t in k9.fused_dopri5_per_sample_reference(
                *(t.cpu() for t in ops64), tight)[:2])
        else:  # the replay stands in: both errors read 0
            p_out, p_fin, p_ctl, p_natt, e_out, e_fin = zout, zfin, ctlout, natt, zout, zfin
    flat = [torch.cat([o.flatten(), f.flatten()]) for o, f in
            ((zout, zfin), ref, (p_out, p_fin), (e_out, e_fin))]
    got, ref, plain, exact = flat[0].double(), flat[1], flat[2].double(), flat[3].double()
    bad = ctlout[3] > 0.5
    attempted = float((natt - ops[6][2]).sum())
    failures = repeated
    # A lane is poisoned iff it entered poisoned or its own accepted steps
    # stop short of its target, and then only with no attempt left: the
    # budget spent or the chunk's cap reached.
    ctl_in = ops[6].cpu().numpy()
    entered = ctl_in[3] > 0.5
    t1 = np.minimum(ops[8].cpu().numpy(), np.float32(plan.t_chunk_end))
    last = np.maximum(mesh.cnt - 1, 0), np.arange(B)
    end = np.where(mesh.cnt > 0, mesh.t[last] + mesh.dt[last], ctl_in[0])
    short = (end < t1) | entered
    bad_np = bad.cpu().numpy()
    if not torch.equal(torch.isnan(got), torch.isnan(ref)) or not np.array_equal(bad_np, short):
        failures.append(f"K9 poisons other lanes than its own steps say ({label})")
    limit = np.minimum(np.float32(plan.budget), ctl_in[2] + plan.cap)
    k_att, p_att = natt.cpu().numpy(), p_natt.cpu().numpy()
    # No attempt past the limit, and a lane that ran out used every one.
    ran_out = bad_np & ~entered
    if (k_att > limit).any() or (k_att[ran_out] != limit[ran_out]).any():
        failures.append(f"K9 counts attempts against their limit otherwise ({label})")
    # The plain float32 solve's mesh is another, so a lane whose need is at
    # the edge of its limit may end otherwise there.  Such a lane must be at
    # the edge in a third mesh too: the plain float64 solve at the same
    # tolerances poisons it or ends it within K9_EDGE of the limit.
    differ = np.nonzero(bad_np != (p_ctl[3].cpu().numpy() > 0.5))[0]
    if differ.size:
        with torch.no_grad():
            _, _, d_ctl, _, d_natt, _ = k9.fused_dopri5_per_sample_reference(
                *(t.cpu() for t in ops64), plan)
        d_att, d_bad = d_natt.cpu().numpy(), d_ctl[3].cpu().numpy() > 0.5
        edge = np.maximum(K9_EDGE_STEPS, K9_EDGE_SHARE * (limit - ctl_in[2]))
        inner = differ[~d_bad[differ] & (limit[differ] - d_att[differ] > edge[differ])]
        print(f"K9-fwd {label}: poison differs from the plain float32 solve on lanes "
              f"{differ.tolist()}: attempts kernel {k_att[differ].tolist()}, plain float32 "
              f"{p_att[differ].tolist()}, plain float64 {d_att[differ].tolist()} (poisoned "
              f"{d_bad[differ].astype(int).tolist()}), limit {limit[differ].tolist()}", flush=True)
        if inner.size:
            failures.append(f"K9 and the plain float32 solve poison lanes {inner.tolist()} "
                            f"away from the edge of their attempt limit ({label})")
    finite = torch.isfinite(ref)
    fwd_err, scale = _err(got[finite], ref[finite]) if finite.any() else (0.0, 0.0)
    good = finite & torch.isfinite(plain) & torch.isfinite(exact)
    kernel_err = float((got - exact)[good].abs().max()) if good.any() else 0.0
    plain_err = float((plain - exact)[good].abs().max()) if good.any() else 0.0
    unit = plan.rtol * max(scale, 1.0)
    limit = 10 * plain_err + unit
    print(f"K9-fwd {label}: max_abs_err {fwd_err:.3e} (largest |value| {scale:.3e}); "
          f"{int(bad.sum())} lanes poisoned (plain float32 {int((p_ctl[3] > 0.5).sum())}); "
          f"steps accepted {int(nacc.sum())} / attempted {attempted:.0f} (longest lane "
          f"{int(mesh.cnt.max())} accepted); error against "
          f"float64 at {EXACT_TOL:g} x tolerances: kernel {kernel_err:.3e}, plain float32 "
          f"{plain_err:.3e} (limit {limit:.3e})", flush=True)
    if fwd_err > FWD_RTOL * max(scale, 1.0):
        failures.append(f"K9 forward ({label})")
    if not kernel_err <= limit:
        failures.append(f"K9 forward less accurate than the plain float32 solve ({label})")

    if not backward:
        return fwd_err, 0.0, (kernel_err / unit, plain_err / unit), attempted, failures
    gen = torch.Generator(device=got.device).manual_seed(3)
    g = torch.randn((zout.shape[0] + 1,) + tuple(zfin.shape), generator=gen, device=got.device)
    g[..., bad] = 0.0  # a poisoned lane's outputs are NaN
    relu_evals = int(mesh.cnt.sum()) * 7 * W
    dzin = []
    bwd_err, bwd_failures = screened_backward(
        "K9", label, lambda gz: _k9_gradients(ops, plan, store, mesh, gz, dzin), g, relu_evals)

    def k9_backward():
        return k9.launch_backward(ops[0], store, ops[7], g[:-1].contiguous(), g[-1].contiguous(),
                                  *ops[2:6], plan)

    bwd_failures += bit_identical("K9", label, k9_backward(), k9_backward)
    dzin, dzin_ref = dzin[-1]
    dzin_err = float((dzin.double() - dzin_ref).abs().max()) if dzin.numel() else 0.0
    if dzin_err > 0.0:
        failures.append(f"K9 backward dzout_in ({label}): {dzin_err:.3e}")
    return fwd_err, bwd_err, (kernel_err / unit, plain_err / unit), attempted, (
        failures + bwd_failures)


def check_k9(device):
    """Phase 22: K9 against its plain version on the slice's launches of
    K9_SLICE_CHECKS and on every launch of the odd cases."""
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9

    X, field, z0 = per_sample_problem(device)
    calls = recorded_k9_launches(X, field, z0, X.interval, None, {})
    print(f"K9 slice: B{PS_BATCH} n{PS_LENGTH - 1} H{PS_HIDDEN} C3 W{PS_WIDTH}, "
          f"{len(calls)} launches", flush=True)
    errors = []
    for i, accuracy, backward, repeat in K9_SLICE_CHECKS:
        errors.append(check_k9_launch(f"slice #{i % len(calls)}", calls[i], accuracy, backward,
                                      repeat))
        print(f"K9 slice #{i % len(calls)} checked at {time.perf_counter() - START:.1f} s",
              flush=True)
    for seed, (label, B, L, H, C, W, kind, which, options, chunk) in enumerate(K9_CASES,
                                                                               start=1):
        X, field, z0 = per_sample_problem(device, (B, L, H, C, W), kind, seed)
        ts, rows = per_sample_times(which, B, L - 1, seed)
        with mock.patch.object(k9, "MAX_INTERVALS", chunk):
            calls = recorded_k9_launches(X, field, z0, ts, rows, options)
        print(f"K9 {label}: B{B} n{L - 1} H{H} C{C} W{W} {kind}, {len(calls)} launches "
              f"(at {time.perf_counter() - START:.1f} s)", flush=True)
        errors += [check_k9_launch(f"{label} #{i}", args) for i, args in enumerate(calls)]
    kernel_sum, plain_sum = (sum(e[2][i] for e in errors) for i in (0, 1))
    print(f"K9 accuracy over all launches, in units of rtol x largest magnitude: kernel "
          f"{kernel_sum:.3f}, plain float32 {plain_sum:.3f} (limit {2 * plain_sum + 1:.3f})")
    failures = [f for e in errors for f in e[4]]
    if not kernel_sum <= 2 * plain_sum + 1:
        failures.append("K9 forward less accurate than the plain float32 solve over all launches")
    if failures:
        raise AssertionError("K9 disagrees with the plain version: " + "; ".join(failures))
    return max(e[0] for e in errors), max(e[1] for e in errors)


def per_sample_loss(X, field, adjoint, t=None):
    """sum(z_T^2) of the per-sample solve, as tests/test_per_sample.py's
    gradient test takes it."""
    import torchcde_tpu_torch as tt

    def loss(z0):
        out = tt.cdeint(X, field, z0, X.interval if t is None else t, adjoint=adjoint,
                        method="dopri5", options=dict(per_sample=True))
        return (out[..., -1, :] ** 2).sum()

    return loss


def per_sample_slice(device):
    """Phase 23: the slice through the public cdeint with every plain version
    patched to raise: the forward, five Adam steps on z0 and the field's
    weights under each adjoint mode, and a solve with batched output times
    and its gradient, each with its K9 launches counted."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9

    X, field, z0 = per_sample_problem(device)
    n_chunks = math.ceil((PS_LENGTH - 1) / k9.MAX_INTERVALS)
    results, failures = {}, []

    def counted(label, fn, expected):
        k9.reset_launch_counts()
        with plain_versions_raise():
            value = fn()
            torch.cuda.synchronize()
        counts = {"fwd": k9.FWD_LAUNCHES, "bwd": k9.BWD_LAUNCHES}
        results[label] = {"k9_launches": counts}
        if counts != expected:
            failures.append(f"{label}: K9 launches {counts}, expected {expected}")
        return value

    with torch.no_grad():
        out = counted("forward", lambda: tt.cdeint(X, field, z0, X.interval, adjoint=False,
                                                   options=dict(per_sample=True)),
                      {"fwd": n_chunks, "bwd": 0})
    # A small input: the slice's problem cut to PS_CHECK shapes, through the
    # kernels and through the plain version in float32, each held against a
    # float64 solve by the plain version at EXACT_TOL x the tolerances.
    small, small_field, small_z0 = per_sample_problem(device, PS_CHECK)
    small64, field64 = copy.copy(small), copy.deepcopy(small_field).double()
    for name in ("_a", "_b", "_two_c", "_three_d"):
        setattr(small64, name, getattr(small, name).double())

    def solve(X_, f_, z0_, **kwargs):
        return tt.cdeint(X_, f_, z0_, X_.interval, adjoint=False, options=dict(per_sample=True),
                         **kwargs).double()

    with torch.no_grad():
        got = solve(small, small_field, small_z0)
        with mock.patch.object(k9, "_runs_kernel", lambda ct: False):
            plain = solve(small, small_field, small_z0)
            exact = solve(small64, field64, small_z0.double(), rtol=1e-4 * EXACT_TOL,
                          atol=1e-6 * EXACT_TOL)
    err, scale = _err(got, exact)
    plain_err = _err(plain, exact)[0]
    limit = 10 * plain_err + 1e-4 * max(scale, 1.0)
    results["forward"].update(small_input=PS_CHECK, max_abs_err_vs_float64=err,
                              plain_float32_err=plain_err, limit=limit, largest=scale,
                              finite_lanes=int(torch.isfinite(out).all(dim=(1, 2)).sum()))
    print(f"per-sample slice forward: shape {tuple(out.shape)}, {results['forward']} "
          f"(at {time.perf_counter() - START:.1f} s)", flush=True)
    if out.shape != (PS_BATCH, 2, PS_HIDDEN) or not torch.isfinite(out).all():
        failures.append("the forward is not finite or has the wrong shape")
    if not err <= limit:
        failures.append(f"the small input's forward is {err:.3e} from the float64 solve")

    for adjoint in (False, True):
        f = copy.deepcopy(field)
        z = z0.clone().requires_grad_()
        opt = torch.optim.Adam([z, *f.parameters()], lr=1e-2)
        loss_fn = per_sample_loss(X, f, adjoint)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(z)
            loss.backward()
            opt.step()
            return float(loss.detach())

        losses = counted(f"adjoint={adjoint}", lambda: [step() for _ in range(PS_STEPS)],
                         {"fwd": PS_STEPS * n_chunks, "bwd": PS_STEPS * n_chunks})
        results[f"adjoint={adjoint}"]["losses"] = losses
        print(f"per-sample slice adjoint={adjoint}: {PS_STEPS} Adam steps, losses {losses}, "
              f"launches {results[f'adjoint={adjoint}']['k9_launches']} "
              f"(at {time.perf_counter() - START:.1f} s)", flush=True)
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            failures.append(f"adjoint={adjoint}: the loss is not finite or does not fall")

    _, rows = per_sample_times("slice rows", PS_BATCH, PS_LENGTH - 1)
    rows = torch.from_numpy(rows).to(device)
    z = z0.clone().requires_grad_()

    def batched():
        out = tt.cdeint(X, field, z, rows, adjoint=False, options=dict(per_sample=True))
        (out[..., -1, :] ** 2).sum().backward()
        return out

    out = counted("batched rows", batched, {"fwd": n_chunks, "bwd": n_chunks})
    results["batched rows"]["finite"] = bool(torch.isfinite(out).all()
                                             and torch.isfinite(z.grad).all())
    print(f"per-sample slice batched rows: shape {tuple(out.shape)}, {results['batched rows']}",
          flush=True)
    if out.shape != (PS_BATCH, 5, PS_HIDDEN) or not results["batched rows"]["finite"]:
        failures.append("the batched-rows solve is not finite or has the wrong shape")
    if failures:
        raise AssertionError("the per-sample slice failed: " + "; ".join(failures))
    return results


def time_k9(device):
    """Phase 24: K9's forward and backward per launch over the slice's eight
    launches and on its first launch alone, the plain version (float32, on
    the card) on that first launch, and the slice's solve and gradient.  The
    plain version, a lockstep pass of small launches per attempt of the
    chunk's longest lane, runs once, without a warm-up.  Phase 25 profiles
    the slice's gradient."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9

    X, field, z0 = per_sample_problem(device)
    calls = recorded_k9_launches(X, field, z0, X.interval, None, {})
    launched = [(args, k9.launch_forward(*args)) for args in calls]
    gzs = [(torch.ones_like(out[0]), torch.ones_like(out[1])) for _, out in launched]

    def forward(pairs):
        for args, _ in pairs:
            k9.launch_forward(*args)

    def backward(pairs, cotangents):
        for (args, out), (gz, gzfin) in zip(pairs, cotangents):
            k9.launch_backward(args[0], out[5], args[7], gz, gzfin, *args[2:6], args[-1])

    n = len(calls)
    meshes = [k9.read_mesh(out[5], out[2]) for _, out in launched]
    timing = {"k9_fwd_ms": _event_ms(lambda: forward(launched), 3) / n,
              "k9_bwd_ms": _event_ms(lambda: backward(launched, gzs), 3) / n,
              "k9_fwd_first_launch_ms": _event_ms(lambda: forward(launched[:1]), 3),
              "k9_bwd_first_launch_ms": _event_ms(lambda: backward(launched[:1], gzs), 3),
              "k9_launches_per_solve": n,
              "k9_steps_accepted": int(sum(m.cnt.sum() for m in meshes)),
              "k9_steps_attempted": int(sum(float((out[4] - args[6][2]).sum())
                                            for args, out in launched)),
              "k9_longest_lane_accepted": int(sum(m.cnt.max() for m in meshes))}

    # The plain version on the first launch: the forward's lockstep solve,
    # then autograd through the replay of the kernel's mesh (what the plain
    # path's backward runs).
    (*ops, plan), _ = launched[0]
    leaves = [t.detach().clone().requires_grad_() for t in (*ops[:6], ops[9])]

    def plain_backward():
        outs = k9.fused_dopri5_per_sample_replay(*leaves[:6], ops[6], ops[7], leaves[6],
                                                 meshes[0], plan)
        torch.autograd.grad(outs, leaves, gzs[0], allow_unused=True)

    with torch.no_grad():
        timing["k9_fwd_plain_first_launch_ms"] = _once_ms(
            lambda: k9.fused_dopri5_per_sample_reference(*ops, plan))
    timing["k9_bwd_plain_first_launch_ms"] = _once_ms(plain_backward)

    loss = per_sample_loss(X, field, adjoint=False)
    z = z0.clone().requires_grad_()
    with torch.no_grad():
        timing["slice_solve_ms"] = _event_ms(
            lambda: tt.cdeint(X, field, z0, X.interval, adjoint=False,
                              options=dict(per_sample=True)), 3)
    timing["slice_grad_ms"] = _event_ms(lambda: torch.autograd.grad(loss(z), z), 3)
    profile = profile_calls(lambda: torch.autograd.grad(loss(z), z), K9_KINDS, 1)
    return timing, k9_bounds(timing), profile


# K1's bfloat16 mode rounds the stage products' operands to bfloat16 where
# the TPU kernel feeds its matrix unit.  Any two float32 summation orders
# (kernel and plain version, or the plain version in float32 and float64)
# put a few operands on the other side of a bfloat16 rounding boundary, a
# one-ulp flip (2^-8 relative) that the serial solve carries on: on an H100
# the plain version in float32 differed from its float64 run by 3e-4
# (forward) to 5e-3 (gradients) relative at the flagship, a fifth of the
# mode's own gap to the unrounded solve (measured on one H100).  So the kernel
# is held against the plain version run in float64 with the same rounding
# points: its relative Frobenius error may be at most BF16_ORDER times the
# plain float32 version's (or 1e-5), and at most BF16_SHARE of the mode's own
# gap (the plain float64 version with against without the rounding), which a
# kernel that did not round would fail.  The lane screen: a lane whose
# gradients (dct, dz0) differ by more than BF16_LANE_RTOL took a flip or a
# ReLU kink that moved a whole term; the kernel may have at most twice as
# many such lanes as the plain float32 version, plus 2, and their cotangents
# are set to zero for the comparison of the six gradients.
BF16_ORDER = 2.0
BF16_SHARE = 0.5
BF16_LANE_RTOL = 1e-2
# K1-bf16 cases: (label, batch, intervals, hidden, channels, width, method,
# substeps, output knots): H 5 (H % 8 != 0: the TPU kernel's padded layout,
# whose selection products round too), H 16 with C 5 at the caps' width
# (two slices; no selection rounding, as in the TPU kernel's matrix-free
# path) and four shapes at the flagship's H 8, C 3.
K1_BF16_CASES = [
    ("H5 padded slice", 1000, 99, 5, 3, 128, "euler", 2, "all"),
    ("H16 C5 two slices", 333, 24, 16, 5, 512, "rk4", 1, "all"),
    ("part block", 2049, 40, 8, 3, 128, "heun", 2, "all"),
    ("striding blocks", 40000, 12, 8, 3, 128, "rk4", 1, "terminal"),
    ("caps width", 200, 16, 8, 3, 512, "midpoint", 3, "subset"),
    ("eight substeps", 2049, 20, 8, 3, 128, "euler", 8, "subset"),
]
# bench.py:152-160, the repository's headline benchmark: the flagship in
# mixed precision.
BF16_FLAGSHIP = dict(FLAGSHIP, compute_dtype="bfloat16")
# bf16 against float32 on the same bf16-quantized problem (tests/
# test_fused_pallas.py, tests/test_fused_dopri.py of the JAX package): bf16
# keeps ~3 decimal digits.
BF16_CLOSE = 0.06


def _bf16_operands(operands):
    """K1's bfloat16-mode operands: the slab table in bfloat16, the rest
    float32 holding bfloat16 values (as the model's casts give them)."""
    return (operands[0].bfloat16(),) + tuple(t.bfloat16().float() for t in operands[1:])


def _bf16_plain(operands, plan, dtype, mx, gz=None):
    """K1's plain version on bfloat16-mode operands in dtype, with the
    rounding (the slab table kept bfloat16) or without it (the table upcast):
    the solution, or with gz the six gradients."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    ct = operands[0].detach().clone() if mx else operands[0].detach().to(dtype)
    leaves = [ct] + [t.detach().to(dtype) for t in operands[1:]]
    if gz is None:
        with torch.no_grad():
            return k1.fused_fixed_solve_reference(*leaves, plan.method, plan.m, plan.dt_sub,
                                                  plan.out_knots)
    leaves = [t.requires_grad_() for t in leaves]
    out = k1.fused_fixed_solve_reference(*leaves, plan.method, plan.m, plan.dt_sub,
                                         plan.out_knots)
    return torch.autograd.grad(out, leaves, gz.to(dtype))


def _bf16_verdict(what, got, ref64, ref32, unrounded, failures):
    """Holds one output of K1's bfloat16 mode (see BF16_ORDER); returns its
    max abs error against the float64 plain version."""
    ref64, ref32, unrounded = ref64.double(), ref32.double(), unrounded.double()
    e_k, e_p, gap = _rel_l2(got, ref64), _rel_l2(ref32, ref64), _rel_l2(unrounded, ref64)
    err = float((got.double() - ref64.double()).abs().max())
    print(f"  {what}: rel_l2 {e_k:.3e} (plain float32 {e_p:.3e}, limit {max(BF16_ORDER * e_p, 1e-5):.3e};"
          f" the mode's gap {gap:.3e}, limit {BF16_SHARE * gap:.3e}) max_abs_err {err:.3e}")
    if (not torch.isfinite(got).all() or e_k > max(BF16_ORDER * e_p, 1e-5)
            or e_k > BF16_SHARE * gap):
        failures.append(what)
    return err


def check_k1_bf16(label, operands, plan):
    """Phase 26: K1's bfloat16 mode, forward and backward, against its plain
    version on the card (see BF16_ORDER)."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    label = k1_label(label, operands, plan)
    out, zres = k1_launched(lambda: k1.launch_forward(*operands, plan), "fwd")
    torch.cuda.synchronize()
    refs = [_bf16_plain(operands, plan, dtype, mx)
            for dtype, mx in ((torch.float64, True), (torch.float32, True), (torch.float64, False))]
    failures = []
    print(f"K1-bf16-fwd {label}:")
    fwd_err = _bf16_verdict("solution", out, *refs, failures)

    gz = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(1),
                     device=out.device)

    def gradients(gz):
        grads = k1_launched(lambda: k1.launch_backward(operands[0], zres, operands[1], gz,
                                                        *operands[2:], plan), "bwd")
        plain = [_bf16_plain(operands, plan, dtype, mx, gz)
                 for dtype, mx in ((torch.float64, True), (torch.float32, True),
                                   (torch.float64, False))]
        torch.cuda.synchronize()
        return grads, plain

    grads, (ref64, ref32, _) = gradients(gz)
    if grads[0].dtype != torch.bfloat16 or any(g.dtype != torch.float32 for g in grads[1:]):
        failures.append(f"gradient dtypes {[str(g.dtype) for g in grads]}")

    def lanes(got, ref):
        err = torch.maximum(_lane_rel_l2(got[0].float(), ref[0].double()),
                            _lane_rel_l2(got[1], ref[1].double()))
        return set(torch.nonzero(err > BF16_LANE_RTOL).flatten().tolist())

    kernel_lanes, plain_lanes = lanes(grads, ref64), lanes(ref32, ref64)
    print(f"K1-bf16-bwd {label}: {len(kernel_lanes)} lanes past {BF16_LANE_RTOL:g} "
          f"(plain float32 {len(plain_lanes)}, limit {2 * len(plain_lanes) + 2})")
    if len(kernel_lanes) > 2 * len(plain_lanes) + 2:
        failures.append("lanes")
    gz[..., sorted(kernel_lanes | plain_lanes)] = 0.0
    grads, plain = gradients(gz)
    bwd_err = max(_bf16_verdict(f"d{name}", g, *(p[i] for p in plain), failures)
                  for i, (name, g) in enumerate(zip(["ct", "z0", "w1", "b1", "w2", "b2"], grads)))
    return fwd_err, bwd_err, ([f"K1-bf16 {f} ({label})" for f in failures]
                              + k1_forward_bit_identical("K1-bf16", label, operands, (out, zres),
                                                         plan)
                              + k1_bit_identical("K1-bf16", label, operands, zres, gz, plan))


def check_k1_bf16_cases(device, model, coeffs):
    """Phase 26 over the flagship's operands (from the bfloat16 model, and
    from one at hidden 16) and K1_BF16_CASES."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    errors = []
    for hidden, m in ((HIDDEN, model), (16, flagship_model(device, 16, BF16_FLAGSHIP))):
        with torch.no_grad():
            p = packed_operands(m, coeffs)
        ops = (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2)
        if ops[0].dtype != torch.bfloat16 or any(t.dtype != torch.float32 for t in ops[1:]):
            raise AssertionError("the bfloat16 model's packing is not K1's bfloat16 mode")
        errors.append(check_k1_bf16(
            f"flagship B{BATCH} H{hidden} C{CHANNELS} W{WIDTH} rk4 m1 terminal", ops,
            k1._Plan("rk4", 1, 1.0, (LENGTH - 1,))))
    for seed, (name, B, n, H, C, W, method, m, which) in enumerate(K1_BF16_CASES, start=1):
        plan = k1._Plan(method, m, 1.0 / m, knot_set(which, n))
        errors.append(check_k1_bf16(f"{name} B{B} n{n} H{H} C{C} W{W} {method} m{m} {which}",
                                    _bf16_operands(random_operands(B, n, H, C, W, seed, device)),
                                    plan))
    failures = [f for e in errors for f in e[2]]
    if failures:
        raise AssertionError("K1's bfloat16 mode disagrees with its plain version: "
                             + "; ".join(failures))
    return max(e[0] for e in errors), max(e[1] for e in errors)


def plain_k1():
    """Routes the fused fixed-step solve to K1's plain version (with the
    bfloat16 mode's rounding for a bfloat16 slab table), on the card."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    return mock.patch.object(k1, "fused_fixed_solve", k1.fused_fixed_solve_reference)


def quantized_f32(model, coeffs):
    """A float32 copy of a bfloat16 model whose weights are its masters
    rounded to bfloat16, and the coefficients rounded the same way: the
    float32 solve of the bfloat16 model's problem."""
    f32 = copy.deepcopy(model)
    f32.cfg = dataclasses.replace(f32.cfg, compute_dtype=None)
    with torch.no_grad():
        for param in f32.parameters():
            param.copy_(param.bfloat16().float())
    return f32, coeffs.bfloat16().float()


def _close(got, ref):
    """bf16 values against float32 (BF16_CLOSE of the largest magnitude, or
    of 1): (max abs error, largest |ref|, ok)."""
    err, scale = _err(got.double(), ref.double())
    return err, scale, bool(torch.isfinite(got).all()) and err <= BF16_CLOSE * max(scale, 1.0)


def _close_grad(got, ref):
    """A bf16 gradient against float32: relative Frobenius error within
    BF16_CLOSE (a gradient's entries cancel; the JAX package holds its bf16
    gradients in this norm): (rel_l2, ok)."""
    rel = _rel_l2(got, ref.double())
    return rel, bool(torch.isfinite(got).all()) and rel <= BF16_CLOSE


def bf16_slices(device, model, coeffs, labels):
    """Phase 27: bench.py's configuration (the flagship in bfloat16): the
    logits against the plain version and the float32 solve of the same
    quantized problem, five Adam steps and one accuracy call with every plain
    version patched to raise and K1's launches counted by mode; then one
    bfloat16 default-configuration step through K2 (B 256) and one small
    bfloat16 solve and gradient each through K8 and K9, for route, dtype and
    closeness to the float32 solve of the same quantized problem."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import accuracy, make_train_step
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8
    from torchcde_tpu_torch.solvers.terms import MLPVectorField

    failures, report = [], {}
    with torch.no_grad():
        logits = model(coeffs)
        with plain_k1():
            plain_logits = model(coeffs)
        f32_model, f32_coeffs = quantized_f32(model, coeffs)
        f32_logits = f32_model(f32_coeffs)
    e_plain = _rel_l2(logits, plain_logits.double())
    gap = _rel_l2(f32_logits, plain_logits.double())
    err, scale, close = _close(logits, f32_logits)
    print(f"bf16 flagship logits: dtype {logits.dtype}, rel_l2 against the plain version "
          f"{e_plain:.3e} (limit {BF16_SHARE * gap:.3e}, half its gap to float32 {gap:.3e}); "
          f"against float32 max_abs_err {err:.3e} (largest |value| {scale:.3e})", flush=True)
    if logits.dtype != torch.bfloat16 or logits.shape != (BATCH, 1) or not close \
            or e_plain > BF16_SHARE * gap:
        failures.append("flagship logits")

    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
    with plain_versions_raise():
        k1.reset_launch_counts()
        losses = [float(step(coeffs, labels)) for _ in range(5)]
        after_steps = (k1.BF16_FWD_LAUNCHES, k1.BF16_BWD_LAUNCHES)
        acc = float(accuracy(model, coeffs, labels))
        torch.cuda.synchronize()
    launches = {"fwd": k1.FWD_LAUNCHES, "bwd": k1.BWD_LAUNCHES,
                "bf16_fwd": k1.BF16_FWD_LAUNCHES, "bf16_bwd": k1.BF16_BWD_LAUNCHES}
    grad_dtypes = sorted({str(param.grad.dtype) for param in model.parameters()})
    print(f"bf16 flagship slice: 5 Adam steps, losses {losses}, accuracy {acc:.4f}, "
          f"K1 launches {launches}, master gradients {grad_dtypes}", flush=True)
    if not all(math.isfinite(v) for v in losses) or losses[-1] == losses[0]:
        failures.append(f"losses {losses}")
    if after_steps != (5, 5) or launches != {"fwd": 6, "bwd": 5, "bf16_fwd": 6, "bf16_bwd": 5}:
        failures.append(f"K1 launches {launches}")
    if grad_dtypes != ["torch.float32"]:
        failures.append(f"master gradients {grad_dtypes}")
    report["flagship"] = {"losses": losses, "accuracy": acc, "k1_launches": launches,
                          "logits_rel_l2_vs_plain": e_plain, "logits_max_abs_err_vs_f32": err}

    # The default configuration (dopri5, adjoint) in bfloat16 through K2.
    d_model, d_coeffs, d_labels = default_model(device, 256, config=dict(DEFAULT, compute_dtype="bfloat16"))
    with torch.no_grad():
        f32_model, f32_coeffs = quantized_f32(d_model, d_coeffs)
        f32_logits = f32_model(f32_coeffs)
    d_step = make_train_step(d_model, torch.optim.Adam(d_model.parameters(), lr=1e-3, eps=1e-8))
    with plain_versions_raise():
        k2.reset_launch_counts()
        with torch.no_grad():
            d_logits = d_model(d_coeffs)
        d_loss = float(d_step(d_coeffs, d_labels))
        torch.cuda.synchronize()
    counts = {"fwd": k2.FWD_LAUNCHES, "bwd": k2.BWD_LAUNCHES}
    err, scale, close = _close(d_logits, f32_logits)
    print(f"bf16 default B256: logits dtype {d_logits.dtype}, against float32 max_abs_err "
          f"{err:.3e} (largest |value| {scale:.3e}); one step, loss {d_loss:.5f}, K2 launches "
          f"{counts}", flush=True)
    if d_logits.dtype != torch.bfloat16 or not close or not math.isfinite(d_loss) \
            or counts != {"fwd": 2, "bwd": 1}:
        failures.append("default configuration through K2")
    report["default_B256"] = {"loss": d_loss, "k2_launches": counts, "logits_max_abs_err_vs_f32": err}

    # One small solve and its gradient each through K8 and K9.
    X_np, _ = spiral_data(64, 33, seed=5)
    x = torch.from_numpy(X_np).to(device)
    gen = torch.Generator().manual_seed(5)
    field32 = MLPVectorField(HIDDEN, CHANNELS, WIDTH)
    for layer in (field32.linear1, field32.linear2):
        bound_ = 1.0 / math.sqrt(layer.in_features)
        with torch.no_grad():
            layer.weight.uniform_(-bound_, bound_, generator=gen)
            layer.bias.uniform_(-bound_, bound_, generator=gen)
    field32 = field32.to(device)
    z0_32 = torch.randn((64, HIDDEN), generator=gen).to(device)
    cases = {
        "K8": (k8, dict(method="reversible_heun", adjoint=True, backend="torchsde", dt=1.0)),
        "K9": (k9, dict(method="dopri5", adjoint=False, options={"per_sample": True})),
    }
    for name, (module, kwargs) in cases.items():
        outs = {}
        for dtype in (torch.bfloat16, torch.float32):
            X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(
                x.to(torch.bfloat16).to(dtype)))
            field = copy.deepcopy(field32)
            with torch.no_grad():
                for param in field.parameters():
                    param.copy_(param.bfloat16().float())
            field = field.to(dtype)
            z0 = z0_32.bfloat16().to(dtype).requires_grad_()
            module.reset_launch_counts()
            with plain_versions_raise():
                out = tt.cdeint(X, field, z0, X.interval, **kwargs)
                out.float().square().sum().backward()
                torch.cuda.synchronize()
            outs[dtype] = (out, z0.grad, {"fwd": module.FWD_LAUNCHES, "bwd": module.BWD_LAUNCHES})
        (out16, g16, counts16), (out32, g32, _) = outs[torch.bfloat16], outs[torch.float32]
        err, scale, close = _close(out16, out32)
        gerr, gclose = _close_grad(g16, g32)
        print(f"bf16 {name}: solution dtype {out16.dtype} max_abs_err against float32 {err:.3e} "
              f"(largest |value| {scale:.3e}); z0 gradient dtype {g16.dtype} rel_l2 {gerr:.3e}; "
              f"launches {counts16}", flush=True)
        if (out16.dtype != torch.bfloat16 or g16.dtype != torch.bfloat16 or not close
                or not gclose or counts16["fwd"] < 1 or counts16["bwd"] < 1):
            failures.append(f"{name} in bfloat16")
        report[name] = {"launches": counts16, "max_abs_err_vs_f32": err, "grad_rel_l2_vs_f32": gerr}
    if failures:
        raise AssertionError("the bfloat16 slices failed: " + "; ".join(failures))
    return report


def time_bf16(device, model, f32_model, coeffs, labels):
    """Phase 28: K1's bfloat16 mode and its plain version at the flagship,
    and the bfloat16 flagship step beside the float32 one and the bfloat16
    plain step, by CUDA events, in turns; then a profile of the bf16 step."""
    from torchcde_tpu_torch.models import make_train_step
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    with torch.no_grad():
        p = packed_operands(model, coeffs)
    ops = (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2)
    n = p.ct.shape[0]
    plan = k1._Plan("rk4", 1, 1.0, (n,))
    out, zres = k1.launch_forward(*ops, plan)
    gz = torch.ones_like(out)
    timing = {
        "k1_bf16_fwd_ms": _event_ms(lambda: k1.launch_forward(*ops, plan), 10),
        "k1_bf16_bwd_ms": _event_ms(lambda: k1.launch_backward(p.ct, zres, p.z0t, gz, *ops[2:], plan), 5),
    }
    with torch.no_grad():
        timing["k1_bf16_fwd_plain_ms"] = _event_ms(
            lambda: k1.fused_fixed_solve_reference(*ops, "rk4", 1, 1.0, (n,)), 3)
    leaves = [ops[0].detach().clone().requires_grad_()] + [t.detach().clone().requires_grad_()
                                                           for t in ops[1:]]
    ref = k1.fused_fixed_solve_reference(*leaves, "rk4", 1, 1.0, (n,))
    timing["k1_bf16_bwd_plain_ms"] = _event_ms(
        lambda: torch.autograd.grad(ref, leaves, gz, retain_graph=True), 3)
    for hidden in K1_HIDDEN[1:]:
        fwd_bound, bwd_bound = k1_bounds(True, hidden)
        timing[f"k1_bf16_H{hidden}"] = dict(
            time_k1_kernels(flagship_model(device, hidden, BF16_FLAGSHIP), coeffs),
            fwd_bound_ms=fwd_bound[0], bwd_bound_ms=bwd_bound[0],
            fwd_plan=k1_plan(1, "forward", hidden), bwd_plan=k1_plan(1, "backward", hidden))

    models = {"bf16": copy.deepcopy(model), "f32": copy.deepcopy(f32_model),
              "bf16_plain": copy.deepcopy(model)}
    steps = {name: make_train_step(m, torch.optim.Adam(m.parameters(), lr=1e-3, eps=1e-8))
             for name, m in models.items()}

    def plain_step():
        with plain_k1():
            steps["bf16_plain"](coeffs, labels)

    fns = {"bf16": lambda: steps["bf16"](coeffs, labels), "f32": lambda: steps["f32"](coeffs, labels),
           "bf16_plain": plain_step}
    samples = {name: [] for name in fns}
    for name, fn in fns.items():  # warm-up
        fn()
    torch.cuda.synchronize()
    for order in (("f32", "bf16", "bf16_plain"), ("bf16_plain", "bf16", "f32")):
        for name in order:
            for _ in range(2 if name == "bf16_plain" else 5):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fns[name]()
                end.record()
                torch.cuda.synchronize()
                samples[name].append(start.elapsed_time(end))
    timing.update({f"{name}_flagship_train_step_ms": statistics.median(v) for name, v in samples.items()})
    timing["flagship_train_step_samples_ms"] = samples
    profile = profile_train_steps(model, coeffs, labels, K1_KINDS)
    return timing, profile


def _once_ms(fn):
    """Milliseconds of one call of fn() on the current stream, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def k9_bounds(timing):
    """K9's least times per launch at the slice, forward and backward, for
    this run's realised meshes: 2 W H (1 + C) float32 operations per stage
    evaluation of one lane's MLP field; the forward makes 6 per attempted step
    and 1 at each chunk entry, the backward recomputes the 7 of each accepted
    step and adds the VJP's and the weight gradients' products, 3 x 7 per
    accepted step (as K2).  Bytes: the table and the state read, the accepted
    steps' store and the rows written (forward); the table, the store and the
    cotangents read, the table's cotangent and dz0 written (backward)."""
    f = 2 * PS_WIDTH * PS_HIDDEN * (1 + 3)
    launches = timing["k9_launches_per_solve"]
    acc, att = timing["k9_steps_accepted"], timing["k9_steps_attempted"]
    ct = 4 * (PS_LENGTH - 1) * 3 * 3 * PS_BATCH
    state = 4 * PS_HIDDEN * PS_BATCH * launches
    store = 4 * acc * (PS_HIDDEN + 2)
    fwd = bound(ct + 2 * state + store, (6 * att + PS_BATCH * launches) * f)
    bwd = bound(2 * ct + store + 3 * state, 3 * 7 * acc * f)
    return tuple((ms / launches, by) for ms, by in (fwd, bwd))


def k8_bounds(batch, n, m, hidden, channels, width=WIDTH):
    """K8's least times at this batch, intervals, substeps, hidden size,
    channel count and width, forward and backward, and the forward's
    on the CUDA cores: 2 W H (1 + C) operations per evaluation of one lane's
    MLP field.  The forward evaluates (m + 1) times per interval, its
    products on the tensor cores in three TF32 passes, counted at the TF32
    rate (and, third, once at the float32 rate); the backward evaluates the
    two of each substep again and adds the two VJPs, whose products and
    weight gradients count as many again each: 6 per substep, float32.
    Bytes: the control's rows and the initial state read, y and ŷ written
    (forward); the rows, y, ŷ and their cotangent read, the rows' cotangent
    and dz0 written (backward)."""
    f = 2 * width * hidden * (1 + channels)
    ct_bytes = 4 * n * 3 * channels * batch
    states = 4 * n * hidden * batch
    state = 4 * hidden * batch
    fwd_bytes, fwd_flops = ct_bytes + state + 2 * states, (m + 1) * n * batch * f
    return (bound(fwd_bytes, 3 * fwd_flops, TF32_TENSOR_FLOPS),
            bound(2 * ct_bytes + 3 * states + state, 6 * m * n * batch * f),
            bound(fwd_bytes, fwd_flops))


def bound(bytes_moved, flops, flops_per_s=FP32_FLOPS):
    """(least ms, what bounds it): bytes over the HBM rate against the
    operations over their type's peak rate (float32 on the CUDA cores unless
    flops_per_s says otherwise)."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_fit_kernels(device, recorded):
    """Phase 13: each new kernel and its plain version (float32, on the card)
    at config 3, K4's library call, the public fit's forward and gradient
    with kernels on and off, and a profile of the NaN-masked gradient.
    Returns {name: (ms, plain_ms, bound_ms, bound_by, library_ms)}, the
    end-to-end times and the profile."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.interpolation.cubic import _masked_fit_plain, _masked_thomas_observed
    from torchcde_tpu_torch.ops.fill import masked_fill_scan
    from torchcde_tpu_torch.ops.tridiagonal import tridiagonal_solve_thomas

    mods = fit_kernel_modules()
    masked, dense = config3_data()
    n, k = FIT_BATCH, FIT_LENGTH
    x2 = torch.from_numpy(masked[..., 0]).to(device).contiguous()
    t = torch.arange(k, dtype=torch.float32, device=device)
    hr = 1.0 / (t[1:] - t[:-1])
    zero = hr.new_zeros(1)
    diag = 2 * (torch.cat([zero, hr]) + torch.cat([hr, zero]))
    rhs = torch.randn((n, k), generator=torch.Generator(device=device).manual_seed(4),
                      device=device)
    values, observed, reverse = recorded["K3"]
    solve_args = recorded["K5"]
    nv = len(values)
    # (kernel, its plain version, repeats of the plain version, bytes, flops):
    # bytes count each input read once and each output written once.
    work = {
        "K6/K7": (lambda: mods["K6/K7"].launch(t, x2, 1), lambda: _masked_fit_plain(t, x2, 1), 2,
                  4 * (n * k + k + 4 * n * (k - 1)), 42 * n * k),
        "K4": (lambda: mods["K4"].launch(rhs, hr, diag, hr),
               lambda: tridiagonal_solve_thomas(rhs, hr, diag, hr), 2,
               4 * (2 * n * k + 3 * k), 8 * n * k),
        "K5": (lambda: mods["K5"].launch(*solve_args),
               lambda: _masked_thomas_observed(*solve_args), 2, 4 * 5 * n * k + n * k, 10 * n * k),
        "K3": (lambda: mods["K3"].launch(values, observed, reverse),
               lambda: masked_fill_scan(tuple(values), observed, -1, reverse), 3,
               4 * 2 * nv * n * k + n * k, 0),
    }
    out = {}
    with torch.no_grad():
        for name, (kernel, plain, repeats, bytes_moved, flops) in work.items():
            ms = _event_ms(kernel, 10)
            with kernels_off():
                plain_ms = _event_ms(plain, repeats)
            out[name] = (ms, plain_ms, *bound(bytes_moved, flops), None)
        # K4's library call: at these inputs all rows share one band system,
        # so torch.linalg.solve of the dense (k, k) matrix against the rows
        # as columns computes the same function.  Building the matrix is
        # set-up, outside the timed window.  The other kernels have none: a
        # fill is cummax and a gather; no call solves K5's 8192 distinct
        # gappy systems (a dense batched solve would hold 8192 x 4096^2
        # floats) or fits a masked spline.
        A = torch.diag(diag) + torch.diag(hr, 1) + torch.diag(hr, -1)
        columns = rhs.t().contiguous()
        library_ms = _event_ms(lambda: torch.linalg.solve(A, columns), 3)
        err, scale = _rel(torch.linalg.solve(A, columns).t(), mods["K4"].launch(rhs, hr, diag, hr)
                          .double())
        print(f"K4 library call torch.linalg.solve (dense {k}x{k}, {n} columns): {library_ms:.4f} ms, "
              f"max_abs_err {err:.3e} against the kernel (largest |value| {scale:.3e})", flush=True)
        if not err <= FWD_RTOL * max(scale, 1.0):
            raise AssertionError("torch.linalg.solve disagrees with K4: not the same function")
        out["K4"] = out["K4"][:4] + (library_ms,)

    xm, xd = (torch.from_numpy(a).to(device) for a in (masked, dense))
    w = torch.ones((n, k - 1, 4), device=device)

    def grad_of(x):
        xg = x.clone().requires_grad_()
        return torch.autograd.grad((tt.natural_cubic_coeffs(xg) * w).sum(), xg)

    end_to_end = {}
    for label, x in (("masked", xm), ("dense", xd)):
        with torch.no_grad():
            end_to_end[f"{label}_fit_ms"] = _event_ms(lambda: tt.natural_cubic_coeffs(x), 5)
        end_to_end[f"{label}_fit_grad_ms"] = _event_ms(lambda: grad_of(x), 3)
        with kernels_off():
            with torch.no_grad():
                end_to_end[f"{label}_fit_plain_ms"] = _event_ms(
                    lambda: tt.natural_cubic_coeffs(x), 2)
            end_to_end[f"{label}_fit_grad_plain_ms"] = _event_ms(lambda: grad_of(x), 1)
    end_to_end["k3_timed_fill"] = f"{nv} values, reverse {reverse}, {n}x{k}"
    # Where the NaN-masked gradient's time goes: the new kernels, the other
    # (PyTorch) kernels of the recomputed pipeline and its autograd, idle.
    profiled = profile_calls(lambda: grad_of(xm), FIT_KERNEL_NAMES, 2)
    return out, end_to_end, profiled


# The long rows (phases 13 and 41): the routes of K4, K5 and K6/K7 that
# the resident kernels do not take, each at a shape of its bound's table.
# (name in the kernels line, operands, rows, length, the route): K4's bands
# per row ("rows", diagonally dominant, as phase 10 draws them) or shared
# ("dense": the dense fit's system on unit times, through the public fit
# and its gradient), K6/K7 on values with 20 % NaN ("masked", the public
# fit's forward), K5 in the gradient of the same fit ("masked_grad": its
# solve and transpose solve).
LONG_ROW_CASES = (("K4 per-row", "rows", 8192, 4096, "per_row"),
                  ("K4 per-row cluster", "rows", 2048, 8192, "per_row_cluster"),
                  ("K4 cluster", "dense", 2048, 8192, "cluster"),
                  ("K5 cluster", "masked_grad", 2048, 8192, "cluster"),
                  ("K5 cluster 2048x16384", "masked_grad", 2048, 16384, "cluster"),
                  ("K6/K7 cluster", "masked", 2048, 8192, "cluster"),
                  ("K6/K7 cluster 2048x16384", "masked", 2048, 16384, "cluster"),
                  ("K4 per-row segmented", "rows", 2048, 65536, "per_row_segmented"),
                  ("K4 segmented", "dense", 2048, 65536, "segmented"),
                  ("K5 segmented", "masked_grad", 2048, 65536, "segmented"),
                  ("K6/K7 segmented", "masked", 2048, 65536, "segmented"),
                  ("K6/K7 segmented 2048x32769", "masked", 2048, 32769, "segmented"))
# The kernel of each kind of case's operands.
LONG_ROW_FAMILY = {"rows": "K4", "dense": "K4", "masked_grad": "K5", "masked": "K6/K7"}
# The kernels each route launches, as the profiler names them (a RowMode
# or cluster level in brackets): every one must show in its case.
ROUTE_KERNELS = {
    ("K4", "per_row"): ("per_row_kernel<0>",),
    ("K4", "per_row_cluster"): ("per_row_kernel<1>",),
    ("K4", "per_row_segmented"): ("per_row_kernel<2>", "per_row_kernel<3>", "per_row_kernel<4>"),
    ("K4", "cluster"): ("band_pivot_kernel<1>", "shared_band_kernel<1>"),
    ("K4", "segmented"): ("band_pivot_kernel<2>", "band_pivot_kernel<4>", "shared_band_kernel<3>",
                          "shared_band_kernel<4>"),
    ("K5", "cluster"): ("gappy_kernel<1>",),
    ("K5", "segmented"): ("gappy_kernel<2>", "gappy_kernel<3>", "gappy_kernel<4>"),
    ("K6/K7", "cluster"): ("resident_fit_kernel<1>",),
    ("K6/K7", "segmented"): ("span_fit_kernel", "resident_fit_kernel<2>",
                             "resident_fit_kernel<3>", "resident_fit_kernel<4>"),
}
# K4's, K5's and K6/K7's one-thread kernels, which no route has: none may run
# in any case.
RETIRED_KERNELS = r"\b(?:(?:masked_)?thomas|long_fit)_kernel\b"
LONG_ROW_KERNELS_ARG = "--long-row-kernels"  # runs long_row_kernels alone


def long_row_operands(what, n, k, device):
    """A LONG_ROW_CASES case's operands, drawn on the card from a seed:
    (b, u, d, l) for "rows"; x (n, k, 1) for the others."""
    gen = torch.Generator(device=device).manual_seed(k)
    if what == "rows":
        b = torch.randn((n, k), generator=gen, device=device)
        u = torch.randn((n, k - 1), generator=gen, device=device)
        l = torch.randn((n, k - 1), generator=gen, device=device)
        pad = u.new_zeros((n, 1))
        return b, u, 1.0 + torch.cat([u.abs(), pad], -1) + torch.cat([pad, l.abs()], -1), l
    x = torch.randn((n, k, 1), generator=gen, device=device)
    if what in ("masked", "masked_grad"):
        x[torch.rand((n, k, 1), generator=gen, device=device) < FIT_NAN] = float("nan")
    return (x,)


def long_row_cotangent(what, ops):
    """The cotangent of a LONG_ROW_CASES case's gradient: ones, but for the
    masked fit phase 11's kind, normal from a seed: with ones the float32
    plain pipeline itself (no kernel, on the CPU too) lands 2-4e-4 of the
    largest magnitude off float64 at 8 x 8192, past FWD_RTOL."""
    if what != "masked_grad":
        return 1.0
    n, k, _ = ops[0].shape
    gen = torch.Generator(device=ops[0].device).manual_seed(3)
    return torch.randn((n, k - 1, 4), generator=gen, device=ops[0].device)


def long_row_call(what, ops):
    """The public entry point of a LONG_ROW_CASES case on its operands:
    tridiagonal_solve and its gradient for per-row bands, the dense fit and
    its gradient, the masked fit's forward (K6/K7), the masked fit and its
    gradient (its recomputed plain pipeline through K3 and K5), the
    gradients of (output * long_row_cotangent).sum().  Returns a call
    giving (output, gradient or None)."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.ops.tridiagonal import tridiagonal_solve

    leaves = [a.clone().requires_grad_() for a in ops]
    w = long_row_cotangent(what, ops)

    def run():
        if what == "masked":
            return tt.natural_cubic_coeffs(ops[0]), None
        out = tridiagonal_solve(*leaves) if what == "rows" else tt.natural_cubic_coeffs(leaves[0])
        return out, torch.autograd.grad((out * w).sum(), leaves[0])[0]

    return run


def long_row_slice(device):
    """Phase 41: each LONG_ROW_CASES case through the public entry points
    (long_row_call) with every plain version patched to raise, the launch
    counts by route set to 0 before and read after, the outputs against
    float64 (per-row solves: the plain PCR solve of every row; the fits:
    the plain path on 8 rows, the masked gradient's on 8 rows at 8192
    positions; past 16 384 positions, and K5's other cases, phase 10 holds
    the kernels at the same lengths, 16 384 and 65 536, instead); then the
    device kernels of each case from long_row_kernels_in_child (a case
    fails where the profiler misses one of its route's kernels; the child
    fails on a one-thread kernel of K4, K5 or K6/K7 anywhere)."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.ops.tridiagonal import tridiagonal_solve_pcr

    mods = fit_kernel_modules()
    routes = {family: mods[family].ROUTE_LAUNCHES for family in ("K4", "K5", "K6/K7")}
    report, failures, added_s = {}, [], 0.0
    for name, what, n, k, route in LONG_ROW_CASES:
        start = time.perf_counter()
        kernel = LONG_ROW_FAMILY[what]
        ops = long_row_operands(what, n, k, device)
        run = long_row_call(what, ops)
        torch.cuda.reset_peak_memory_stats()
        with plain_versions_raise():
            reset_fit_counts()
            out, grad = run()
            torch.cuda.synchronize()
            counts = fit_counts()
            by_route = {r: c for r, c in routes[kernel].items() if c}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = 8
        if what == "rows":
            with torch.no_grad():
                ref = tridiagonal_solve_pcr(*(a.double() for a in ops))
            err, scale = _rel(out, ref)
        elif what == "masked_grad" and k <= 8192:
            x64 = ops[0][:rows].double().requires_grad_()
            w64 = long_row_cotangent(what, ops)[:rows].double()
            ref = torch.autograd.grad((tt.natural_cubic_coeffs(x64) * w64).sum(), x64)[0]
            err, scale = _rel(grad[:rows], ref)
            del w64
        elif what == "masked_grad" or k > 16384:
            # phase 10 holds the kernel at this length (and K5's masked fit
            # forward is the K6/K7 case's at the same length and seed)
            ref, err, scale = None, None, float(out.abs().max())
        else:
            with torch.no_grad():
                ref = tt.natural_cubic_coeffs(ops[0][:rows].double())
            err, scale = _rel(out[:rows], ref)
        report[name] = {"shape": f"{n}x{k}", "launches": counts[kernel], "by_route": by_route,
                        "max_abs_err": err, "scale": scale, "peak_gb": peak_gb}
        checked = "held in phase 10" if err is None else f"max_abs_err {err:.3e}"
        checked += " (the gradient's)" if what == "masked_grad" and k <= 8192 else ""
        print(f"long rows {name} {n}x{k}: route {route}, launches {counts[kernel]} {by_route}, "
              f"{checked} (largest |value| {scale:.3e}), peak {peak_gb:.1f} GB", flush=True)
        if not bool(out.isfinite().all()) or (err is not None
                                               and not err <= FWD_RTOL * max(scale, 1.0)):
            failures.append(f"{name}: the output disagrees with float64")
        if grad is not None and not bool(grad.isfinite().all()):
            failures.append(f"{name}: the gradient is not finite")
        if set(by_route) != {route}:
            failures.append(f"{name}: launched {by_route}, not the {route} route")
        del ops, run, out, grad, ref
        torch.cuda.empty_cache()
        if what == "masked_grad" or route.endswith("segmented"):
            added_s += time.perf_counter() - start
    print(f"long rows: the K5 and segmented cases took {added_s:.1f} s", flush=True)

    # The device kernels of each case, each from a profiler session of its
    # own, in a new process of this script (long_row_kernels_in_child).
    for name, (device_us, events) in long_row_kernels_in_child().items():
        _, what, _, _, route = next(case for case in LONG_ROW_CASES if case[0] == name)
        report[name]["kernel_device_us"] = device_us
        report[name]["kernels"] = sorted(device_us)
        missing = [kernel for kernel in ROUTE_KERNELS[(LONG_ROW_FAMILY[what], route)]
                   if not any(kernel in m for m in device_us)]
        if missing:
            failures.append(f"{name}: the profiler did not see {missing} of the {route} route "
                            f"({sorted(device_us)}, of {events} device events)")
    if failures:
        raise AssertionError("the long rows: " + "; ".join(failures))
    return report


def long_row_kernels(device):
    """Each LONG_ROW_CASES case once more through its public entry point,
    every plain version raising, in a profiler session of its own: {name:
    ({fit kernel's name: device us}, count of all device events)}.  Raises
    where any device event is one of the retired one-thread kernels of K4,
    K5 or K6/K7."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, what, n, k, route in LONG_ROW_CASES:
        run = long_row_call(what, long_row_operands(what, n, k, device))
        torch.cuda.synchronize()
        with plain_versions_raise(), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        pattern = FIT_KERNEL_NAMES[LONG_ROW_FAMILY[what]]
        device_us, events, one_thread = {}, 0, set()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                events += 1
                if re.search(RETIRED_KERNELS, e.name):
                    one_thread.add(e.name)
                if re.search(pattern, e.name):
                    span = e.time_range.end - e.time_range.start
                    device_us[e.name] = device_us.get(e.name, 0.0) + span
        if one_thread:
            raise AssertionError(f"long rows {name}: one-thread kernels ran: {sorted(one_thread)}")
        out[name] = (device_us, events)
        print(f"long rows {name}: kernels (device us) {device_us}, of {events} device events",
              flush=True)
        del run
        torch.cuda.empty_cache()
    return out


def long_row_kernels_in_child():
    """long_row_kernels in a new process of this script, which it waits for.
    Late in this script's run the profiler recorded no device event in most
    of these sessions, with 0.5 s idle on either side of each case too,
    while a new process names every kernel."""
    torch.cuda.empty_cache()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), LONG_ROW_KERNELS_ARG],
                           capture_output=True, text=True, timeout=600)
    lines = child.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(f"  (child) {line}", flush=True)
    if child.returncode or not lines:
        raise AssertionError(f"the long rows' profile exited {child.returncode}: "
                             f"{child.stderr[-2000:]}")
    return json.loads(lines[-1])


def time_long_rows(device):
    """Phase 13's long rows: each LONG_ROW_CASES route's ms (CUDA events),
    its plain version's (float32 on the card, one call), its bound, and
    the library call where there is one: torch.linalg.solve of the dense
    k x k shared system against the rows as columns for K4's shared bands.
    K5 runs on the operands of the last launch of one masked gradient of
    its case, and the gradient itself is timed end to end.  Returns ({name:
    (ms, plain_ms, bound_ms, bound_by, library_ms)}, {name: the gradient's
    ms})."""
    from torchcde_tpu_torch.interpolation.cubic import _masked_fit_plain, _masked_thomas_observed
    from torchcde_tpu_torch.ops.row_split import CLUSTER_REACH
    from torchcde_tpu_torch.ops.tridiagonal import tridiagonal_solve_thomas

    mods = fit_kernel_modules()
    out, gradient_ms = {}, {}
    for name, what, n, k, route in LONG_ROW_CASES:
        ops = long_row_operands(what, n, k, device)
        solve_args = None
        if what == "masked_grad":
            run = long_row_call(what, ops)
            launch, recorded = mods["K5"].launch, []
            with mock.patch.object(mods["K5"], "launch",
                                   lambda *a: recorded.append(a) or launch(*a)):
                run()
            solve_args = recorded[-1]
            gradient_ms[name] = _event_ms(run, 3)
            del run
        with torch.no_grad():
            library_ms = None
            if what == "masked_grad":
                kernel = lambda: mods["K5"].launch(*solve_args)
                plain = lambda: _masked_thomas_observed(*solve_args)
                bytes_moved, flops = 4 * 5 * n * k + n * k, 10 * n * k
            elif what == "masked":
                x2, t = ops[0][..., 0].contiguous(), torch.arange(k, dtype=torch.float32,
                                                                  device=device)
                kernel = lambda: mods["K6/K7"].launch(t, x2, 1)
                plain = lambda: _masked_fit_plain(t, x2, 1)
                bytes_moved, flops = 4 * (n * k + k + 4 * n * (k - 1)), 42 * n * k
            else:
                if what == "dense":
                    hr = torch.ones(k - 1, device=device)
                    zero = hr.new_zeros(1)
                    system = (ops[0][..., 0].contiguous(), hr,
                              2 * (torch.cat([zero, hr]) + torch.cat([hr, zero])), hr)
                    bytes_moved = 4 * (2 * n * k + 3 * k)
                else:
                    system = ops
                    bytes_moved = 4 * (3 * n * k + 2 * n * (k - 1))
                kernel = lambda: mods["K4"].launch(*system)
                plain = lambda: tridiagonal_solve_thomas(*system)
                flops = 8 * n * k
                if what == "dense":
                    b, hr, diag, _ = system
                    A = torch.zeros((k, k), device=device)
                    A.diagonal().copy_(diag)
                    A.diagonal(1).copy_(hr)
                    A.diagonal(-1).copy_(hr)
                    columns = b.t().contiguous()
                    if k > CLUSTER_REACH:  # 17 GB at 65 536 and seconds a solve: one call
                        solved = []
                        library_ms = _once_ms(
                            lambda: solved.append(torch.linalg.solve(A, columns)))
                        solved = solved[0]
                    else:
                        library_ms = _event_ms(lambda: torch.linalg.solve(A, columns), 3)
                        solved = torch.linalg.solve(A, columns)
                    err, scale = _rel(solved.t(), kernel().double())
                    print(f"{name} library call torch.linalg.solve (dense {k}x{k}, {n} columns): "
                          f"{library_ms:.4f} ms, max_abs_err {err:.3e} against the kernel "
                          f"(largest |value| {scale:.3e})", flush=True)
                    if not err <= FWD_RTOL * max(scale, 1.0):
                        raise AssertionError(f"torch.linalg.solve disagrees with {name}")
                    del A, columns, solved
            ms = _event_ms(kernel, 3 if k > 16384 else 10)
            with kernels_off():
                plain_ms = _once_ms(plain)
            out[name] = (ms, plain_ms, *bound(bytes_moved, flops), library_ms)
            print(f"{name} {n}x{k} ({route}): {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
                  f"{out[name][2]:.4f} ms ({out[name][3]})", flush=True)
            del ops, solve_args
            torch.cuda.empty_cache()
    print(f"long rows: the masked gradient, end to end (ms): {gradient_ms}", flush=True)
    return out, gradient_ms


def fused_bounds(k2_ms):
    """The least times of K1 (flagship shapes) and K2 (default configuration,
    batch 4096, this run's realised mesh): 2 W H (1 + C) float32 operations
    per stage evaluation of one lane's MLP field.  K1: rk4, 4 stages per
    interval forward; the backward needs one recompute of the 4 stages from
    the stored interval state, then the VJP's products and the weight
    gradients' products, as many again each: 3 times the forward's (the
    flagship's one substep per interval leaves nothing to replay; the
    kernel's replay before its recompute is its own choice).  K2: 6 new
    stage evaluations per attempted step (the first stage is the last
    one's) and one to start; the backward recomputes the 7 stages of every
    accepted step and adds the VJP's and the weight gradients' products, 3
    times 7 per accepted step.  Bytes (the control's coefficients, states
    and cotangents) are far below: operations bound."""
    n = LENGTH - 1
    return k1_bounds(False) + k2_bounds(k2_ms, BATCH, n, CHANNELS, 3)


def k1_bounds(bf16, hidden=HIDDEN, channels=CHANNELS):
    """K1's least times at the flagship's shapes at this hidden size and
    channel count (see fused_bounds), forward and backward.  The bfloat16
    mode's slabs (and their cotangents) take 2 bytes instead of 4, and its
    stage products, whose operands are bfloat16 summed in float32, count at
    the tensor cores' bfloat16 rate."""
    f = 2 * WIDTH * hidden * (1 + channels)
    n = LENGTH - 1
    ct_bytes = (2 if bf16 else 4) * n * 3 * channels * BATCH
    state = 4 * hidden * BATCH
    rate = BF16_TENSOR_FLOPS if bf16 else FP32_FLOPS
    return (bound(ct_bytes + state + 4 * n * hidden * BATCH, n * 4 * BATCH * f, rate),
            bound(2 * ct_bytes + 2 * 4 * n * hidden * BATCH + 2 * state,
                  3 * n * 4 * BATCH * f, rate))


def k2_bounds(k2_ms, batch, n, channels, rows):
    """K2's least times, forward and backward, for this run's realised mesh
    (see fused_bounds) over n intervals of rows * channels table rows (3 * C
    cubic, C linear)."""
    f = 2 * WIDTH * HIDDEN * (1 + channels)
    ct_bytes = 4 * n * rows * channels * batch
    state = 4 * HIDDEN * batch
    acc, att = k2_ms["k2_steps_accepted"], k2_ms["k2_steps_attempted"]
    return (bound(ct_bytes + state + 4 * acc * HIDDEN * batch, (6 * att + 1) * batch * f),
            bound(2 * ct_bytes + 4 * acc * HIDDEN * batch + 2 * state, 3 * 7 * acc * batch * f))


# 29-30. The rest of the solver surface and the first example.  The methods,
# jump_t, tuple states and scipy_solver run as plain PyTorch ops on the card
# (the JAX package runs them as XLA ops, no Pallas kernel): no fused kernel
# may launch for them.  Problem: the spiral data at the flagship's width
# (3 channels, hidden 8, width 128, an MLPVectorField over Hermite
# coefficients, float32), its length cut to SURFACE_LENGTH so that both
# phases stay within 40 s; forwards at SURFACE_BATCH, one direct gradient
# per method at SURFACE_GRAD_BATCH (low-order adaptive meshes are long), on
# the first lanes of the same problem.  Each solve is held against the
# port's float64 solve of the same problem: a fixed-step method on the same
# steps, within SURFACE_FIXED_RTOL of the largest magnitude (values) or
# SURFACE_FIXED_GRAD_RTOL in the relative Frobenius norm (gradients: where
# rounding puts a ReLU pre-activation on the other side of zero, a lane's
# gradient differs by a whole term, as in K1's checks above; one such lane
# of 256 moved implicit_adams's to 4e-4 on an H100); an adaptive one's values against
# one float64 dopri5 solve at rtol 1e-10, atol 1e-12 and a budget of
# EXACT_CAP steps, whose first lanes serve the smaller batches (its float32
# mesh parts from any float64 one, ROADMAP section 3), its gradients against
# one float64 direct gradient of dopri5 at rtol 1e-8, atol 1e-10 with a jump
# at every interior knot (GRAD_TIGHT; the direct gradient at rtol 1e-10
# takes minutes, and on a CPU rehearsal one at rtol 1e-7 lay 6e-4 from it),
# each within SURFACE_ADAPTIVE_RTOL: the global error of a solve at rtol
# 1e-4 over the knot intervals, which reaches ~1e-2 of the largest magnitude
# on this data (EXACT_TOL above), with room for the order-2 pairs.  The
# backsolve adjoint's gradient carries its own error at rtol 1e-4, 2-3e-2
# from direct gradients (ROADMAP section 3, in float64 on the CPU): it is
# held within SURFACE_BACKSOLVE_RTOL.  scipy_solver (RK45 at rtol 1e-6, atol
# 1e-8) is held within SURFACE_SCIPY_RTOL of the tight solve.
SURFACE_METHODS = ("heun3", "bosh3", "dopri5_nofsal", "dopri8", "adaptive_heun", "fehlberg2",
                   "explicit_adams", "implicit_adams")
SURFACE_FIXED = ("heun3", "explicit_adams", "implicit_adams")
SURFACE_BATCH, SURFACE_GRAD_BATCH, SURFACE_SCIPY_BATCH = 4096, 256, 16
SURFACE_LENGTH = 10
SURFACE_FIXED_RTOL = 1e-4
SURFACE_FIXED_GRAD_RTOL = 5e-3
SURFACE_ADAPTIVE_RTOL = 5e-2
SURFACE_SCIPY_RTOL = 1e-3
SURFACE_BACKSOLVE_RTOL = 1e-1
TIGHT = dict(method="dopri5", rtol=1e-10, atol=1e-12, max_steps=EXACT_CAP)
GRAD_TIGHT = dict(method="dopri5", rtol=1e-8, atol=1e-10, max_steps=EXACT_CAP)


class SurfaceProblem:
    """The phase's problem: the spiral data's control, an MLPVectorField and
    z0 in float32 on the card, and their float64 twins; ``lanes(n)`` gives
    the first n lanes of each."""

    def __init__(self, device, batch, seed=0):
        import torchcde_tpu_torch as tt
        from torchcde_tpu_torch.solvers.terms import MLPVectorField

        X_np, _ = spiral_data(batch, SURFACE_LENGTH, seed)
        self.x = torch.from_numpy(X_np).to(device)
        torch.manual_seed(seed)
        self.field = MLPVectorField(HIDDEN, CHANNELS, WIDTH).to(device)
        self.field64 = copy.deepcopy(self.field).double()
        gen = torch.Generator().manual_seed(seed)
        self.z0 = (0.5 * torch.randn(batch, HIDDEN, generator=gen)).to(device)
        self.coeffs = tt.hermite_cubic_coefficients_with_backward_differences(self.x)

    def lanes(self, n, dtype=torch.float32):
        """(X, field, z0) of the first n lanes in dtype."""
        import torchcde_tpu_torch as tt

        field = self.field if dtype == torch.float32 else self.field64
        return tt.CubicSpline(self.coeffs[:n].to(dtype)), field, self.z0[:n].to(dtype)


def surface_kwargs(method):
    if method in SURFACE_FIXED:
        return dict(method=method, options=dict(step_size=1.0))
    return dict(method=method)


def fused_launches():
    """Every launch count of the fused solver kernels K1, K2, K8 and K9."""
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    return {name: (m.FWD_LAUNCHES, m.BWD_LAUNCHES)
            for name, m in (("K1", k1), ("K2", k2), ("K8", k8), ("K9", k9))}


def reset_fused_launches():
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    for m in (k1, k2, k8, k9):
        m.reset_launch_counts()


def _timed(fn):
    """(fn()'s result, its wall milliseconds, the card synchronised)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - start)


def _grads(X, field, z0, proj, **kwargs):
    """Direct gradients of sum(out[..., -1, :] * proj) w.r.t. z0 and the field."""
    import torchcde_tpu_torch as tt

    z0 = z0.detach().requires_grad_()
    params = [z0] + list(field.parameters())
    out = tt.cdeint(X, field, z0, X.interval, **kwargs)
    return torch.autograd.grad((out[..., -1, :] * proj).sum(), params)


def _rel_frobenius(got, ref):
    return max(float(torch.linalg.vector_norm(g.double() - r) / torch.linalg.vector_norm(r))
               for g, r in zip(got, ref))


def surface_slice(device):
    """Phase 29: every method the earlier phases do not run, jump_t, a tuple
    state and scipy_solver through the public ``cdeint`` on the card, each
    held against a float64 solve, with K1, K2, K8 and K9 launched zero times."""
    import torchcde_tpu_torch as tt

    failures, report = [], {}

    def hold(label, err, limit, key="err"):
        report[label][key] = err
        if not err <= limit:
            failures.append(f"{label} {key}: {err:.3e} > {limit:.1e}")

    def rel_err(out, ref):
        err, scale = _err(out.double(), ref)
        return err / scale

    reset_fused_launches()
    problem = SurfaceProblem(device, SURFACE_BATCH)
    X, field, z0 = problem.lanes(SURFACE_BATCH)
    X64, field64, z064 = problem.lanes(SURFACE_BATCH, torch.float64)
    with torch.no_grad():
        (tight, stats), tight_ms = _timed(lambda: tt.cdeint(
            X64, field64, z064, X64.interval, adjoint=False, return_stats=True, **TIGHT))
        report[f"float64 rtol 1e-10 B{SURFACE_BATCH}"] = dict(
            ms=tight_ms, steps=int(stats["steps_attempted"]))
        for method in SURFACE_METHODS:
            (out, stats), ms = _timed(lambda: tt.cdeint(
                X, field, z0, X.interval, adjoint=False, return_stats=True,
                **surface_kwargs(method)))
            label = f"{method} B{SURFACE_BATCH}"
            report[label] = dict(ms=ms, steps=int(stats["steps_attempted"]))
            if method in SURFACE_FIXED:
                ref, report[label]["reference_ms"] = _timed(lambda: tt.cdeint(
                    X64, field64, z064, X64.interval, adjoint=False, **surface_kwargs(method)))
                limit = SURFACE_FIXED_RTOL
            else:
                ref, limit = tight, SURFACE_ADAPTIVE_RTOL
            if out.shape != ref.shape or not torch.isfinite(out).all():
                failures.append(f"{label}: shape {tuple(out.shape)} or not finite")
            hold(label, rel_err(out, ref), limit)
            print(f"surface {label}: {ms:.1f} ms, {report[label]['steps']} steps, error "
                  f"against float64 {report[label]['err']:.3e} of the largest magnitude",
                  flush=True)

    B = SURFACE_GRAD_BATCH
    X, field, z0 = problem.lanes(B)
    X64, field64, z064 = problem.lanes(B, torch.float64)
    proj = torch.randn(B, HIDDEN, generator=torch.Generator().manual_seed(2)).to(device)
    jumps = X.grid_points[1:-1]
    grad_ref, ref_ms = _timed(lambda: _grads(X64, field64, z064, proj.double(), adjoint=False,
                                             options=dict(jump_t=jumps), **GRAD_TIGHT))
    report[f"float64 gradient rtol 1e-8 B{B}"] = dict(ms=ref_ms)
    for method in SURFACE_METHODS:
        grads, ms = _timed(lambda: _grads(X, field, z0, proj, adjoint=False,
                                          **surface_kwargs(method)))
        label = f"{method} gradient B{B}"
        report[label] = dict(ms=ms)
        if method in SURFACE_FIXED:
            ref, report[label]["reference_ms"] = _timed(lambda: _grads(
                X64, field64, z064, proj.double(), adjoint=False, **surface_kwargs(method)))
            hold(label, _rel_frobenius(grads, ref), SURFACE_FIXED_GRAD_RTOL)
        else:
            hold(label, _rel_frobenius(grads, grad_ref), SURFACE_ADAPTIVE_RTOL)
        print(f"surface {label}: {ms:.1f} ms, rel_frobenius {report[label]['err']:.3e}",
              flush=True)

    # dopri5 with a jump at every interior knot, in both adjoint modes.
    for adjoint in (False, True):
        label = f"dopri5 jump_t adjoint={adjoint} B{B}"
        with torch.no_grad():
            out, ms = _timed(lambda: tt.cdeint(X, field, z0, X.interval, adjoint=adjoint,
                                               options=dict(jump_t=jumps)))
        grads, grad_ms = _timed(lambda: _grads(X, field, z0, proj, adjoint=adjoint,
                                               options=dict(jump_t=jumps)))
        report[label] = dict(ms=ms, gradient_ms=grad_ms)
        hold(label, rel_err(out, tight[:B]), SURFACE_ADAPTIVE_RTOL)
        hold(label, _rel_frobenius(grads, grad_ref),
             SURFACE_BACKSOLVE_RTOL if adjoint else SURFACE_ADAPTIVE_RTOL, "gradient_err")
        print(f"surface {label}: {ms:.1f} ms, gradient {grad_ms:.1f} ms, errors "
              f"{report[label]['err']:.3e}, {report[label]['gradient_err']:.3e}", flush=True)

    # A two-member tuple state: the MLP field on the spline, and on a second
    # control (the spline of the last two channels) a constant field A, whose
    # solution z0 + A (X(t) - X(t0)) is known.
    A = 0.5 * torch.randn(4, 2, generator=torch.Generator().manual_seed(3)).to(device)
    Xb = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(
        problem.x[:B, :, 1:]))
    zb0 = torch.full((B, 4), 0.1, device=device)

    def func(t, zs):
        za, zb = zs
        return field(t, za), A.expand(zb.shape[:-1] + A.shape)

    Xt = tt.TupleControl(X, Xb)
    with torch.no_grad():
        out, ms = _timed(lambda: tt.cdeint(Xt, func, (z0, zb0), Xt.interval, adjoint=False))
        end = Xb.evaluate(Xb.interval[-1]) - Xb.evaluate(Xb.interval[0])
        exact_b = zb0.double() + end.double() @ A.double().t()
    label = f"tuple state dopri5 B{B}"
    report[label] = dict(ms=ms)
    hold(label, max(rel_err(out[0], tight[:B]), rel_err(out[1][..., -1, :], exact_b)),
         SURFACE_ADAPTIVE_RTOL)
    print(f"surface {label}: {ms:.1f} ms, error {report[label]['err']:.3e}", flush=True)

    # scipy_solver: solve_ivp steps on the host, the right-hand side on the card.
    X, field, z0 = problem.lanes(SURFACE_SCIPY_BATCH)
    with torch.no_grad():
        out, ms = _timed(lambda: tt.cdeint(X, field, z0, X.interval, adjoint=False,
                                           method="scipy_solver", rtol=1e-6, atol=1e-8))
    label = f"scipy_solver RK45 B{SURFACE_SCIPY_BATCH}"
    report[label] = dict(ms=ms)
    hold(label, rel_err(out, tight[:SURFACE_SCIPY_BATCH]), SURFACE_SCIPY_RTOL)
    print(f"surface {label}: {ms:.1f} ms, error {report[label]['err']:.3e}", flush=True)

    launches = fused_launches()
    report["fused_launches"] = launches
    print(f"surface: fused kernel launches {launches}", flush=True)
    if any(n for pair in launches.values() for n in pair):
        failures.append(f"a fused kernel launched on the solver surface: {launches}")
    if failures:
        raise AssertionError("solver surface: " + "; ".join(failures))
    return report


def example_slice():
    """Phase 30: examples/torch_time_series_classification.py's main on the
    card for one epoch: a finite accuracy, and K2 launched both ways."""
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import torch_time_series_classification as example

    k2.reset_launch_counts()
    acc, ms = _timed(lambda: example.main(num_epochs=1, device="cuda"))
    launches = {"fwd": k2.FWD_LAUNCHES, "bwd": k2.BWD_LAUNCHES}
    print(f"example: accuracy {acc:.4f} after one epoch, {ms:.1f} ms, K2 launches {launches}",
          flush=True)
    if not math.isfinite(acc) or not launches["fwd"] > 0 or not launches["bwd"] > 0:
        raise AssertionError(f"the example did not run through K2: {acc}, {launches}")
    return dict(accuracy=acc, ms=ms, k2_launches=launches)


# --------------------------------------------------------------------------
# The host side (phases 31-33): the C++ preprocessing runtime against the
# card's own preprocessing, the prefetching loader feeding three slices, and
# the observability utilities on the flagship.
# --------------------------------------------------------------------------

# The loader of phases 32-33: four preprocessing threads, two batches ahead.
LOADER_WORKERS, LOADER_PREFETCH = 4, 2
LOADER_STEPS = 5
# Phase 33's timing.  A pass is one epoch of a loader, longer than
# examples/parallel_training.py's 32 batches.  Its steady steps are those
# during which the loader is still making batches at its in-flight bound
# (prefetch + workers - 1 ahead of the consumer): from the first step past
# the batches made at the pass's start, to the last before the loader runs
# out of batches to make.  Medians are taken over those steps alone.
TIMED_BATCHES = 48
TIMED_PASSES = 4  # of each variant, in turns, the order reversed every other turn
IN_FLIGHT = LOADER_PREFETCH + LOADER_WORKERS - 1
STEADY = slice(IN_FLIGHT + 1, TIMED_BATCHES - IN_FLIGHT)
PROFILED_CALLS = 3
HOST_REPEATS = 3
# device_profile's device time against phase 9's kernel time of the same step.
PROFILE_AGREEMENT = 0.25


def host_cpu():
    """The host's CPU (/proc/cpuinfo's first entry: model name, vendor,
    family, model, MHz) and the threads this process may use."""
    fields = {"model name": "cpu", "vendor_id": "vendor", "cpu family": "family",
              "model": "model", "cpu MHz": "mhz"}
    cpu = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            if not line.strip():
                break
            if key.strip() in fields:
                cpu[fields[key.strip()]] = value.strip()
    return {**cpu, "threads": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count()}


def _host_ms(fn, repeats=HOST_REPEATS):
    """Median wall ms of fn() on the host (the native calls are synchronous)."""
    samples = []
    for _ in range(repeats):
        start = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - start) * 1e3)
    return statistics.median(samples)


def native_slice(device):
    """Phase 31: the host runtime on each loader route's full-width data
    against the port's public function on the card (float32, within
    FWD_RTOL of its largest magnitude), the card side with every plain
    version patched to raise and its fit launches asserted; and the host's
    preprocessing ms per batch of each route."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch import native

    cpu = host_cpu()
    print(f"host: {json.dumps(cpu)}; the native calls use {native._default_threads()} threads",
          flush=True)
    x_flag, _ = spiral_data(BATCH, LENGTH)
    x_nan, _ = nan_spiral_data(BATCH, LENGTH)
    t = np.arange(LENGTH, dtype=np.float32)
    t_log = np.arange(LOG_ODE_LENGTH, dtype=np.float32)
    x_log, _ = spiral_data(LOG_ODE_BATCH, LOG_ODE_LENGTH)
    x_log_nan, _ = nan_spiral_data(LOG_ODE_BATCH, LOG_ODE_LENGTH)
    no_fit = {"K3": 0, "K4": 0, "K5": 0, "K6/K7": 0}
    routes = [
        ("hermite", f"flagship spirals {x_flag.shape}", lambda: native.hermite_coeffs(t, x_flag),
         lambda: tt.hermite_cubic_coefficients_with_backward_differences(
             torch.from_numpy(x_flag).to(device)), no_fit),
        ("cubic", f"NaN spirals {x_nan.shape}", lambda: native.natural_cubic_masked(t, x_nan),
         lambda: tt.natural_cubic_coeffs(torch.from_numpy(x_nan).to(device)),
         dict(no_fit, **{"K6/K7": 1})),
        ("logsig", f"config-4 spirals {x_log.shape}",
         lambda: native.logsig_windows_host(t_log, x_log, LOG_ODE_DEPTH, LOG_ODE_WINDOW),
         lambda: tt.logsig_windows(torch.from_numpy(x_log).to(device), LOG_ODE_DEPTH,
                                   LOG_ODE_WINDOW), no_fit),
        ("logsig NaN", f"config-4 spirals {x_log_nan.shape}, 30 % NaN",
         lambda: native.logsig_windows_host(t_log, x_log_nan, LOG_ODE_DEPTH, LOG_ODE_WINDOW),
         lambda: tt.logsig_windows(torch.from_numpy(x_log_nan).to(device), LOG_ODE_DEPTH,
                                   LOG_ODE_WINDOW), dict(no_fit, K3=2)),
    ]
    failures, report = [], {"host": cpu}
    for route, label, host_fn, card_fn, expected in routes:
        host = host_fn()
        with plain_versions_raise():
            reset_fit_counts()
            card = card_fn()
            torch.cuda.synchronize()
            fit = fit_counts()
        if host.shape != tuple(card.shape) or host.dtype != np.float32:
            failures.append(f"{route}: host {host.shape} {host.dtype}, card {tuple(card.shape)}")
            continue
        err, scale = _rel(torch.from_numpy(host).to(device), card.double())
        _report(f"native {route} of the {label} vs the card", err, scale,
                FWD_RTOL * max(scale, 1.0), failures, bool(np.isfinite(host).all()))
        if fit != expected:
            failures.append(f"{route}: the card's fit launched {fit}, not {expected}")
        report[route] = {"max_abs_err": err, "largest": scale, "card_fit_launches": fit,
                         "host_ms_per_batch": _host_ms(host_fn)}
    print("native: " + json.dumps(report), flush=True)
    if failures:
        raise AssertionError("the host runtime disagrees with the card: " + "; ".join(failures))
    return report


def _loader(device, x, y, batch, workers=LOADER_WORKERS, **kwargs):
    from torchcde_tpu_torch.data import CoefficientDataLoader

    return CoefficientDataLoader(x, y, batch, shuffle=True, seed=0, num_workers=workers,
                                 prefetch=LOADER_PREFETCH, device=device, **kwargs)


def _adam_step(model):
    from torchcde_tpu_torch.models import make_train_step

    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
    return make_train_step(model, optimizer), optimizer


def logits_on_own_meshes(model, own_coeffs, fed_coeffs):
    """The model's logits on own_coeffs through K2, each launch's accepted
    mesh recorded, and its logits on fed_coeffs with each fused solve
    replayed in float64 along the mesh K2 took on own_coeffs.  An adaptive
    solve's mesh hangs on rounding-level changes of its input (see
    EXACT_TOL), so two inputs are held against each other on one mesh."""
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    meshes, launch = [], k2.launch_forward

    def record(*args, **kwargs):
        out = launch(*args, **kwargs)
        meshes.append(k2.read_mesh(out[3]))
        return out

    with mock.patch.object(k2, "launch_forward", record), torch.no_grad():
        own = model(own_coeffs)
    pinned = iter(meshes)

    def replay(ct, z0t, w1t, b1, w2t, b2, dt0, plan, weights=None):
        ops = (v.double() for v in (ct, z0t, w1t, b1, w2t, b2))
        zout, zfin = k2.fused_dopri5_replay(*ops, next(pinned), plan)
        return zout.to(ct.dtype), zfin.to(ct.dtype), dt0

    with mock.patch.object(k2, "fused_dopri5_solve", replay), torch.no_grad():
        fed = model(fed_coeffs)
    if not meshes or next(pinned, None) is not None:
        raise AssertionError(f"{len(meshes)} K2 meshes recorded, not one for each replayed solve")
    return own, fed


def loader_slices(device):
    """Phase 32: three slices fed by CoefficientDataLoader(num_workers=4,
    prefetch=2) at full width, five Adam steps each, every plain version
    patched to raise and the fused kernel's launches counted from just
    before the first step: the flagship (Hermite route, K1), the default
    configuration on 30 %-NaN spirals (masked cubic route, K2) and config 4
    (logsig route, K2's linear mode).  The model's logits before the first
    step on the loader's first batch are held against its logits on the
    port's own card coefficients of the same rows, within FWD_RTOL: the
    adaptive slices' on the meshes K2 took on the card's own coefficients
    (logits_on_own_meshes)."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    def k1_counts():
        return {"fwd": k1.FWD_LAUNCHES, "bwd": k1.BWD_LAUNCHES}

    def k2_counts():
        return {"fwd": k2.FWD_LAUNCHES, "bwd": k2.BWD_LAUNCHES}

    def k2_linear_counts():
        return {**k2_counts(), "linear_fwd": k2.LINEAR_FWD_LAUNCHES,
                "linear_bwd": k2.LINEAR_BWD_LAUNCHES}

    def own_logsig(xb):
        return tt.linear_interpolation_coeffs(
            tt.logsig_windows(xb, LOG_ODE_DEPTH, LOG_ODE_WINDOW))

    n = LOADER_STEPS
    slices = [
        ("flagship rk4 (hermite)", spiral_data(n * BATCH, LENGTH, seed=2), BATCH,
         dict(interpolation="hermite"), lambda: make_model(device),
         tt.hermite_cubic_coefficients_with_backward_differences, k1.reset_launch_counts,
         k1_counts, {"fwd": n, "bwd": n}),
        ("default on NaN spirals (cubic)", nan_spiral_data(n * BATCH, LENGTH, seed=3), BATCH,
         dict(interpolation="cubic"),
         lambda: NeuralCDE(NeuralCDEConfig(**DEFAULT), generator=torch.Generator().manual_seed(0)),
         tt.natural_cubic_coeffs, k2.reset_launch_counts, k2_counts, {"fwd": n, "bwd": n}),
        ("config 4 (logsig)", spiral_data(n * LOG_ODE_BATCH, LOG_ODE_LENGTH, seed=4),
         LOG_ODE_BATCH, dict(interpolation="logsig", depth=LOG_ODE_DEPTH,
                             window_length=LOG_ODE_WINDOW),
         lambda: log_ode_model(device), own_logsig, k2.reset_launch_counts, k2_linear_counts,
         {"fwd": n, "bwd": n, "linear_fwd": n, "linear_bwd": n}),
    ]
    report = {}
    for label, (x, y), batch, kwargs, build, own, reset, counts, expected in slices:
        failures = []
        rows = np.random.default_rng(0).permutation(x.shape[0])[:batch]  # the loader's first batch
        with plain_versions_raise():
            model = build()
            initial = copy.deepcopy(model)
            step, _optimizer = _adam_step(model)
            losses, start = [], time.perf_counter()
            for i, (coeffs, labels) in enumerate(_loader(device, x, y, batch, **kwargs)):
                if i == 0:
                    if not torch.equal(labels.cpu(), torch.from_numpy(y[rows])):
                        failures.append("the first batch's labels are not its rows'")
                    fed_coeffs = coeffs
                    own_coeffs = own(torch.from_numpy(x[rows]).to(device))
                    reset()
                losses.append(float(step(coeffs, labels)))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            launches = counts()
        err, scale = _rel(fed_coeffs, own_coeffs.double())
        _report(f"loader slice {label}: the first batch's coefficients vs the card's own", err,
                scale, FWD_RTOL * max(scale, 1.0), failures)
        with torch.no_grad():
            ref, fed = initial(own_coeffs), initial(fed_coeffs)
        # Each on its own mesh, where the solve is adaptive: printed only.
        fed_vs_own = float((fed - ref).abs().max())
        if initial.cfg.solver == "dopri5":
            ref, fed = logits_on_own_meshes(initial, own_coeffs, fed_coeffs)
        logit_err, scale = _rel(fed, ref.double())
        limit = FWD_RTOL * max(scale, 1.0)
        _report(f"loader slice {label}: logits of the first batch vs the card's own "
                f"coefficients'", logit_err, scale, limit, failures, bool(fed.isfinite().all()))
        print(f"loader slice {label}: the first batch's logits, each solve on its own mesh, "
              f"differ from those on the card's own coefficients by {fed_vs_own:.3e}",
              flush=True)
        print(f"loader slice {label}: B{batch} coefficients {tuple(coeffs.shape)}, "
              f"{len(losses)} Adam steps in {seconds:.2f} s, losses {losses}, "
              f"launches {launches}", flush=True)
        if len(losses) != n or not all(math.isfinite(v) for v in losses) \
                or losses[-1] == losses[0]:
            failures.append(f"the loss is not finite or does not change: {losses}")
        if launches != expected:
            failures.append(f"the steps did not launch {expected}: {launches}")
        if failures:
            raise AssertionError(f"the loader slice {label} failed: " + "; ".join(failures))
        report[label] = {"losses": losses, "launches": launches, "coefficients_max_abs_err": err,
                         "logits_max_abs_err": logit_err, "logits_limit": limit,
                         "logits_fed_vs_own": fed_vs_own, "seconds": seconds}
    return report


def _unnamed(names, kinds):
    """The kinds (name -> pattern) that no name matches."""
    return [kind for kind, pattern in kinds.items()
            if not any(re.search(pattern, name) for name in names)]


def observability_slice(device, flagship_profile):
    """Phase 33 on the flagship, loader-fed: two steps under trace() with
    annotate("train_step"), whose written trace must name K1's kernels and
    the annotation; a checkpoint of the model and Adam after step 3, from
    which steps 4-5 must repeat bit for bit; and device_profile of the step,
    whose ops must include K1's kernels and whose device time must lie
    within PROFILE_AGREEMENT of phase 9's kernel time of the same step."""
    from torchcde_tpu_torch.utils import annotate, load_checkpoint, save_checkpoint, trace
    from torchcde_tpu_torch.utils.observability import device_profile

    x, y = spiral_data(LOADER_STEPS * BATCH, LENGTH, seed=2)
    model = make_model(device)
    step, optimizer = _adam_step(model)
    failures = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        it = iter(_loader(device, x, y, BATCH, interpolation="hermite"))
        with trace(os.path.join(tmp, "trace")):
            for _ in range(2):
                with annotate("train_step"):
                    step(*next(it))
        (trace_file,) = glob.glob(os.path.join(tmp, "trace", "*.pt.trace.json"))
        with open(trace_file) as f:
            names = {str(e.get("name")) for e in json.load(f)["traceEvents"]}
        missing = _unnamed(names, {**K1_KINDS, "annotation": r"^train_step$"})
        print(f"trace: {os.path.getsize(trace_file)} bytes, {len(names)} event names, "
              f"missing {missing}", flush=True)
        if missing:
            failures.append(f"the trace does not name {missing}")

        step(*next(it))
        checkpoint = os.path.join(tmp, "after_step3")
        save_checkpoint(checkpoint, {"model": model.state_dict(),
                                     "optimizer": optimizer.state_dict()})
        rest = list(it)
        first = [float(step(*b)) for b in rest]
        restored = load_checkpoint(checkpoint, {"model": model.state_dict(),
                                                "optimizer": optimizer.state_dict()})
        model.load_state_dict(restored["model"])
        optimizer.load_state_dict(restored["optimizer"])
        again = [float(step(*b)) for b in rest]
        print(f"checkpoint: steps 4-5 {first}, resumed {again}", flush=True)
        if len(rest) != 2 or first != again:
            failures.append(f"the resumed steps differ: {first} vs {again}")

    prof = device_profile(step, *rest[0])
    reference = sum(flagship_profile[key] for key in (
        "k1_fwd_ms_per_call", "k1_bwd_ms_per_call", "other_kernels_ms_per_call"))
    ops_missing = _unnamed([op[0] for op in prof["ops"]], K1_KINDS)
    print(f"device_profile: device_ms {prof['device_ms']:.4f} against phase 9's "
          f"{reference:.4f}, bytes_per_iter {prof['bytes_per_iter']:.0f}, "
          f"{len(prof['ops'])} ops, top {prof['ops'][:3]}, missing {ops_missing}", flush=True)
    if ops_missing:
        failures.append(f"device_profile's ops do not name {ops_missing}")
    if not abs(prof["device_ms"] - reference) <= PROFILE_AGREEMENT * reference:
        failures.append(f"device_profile's {prof['device_ms']} ms is not within "
                        f"{PROFILE_AGREEMENT} of phase 9's {reference} ms")
    if failures:
        raise AssertionError("observability: " + "; ".join(failures))
    return {"resumed_losses": again, "device_profile_ms": prof["device_ms"],
            "phase9_kernel_ms": reference, "device_profile_bytes_per_iter": prof["bytes_per_iter"],
            "device_profile_top_ops": prof["ops"][:4]}


def time_loader_fed(device):
    """The flagship step fed by the loader against the in-memory step on the
    same batches, by CUDA events, TIMED_PASSES of TIMED_BATCHES steps of
    each variant in turns (each sample from just before the batch is asked
    for to the step's end, one synchronize a step), medians over the STEADY
    steps.  Variants that attribute the loader's cost: its native calls on
    one thread each; one worker; the native Hermite call replaced by a sleep
    of its own time (index, pinning and copy stay); the loader with
    device_put=False stepped in lockstep with the in-memory step (its host
    work without pinning, copy or stream order), also with the sleeping
    Hermite call (what stays is the index and the loader's own Python); and
    the in-memory step while a second, unthrottled loader runs on
    background threads and its own stream.  Also the parts of one batch
    (fancy index, native Hermite, pinning, the copy on a side stream) and
    the device-idle share of the loader-fed and in-memory steps by
    torch.profiler, past the pass's start."""
    from torchcde_tpu_torch import native

    x, y = spiral_data(TIMED_BATCHES * BATCH, LENGTH, seed=5)
    base = make_model(device)
    memory = list(_loader(device, x, y, BATCH, interpolation="hermite"))
    torch.cuda.synchronize()

    # One batch's parts on the host, and its copy on a side stream.
    rows = np.random.default_rng(0).permutation(x.shape[0])[:BATCH]
    t = np.arange(LENGTH, dtype=np.float32)
    coeffs_np = native.hermite_coeffs(t, x[rows])
    pinned = torch.from_numpy(coeffs_np).pin_memory()
    side = torch.cuda.Stream(device)

    def copy_ms():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            for _ in range(10):
                pinned.to(device, non_blocking=True)
            end.record(side)
        end.synchronize()
        return start.elapsed_time(end) / 10

    copy_ms()
    parts = {"index_ms": _host_ms(lambda: x[rows]),
             "hermite_native_ms": _host_ms(lambda: native.hermite_coeffs(t, x[rows])),
             "hermite_native_1_thread_ms": _host_ms(
                 lambda: native.hermite_coeffs(t, x[rows], n_threads=1)),
             "pin_ms": _host_ms(lambda: torch.from_numpy(coeffs_np).pin_memory()),
             "pinned_copy_ms": copy_ms(), "coefficient_bytes": coeffs_np.nbytes,
             "native_threads": native._default_threads()}

    def sleeping_hermite(_t, _x, n_threads=None):
        time.sleep(parts["hermite_native_ms"] / 1e3)
        return coeffs_np

    def background(stop):
        with torch.cuda.stream(torch.cuda.Stream(device)):
            while not stop.is_set():
                for _batch in _loader(device, x, y, BATCH, interpolation="hermite"):
                    if stop.is_set():
                        break

    def fed(**kwargs):
        return lambda: iter(_loader(device, x, y, BATCH, interpolation="hermite", **kwargs))

    def host_only():  # the in-memory batches, each after the loader's host-side batch
        host = _loader(device, x, y, BATCH, interpolation="hermite", device_put=False)
        with contextlib.closing(iter(host)) as made:
            for _made, batch in zip(made, memory):
                yield batch

    def sleeps():
        return mock.patch.object(native, "hermite_coeffs", sleeping_hermite)

    # name -> (batches of a pass, what surrounds the pass)
    variants = {
        "loader": (fed(), contextlib.nullcontext),
        "memory": (lambda: (b for b in memory), contextlib.nullcontext),
        "loader_1_native_thread": (
            fed(), lambda: mock.patch.object(native, "_default_threads", lambda: 1)),
        "loader_1_worker": (fed(workers=1), contextlib.nullcontext),
        "loader_native_sleeps": (fed(), sleeps),
        "loader_host_only": (host_only, contextlib.nullcontext),
        "loader_host_only_native_sleeps": (host_only, sleeps),
        "memory_with_loader_behind": (lambda: (b for b in memory), contextlib.nullcontext),
    }
    names = list(variants)
    steps = {name: _adam_step(copy.deepcopy(base))[0] for name in names}

    def run(name, n_steps):
        batches, around = variants[name]
        stop = threading.Event()
        behind = threading.Thread(target=background, args=(stop,))
        if name == "memory_with_loader_behind":
            behind.start()
        samples = []
        try:
            with around(), contextlib.closing(batches()) as source:
                for _ in range(n_steps):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    steps[name](*next(source))
                    end.record()
                    torch.cuda.synchronize()
                    samples.append(start.elapsed_time(end))
        finally:
            stop.set()
            if behind.is_alive():
                behind.join()
        return samples

    for name in names:  # warm-up, dropped
        run(name, STEADY.start)
    passes = {name: [] for name in names}
    for turn in range(TIMED_PASSES):
        for name in (names if turn % 2 == 0 else names[::-1]):
            passes[name].append(run(name, TIMED_BATCHES))
    steady = {name: [v for p in ps for v in p[STEADY]] for name, ps in passes.items()}
    medians = {name: statistics.median(v) for name, v in steady.items()}

    def epochs(loader):
        while True:
            yield from loader

    profiles = {}
    for name, source in (("loader", epochs(_loader(device, x, y, BATCH,
                                                   interpolation="hermite"))),
                         ("memory", epochs(memory))):
        step = _adam_step(copy.deepcopy(base))[0]
        for _ in range(STEADY.start):  # past the pass's start
            step(*next(source))
        profiles[name] = profile_calls(lambda: step(*next(source)), K1_KINDS, PROFILED_CALLS)
        source.close()
    for profile in profiles.values():
        if "device_busy_share" in profile:
            profile["device_idle_share"] = 1.0 - profile["device_busy_share"]
    return {"train_step_ms": medians, "steady_steps": [STEADY.start, STEADY.stop],
            "train_step_pass_samples_ms": passes, "batch_parts": parts, "profiles": profiles}


# --------------------------------------------------------------------------
# Parallelism (phases 34-38): four ranks on the one card, joined by gloo,
# spawned once for phases 34-37 after the parent has built every library
# (the ranks load them from _build/), then one single-rank NCCL group and
# the parallel example.  The ranks time-share the card: their times prove
# the path and are recorded; they are not a scaling result.
# --------------------------------------------------------------------------

PAR_WORLD = 4
PAR_STEPS = 5
PAR_BATCH = 4096        # the data-parallel flagship: 1024 rows a rank
PAR_REV_BATCH = 4096    # config 5's widths at a reduced batch
PAR_TP_BATCH = 1024     # tensor parallelism, data 2 x model 2
PAR_GRAD_BATCH = 1024   # the sequence-sharded masked fit's gradient
PAR_EXAMPLE_BATCH = 128  # the parallel example's global batch (4 steps an epoch)
PAR_LOSS_RTOL = 1e-4
# Phase 36's per-sample solves on the tensor-parallel field: phase 39's
# widths, 64 lanes a data slice, float64 on controls linear in time.
PAR_PS_BATCH = 128
TP_FIELD_RULES = (("linear1.weight", 0), ("linear1.bias", 0), ("linear2.weight", 1))
# The masked fit's gradient through SPIKE against the one-process gradient
# (K6/K7's recomputed plain pipeline), both float32: relative Frobenius at
# the observed positions.
PAR_FIT_GRAD_RTOL = 1e-4


def par_counts():
    """Every launch counter a parallel phase reads, in this process."""
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    counts = {"K1-fwd": k1.FWD_LAUNCHES, "K1-bwd": k1.BWD_LAUNCHES,
              "K8-fwd": k8.FWD_LAUNCHES, "K8-bwd": k8.BWD_LAUNCHES,
              "K9-fwd": k9.FWD_LAUNCHES, "K9-bwd": k9.BWD_LAUNCHES}
    counts.update(fit_counts())
    return counts


def par_reset():
    from torchcde_tpu_torch.parallel import comm
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    k1.reset_launch_counts()
    k8.reset_launch_counts()
    k9.reset_launch_counts()
    reset_fit_counts()
    comm.reset_staged_bytes()


def par_phase(fn):
    """Runs fn() with every counter at 0: (its result, a report of the wall
    ms and CUDA-event ms, the launches and the bytes staged through the
    host)."""
    from torchcde_tpu_torch.parallel import comm

    par_reset()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    report = {"wall_ms": 1e3 * (time.perf_counter() - t0), "event_ms": start.elapsed_time(end),
              "launches": {k: v for k, v in par_counts().items() if v},
              "staged_bytes": comm.STAGED_BYTES}
    return out, report


def _first_step_grads(model, optimizer):
    """Records the gradients the optimizer's first step sees (after the
    data-parallel all-reduce), whole."""
    seen = []

    def hook(_opt, _args, _kwargs):
        if not seen:
            seen.append([_whole(p.grad).detach().clone() for p in model.parameters()])

    optimizer.register_step_pre_hook(hook)
    return seen


def _train_run(device, config, x, y, mesh=None):
    """PAR_STEPS Adam steps from one seed's weights: (losses, the first
    step's gradients)."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import make_train_step
    from torchcde_tpu_torch.parallel import place_params, shard_batch

    model = make_model(device, config=config)
    if mesh is not None:
        place_params(mesh, model)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8, foreach=False)
    grads = _first_step_grads(model, optimizer)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(x).to(device))
    labels = torch.from_numpy(y).to(device)
    if mesh is not None:
        coeffs, labels = shard_batch(mesh, (coeffs, labels))
    step = make_train_step(model, optimizer, mesh=mesh)
    losses = [float(step(coeffs, labels)) for _ in range(PAR_STEPS)]
    return losses, grads[0]


def par_data_parallel(device, mesh, config, batch, kernel, bits=False):
    """Phases 34-35: the data-parallel slice of ``config`` against the
    one-process run of the same steps on the same card."""
    x, y = spiral_data(batch, LENGTH)
    ref_losses, ref_grads = _train_run(device, config, x, y)
    (losses, grads), report = par_phase(lambda: _train_run(device, config, x, y, mesh))
    grad_err = _rel_frobenius(grads, [g.double() for g in ref_grads])
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    report.update(losses=losses, loss_rel_err=loss_err, grad_rel_frobenius=grad_err)
    want = {f"{kernel}-fwd": PAR_STEPS, f"{kernel}-bwd": PAR_STEPS}
    got = {k: report["launches"].get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"a rank did not launch {kernel} once per step: {report['launches']}")
    if bits:
        same = losses == ref_losses and all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
        report["same_bits"] = same
        if not same:
            raise AssertionError("the single-rank group's step is not the one-process step, "
                                 f"bit for bit: {report}")
    elif grad_err > BWD_RTOL or loss_err > PAR_LOSS_RTOL or not all(map(math.isfinite, losses)):
        raise AssertionError(f"the data-parallel step disagrees with one process: {report}")
    return report


def _plain_step_grads(model, coeffs, labels):
    """The model's logits and the loss's gradients.  For a float64 model the
    solve is the plain path on the card: K1 takes float32."""
    from torchcde_tpu_torch.models.neural_cde import bce_with_logits

    logits = model(coeffs)
    loss = bce_with_logits(logits[..., 0], labels)
    return logits.detach(), torch.autograd.grad(loss, list(model.parameters()))


def _tp_report(name, report):
    """Prints a tensor-parallel case's wall ms on this rank; fails if K1 or
    K9 launched for the sharded field."""
    rank = torch.distributed.get_rank()
    print(f"chip_smoke: rank {rank}: phase 36 {name}: {report['wall_ms']:.1f} ms wall, "
          f"{report['event_ms']:.1f} ms events", flush=True)
    if any(report["launches"].get(k, 0) for k in ("K1-fwd", "K1-bwd", "K9-fwd", "K9-bwd")):
        raise AssertionError(f"a kernel launched for a sharded field ({name}): {report}")


def par_tensor_parallel(device, mesh):
    """Phase 36: data 2 x model 2 at the flagship's widths.  The sharded
    field declines K1 (no launch) and solves on the plain path, its layers
    as DTensor ops, directly and (config ``adjoint=True``) by the rk4
    backsolve, whose parameter cotangents ride the augmented state whole on
    every rank (``comm.whole`` over gloo); each held against the
    one-process plain solve of the same kind in float64 on the card
    (float32 and float64 runs: logits within FWD_RTOL, gradients within
    BWD_RTOL).  Then the per-sample cases (``par_tp_per_sample``)."""
    out = {}
    for adjoint in (False, True):
        out.update(_tp_flagship(device, mesh, adjoint))
    out.update(par_tp_per_sample(device, mesh))
    return out


def _tp_flagship(device, mesh, adjoint):
    """The flagship's tensor-parallel step, float32 and float64, against the
    one-process float64 step.  With ``adjoint`` (the rk4 backsolve) float64
    only: a float32 backsolve rebuilds z backwards with its float32 rounding
    amplified (1e-5 of z after 99 steps in a CPU rehearsal at B 128), so a
    ReLU that switches on one rank's path and not on another's moves a
    lane's cotangent, by 2.5e-4 of the whole in that rehearsal, past
    BWD_RTOL, whichever of two float32 runs is held against the other."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models.neural_cde import bce_with_logits
    from torchcde_tpu_torch.models.training import _average_over_data
    from torchcde_tpu_torch.parallel import place_params, shard_batch
    from torchcde_tpu_torch.solvers import disable_fused_dispatch

    config = dict(FLAGSHIP, adjoint=adjoint)
    x, y = spiral_data(PAR_TP_BATCH, LENGTH)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(x).to(device))
    labels = torch.from_numpy(y).to(device)
    ref = make_model(device, config=config).double()
    with disable_fused_dispatch():  # the plain path, the backsolve under adjoint=True
        ref_logits, ref_grads = _plain_step_grads(ref, coeffs.double(), labels.double())
    rows = shard_batch(mesh, torch.arange(PAR_TP_BATCH, device=device))
    out = {}
    for dtype in (torch.float64,) if adjoint else (torch.float32, torch.float64):
        def run():
            model = make_model(device, config=config).to(dtype)
            place_params(mesh, model)
            c, lab = shard_batch(mesh, (coeffs.to(dtype), labels.to(dtype)))
            logits = model(c)
            loss = bce_with_logits(logits[..., 0], lab)
            loss.backward()
            _average_over_data(model, loss.detach(), mesh)
            return logits.detach(), [_whole(p.grad) for p in model.parameters()]

        (logits, grads), report = par_phase(run)
        err, scale = _err(logits.double(), ref_logits[rows])
        report.update(logits_max_abs_err=err, logits_scale=scale,
                      grad_rel_frobenius=_rel_frobenius(grads, ref_grads))
        name = ("backsolve_" if adjoint else "") + str(dtype).replace("torch.", "")
        _tp_report(name, report)
        out[name] = report
    if any(r["logits_max_abs_err"] > FWD_RTOL * max(r["logits_scale"], 1.0)
           or r["grad_rel_frobenius"] > BWD_RTOL for r in out.values()):
        raise AssertionError(f"tensor parallelism disagrees with the plain solve: {out}")
    return out


def par_tp_per_sample(device, mesh):
    """Phase 36's per-sample cases: dopri5 with options={'per_sample': True}
    on an MLP field whose weights are sharded over ``model`` (the flagship's
    rules), at phase 39's widths on controls linear in time, in float64:
    the values at length PS39_CUT, and the weights' gradients at
    PS39_GRAD_LENGTH with adjoint=False and adjoint=True (the per-lane
    backsolve).  Each is held against the one-process solve of every lane
    with the weights plain and the fused routes off (``disable_fused_dispatch``)
    at FWD_RTOL / BWD_RTOL; K9 declines the sharded field (no launch)."""
    import torchcde_tpu_torch as tt
    from torch.distributed.tensor import Shard
    from torchcde_tpu_torch.parallel import comm, place_params, shard_batch
    from torchcde_tpu_torch.solvers import disable_fused_dispatch

    _, field, z0 = per_sample_problem(device, shape=(PAR_PS_BATCH, 2, PS_HIDDEN, 3, PS_WIDTH))
    field, z0 = field.double(), z0.double()
    proj = torch.randn(PAR_PS_BATCH, PS_HIDDEN, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(6)).to(device)
    rows = shard_batch(mesh, torch.arange(PAR_PS_BATCH, device=device))

    def solve(f, X, z, adjoint, p):
        out = tt.cdeint(X, f, z, X.interval, adjoint=adjoint, method="dopri5",
                        options=dict(per_sample=True), **PS39_GRAD_TOL)
        if p is None:
            return out.detach()
        loss = (out[..., -1, :] * p).sum()
        return torch.autograd.grad(loss, [w for w in f.parameters()])

    out = {}
    for name, length, adjoint in (("per_sample_values", PS39_CUT, False),
                                  ("per_sample_gradient_direct", PS39_GRAD_LENGTH, False),
                                  ("per_sample_gradient_adjoint", PS39_GRAD_LENGTH, True)):
        X = smooth_control(device, PAR_PS_BATCH, length)
        values = name == "per_sample_values"
        with disable_fused_dispatch(), torch.set_grad_enabled(not values):
            ref = solve(field, X, z0, adjoint, None if values else proj)
        tp_field = copy.deepcopy(field)
        place_params(mesh, tp_field, [(n, Shard(d)) for n, d in TP_FIELD_RULES])
        Xr = tt.CubicSpline(torch.cat([X._a, X._b, X._two_c, X._three_d], -1)[rows])

        def run():
            with torch.set_grad_enabled(not values):
                got = solve(tp_field, Xr, z0[rows], adjoint, None if values else proj[rows])
            if values:
                return got
            return [comm.psum(comm.whole(g), mesh, "data") for g in got]

        got, report = par_phase(run)
        if values:
            err, scale = _err(got, ref[rows])
            report.update(max_abs_err=err, scale=scale, lanes=int(got.shape[0]))
            bad = not err <= FWD_RTOL * max(scale, 1.0)
        else:
            report["grad_rel_frobenius"] = _rel_frobenius(got, ref)
            bad = not report["grad_rel_frobenius"] <= BWD_RTOL
        _tp_report(name, report)
        if bad:
            raise AssertionError(f"a per-sample solve on the tensor-parallel field disagrees "
                                 f"with one process ({name}): {report}")
        out[name] = report
    return out


def _whole(t):
    from torchcde_tpu_torch.parallel import comm

    return comm.whole(t)


def _dense_system(dense):
    """Config 3's dense natural-spline system on uniform knots: shared bands
    (hr 1), right-hand sides per row (as interpolation/cubic.py builds it)."""
    xT = dense.transpose(-1, -2)[..., 0, :]
    k = xT.shape[-1]
    hr = torch.ones(k - 1, dtype=xT.dtype, device=xT.device)
    zero = torch.zeros(1, dtype=xT.dtype, device=xT.device)
    diag = 2 * (torch.cat([zero, hr]) + torch.cat([hr, zero]))
    pds = 3 * (xT[..., 1:] - xT[..., :-1])
    zcol = torch.zeros_like(xT[..., :1])
    rhs = torch.cat([pds, zcol], -1) + torch.cat([zcol, pds], -1)
    return rhs, hr, diag, hr


def par_sequence(device, mesh):
    """Phase 37: config 3's fits with the length over 4 ranks (1024
    positions each): the masked fit (K3 and K5 on each shard) against the
    one-process masked fit (K6/K7), the dense system by SPIKE (K4 on each
    shard) and by distributed PCR against K4 on the whole rows, and the
    masked fit's gradient at a reduced batch against the one-process one."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.ops import tridiagonal_kernel
    from torchcde_tpu_torch.ops.tridiagonal import tridiagonal_solve
    from torchcde_tpu_torch.parallel import (comm, natural_cubic_coeffs_seq_sharded,
                                             tridiagonal_solve_seq_sharded)

    me = comm.axis_index(mesh, "model")
    x_np, dense_np = config3_data()
    x = torch.from_numpy(x_np).to(device)
    k_loc = FIT_LENGTH // PAR_WORLD
    out = {}

    ref = tt.natural_cubic_coeffs(x)
    got, report = par_phase(lambda: natural_cubic_coeffs_seq_sharded(x, None, mesh).to_local())
    lo, hi = me * k_loc, min((me + 1) * k_loc, FIT_LENGTH - 1)
    err, scale = _err(got.double(), ref[:, lo:hi].double())
    report.update(max_abs_err=err, scale=scale, local_rows=got.shape[-2])
    if got.shape[-2] != hi - lo or err > FWD_RTOL * max(scale, 1.0) or got.device != device:
        raise AssertionError(f"the sequence-sharded masked fit disagrees: {report}")
    if report["launches"].get("K5") != 1 or not report["launches"].get("K3"):
        raise AssertionError(f"the masked fit's shard did not run K3 and K5: {report}")
    out["masked_fit"] = report
    del ref, got

    system = _dense_system(torch.from_numpy(dense_np).to(device))
    ref = tridiagonal_solve(*system, method="auto")
    for method in ("spike", "pcr"):
        got, report = par_phase(lambda: tridiagonal_solve_seq_sharded(
            *system, mesh, method=method).to_local())
        err, scale = _err(got.double(), ref[:, me * k_loc:(me + 1) * k_loc].double())
        report.update(max_abs_err=err, scale=scale)
        if err > FWD_RTOL * max(scale, 1.0) or got.device != device:
            raise AssertionError(f"the sequence-sharded dense solve ({method}) disagrees: {report}")
        if method == "spike":
            report["k4_route"] = tridiagonal_kernel.solve_plan(k_loc, shared=False).variant
            if report["launches"].get("K4") != 1:
                raise AssertionError(f"SPIKE's shard did not run K4 once: {report}")
        out[f"dense_{method}"] = report
    del ref, system

    xg = x[:PAR_GRAD_BATCH].clone()
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (PAR_GRAD_BATCH, FIT_LENGTH - 1, 4)).astype(np.float32)).to(device)
    x1 = xg.clone().requires_grad_()
    (g_ref,) = torch.autograd.grad(torch.sum(tt.natural_cubic_coeffs(x1) * w), x1)

    def sharded_grad():
        x2 = xg.clone().requires_grad_()
        local = natural_cubic_coeffs_seq_sharded(x2, None, mesh).to_local()
        return torch.autograd.grad(torch.sum(local * w[:, lo:hi]), x2)[0]

    g, report = par_phase(sharded_grad)
    observed = ~torch.isnan(xg)
    report["grad_rel_frobenius"] = _rel_frobenius([g[observed]], [g_ref[observed].double()])
    if report["grad_rel_frobenius"] > PAR_FIT_GRAD_RTOL or g.device != device:
        raise AssertionError(f"the sequence-sharded masked fit's gradient disagrees: {report}")
    out["masked_fit_gradient"] = report
    return out


def _rank_device(rank, device_type):
    """Rank r computes on cuda:(r mod the number of cards): here all four
    share the one card.  (``device_type="cpu"`` rehearses on the CPU.)"""
    if device_type != "cuda":
        return torch.device(device_type)
    device = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def par_rank(rank, world, smi, device_type="cuda"):
    """Phases 34-37 on one of the four gloo ranks (all on the one card)."""
    from torchcde_tpu_torch.parallel import make_mesh

    device = _rank_device(rank, device_type)
    start = time.perf_counter()

    def progress(phase):
        print(f"chip_smoke: rank {rank}: phase {phase} at "
              f"{time.perf_counter() - start:.1f} s in the rank", flush=True)

    dp = make_mesh(data=PAR_WORLD, model=1, device=device_type)
    report = {"card": smi}
    progress("34")
    report["dp_flagship"] = par_data_parallel(device, dp, FLAGSHIP, PAR_BATCH, "K1")
    progress("35")
    for adjoint in (False, True):
        report[f"dp_config5_adjoint={adjoint}"] = par_data_parallel(
            device, dp, dict(CONFIG5, adjoint=adjoint), PAR_REV_BATCH, "K8")
    progress("36")
    report["tensor_parallel"] = par_tensor_parallel(
        device, make_mesh(data=2, model=2, device=device_type))
    progress("37")
    report["sequence"] = par_sequence(
        device, make_mesh(data=1, model=PAR_WORLD, device=device_type))
    progress("37 done")
    return report


def par_nccl_rank(rank, world, smi, device_type="cuda"):
    """Phase 38: one rank in an NCCL group, a (1, 1) mesh: the flagship's
    data-parallel step bit for bit the one-process step, and both sequence-
    sharded fits through their one-shard shortcuts, bit for bit the
    single-device calls."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.ops.tridiagonal import tridiagonal_solve
    from torchcde_tpu_torch.parallel import (make_mesh, natural_cubic_coeffs_seq_sharded,
                                             tridiagonal_solve_seq_sharded)

    device = _rank_device(rank, device_type)
    mesh = make_mesh(data=1, model=1, device=device_type)
    report = {"card": smi, "backend": torch.distributed.get_backend()}
    report["dp_flagship"] = par_data_parallel(device, mesh, FLAGSHIP, PAR_BATCH, "K1", bits=True)
    x_np, dense_np = config3_data()
    x = torch.from_numpy(x_np).to(device)
    got, r = par_phase(lambda: natural_cubic_coeffs_seq_sharded(x, None, mesh).to_local())
    r["same_bits"] = bool(torch.equal(got, tt.natural_cubic_coeffs(x)))
    report["masked_fit_one_shard"] = r
    system = _dense_system(torch.from_numpy(dense_np).to(device))
    got, r = par_phase(lambda: tridiagonal_solve_seq_sharded(*system, mesh).to_local())
    r["same_bits"] = bool(torch.equal(got, tridiagonal_solve(*system, method="auto")))
    report["dense_one_shard"] = r
    if not (report["masked_fit_one_shard"]["same_bits"] and report["dense_one_shard"]["same_bits"]):
        raise AssertionError(f"a one-shard shortcut is not the single-device call: {report}")
    if r["launches"].get("K4") != 1:
        raise AssertionError(f"the one-shard dense solve did not run K4 once: {r}")
    return report


def parallel_example():
    """The example examples/torch_parallel_training.py for one epoch on the
    card, four gloo ranks: a finite loss.  Its tensor-parallel field solves
    on the plain path, about 2.5 s a step here: PAR_EXAMPLE_BATCH makes the
    epoch 4 steps (its default, 32, 16)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import torch_parallel_training as example

    losses, ms = _timed(lambda: example.main(num_epochs=1, batch_size=PAR_EXAMPLE_BATCH,
                                             world_size=PAR_WORLD, backend="gloo",
                                             device="cuda"))
    print(f"parallel example: losses {losses.tolist()}, {ms:.1f} ms", flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"the parallel example's loss is not finite: {losses}")
    return {"losses": losses.tolist(), "wall_ms": ms}


def par_kernel_launches(rank_report):
    """{kernel: {phase: launches}} from one rank's report of phases 34-37."""
    phases = {"dp_flagship": rank_report["dp_flagship"]}
    for key in ("dp_config5_adjoint=False", "dp_config5_adjoint=True"):
        phases[key] = rank_report[key]
    for case, r in rank_report["tensor_parallel"].items():
        phases[f"tensor_parallel_{case}"] = r
    for key, r in rank_report["sequence"].items():
        phases[f"sequence_{key}"] = r
    out = {}
    for phase, r in phases.items():
        for kernel, count in r["launches"].items():
            out.setdefault(kernel, {})[phase] = count
    return out


def parallel_phases(smi):
    """Phases 34-38 from the parent: the libraries are built; the ranks'
    failures raise here (run_ranks), so the script exits non-zero."""
    from torchcde_tpu_torch.parallel.launch import run_ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gloo, ms = _timed(lambda: run_ranks(par_rank, PAR_WORLD, backend="gloo", args=(smi,),
                                        timeout=600))
    for rank, r in enumerate(gloo):
        print("parallel: " + json.dumps({"rank": rank, **r}), flush=True)
    elapsed("38")
    nccl, nccl_ms = _timed(lambda: run_ranks(par_nccl_rank, 1, backend="nccl", args=(smi,),
                                             timeout=600))
    print("parallel: " + json.dumps({"nccl_single_rank": nccl[0]}), flush=True)
    example = parallel_example()
    return {"gloo_ranks_wall_ms": ms, "nccl_wall_ms": nccl_ms, "ranks": gloo,
            "nccl": nccl[0], "example": example}


# --------------------------------------------------------------------------
# Phase 39: per-sample solves outside K9, every lane in one lockstep solve
# (solvers/per_sample.py; plain PyTorch ops on the card, no kernel).
# --------------------------------------------------------------------------

# The full-shape solves: bench_per_sample's problem through each path, with
# a budget that completes every lane (bench_per_sample's lanes need up to
# 7642 attempts each at rtol 1e-4, run_benchmarks.py:706-711, past the
# default 4096).  dopri5 runs at rtol 1e-5: at the benchmark's 1e-4 its
# global error over the 1023 rough intervals is 4.6-6.2 % of the largest
# magnitude (measured on an H100), at the edge of SURFACE_ADAPTIVE_RTOL; bosh3's
# is 0.7 % at 1e-4.
PS39_FULL_TOL = {"dopri5": dict(rtol=1e-5, atol=1e-7, max_steps=32768),
                 "bosh3": dict(rtol=1e-4, atol=1e-6, max_steps=65536)}
# The other methods at a cut length, each at a tolerance that keeps its
# global error within SURFACE_ADAPTIVE_RTOL (fehlberg2's first-order
# solution is 16 % off at rtol 1e-4 and length 128).
PS39_CUT = 128
PS39_CUT_TOL = {"dopri8": dict(rtol=1e-4, atol=1e-6, max_steps=16384),
                "adaptive_heun": dict(rtol=1e-4, atol=1e-6),
                "fehlberg2": dict(rtol=1e-6, atol=1e-8)}
# The gradients' length and tolerance: at rtol 1e-4 the direct gradient of
# the realised mesh is 11 % (the CPU) to 25 % (an H100) from the converged
# gradient on these rough controls, at rtol 1e-6 0.3 % (the CPU).
PS39_GRAD_LENGTH = 8
PS39_GRAD_TOL = dict(rtol=1e-6, atol=1e-8)
PS39_LANES = 8
PS39_JUMP_EVERY = 64
# The lane loop's other drivers (jumps, and the restart of a stepper without
# a dense step) on fewer lanes, with a jump at every 16th knot of the cut.
PS39_LANES_MORE, PS39_LOOP_JUMP_EVERY = 4, 16
# The smooth control's slope a knot, in bench_per_sample's scale: gentle
# enough that the MLP's solve over 128 knots amplifies a rounding difference
# of its products by little.
PS39_SMOOTH_SLOPE = 0.125
# The float64 lanes against the same lanes solved one at a time by the
# general integrator.
PS39_EXACT = 1e-12
# The references, each at tighter tolerances: the MLP's solves by K9 (code
# that per_sample.py does not run; float32), the t-reading field's by the
# lockstep solve in float64 (the whole batch under one controller through
# integrate.odeint took 63 s and 28 s at length 1024 on the card), the
# gradient by direct backpropagation of the whole batch under one
# controller through integrate.odeint in float64.
# K9 at its own budget of 2048 attempts a lane and chunk of 128 intervals:
# at rtol 1e-6 the hardest lane needs ~2 300 a chunk (18 514 over 1023
# intervals in float64 on an H100), at 5e-6 ~1 700.
PS39_REF_K9 = dict(rtol=5e-6, atol=5e-8)
PS39_REF = dict(method="dopri5", rtol=1e-7, atol=1e-9, max_steps=1 << 17)
PS39_REF_FULL = dict(method="dopri5", rtol=1e-6, atol=1e-8, max_steps=1 << 17)
# The batch sizes at which the lanes' right-hand side is compared, bit for
# bit, with the same rows in a batch of 64 (per_sample._MIN_LANES).
PS39_PROBE_BATCHES = (1, 2, 16, 17, 32, 63, 64, 65, 128, 256, 512, 1024, 4096)


def _t_field(W):
    """A vector field that reads its time (the JAX contract: called
    unbatched for each lane)."""
    def field(s, z):
        return torch.tanh(z)[..., None] * W * torch.cos(0.01 * torch.as_tensor(s))
    return field


def _cut(X, length):
    """The spline X over its first ``length`` knots."""
    import torchcde_tpu_torch as tt

    return tt.CubicSpline(torch.cat([X._a, X._b, X._two_c, X._three_d], -1)[:, :length - 1])


def _lane_loop(X, field, z0, lanes, t=None, jump_t=None, **kwargs):
    """The first ``lanes`` lanes one at a time, as the port solved a
    per-sample batch before the lockstep solve: each lane's own control rows
    and integrate.odeint (with ``jump_t``), with its statistics.  Returns (out (lanes, n, H),
    [stats], wall ms)."""
    from torchcde_tpu_torch.solvers.integrate import SolverConfig, odeint
    from torchcde_tpu_torch.solvers.terms import make_cde_rhs

    cfg = SolverConfig(step_size=None, **kwargs)

    def run():
        outs, stats = [], []
        for i in range(lanes):
            Xi = copy.copy(X)
            for name, v in vars(X).items():
                if isinstance(v, torch.Tensor) and v.ndim >= 3:
                    setattr(Xi, name, v[i])
            out, lane_stats = odeint(make_cde_rhs(field, Xi), z0[i],
                                     X.interval if t is None else t, cfg, jump_t,
                                     collect_stats=True)
            outs.append(out)
            stats.append(lane_stats)
        return torch.stack(outs), stats

    with torch.no_grad():
        (out, stats), ms = _timed(run)
    return out, stats, ms


def lane_invariance_probe(X, field, z0):
    """{dtype: {batch: whether the rows of the lanes' right-hand side, vmapped
    over the lanes as the lockstep solve evaluates it, have the same bits as
    the same rows in a batch of 64}} at bench_per_sample's widths, the rows
    tiled from X's."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers.per_sample import LaneField, _Lanes

    top = max(PS39_PROBE_BATCHES)
    reps = -(-top // X._a.shape[0])
    coeffs = torch.cat([X._a, X._b, X._two_c, X._three_d], -1).repeat(reps, 1, 1)[:top]
    z = z0.repeat(reps, 1)[:top]
    found = {}
    for dtype in (torch.float32, torch.float64):
        f = copy.deepcopy(field).to(dtype)
        rows = {}
        with torch.no_grad():
            for B in PS39_PROBE_BATCHES:
                Xb = tt.CubicSpline(coeffs[:B].to(dtype))
                t = torch.full((B,), 300.37, dtype=dtype, device=z.device)
                rows[B] = LaneField(f, _Lanes(Xb, B, z.device))(t, z[:B].to(dtype))
        found[str(dtype).replace("torch.", "")] = {
            B: bool(torch.equal(rows[B][:min(B, 64)], rows[64][:min(B, 64)]))
            for B in PS39_PROBE_BATCHES}
    return found


def smooth_control(device, batch, length, seed=1):
    """A float64 spline at bench_per_sample's magnitudes on paths linear in
    time: each lane's channels move by a fixed slope, PS39_SMOOTH_SLOPE of
    bench_per_sample's scale a knot at most times a standard normal."""
    import torchcde_tpu_torch as tt

    rng = np.random.default_rng(seed)
    spread = (0.06 * 10.0 ** np.linspace(-0.5, 0.5, batch))[:, None, None]
    start, slope = (rng.standard_normal((batch, 1, 3)) for _ in range(2))
    x = spread * (start + PS39_SMOOTH_SLOPE * slope * np.arange(length)[None, :, None])
    return tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(x).to(device)))


def _double(X, field, z0):
    import torchcde_tpu_torch as tt

    coeffs = torch.cat([X._a, X._b, X._two_c, X._three_d], -1).double()
    return tt.CubicSpline(coeffs), copy.deepcopy(field).double(), z0.double()


def _lockstep_solve(label, X, field, z0, report, t=None, **kwargs):
    """One per-sample solve with its statistics, timed by the host's clock
    and by CUDA events, with its host reads and lockstep iterations."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers import per_sample

    per_sample.reset_counts()
    options = dict(per_sample=True, **kwargs.pop("options", {}))
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        torch.cuda.synchronize()
        start = time.perf_counter()
        begin.record()
        out, stats = tt.cdeint(X, field, z0, X.interval if t is None else t, adjoint=False,
                               return_stats=True, options=options, **kwargs)
        end.record()
        torch.cuda.synchronize()
    nfe = stats["nfe"].double()
    report[label] = dict(
        wall_ms=1e3 * (time.perf_counter() - start), event_ms=begin.elapsed_time(end),
        host_reads=per_sample.HOST_READS, iterations=per_sample.ITERATIONS,
        nfe_min=int(nfe.min()), nfe_mean=float(nfe.mean()), nfe_max=int(nfe.max()),
        lanes=int(out.shape[0]), finite_lanes=int(torch.isfinite(out).all(dim=(1, 2)).sum()))
    return out, stats


def per_sample_lockstep_phase(device):
    """Phase 39: options={'per_sample': True} where K9 declines, through the
    public cdeint on the card: bench_per_sample's problem at its full shape
    with return_stats (dopri5 through an MLPVectorField and through a field
    that reads t, bosh3, dopri5 with a jump at every 64th knot), dopri8,
    adaptive_heun and fehlberg2 at a cut length, one direct and one adjoint
    gradient, each held against a reference at tighter tolerances (K9, a
    float64 lockstep solve, a float64 whole-batch gradient), and the first
    lanes in float64 against each lane solved alone by integrate.odeint.
    K1, K2, K8 and K9 launch zero times on the lockstep solves."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers import per_sample

    start = time.perf_counter()
    failures, report = [], {}

    def hold(label, key, err, limit):
        report[label][key] = err
        if not err <= limit:
            failures.append(f"{label} {key}: {err:.3e} > {limit:.1e}")

    def rel_err(out, ref):
        err, scale = _err(out.double(), ref)
        return err / scale

    def reference(label, X, field, z0, tol):
        out, _ = _lockstep_solve(label, X, field, z0, report, **tol)
        print(f"per-sample lockstep {label}: {json.dumps(report.pop(label))}", flush=True)
        return out

    def kernel_reference(label, X):
        """The MLP's solve by K9, declining nothing (dopri5, no stats)."""
        reset_fused_launches()
        with torch.no_grad():
            out, ms = _timed(lambda: tt.cdeint(X, field, z0, X.interval, adjoint=False,
                                               options=dict(per_sample=True), **PS39_REF_K9))
        launches = fused_launches()["K9"][0]
        print(f"per-sample lockstep {label} by K9 (float32, rtol {PS39_REF_K9['rtol']}): "
              f"{ms:.1f} ms, {launches} launches, finite {bool(torch.isfinite(out).all())}",
              flush=True)
        if not launches or not torch.isfinite(out).all():
            failures.append(f"{label}: K9 declined or is not finite ({launches} launches)")
        return out.double()

    def show(label):
        print(f"per-sample lockstep {label}: {json.dumps(report[label])}", flush=True)

    X, field, z0 = per_sample_problem(device)
    W = (0.3 * torch.randn(PS_HIDDEN, 3, generator=torch.Generator().manual_seed(5))).to(device)
    t_field = _t_field(W)
    X64, field64, z064 = _double(X, field, z0)
    t_field64 = _t_field(W.double())
    Xc, Xc64 = _cut(X, PS39_CUT), _cut(X64, PS39_CUT)
    refs = {"MLP": kernel_reference(f"reference MLP B{PS_BATCH} L{PS_LENGTH}", X)}
    ref_cut = kernel_reference(f"reference MLP B{PS_BATCH} L{PS39_CUT}", Xc)
    reset_fused_launches()
    refs["t-reading"] = reference(f"float64 reference t-reading B{PS_BATCH} L{PS_LENGTH}", X64,
                                  t_field64, z064, PS39_REF_FULL)
    jumps = X.grid_points[PS39_JUMP_EVERY:-1:PS39_JUMP_EVERY]
    full = (("dopri5 MLP", field, "MLP", {}),
            ("dopri5 t-reading field", t_field, "t-reading", {}),
            ("bosh3 MLP", field, "MLP", dict(method="bosh3")),
            (f"dopri5 MLP jump every {PS39_JUMP_EVERY}th knot", field, "MLP",
             dict(options=dict(jump_t=jumps))))
    for label, f, ref, kwargs in full:
        method = kwargs.setdefault("method", "dopri5")
        label = f"{label} B{PS_BATCH} L{PS_LENGTH} rtol {PS39_FULL_TOL[method]['rtol']}"
        out, _ = _lockstep_solve(label, X, f, z0, report, **kwargs, **PS39_FULL_TOL[method])
        hold(label, "err", rel_err(out, refs[ref]), SURFACE_ADAPTIVE_RTOL)
        if report[label]["finite_lanes"] != PS_BATCH or out.shape != (PS_BATCH, 2, PS_HIDDEN):
            failures.append(f"{label}: shape {tuple(out.shape)}, "
                            f"{report[label]['finite_lanes']} finite lanes")
        show(label)

    print(f"per-sample lockstep: the other methods at length {PS39_CUT} "
          f"(cut from {PS_LENGTH})", flush=True)
    for method, tol in PS39_CUT_TOL.items():
        label = f"{method} MLP B{PS_BATCH} L{PS39_CUT} rtol {tol['rtol']}"
        out, _ = _lockstep_solve(label, Xc, field, z0, report, method=method, **tol)
        hold(label, "err", rel_err(out, ref_cut), SURFACE_ADAPTIVE_RTOL)
        if report[label]["finite_lanes"] != PS_BATCH:
            failures.append(f"{label}: {report[label]['finite_lanes']} finite lanes")
        show(label)

    # One direct and one adjoint gradient (z0 and W) of the field that
    # reads t, against direct backpropagation of a tight float64 solve of the
    # whole batch under one controller.
    proj = torch.randn(PS_BATCH, PS_HIDDEN, generator=torch.Generator().manual_seed(6))
    proj = proj.to(device)

    def grads(Xg, Wg, zg, lockstep=True, **kwargs):
        Wg, zg = Wg.detach().requires_grad_(), zg.detach().requires_grad_()
        out = tt.cdeint(Xg, _t_field(Wg), zg, Xg.interval,
                        options=dict(per_sample=True) if lockstep else {}, **kwargs)
        loss = (out[..., -1, :] * proj.to(out.dtype)).sum()
        return torch.autograd.grad(loss, [zg, Wg])

    Xg, Xg64 = _cut(X, PS39_GRAD_LENGTH), _cut(X64, PS39_GRAD_LENGTH)
    (grad_ref, ref_ms) = _timed(lambda: grads(Xg64, W.double(), z064, lockstep=False,
                                             adjoint=False, **PS39_REF))
    print(f"per-sample lockstep: float64 reference gradient L{PS39_GRAD_LENGTH}, direct "
          f"through the whole batch under one controller, {ref_ms:.1f} ms", flush=True)
    for adjoint in (False, True):
        label = (f"gradient adjoint={adjoint} B{PS_BATCH} L{PS39_GRAD_LENGTH} "
                 f"rtol {PS39_GRAD_TOL['rtol']}")
        per_sample.reset_counts()
        g, ms = _timed(lambda: grads(Xg, W, z0, adjoint=adjoint, **PS39_GRAD_TOL))
        report[label] = dict(wall_ms=ms, iterations=per_sample.ITERATIONS)
        hold(label, "rel_frobenius", _rel_frobenius(g, grad_ref),
             SURFACE_BACKSOLVE_RTOL if adjoint else SURFACE_ADAPTIVE_RTOL)
        show(label)

    # The first lanes in float64, in the lockstep batch and each alone through
    # integrate.odeint, the code that solved a per-sample batch before the
    # lockstep solve, through each driver of the lockstep: the same
    # statistics and values, on controls linear in time (on bench_per_sample's
    # rough controls one ulp of a product, which a lane alone rounds
    # otherwise, moves the mesh: ROADMAP §3), output at every knot.
    Xs = smooth_control(device, PS_BATCH, PS39_CUT)
    ts = Xs.grid_points
    cases = (("MLP", field64, {}, PS39_LANES), ("t-reading", t_field64, {}, PS39_LANES),
             (f"MLP jump every {PS39_LOOP_JUMP_EVERY}th knot", field64,
              dict(jump_t=ts[PS39_LOOP_JUMP_EVERY:-1:PS39_LOOP_JUMP_EVERY]), PS39_LANES_MORE),
             ("MLP dopri8", field64, dict(method="dopri8"), PS39_LANES_MORE))
    for name, f64, kwargs, lanes in cases:
        label = f"float64 {name} B{PS_BATCH} L{PS39_CUT} linear in time, {PS39_CUT} outputs"
        jump_t = kwargs.pop("jump_t", None)
        options = {} if jump_t is None else dict(options=dict(jump_t=jump_t))
        out, stats = _lockstep_solve(label, Xs, f64, z064, report, t=ts, max_steps=8192,
                                     **kwargs, **options)
        loop, loop_stats, loop_ms = _lane_loop(Xs, f64, z064, lanes, ts, jump_t,
                                               max_steps=8192, **kwargs)
        err, scale = _err(out[:lanes], loop)
        same = all(int(lane_stats[k]) == int(stats[k][i])
                   for i, lane_stats in enumerate(loop_stats) for k in stats)
        report[label].update(lane_loop_max_abs_err=err, lane_loop_largest_value=scale,
                             lane_loop_same_stats=same, lane_loop_lanes=lanes,
                             lane_loop_wall_ms=loop_ms)
        hold(label, "lane_loop_rel_err", err / scale, PS39_EXACT)
        if not same:
            failures.append(f"{label}: a lane took other steps than integrate.odeint takes "
                            "on it alone")
        show(label)

    # On bench_per_sample's controls: the MLP's lanes alone through
    # integrate.odeint (the same problem at the same tolerance, on another
    # mesh), and their time, scaled to the batch, as the witness of that loop
    # over the lanes (extrapolated, not run); the t-reading field's replayed
    # CUDA graphs against the eager iterations of the same lockstep solve,
    # which a solve takes with autograd on (this field has no product whose
    # kernel the capture could change).
    label = f"float64 MLP B{PS_BATCH} L{PS39_CUT}"
    out, _ = _lockstep_solve(label, Xc64, field64, z064, report, max_steps=8192)
    loop, _, loop_ms = _lane_loop(Xc64, field64, z064, PS39_LANES, max_steps=8192)
    report[label].update(lane_loop_lanes=PS39_LANES, lane_loop_wall_ms=loop_ms,
                         extrapolated_lane_loop_wall_ms=loop_ms * PS_BATCH / PS39_LANES)
    hold(label, "lane_loop_rel_err", rel_err(out[:PS39_LANES], loop.double()),
         SURFACE_ADAPTIVE_RTOL)
    show(label)
    label = f"float64 t-reading B{PS_BATCH} L{PS39_CUT}"
    out, stats = _lockstep_solve(label, Xc64, t_field64, z064, report, max_steps=8192)
    with torch.enable_grad():
        (eager, eager_stats), ms = _timed(lambda: tt.cdeint(
            Xc64, t_field64, z064, Xc64.interval, adjoint=False, return_stats=True,
            max_steps=8192, options=dict(per_sample=True)))
    report[label]["eager_wall_ms"] = ms
    hold(label, "eager_max_abs_err", float((eager - out).abs().max()), PS39_EXACT)
    if not all(torch.equal(eager_stats[k], stats[k]) for k in stats):
        failures.append(f"{label}: the eager iterations took other steps")
    show(label)

    report["lane_rows_equal_to_64_lanes"] = lane_invariance_probe(X, field, z0)
    print("per-sample lockstep: the lanes' right-hand side, rows bit for bit those of a "
          f"batch of 64, by batch size: {json.dumps(report['lane_rows_equal_to_64_lanes'])}",
          flush=True)
    launches = fused_launches()
    report["fused_launches"] = launches
    report["phase_wall_s"] = time.perf_counter() - start
    print(f"per-sample lockstep: fused kernel launches {launches}, phase "
          f"{report['phase_wall_s']:.1f} s", flush=True)
    if any(n for pair in launches.values() for n in pair):
        failures.append(f"a fused kernel launched on the lockstep path: {launches}")
    if failures:
        raise AssertionError("per-sample lockstep: " + "; ".join(failures))
    return report


# --------------------------------------------------------------------------
# Phase 40: the flagship step with the fused kernels switched off
# (solvers.force_fused_kernels(False)): the baseline "kernels off on the same
# card" beside the kernel's step.
# --------------------------------------------------------------------------

KERNELS_OFF_TURNS = 5  # timed steps of each, in turns, after one warm-up each


def kernels_off_phase(device, model, coeffs, labels):
    """Phase 40: one flagship step (B 4096, rk4) with every fused route
    declined by the public switch: no K1 launch, its logits within FWD_RTOL
    and its gradients within BWD_RTOL of the kernel's step on the same
    weights; then the median train-step ms of both (CUDA events, Adam), in
    turns, the order reversed every other turn."""
    from torchcde_tpu_torch.models import make_train_step
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
    from torchcde_tpu_torch.solvers import force_fused_kernels

    on_logits, on_grads = _plain_step_grads(model, coeffs, labels)
    k1.reset_launch_counts()
    force_fused_kernels(False)
    try:
        off_logits, off_grads = _plain_step_grads(model, coeffs, labels)
        off_launches = {"fwd": k1.FWD_LAUNCHES, "bwd": k1.BWD_LAUNCHES}
    finally:
        force_fused_kernels(None)
    err, scale = _err(off_logits.double(), on_logits.double())
    report = {"k1_launches_switched_off": off_launches, "logits_max_abs_err": err,
              "logits_scale": scale,
              "grad_rel_frobenius": _rel_frobenius(off_grads, [g.double() for g in on_grads])}
    if off_launches != {"fwd": 0, "bwd": 0}:
        raise AssertionError(f"K1 launched with the fused kernels switched off: {report}")
    if not (err <= FWD_RTOL * max(scale, 1.0) and report["grad_rel_frobenius"] <= BWD_RTOL
            and torch.isfinite(off_logits).all()):
        raise AssertionError(f"the step without kernels disagrees with the kernel's: {report}")

    steps = {}
    for name in ("kernel", "off"):
        m = copy.deepcopy(model)
        steps[name] = make_train_step(m, torch.optim.Adam(m.parameters(), lr=1e-3, eps=1e-8))
    samples = {"kernel": [], "off": []}

    def timed(name):
        force_fused_kernels(False if name == "off" else None)
        try:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            steps[name](coeffs, labels)
            end.record()
            torch.cuda.synchronize()
        finally:
            force_fused_kernels(None)
        return start.elapsed_time(end)

    k1.reset_launch_counts()
    for name in ("kernel", "off"):
        timed(name)  # warm-up
    for turn in range(KERNELS_OFF_TURNS):
        for name in (("kernel", "off") if turn % 2 == 0 else ("off", "kernel")):
            samples[name].append(timed(name))
    report.update(
        step_ms={k: statistics.median(v) for k, v in samples.items()}, step_samples_ms=samples,
        k1_launches_in_the_turns={"fwd": k1.FWD_LAUNCHES, "bwd": k1.BWD_LAUNCHES})
    if report["k1_launches_in_the_turns"] != {"fwd": KERNELS_OFF_TURNS + 1,
                                              "bwd": KERNELS_OFF_TURNS + 1}:
        raise AssertionError(f"the turns did not launch K1 once a kernel step: {report}")
    print("kernels off: " + json.dumps(report), flush=True)
    return report


def elapsed(phase):
    """Prints the seconds since the script started, before a phase."""
    print(f"chip_smoke: phase {phase} at {time.perf_counter() - START:.1f} s", flush=True)


def main():
    smi, device = phase_device()

    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import accuracy, make_train_step
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    phase_build()

    # 3-4. The kernels against their plain version, at the main path's shapes.
    X_np, y_np = spiral_data(BATCH, LENGTH)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(X_np).to(device))
    labels = torch.from_numpy(y_np).to(device)
    model = make_model(device)
    errors = []
    for hidden in K1_HIDDEN:
        with torch.no_grad():
            p = packed_operands(model if hidden == HIDDEN else flagship_model(device, hidden),
                                coeffs)
        errors.append(check_k1(f"flagship B{BATCH} H{hidden} C{CHANNELS} W{WIDTH} rk4 m1 terminal",
                               (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2),
                               k1._Plan("rk4", 1, 1.0, (LENGTH - 1,))))
    for seed, (B, n, H, C, W, method, m, which) in enumerate(ODD_CASES, start=1):
        plan = k1._Plan(method, m, 1.0 / m, knot_set(which, n))
        errors.append(check_k1(f"odd B{B} n{n} H{H} C{C} W{W} {method} m{m} {which}",
                               random_operands(B, n, H, C, W, seed, device), plan))
    failures = [f for e in errors for f in e[2]]
    if failures:
        raise AssertionError("kernels disagree with the plain version: " + "; ".join(failures))
    fwd_err, bwd_err = (max(e[i] for e in errors) for i in (0, 1))

    # 5. The K1 slice through the public entry points.
    with torch.no_grad():
        logits = model(coeffs)
        plain_logits = plain_forward(model, coeffs)
    err, scale = _err(logits, plain_logits)
    print(f"slice logits vs plain version: max_abs_err {err:.3e} (largest |value| {scale:.3e})")
    if logits.shape != (BATCH, 1) or not torch.isfinite(logits).all() or err > FWD_RTOL * max(scale, 1.0):
        raise AssertionError("the model's logits disagree with the plain version")

    train_model = copy.deepcopy(model)
    step = make_train_step(train_model, torch.optim.Adam(train_model.parameters(), lr=1e-3, eps=1e-8))
    k1.reset_launch_counts()
    losses = [float(step(coeffs, labels)) for _ in range(5)]
    fwd_after_steps, bwd_after_steps = k1.FWD_LAUNCHES, k1.BWD_LAUNCHES
    acc = float(accuracy(train_model, coeffs, labels))
    launches = {"fwd": k1.FWD_LAUNCHES, "bwd": k1.BWD_LAUNCHES}
    torch.cuda.synchronize()
    print(f"slice: 5 Adam steps, losses {losses}, accuracy {acc:.4f}, launches {launches}")
    if not all(math.isfinite(v) for v in losses) or losses[-1] == losses[0]:
        raise AssertionError(f"the loss is not finite or does not change: {losses}")
    if (fwd_after_steps, bwd_after_steps) != (5, 5) or launches != {"fwd": 6, "bwd": 5}:
        raise AssertionError(f"the main path did not run the kernels once per step: {launches}")
    hidden_slice = k1_hidden_slice(device, coeffs, labels)

    elapsed("6")
    # 6. K2 against its plain version, and 7. the default configuration.
    k2_fwd_err, k2_bwd_err = check_k2(device)
    k2_launches = k2_slice(device)

    elapsed("8")
    # 8. Timing, and 9. the profiles.
    k1_timing = time_k1(device, coeffs, labels)
    k1_h8 = k1_timing[HIDDEN]
    print("timing: " + json.dumps({
        "card": smi, "train_step_ms": k1_h8["train_step_ms"],
        "train_step_samples_ms": k1_h8["train_step_samples_ms"],
        **{k: v for k, v in k1_h8.items() if k.startswith("k1_")},
        "k1_fwd_plan": k1_h8["fwd_plan"], "k1_bwd_plan": k1_h8["bwd_plan"],
        **{f"k1_H{h}": {**t, "fwd_bound_ms": k1_bounds(False, h)[0][0],
                        "bwd_bound_ms": k1_bounds(False, h)[1][0]}
           for h, t in k1_timing.items() if h != HIDDEN},
        "k1_H16_slice": hidden_slice,
    }))
    k2_ms = time_k2(device)
    default_steps = {}
    for batch in DEFAULT_BATCHES:
        d_model, d_coeffs, d_labels = default_model(device, batch)
        default_steps[batch] = time_train_steps(
            d_model, d_coeffs, d_labels, plain_k2_loss(d_coeffs, d_labels), counts=(5, 1))
    print("timing: " + json.dumps({
        "card": smi, **k2_ms,
        **{f"default_B{b}_train_step_ms": m for b, (m, _) in default_steps.items()},
        **{f"default_B{b}_train_step_samples_ms": v for b, (_, v) in default_steps.items()},
    }))
    flagship_profile = profile_train_steps(model, coeffs, labels, K1_KINDS)
    print("profile: " + json.dumps(dict(flagship_profile, config="flagship rk4", card=smi)))
    for batch in DEFAULT_BATCHES:
        print("profile: " + json.dumps(dict(
            profile_train_steps(*default_model(device, batch), K2_KINDS),
            config=f"default dopri5 adjoint B{batch}", card=smi)))
    elapsed("10")
    # 10-13. The natural cubic fit: its kernels, the config-3 slice, the NaN
    # spiral slice and the timing.
    fit_errors = check_fit_kernels(device)
    elapsed("11")
    recorded = {}
    fit_launches, slice_errors = fit_slice(device, recorded)
    fit_errors["K5"] = max(fit_errors["K5"], slice_errors[("masked", "K5")])
    elapsed("12")
    spiral_fit, spiral_k2, spiral_err = nan_spiral_slice(device)
    for name, count in spiral_fit.items():
        fit_launches[name] += count
    elapsed("13")
    fit_ms, fit_end_to_end, fit_profile = time_fit_kernels(device, recorded)
    elapsed("13, the long rows")
    long_ms, long_grad_ms = time_long_rows(device)
    print("profile: " + json.dumps(dict(fit_profile, config="config-3 NaN-masked fit gradient",
                                        card=smi)))
    print("timing: " + json.dumps({
        "card": smi, **{f"{name}_ms": v[0] for name, v in fit_ms.items()},
        **{f"{name}_plain_ms": v[1] for name, v in fit_ms.items()},
        **{f"{name}_bound_ms": v[2] for name, v in fit_ms.items()},
        "K4_library_ms": fit_ms["K4"][4], **fit_end_to_end,
        "long_rows_ms": {name: dict(zip(("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
                                        v)) for name, v in long_ms.items()},
        "long_rows_masked_gradient_ms": long_grad_ms,
        "fit_slice_max_abs_err": {" ".join(key): v for key, v in slice_errors.items()},
        "nan_spiral_fit_max_abs_err": spiral_err, "nan_spiral_k2_launches": spiral_k2,
    }))

    elapsed("14")
    # 14-17. The log-ODE Neural RDE path (config 4): K2's linear mode, the
    # slice without and with NaNs, config 2's preprocessing, the timing.
    x_log, log_labels = log_ode_data(device, nan=False)
    log_coeffs = tt.linear_interpolation_coeffs(
        tt.logsig_windows(x_log, LOG_ODE_DEPTH, LOG_ODE_WINDOW))
    k2l_fwd_err, k2l_bwd_err = check_k2_linear(device, log_coeffs, log_ode_model(device))
    log_slice = log_ode_slice(device)
    irregular_k3, irregular_errors = irregular_slice(device)
    fit_launches["K3"] += irregular_k3 + log_slice["30 % NaN"]["fit_launches"]["K3"]
    log_ms, (k2l_fwd_bound, k2l_bwd_bound), log_profile = time_log_ode(
        device, log_coeffs, log_labels, x_log)
    print("profile: " + json.dumps(dict(log_profile, config="config-4 log-ODE train step",
                                        card=smi)))
    print("timing: " + json.dumps({"card": smi, **log_ms, "log_ode_slice": log_slice,
                                   "irregular_max_abs_err": irregular_errors}))
    k2l_launches = {kind: sum(r["k2_launches"][f"linear_{kind}"] for r in log_slice.values())
                    for kind in ("fwd", "bwd")}

    elapsed("18")
    # 18-21. The reversible-Heun Neural CDE (config 5): K8 against its plain
    # version, the slice in both adjoint modes, the timing and the profiles.
    k8_fwd_err, k8_bwd_err = check_k8_cases(device)
    config5 = config5_slice(device)
    config5_h16 = config5_slice(device, hidden=16)
    k8_ms = time_k8(device)
    k8_fwd_bound, k8_bwd_bound, _ = k8_bounds(CONFIG5_BATCH, LENGTH - 1, 1, HIDDEN, CHANNELS)
    print("timing: " + json.dumps({
        "card": smi, **k8_ms,
        "config5_slice": {f"adjoint={a}": r for a, r in config5.items()},
        "config5_H16_slice": {f"adjoint={a}": r for a, r in config5_h16.items()}}))
    for adjoint in (False, True):
        profile = profile_train_steps(*config5_problem(device, adjoint), K8_KINDS)
        if "device_busy_ms_per_call" in profile:
            profile["k8_share_of_busy"] = ((profile["k8_fwd_ms_per_call"]
                                            + profile["k8_bwd_ms_per_call"])
                                           / profile["device_busy_ms_per_call"])
        print("profile: " + json.dumps(dict(profile, config=f"config-5 reversible Heun "
                                            f"adjoint={adjoint} B{CONFIG5_BATCH}", card=smi)))
    k8_launches = {kind: sum(r["k8_launches"][kind] for r in config5.values())
                   for kind in ("fwd", "bwd")}

    elapsed("22")
    # 22-25. Per-sample stepping: K9 against its plain version, the slice
    # with its launches counted, the timing and the profile.
    k9_fwd_err, k9_bwd_err = check_k9(device)
    elapsed("23")
    ps_slice = per_sample_slice(device)
    elapsed("24")
    k9_ms, (k9_fwd_bound, k9_bwd_bound), k9_profile = time_k9(device)
    print("timing: " + json.dumps({
        "card": smi, **k9_ms, "k9_fwd_bound_ms": k9_fwd_bound[0],
        "k9_bwd_bound_ms": k9_bwd_bound[0], "per_sample_slice": ps_slice}))
    print("profile: " + json.dumps(dict(k9_profile, config=f"per-sample slice gradient "
                                        f"B{PS_BATCH} n{PS_LENGTH - 1}", card=smi)))
    k9_launches = {kind: sum(r["k9_launches"][kind] for r in ps_slice.values())
                   for kind in ("fwd", "bwd")}

    elapsed("26")
    # 26-28. Mixed precision (bench.py's configuration): K1's bfloat16 mode
    # against its plain version, the slices (the flagship, and bf16 through
    # K2, K8 and K9), the timing beside the float32 flagship and a profile.
    bf16_model = make_model(device, config=BF16_FLAGSHIP)
    k1b_fwd_err, k1b_bwd_err = check_k1_bf16_cases(device, bf16_model, coeffs)
    elapsed("27")
    bf16_report = bf16_slices(device, copy.deepcopy(bf16_model), coeffs, labels)
    bf16_launches = bf16_report["flagship"]["k1_launches"]
    elapsed("28")
    bf16_ms, bf16_profile = time_bf16(device, bf16_model, model, coeffs, labels)
    k1b_fwd_bound, k1b_bwd_bound = k1_bounds(True)
    print("timing: " + json.dumps({"card": smi, **bf16_ms, "k1_bf16_fwd_plan": k1_plan(1, "forward"),
                                   "k1_bf16_bwd_plan": k1_plan(1, "backward"),
                                   "k1_bf16_fwd_bound_ms": k1b_fwd_bound[0],
                                   "k1_bf16_bwd_bound_ms": k1b_bwd_bound[0],
                                   "bf16_slices": bf16_report}))
    print("profile: " + json.dumps(dict(bf16_profile, config="flagship bf16 (bench.py)", card=smi)))

    elapsed("29")
    # 29-30. The rest of the solver surface (plain PyTorch on the card, no
    # fused kernel) and the first example.
    surface = surface_slice(device)
    elapsed("30")
    example = example_slice()
    print("timing: " + json.dumps({"card": smi, "solver_surface": surface, "example": example}))

    elapsed("31")
    # 31-33. The host side: the C++ runtime against the card's preprocessing,
    # the loader feeding three slices, observability and the loader's timing.
    native_report = native_slice(device)
    elapsed("32")
    loader_report = loader_slices(device)
    elapsed("33")
    observability = observability_slice(device, flagship_profile)
    loader_timing = time_loader_fed(device)
    print("timing: " + json.dumps({
        "card": smi, "host": native_report["host"],
        "host_preprocessing_ms_per_batch": {
            route: r["host_ms_per_batch"] for route, r in native_report.items() if route != "host"},
        "loader_fed_flagship": loader_timing, "loader_slices": loader_report,
        "observability": observability}))

    elapsed("34")
    # 34-38. Parallelism: four gloo ranks on the card (data-parallel K1 and
    # K8 slices, tensor parallelism, the sequence-sharded fits), one
    # single-rank NCCL group, and the parallel example.
    parallel = parallel_phases(smi)
    print("timing: " + json.dumps({"card": smi, "parallel_wall_ms": {
        "gloo_ranks": parallel["gloo_ranks_wall_ms"], "nccl_rank": parallel["nccl_wall_ms"],
        "example": parallel["example"]["wall_ms"]}}))

    elapsed("39")
    # 39. Per-sample solves outside K9: one lockstep solve over the lanes.
    lockstep = per_sample_lockstep_phase(device)
    print("timing: " + json.dumps({"card": smi, "per_sample_lockstep": lockstep}))

    elapsed("40")
    # 40. The flagship step with the fused kernels switched off, beside the
    # kernel's step.
    kernels_off = kernels_off_phase(device, model, coeffs, labels)
    print("timing: " + json.dumps({"card": smi, "flagship_kernels_off": kernels_off}))

    elapsed("41")
    # 41. The long rows: K4's bands, K5 in the masked gradient and K6/K7 past
    # 4096 through the public entry points, by route, with the profiler's
    # kernel names.
    long_rows = long_row_slice(device)
    print("timing: " + json.dumps({"card": smi, "long_rows": long_rows}))

    k2_total = {kind: sum(c[kind] for c in k2_launches.values()) for kind in ("fwd", "bwd")}
    k1_fwd_bound, k1_bwd_bound, k2_fwd_bound, k2_bwd_bound = fused_bounds(k2_ms)
    # No single PyTorch call computes a fused CDE solve: K1's, K2's and K8's
    # library_ms is null (the fit kernels': time_fit_kernels).
    kernels = [
        {"name": "K1-fwd", "kernel": K1_FWD_KERNEL, "route": "cuda", "source": SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:182", "launches": launches["fwd"],
         "max_abs_err": fwd_err, "ms": k1_h8["k1_fwd_ms"], "plain_ms": k1_h8["k1_fwd_plain_ms"],
         "bound_ms": k1_fwd_bound[0], "bound_by": k1_fwd_bound[1], "library_ms": None},
        {"name": "K1-bwd", "kernel": K1_BWD_KERNEL, "route": "cuda", "source": SOURCE_BWD,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:265", "launches": launches["bwd"],
         "max_abs_err": bwd_err, "ms": k1_h8["k1_bwd_ms"], "plain_ms": k1_h8["k1_bwd_plain_ms"],
         "bound_ms": k1_bwd_bound[0], "bound_by": k1_bwd_bound[1], "library_ms": None},
        {"name": "K1-fwd H16", "kernel": K1_FWD_KERNEL, "route": "cuda", "source": SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:182",
         "launches": hidden_slice["k1_launches"]["fwd"], "max_abs_err": fwd_err,
         "ms": k1_timing[16]["k1_fwd_ms"], "plain_ms": k1_timing[16]["k1_fwd_plain_ms"],
         "bound_ms": k1_bounds(False, 16)[0][0], "bound_by": k1_bounds(False, 16)[0][1],
         "library_ms": None},
        {"name": "K1-bwd H16", "kernel": K1_BWD_KERNEL, "route": "cuda", "source": SOURCE_BWD,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:265",
         "launches": hidden_slice["k1_launches"]["bwd"], "max_abs_err": bwd_err,
         "ms": k1_timing[16]["k1_bwd_ms"], "plain_ms": k1_timing[16]["k1_bwd_plain_ms"],
         "bound_ms": k1_bounds(False, 16)[1][0], "bound_by": k1_bounds(False, 16)[1][1],
         "library_ms": None},
        {"name": "K2-fwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_dopri_pallas.py:161",
         "launches": k2_total["fwd"], "max_abs_err": k2_fwd_err, "ms": k2_ms["k2_fwd_ms"],
         "plain_ms": k2_ms["k2_fwd_plain_ms"], "bound_ms": k2_fwd_bound[0],
         "bound_by": k2_fwd_bound[1], "library_ms": None},
        {"name": "K2-bwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_dopri_pallas.py:295",
         "launches": k2_total["bwd"], "max_abs_err": k2_bwd_err, "ms": k2_ms["k2_bwd_ms"],
         "plain_ms": k2_ms["k2_bwd_plain_ms"], "bound_ms": k2_bwd_bound[0],
         "bound_by": k2_bwd_bound[1], "library_ms": None},
        {"name": "K2-linear-fwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_dopri_pallas.py:161",
         "launches": k2l_launches["fwd"], "max_abs_err": k2l_fwd_err,
         "ms": log_ms["linear_k2_fwd_ms"], "plain_ms": log_ms["linear_k2_fwd_plain_ms"],
         "bound_ms": k2l_fwd_bound[0], "bound_by": k2l_fwd_bound[1], "library_ms": None},
        {"name": "K2-linear-bwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_dopri_pallas.py:295",
         "launches": k2l_launches["bwd"], "max_abs_err": k2l_bwd_err,
         "ms": log_ms["linear_k2_bwd_ms"], "plain_ms": log_ms["linear_k2_bwd_plain_ms"],
         "bound_ms": k2l_bwd_bound[0], "bound_by": k2l_bwd_bound[1], "library_ms": None},
        {"name": "K8-fwd", "route": "cuda", "source": K8_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:741", "launches": k8_launches["fwd"],
         "max_abs_err": k8_fwd_err, "ms": k8_ms["k8_fwd_ms"], "plain_ms": k8_ms["k8_fwd_plain_ms"],
         "bound_ms": k8_fwd_bound[0], "bound_by": k8_fwd_bound[1], "library_ms": None},
        {"name": "K8-bwd", "route": "cuda", "source": K8_BWD_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:783", "launches": k8_launches["bwd"],
         "max_abs_err": k8_bwd_err, "ms": k8_ms["k8_bwd_ms"], "plain_ms": k8_ms["k8_bwd_plain_ms"],
         "bound_ms": k8_bwd_bound[0], "bound_by": k8_bwd_bound[1], "library_ms": None},
    ]
    # No PyTorch call computes a per-lane adaptive solve: K9's library_ms is null.
    kernels += [
        {"name": "K9-fwd", "route": "cuda", "source": K9_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_dopri_persample.py:145",
         "launches": k9_launches["fwd"], "max_abs_err": k9_fwd_err, "ms": k9_ms["k9_fwd_ms"],
         "plain_ms": k9_ms["k9_fwd_plain_first_launch_ms"], "bound_ms": k9_fwd_bound[0],
         "bound_by": k9_fwd_bound[1], "library_ms": None},
        {"name": "K9-bwd", "route": "cuda", "source": K9_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_dopri_persample.py:330",
         "launches": k9_launches["bwd"], "max_abs_err": k9_bwd_err, "ms": k9_ms["k9_bwd_ms"],
         "plain_ms": k9_ms["k9_bwd_plain_first_launch_ms"], "bound_ms": k9_bwd_bound[0],
         "bound_by": k9_bwd_bound[1], "library_ms": None},
    ]
    kernels += [
        {"name": "K1-bf16-fwd", "kernel": K1_FWD_KERNEL, "route": "cuda", "source": SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:182",
         "launches": bf16_launches["bf16_fwd"], "max_abs_err": k1b_fwd_err,
         "ms": bf16_ms["k1_bf16_fwd_ms"], "plain_ms": bf16_ms["k1_bf16_fwd_plain_ms"],
         "bound_ms": k1b_fwd_bound[0], "bound_by": k1b_fwd_bound[1], "library_ms": None},
        {"name": "K1-bf16-bwd", "kernel": K1_BWD_KERNEL, "route": "cuda", "source": SOURCE_BWD,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:265",
         "launches": bf16_launches["bf16_bwd"], "max_abs_err": k1b_bwd_err,
         "ms": bf16_ms["k1_bf16_bwd_ms"], "plain_ms": bf16_ms["k1_bf16_bwd_plain_ms"],
         "bound_ms": k1b_bwd_bound[0], "bound_by": k1b_bwd_bound[1], "library_ms": None},
    ]
    for name in ("K3", "K4", "K5", "K6/K7"):
        ms, plain_ms, bound_ms, bound_by, library_ms = fit_ms[name]
        kernels.append({"name": name, "route": "cuda", "source": FIT_SOURCES[name],
                        "replaces": FIT_REPLACES[name], "launches": fit_launches[name],
                        "max_abs_err": fit_errors[name], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms})
        if name == "K5":  # the kernel of K5's route at config 3's length
            kernels[-1]["variant"] = K5_VARIANTS[
                fit_kernel_modules()["K5"].solve_plan(FIT_LENGTH).variant]
    # The routes past the resident kernels: each one's launches from phase 41,
    # its largest error over phase 10's cases, its times from phase 13.
    for name, what, n, k, route in LONG_ROW_CASES:
        family = LONG_ROW_FAMILY[what]
        ms, plain_ms, bound_ms, bound_by, library_ms = long_ms[name]
        kernels.append({"name": name, "route": "cuda", "source": FIT_SOURCES[family],
                        "replaces": FIT_REPLACES[family], "launches": long_rows[name]["launches"],
                        "max_abs_err": ROUTE_ERRORS[family][route], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms, "variant": route, "shape": f"{n}x{k}"})
    # Each kernel's launches on one rank of each parallel phase (rank 0; the
    # ranks' counts are equal, each on its own shard).
    per_rank = par_kernel_launches(parallel["ranks"][0])
    for entry in kernels:
        entry["parallel_launches_per_rank"] = per_rank.get(entry["name"], {})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


START = time.perf_counter()

if __name__ == "__main__":
    if sys.argv[1:] == [LONG_ROW_KERNELS_ARG]:
        print(json.dumps(long_row_kernels(phase_device()[1])))
    else:
        main()
        print(f"chip_smoke: {time.perf_counter() - START:.1f} s", file=sys.stderr)
