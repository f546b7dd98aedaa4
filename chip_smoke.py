"""Drives the PyTorch port's main paths on one NVIDIA GPU and checks its kernels.

    python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which raises on failure:

1. device: the card's name and power limit from nvidia-smi; TF32 off;
2. build: compiles torchcde_tpu_torch/csrc with nvcc (one process per source);
3. K1 forward and 4. K1 backward: the fixed-step kernels against their plain
   PyTorch version on the card, at the flagship shapes (in both kernel
   variants) and at odd cases covering every tableau, up to 8 substeps, odd
   batches and shapes at the JAX kernel's caps;
5. K1 slice: five Adam steps of the spiral Neural CDE at the flagship
   configuration (rk4, step 1) through the public entry points, with the K1
   launch counts read around that run, then one ``accuracy`` call;
6. K2 forward and backward: the adaptive dopri5 kernels against their plain
   version, per realised mesh, on every launch of nine cases (the default
   configuration at batch 4096 and 256, two groups, three chunks, 20 output
   times, the caps, tight tolerances, an odd shape, an exhausted budget);
7. K2 slice: five Adam steps of the default Neural CDE configuration (dopri5,
   adjoint) at batch 4096 and at batch 256, each with the K2 launch counts
   read around it, then one ``accuracy`` call each;
8. timing: K1 (both variants), K2 and both train steps against the plain
   version, by CUDA events;
9. profile: torch.profiler over train steps of both configurations: the
   device's busy share, kernels per step and the fused kernels' device time.

The last line is the JSON object {"ok": true, "device": {...}}; the line
before it lists every kernel of the paths.  Without a CUDA device the script
exits non-zero before building anything.
"""

import copy
import json
import math
import re
import statistics
import subprocess
import sys
import time
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
SOURCE = "torchcde_tpu_torch/csrc/fused_fixed.cu"
# Odd K1 cases: (batch, intervals, hidden, channels, width, method, substeps,
# output knots).  Shapes up to the JAX kernel's caps (C * H <= 512,
# 3 * C <= 16, width <= 512, 8 substeps).  H 8, C 3 runs the specialised
# variant up to width 432 and the generic one past it; every tableau runs in
# both variants.
ODD_CASES = [
    (1000, 99, 5, 3, 128, "euler", 2, "all"),
    (520, 40, 8, 3, 64, "euler", 1, "all"),
    (1000, 99, 8, 3, 128, "heun", 4, "subset"),
    (1000, 99, 8, 3, 128, "midpoint", 3, "terminal"),
    (300, 20, 8, 3, 500, "rk4", 2, "subset"),
    (333, 24, 16, 5, 512, "rk4", 1, "all"),
    (300, 12, 100, 5, 512, "midpoint", 8, "subset"),
    (77, 30, 7, 2, 64, "heun", 1, "all"),
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
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    path, seconds, log = _build.build()
    k1._library()
    k2._library()
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    print(f"build: {path.name} in {seconds:.1f} s", flush=True)
    for line in ptxas:
        print(f"  ptxas: {line}")


def make_model(device, seed=0):
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig

    gen = torch.Generator().manual_seed(seed)
    return NeuralCDE(NeuralCDEConfig(**FLAGSHIP), generator=gen).to(device)


def packed_operands(model, coeffs):
    """The K1 operands exactly as the model's forward builds them."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers.fused_fixed_kernel import pack_operands

    X = tt.CubicSpline(coeffs)
    z0 = model.initial(X.evaluate(X.interval[0]))
    return pack_operands(X._b, X._two_c, X._three_d, z0, model.func)


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

    grads = k1.launch_backward(operands[0], zres, operands[1], gz, *operands[2:], plan)
    plain = []
    for dtype in (torch.float64, torch.float32):
        leaves = [t.detach().to(dtype).requires_grad_() for t in operands]
        ref = k1.fused_fixed_solve_reference(*leaves, plan.method, plan.m, plan.dt_sub,
                                             plan.out_knots)
        plain.append(torch.autograd.grad(ref, leaves, gz.to(dtype)))
    torch.cuda.synchronize()
    return grads, plain[0], plain[1]


def check_k1(label, operands, plan):
    """Kernel forward and backward against autograd through the plain version."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    H, (n, _, C, B), W = operands[1].shape[0], operands[0].shape, operands[2].shape[0]
    label = f"{label} [{k1.kernel_variant(H, C, W, plan)}]"
    out, zres = k1.launch_forward(*operands, plan)
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

    # Lanes where rounding crossed a ReLU kink differ by a whole term (see
    # BWD_RTOL); they are found by their own gradients (dct, dz0), and the
    # comparison is repeated with their cotangent set to zero.
    gz = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(1),
                     device=out.device)
    grads, ref_grads, _ = _gradients(operands, zres, gz, plan)
    lane_err = torch.maximum(_lane_rel_l2(grads[0], ref_grads[0]),
                             _lane_rel_l2(grads[1], ref_grads[1]))
    kinked = torch.nonzero(lane_err > LANE_RTOL).flatten().tolist()
    allowed = 2 + int(KINKED_PER_RELU * B * n * plan.m * len(k1._chain_form(plan.method)[2]) * W)
    worst = float(lane_err.max())
    print(f"K1-bwd {label}: {len(kinked)} lanes past {LANE_RTOL:g} (limit {allowed}), "
          f"largest lane error {worst:.2e}, largest of the other lanes "
          f"{float(lane_err.masked_fill(lane_err > LANE_RTOL, 0.0).max()):.2e}")
    if len(kinked) > allowed or worst > LANE_GROSS:
        failures.append(f"K1 backward: lanes disagree ({label})")
    gz[..., kinked] = 0.0
    grads, ref_grads, ref32_grads = _gradients(operands, zres, gz, plan)

    bwd_err = 0.0
    for name, g, r, r32 in zip(["ct", "z0", "w1", "b1", "w2", "b2"], grads, ref_grads, ref32_grads):
        err, scale = _err(g.double(), r)
        rel, rel32 = _rel_l2(g, r), _rel_l2(r32, r)
        print(f"K1-bwd {label} d{name}: rel_l2 {rel:.3e} max_abs_err {err:.3e} "
              f"(largest |value| {scale:.3e}; plain float32 rel_l2 {rel32:.3e} "
              f"max_abs_err {_err(r32.double(), r)[0]:.3e})")
        if not torch.isfinite(g).all() or rel > BWD_RTOL:
            failures.append(f"K1 backward d{name} ({label})")
        bwd_err = max(bwd_err, err)
    return fwd_err, bwd_err, failures


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


def time_k1(model, coeffs):
    """Flagship K1 ms: {variant: (forward, backward)} and the plain version's."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    with torch.no_grad():
        p = packed_operands(model, coeffs)
    n = p.ct.shape[0]
    ops = (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2)
    kernel_ms = {}
    for name, generic in (("specialised", False), ("generic", True)):
        plan = k1._Plan("rk4", 1, 1.0, (n,), generic)
        out, zres = k1.launch_forward(*ops, plan)
        gz = torch.ones_like(out)
        kernel_ms[name] = (
            _event_ms(lambda: k1.launch_forward(*ops, plan), 10),
            _event_ms(lambda: k1.launch_backward(p.ct, zres, p.z0t, gz, *ops[2:], plan), 5))

    leaves = [t.detach().clone().requires_grad_() for t in ops]
    with torch.no_grad():
        plain_fwd_ms = _event_ms(
            lambda: k1.fused_fixed_solve_reference(*ops, "rk4", 1, 1.0, (n,)), 3)
    ref = k1.fused_fixed_solve_reference(*leaves, "rk4", 1, 1.0, (n,))
    plain_bwd_ms = _event_ms(
        lambda: torch.autograd.grad(ref, leaves, gz, retain_graph=True), 3)
    return kernel_ms, plain_fwd_ms, plain_bwd_ms


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


def profile_train_steps(model, coeffs, labels, kinds, steps=3):
    """torch.profiler over a few train steps: device busy share, launches, and
    the device ms per step of the kernels whose names match kinds' patterns."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchcde_tpu_torch.models import make_train_step

    model = copy.deepcopy(model)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
    step(coeffs, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step(coeffs, labels)
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
    fused_us = {name: sum(e[1] - e[0] for e in kernels if re.search(pattern, e[2]))
                for name, pattern in kinds.items()}
    return {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "device_kernels_per_step": len(kernels) / steps,
        "device_copies_per_step": (len(device) - len(kernels)) / steps,
        **{f"{name}_ms_per_step": us / 1e3 / steps for name, us in fused_us.items()},
    }


K2_SOURCE = "torchcde_tpu_torch/csrc/fused_dopri.cu"
# The default Neural CDE configuration: cubic control, dopri5, adjoint,
# rtol 1e-4, atol 1e-6 (NeuralCDEConfig's defaults), at the width of the
# repository's benchmark.
DEFAULT = dict(input_channels=CHANNELS, hidden_channels=HIDDEN, output_channels=1, width=WIDTH)
DEFAULT_BATCHES = (4096, 256)
# K2 cases: (label, batch, length, hidden, channels, width, output times,
# solver options).  Each launch of each case is checked against the plain
# version on its own realised mesh.
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
]


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


def k2_problem(batch, length, hidden, channels, width, seed, device):
    """(control, vector field, z0) of a seeded NeuralCDE on smooth paths, as
    the model's forward builds them."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig

    model = NeuralCDE(NeuralCDEConfig(channels, hidden, 1, width=width),
                      generator=torch.Generator().manual_seed(seed)).to(device)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(paths(batch, length, channels, seed)).to(device)))
    with torch.no_grad():
        z0 = model.initial(X.evaluate(X.interval[0]))
    return X, model.func, z0


def _k2_grads(ops, dt0, plan, store, mesh, gz, gzfin):
    """The backward kernel's gradients and autograd's through the float64
    replay of the kernel's mesh."""
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    grads = k2.launch_backward(ops[0], store, gz, gzfin, *ops[2:], plan)
    leaves = [t.detach().double().requires_grad_() for t in ops]
    outs = k2.fused_dopri5_replay(*leaves, mesh, plan)
    pairs = [(o, g.double()) for o, g in zip(outs, (gz, gzfin)) if o.numel()]
    ref = torch.autograd.grad([o for o, _ in pairs], leaves, [g for _, g in pairs])
    torch.cuda.synchronize()
    return grads, ref


def check_k2_launch(label, ops, dt0, plan):
    """One K2 launch against the plain version: the forward against the
    float64 replay of the kernel's own mesh, the kernel's mesh against the
    plain float32 solve's, and the backward against autograd through the
    replay (with K1's ReLU-kink lane screen)."""
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    H, (n, _, C, B), W = ops[1].shape[0], ops[0].shape, ops[2].shape[0]
    label = f"{label} [{k2.kernel_variant(H, C, W)}]"
    zout, zfin, _dtfin, store = k2.launch_forward(*ops, dt0, plan)
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
        return 0.0, 0.0, (0.0, 0.0), [] if nan else [f"K2 exhausted budget not NaN ({label})"]
    failures = []
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
    grads, ref_grads = _k2_grads(ops, dt0, plan, store, mesh, gz, gzfin)
    lane_err = torch.maximum(_lane_rel_l2(grads[0], ref_grads[0]),
                             _lane_rel_l2(grads[1], ref_grads[1]))
    kinked = torch.nonzero(lane_err > LANE_RTOL).flatten().tolist()
    allowed = 2 + int(KINKED_PER_RELU * B * len(mesh.t) * 7 * W)
    worst = float(lane_err.max())
    print(f"K2-bwd {label}: {len(kinked)} lanes past {LANE_RTOL:g} (limit {allowed}), "
          f"largest lane error {worst:.2e}")
    if len(kinked) > allowed or worst > LANE_GROSS:
        failures.append(f"K2 backward: lanes disagree ({label})")
    gz[..., kinked] = 0.0
    gzfin[..., kinked] = 0.0
    grads, ref_grads = _k2_grads(ops, dt0, plan, store, mesh, gz, gzfin)
    bwd_err = 0.0
    for name, g, r in zip(["ct", "z0", "w1", "b1", "w2", "b2"], grads, ref_grads):
        err, scale = _err(g.double(), r)
        rel = _rel_l2(g, r)
        print(f"K2-bwd {label} d{name}: rel_l2 {rel:.3e} max_abs_err {err:.3e} "
              f"(largest |value| {scale:.3e})")
        if not torch.isfinite(g).all() or rel > BWD_RTOL:
            failures.append(f"K2 backward d{name} ({label})")
        bwd_err = max(bwd_err, err)
    return fwd_err, bwd_err, accuracy, failures


def recorded_k2_launches(X, field, z0, ts, cfg):
    """The arguments of every K2 forward launch of one fused solve."""
    from torchcde_tpu_torch.solvers import fused_dopri, fused_dopri_kernel as k2

    calls = []
    launch = k2.launch_forward

    def record(*args):
        calls.append(args)
        return launch(*args)

    with mock.patch.object(k2, "launch_forward", record), torch.no_grad():
        if fused_dopri.try_fused_dopri5(X, field, z0, ts, cfg) is None:
            raise AssertionError("the fused dopri5 solve declined")
    return calls


def check_k2(device):
    """Phase 6: every K2 case, every launch."""
    from torchcde_tpu_torch.solvers import SolverConfig

    errors = []
    for seed, (label, B, L, H, C, W, which, options) in enumerate(K2_CASES, start=1):
        X, field, z0 = k2_problem(B, L, H, C, W, seed, device)
        n = L - 1
        ts = (np.array([0.0, float(n)]) if which == "terminal"
              else np.concatenate([[0.0], np.linspace(n / 20, n, 20) - 0.37 * (np.arange(20) % 2)]))
        calls = recorded_k2_launches(X, field, z0, ts, SolverConfig(**options))
        print(f"K2 {label}: B{B} n{n} H{H} C{C} W{W}, {len(ts)} output times, "
              f"{len(calls)} launches", flush=True)
        for i, (*ops, dt0, plan) in enumerate(calls):
            errors.append(check_k2_launch(f"{label} #{i}", tuple(ops), dt0, plan))
    failures = [f for e in errors for f in e[3]]
    kernel_sum, plain_sum = (sum(e[2][i] for e in errors) for i in (0, 1))
    print(f"K2 accuracy over all launches, in units of rtol x largest magnitude: "
          f"kernel {kernel_sum:.3f}, plain float32 {plain_sum:.3f} (limit {2 * plain_sum:.3f})")
    if not kernel_sum <= 2 * plain_sum:
        failures.append("K2 forward less accurate than the plain float32 solve over all launches")
    if failures:
        raise AssertionError("K2 disagrees with the plain version: " + "; ".join(failures))
    return max(e[0] for e in errors), max(e[1] for e in errors)


def default_model(device, batch, seed=0):
    """The default configuration and its spiral data."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig

    model = NeuralCDE(NeuralCDEConfig(**DEFAULT), generator=torch.Generator().manual_seed(seed))
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
    from torchcde_tpu_torch.solvers import SolverConfig
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    model, coeffs, _ = default_model(device, 4096)
    X = tt.CubicSpline(coeffs)
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


def main():
    smi, device = phase_device()

    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.models import accuracy, make_train_step
    from torchcde_tpu_torch.models.neural_cde import bce_with_logits
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    phase_build()

    # 3-4. The kernels against their plain version, at the main path's shapes.
    X_np, y_np = spiral_data(BATCH, LENGTH)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(X_np).to(device))
    labels = torch.from_numpy(y_np).to(device)
    model = make_model(device)
    with torch.no_grad():
        p = packed_operands(model, coeffs)
    flagship_ops = (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2)
    errors = [check_k1(f"flagship B{BATCH} H{HIDDEN} C{CHANNELS} W{WIDTH} rk4 m1 terminal",
                       flagship_ops, k1._Plan("rk4", 1, 1.0, (LENGTH - 1,), generic))
              for generic in (False, True)]
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

    # 6. K2 against its plain version, and 7. the default configuration.
    k2_fwd_err, k2_bwd_err = check_k2(device)
    k2_launches = k2_slice(device)

    # 8. Timing, and 9. the profiles.
    kernel_ms, plain_fwd_ms, plain_bwd_ms = time_k1(model, coeffs)
    (fwd_ms, bwd_ms), generic_ms = kernel_ms["specialised"], kernel_ms["generic"]
    medians, samples = time_train_steps(
        model, coeffs, labels,
        lambda m: bce_with_logits(plain_forward(m, coeffs)[..., 0], labels))
    print("timing: " + json.dumps({
        "card": smi, "train_step_ms": medians, "train_step_samples_ms": samples,
        "k1_fwd_ms": fwd_ms, "k1_fwd_plain_ms": plain_fwd_ms,
        "k1_bwd_ms": bwd_ms, "k1_bwd_plain_ms": plain_bwd_ms,
        "k1_fwd_generic_ms": generic_ms[0], "k1_bwd_generic_ms": generic_ms[1],
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
    k1_kinds = {"k1_fwd": r"\bfwd_kernel\b", "k1_bwd": r"\bbwd_kernel\b"}
    k2_kinds = {"k2_fwd": r"\bdopri_fwd_kernel\b", "k2_bwd": r"\bdopri_bwd_kernel\b"}
    print("profile: " + json.dumps(dict(
        profile_train_steps(model, coeffs, labels, k1_kinds), config="flagship rk4", card=smi)))
    for batch in DEFAULT_BATCHES:
        print("profile: " + json.dumps(dict(
            profile_train_steps(*default_model(device, batch), k2_kinds),
            config=f"default dopri5 adjoint B{batch}", card=smi)))
    k2_total = {kind: sum(c[kind] for c in k2_launches.values()) for kind in ("fwd", "bwd")}
    print(json.dumps({"kernels": [
        {"name": "K1-fwd", "route": "cuda", "source": SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:182", "launches": launches["fwd"],
         "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": plain_fwd_ms},
        {"name": "K1-bwd", "route": "cuda", "source": SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:265", "launches": launches["bwd"],
         "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": plain_bwd_ms},
        {"name": "K2-fwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_dopri_pallas.py:161",
         "launches": k2_total["fwd"], "max_abs_err": k2_fwd_err, "ms": k2_ms["k2_fwd_ms"],
         "plain_ms": k2_ms["k2_fwd_plain_ms"]},
        {"name": "K2-bwd", "route": "cuda", "source": K2_SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_dopri_pallas.py:295",
         "launches": k2_total["bwd"], "max_abs_err": k2_bwd_err, "ms": k2_ms["k2_bwd_ms"],
         "plain_ms": k2_ms["k2_bwd_plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    start = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s", file=sys.stderr)
