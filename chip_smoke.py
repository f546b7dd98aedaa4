"""Drives the PyTorch port's main path on one NVIDIA GPU and checks its kernels.

    python3 chip_smoke.py        (from the repository root; needs one CUDA card)

Phases, each of which raises on failure:

1. device: the card's name and power limit from nvidia-smi; TF32 off;
2. build: compiles torchcde_tpu_torch/csrc with nvcc;
3. K1 forward and 4. K1 backward: the CUDA kernels against their plain
   PyTorch version on the card, at the flagship shapes (in both kernel
   variants) and at odd cases covering every tableau, up to 8 substeps, odd
   batches and shapes at the JAX kernel's caps;
5. slice: five Adam steps of the spiral Neural CDE at the flagship
   configuration through the public entry points, with the kernels' launch
   counts read around that run, then one ``accuracy`` call;
6. timing: the kernels (both variants) and the train step against the plain
   version, by CUDA events;
7. profile: torch.profiler over three train steps: the device's busy share,
   kernels per step and the K1 kernels' share of device time.

The last line is the JSON object {"ok": true, "device": {...}}; the line
before it lists every kernel of the path.  Without a CUDA device the script
exits non-zero before building anything.
"""

import copy
import json
import math
import statistics
import subprocess
import sys
import time

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
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    path, seconds, log = _build.build()
    k1._library()
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


def time_train_steps(model, coeffs, labels):
    """Median train-step ms, kernel path and plain version, in turns."""
    from torchcde_tpu_torch.models import make_train_step
    from torchcde_tpu_torch.models.neural_cde import bce_with_logits

    kernel_model, plain_model = copy.deepcopy(model), copy.deepcopy(model)
    kernel_step = make_train_step(
        kernel_model, torch.optim.Adam(kernel_model.parameters(), lr=1e-3, eps=1e-8))
    plain_opt = torch.optim.Adam(plain_model.parameters(), lr=1e-3, eps=1e-8)

    def plain_step():
        plain_opt.zero_grad(set_to_none=True)
        bce_with_logits(plain_forward(plain_model, coeffs)[..., 0], labels).backward()
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
                5 if name == "kernel" else 2)
    return {k: statistics.median(v) for k, v in samples.items()}, samples


def profile_train_steps(model, coeffs, labels, steps=3):
    """torch.profiler over a few train steps: device busy share and launches."""
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
    k1_us = {kind: sum(e[1] - e[0] for e in kernels if kind in e[2]) for kind in ("fwd_kernel", "bwd_kernel")}
    return {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "device_kernels_per_step": len(kernels) / steps,
        "device_copies_per_step": (len(device) - len(kernels)) / steps,
        "k1_fwd_ms_per_step": k1_us["fwd_kernel"] / 1e3 / steps,
        "k1_bwd_ms_per_step": k1_us["bwd_kernel"] / 1e3 / steps,
    }


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

    # 5. The slice through the public entry points.
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

    # 6. Timing, and 7. the profile.
    kernel_ms, plain_fwd_ms, plain_bwd_ms = time_k1(model, coeffs)
    (fwd_ms, bwd_ms), generic_ms = kernel_ms["specialised"], kernel_ms["generic"]
    medians, samples = time_train_steps(model, coeffs, labels)
    print("timing: " + json.dumps({
        "card": smi, "train_step_ms": medians, "train_step_samples_ms": samples,
        "k1_fwd_ms": fwd_ms, "k1_fwd_plain_ms": plain_fwd_ms,
        "k1_bwd_ms": bwd_ms, "k1_bwd_plain_ms": plain_bwd_ms,
        "k1_fwd_generic_ms": generic_ms[0], "k1_bwd_generic_ms": generic_ms[1],
    }))
    print("profile: " + json.dumps(dict(profile_train_steps(model, coeffs, labels), card=smi)))
    print(json.dumps({"kernels": [
        {"name": "K1-fwd", "route": "cuda", "source": SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:182", "launches": launches["fwd"],
         "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": plain_fwd_ms},
        {"name": "K1-bwd", "route": "cuda", "source": SOURCE,
         "replaces": "torchcde_tpu/solvers/fused_pallas.py:265", "launches": launches["bwd"],
         "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": plain_bwd_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    start = time.perf_counter()
    main()
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s", file=sys.stderr)
