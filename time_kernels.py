"""Times the fused kernels (K1 in float32 and bfloat16, K2, K8, K9), the
fit's K6/K7, K4 and K5, and the flagship's, the default configuration's and
config 5's train steps and config 3's fits in one checkout.

    python3 time_kernels.py [ROOT] [--parts k2,k9,k8,k1,fit]

imports the port and its ``chip_smoke.py`` from the checkout at ROOT (by
default this script's directory), builds its kernels, and prints one JSON
line: the card's name and power limit, K2's forward and backward ms at the
default configuration at batch 4096 and 256 (as ``chip_smoke.py``'s phase 8
times them) with each mesh's accepted and attempted steps and the
forward's launch plan, the default train step's median ms at batch 4096
and 256 (CUDA events, 10 steps), K2's linear mode at config 4 (as phase
17 times it), K2 at phase 6's caps case (B 300, W 512, H 16, C 5), K9's
forward and backward ms per launch at the per-sample slice (as phase 24
times them; where the checkout has K9), the accepted steps of each timed
mesh (a backward's time follows them), K8's forward and backward at config
5's operands at hidden 8, 16 and 32 (as phase 20 times them) and at phase
18's two shapes whose weights stream through shared memory, with their
launch plans as the checkout reports them, config 5's train step in both
adjoint modes, K1's
forward and backward at the flagship's operands at hidden 8, 16 and 32 in
float32 and in bfloat16 (as phases 8 and 28 time them) with both launch
plans where the checkout reports them and the flagship's train step at
each (median of 10), K1 at each of ``chip_smoke.ODD_CASES`` and at the
flagship's widths at hidden 16 and batch 520 (float32, with both plans:
the small-batch shapes read the plan's lanes a block), K6/K7,
K4 and K5 at config 3 (as phase 13 times them; K5 on the operands of one
masked gradient's last launch, recorded as phase 11 records them), config
3's NaN-masked and dense fits' forwards and gradients through
``natural_cubic_coeffs``, K4, K5 and K6/K7 at the long-row shapes of
``LONG_SHAPES`` with each one's peak memory (K4's shared bands past 4096
also by the per-row cluster
route, where the checkout has it; K5 on the operands of one masked
gradient's last launch at its shape), the masked gradient at
``MASKED_GRAD_SHAPES`` with K5's share of it, and ptxas's report for each kernel of K1, K2, K4,
K5, K6/K7, K8 and K9 (registers, stack frame, spills).  ``--parts`` keeps some
of the groups (k2: K2 and the default steps, K2's linear mode and caps
case; k9; k8: K8 and config 5's step; k1: K1 and the flagship steps; fit:
K6/K7, K4, K5 and the fits).  To compare two commits on one card,
unpack both and run this for each on the same card, in turns: parent,
change, change, parent.  Needs one CUDA card.
"""

import json
import os
import re
import statistics
import sys
from unittest import mock

import torch


def ptxas_report(log, pattern=r"_kernel"):
    """{entry function: [ptxas lines]} for the entries matching pattern."""
    report, entry = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1) if re.search(pattern, found.group(1)) else None
        elif entry and ("stack frame" in line or "registers" in line or "spill" in line):
            report.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return report


def time_k2_linear(cs, device):
    """K2's linear mode at config 4: forward and backward ms of its one
    launch."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers import SolverConfig
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    x, _ = cs.log_ode_data(device, nan=False)
    X = tt.LinearInterpolation(tt.linear_interpolation_coeffs(
        tt.logsig_windows(x, cs.LOG_ODE_DEPTH, cs.LOG_ODE_WINDOW)))
    model = cs.log_ode_model(device)
    with torch.no_grad():
        z0 = model.initial(X.evaluate(X.interval[0]))
    (*ops, dt0, plan), = cs.recorded_k2_launches(X, model.func, z0, X.interval, SolverConfig())
    zout, zfin, _, store = k2.launch_forward(*ops, dt0, plan)
    gz, gzfin = torch.ones_like(zout), torch.ones_like(zfin)
    return {"k2_linear_fwd_ms": cs._event_ms(lambda: k2.launch_forward(*ops, dt0, plan), 3),
            "k2_linear_bwd_ms": cs._event_ms(
                lambda: k2.launch_backward(ops[0], store, gz, gzfin, *ops[2:], plan), 5),
            "k2_linear_steps_accepted": len(k2.read_mesh(store).t)}


def time_k2_caps(cs, device):
    """K2 at phase 6's caps case (B 300, length 30, W 512, H 16, C 5, cubic):
    forward and backward ms of its one launch."""
    import numpy as np

    from torchcde_tpu_torch.solvers import SolverConfig
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2

    X, field, z0 = cs.k2_problem(300, 30, 16, 5, 512, 6, device)
    (*ops, dt0, plan), = cs.recorded_k2_launches(X, field, z0, np.array([0.0, 29.0]),
                                                 SolverConfig())
    zout, zfin, _, store = k2.launch_forward(*ops, dt0, plan)
    gz, gzfin = torch.ones_like(zout), torch.ones_like(zfin)
    return {"k2_caps_fwd_ms": cs._event_ms(lambda: k2.launch_forward(*ops, dt0, plan), 5),
            "k2_caps_bwd_ms": cs._event_ms(
                lambda: k2.launch_backward(ops[0], store, gz, gzfin, *ops[2:], plan), 5),
            "k2_caps_steps_accepted": len(k2.read_mesh(store).t)}


def time_k9(cs, device):
    """K9's forward and backward ms per launch over the slice's launches."""
    from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9

    X, field, z0 = cs.per_sample_problem(device)
    calls = cs.recorded_k9_launches(X, field, z0, X.interval, None, {})
    launched = [(args, k9.launch_forward(*args)) for args in calls]

    def backward():
        for args, out in launched:
            k9.launch_backward(args[0], out[5], args[7], torch.ones_like(out[0]),
                               torch.ones_like(out[1]), *args[2:6], args[-1])

    n = len(calls)
    return {"k9_fwd_ms": cs._event_ms(lambda: [k9.launch_forward(*a) for a in calls], 3) / n,
            "k9_bwd_ms": cs._event_ms(backward, 3) / n,
            "k9_steps_accepted": int(sum(int(out[5][3].sum()) for _, out in launched))}


def k8_launch_plans(k8, B, H, C, W, plan, device):
    """K8's launch plans as the checkout reports them: the forward's and
    backward's plans (a checkout with one kernel per direction), or the
    variant and the backward's plan (a checkout with two variants)."""
    if hasattr(k8, "forward_plan"):
        return {"fwd_plan": k8.forward_plan(B, H, C, W),
                "bwd_plan": k8.backward_plan(B, H, C, W, device)}
    return {"variant": k8.kernel_variant(H, C, W, plan),
            "bwd_plan": k8.backward_plan(B, H, C, W, plan, device)}


def time_k8(cs, device):
    """K8's forward and backward ms at config 5's operands at hidden 8, 16
    and 32 (as phase 20 times them) and at phase 18's two shapes whose
    weights stream (the caps' H 100, C 5, W 512; H 16, C 5, W 512) with
    their launch plans and their plain versions' ms, and config 5's train
    step's median ms with the adjoint and with direct backpropagation
    (hidden 8)."""
    from torchcde_tpu_torch.models import make_train_step
    from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8

    timing = {}
    plan = k8._Plan(1, 1.0)
    for hidden in (8, 16, 32):
        model, coeffs, labels = cs.default_model(
            device, cs.CONFIG5_BATCH, config=dict(cs.CONFIG5, hidden_channels=hidden, adjoint=True))
        with torch.no_grad():
            p = cs.packed_operands(model, coeffs)
        ops = (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2)
        y, yhat = k8.launch_forward(*ops, plan)
        gy = torch.ones_like(y)
        key = f"k8_H{hidden}"
        timing[f"{key}_fwd_ms"] = cs._event_ms(lambda: k8.launch_forward(*ops, plan), 10)
        timing[f"{key}_bwd_ms"] = cs._event_ms(
            lambda: k8.launch_backward(p.ct, y, yhat, gy, *ops[2:], plan), 5)
        C, B = p.ct.shape[2], p.ct.shape[3]
        timing[f"{key}_plans"] = k8_launch_plans(k8, B, hidden, C, p.w1t.shape[0], plan, device)
    # Phase 18's shapes whose weights outgrow a block's shared memory.
    for B, n, H, C, W, m in ((300, 12, 100, 5, 512, 8), (520, 40, 16, 5, 512, 2)):
        ops = cs.random_operands(B, n, H, C, W, 0, device)
        shape_plan = k8._Plan(m, 1.0 / m)
        y, yhat = k8.launch_forward(*ops, shape_plan)
        gy = torch.ones_like(y)
        key = f"k8_B{B}_H{H}_C{C}_W{W}_m{m}"
        timing[f"{key}_fwd_ms"] = cs._event_ms(lambda: k8.launch_forward(*ops, shape_plan), 3)
        timing[f"{key}_bwd_ms"] = cs._event_ms(
            lambda: k8.launch_backward(ops[0], y, yhat, gy, *ops[2:], shape_plan), 3)
        timing[f"{key}_plans"] = k8_launch_plans(k8, B, H, C, W, shape_plan, device)
        with torch.no_grad():
            timing[f"{key}_fwd_plain_ms"] = cs._event_ms(
                lambda: k8.fused_reversible_solve_reference(*ops, m, 1.0 / m), 1)
            timing[f"{key}_bwd_plain_ms"] = cs._event_ms(
                lambda: k8.fused_reversible_backward_reference(ops[0], y, yhat, gy, *ops[2:], m,
                                                               1.0 / m), 1)
    model, coeffs, labels = cs.config5_problem(device, adjoint=True)
    for adjoint in (True, False):
        if not adjoint:
            model = cs.config5_problem(device, adjoint=False)[0]
        step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
        step(coeffs, labels)  # warm-up
        samples = [cs._once_ms(lambda: step(coeffs, labels)) for _ in range(10)]
        mode = "adjoint" if adjoint else "direct"
        timing[f"config5_{mode}_train_step_ms"] = statistics.median(samples)
        timing[f"config5_{mode}_train_step_samples_ms"] = samples
    return timing


def time_k2_default(cs, device, batch):
    """K2's forward and backward ms at the default configuration at this
    batch (its one launch), the mesh's accepted and attempted steps and,
    where the checkout has the team forward's plan, that plan."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.solvers import SolverConfig
    from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
    from torchcde_tpu_torch.solvers import team

    model, coeffs, _ = cs.default_model(device, batch)
    X = tt.CubicSpline(coeffs)
    with torch.no_grad():
        z0 = model.initial(X.evaluate(X.interval[0]))
    (*ops, dt0, plan), = cs.recorded_k2_launches(X, model.func, z0, X.interval, SolverConfig())
    zout, zfin, _, store = k2.launch_forward(*ops, dt0, plan)
    gz, gzfin = torch.ones_like(zout), torch.ones_like(zfin)
    mesh = k2.read_mesh(store)
    key = f"k2_default_B{batch}"
    timing = {f"{key}_fwd_ms": cs._event_ms(lambda: k2.launch_forward(*ops, dt0, plan), 5),
              f"{key}_bwd_ms": cs._event_ms(
                  lambda: k2.launch_backward(ops[0], store, gz, gzfin, *ops[2:], plan), 5),
              f"{key}_steps_accepted": len(mesh.t), f"{key}_steps_attempted": mesh.attempted}
    if not hasattr(k2, "kernel_variant"):  # every forward on the team kernel
        C, W = ops[0].shape[2], ops[2].shape[0]
        timing[f"{key}_fwd_plan"] = team.team_forward_plan(batch, z0.shape[-1], C, W, True)
    return timing


def step_ms(cs, model, coeffs, labels, count=10):
    """The median ms of count train steps (CUDA events), after one."""
    from torchcde_tpu_torch.models import make_train_step

    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
    step(coeffs, labels)  # warm-up
    return statistics.median(cs._once_ms(lambda: step(coeffs, labels)) for _ in range(count))


def time_k1_launches(k1, cs, ops, plan, mode, device, key, repeats=(10, 5)):
    """K1's forward and backward ms on ops under key, and both launch plans
    where the checkout reports them."""
    out, zres = k1.launch_forward(*ops, plan)
    gz = torch.ones_like(out)
    timing = {f"{key}_fwd_ms": cs._event_ms(lambda: k1.launch_forward(*ops, plan), repeats[0]),
              f"{key}_bwd_ms": cs._event_ms(
                  lambda: k1.launch_backward(ops[0], zres, ops[1], gz, *ops[2:], plan),
                  repeats[1])}
    shape = (ops[0].shape[3], ops[1].shape[0], ops[0].shape[2], ops[2].shape[0], plan, mode,
             device)
    for which, short in (("forward", "fwd"), ("backward", "bwd")):
        if hasattr(k1, f"{which}_plan"):
            timing[f"{key}_{short}_plan"] = getattr(k1, f"{which}_plan")(*shape)
    return timing


# The flagship's widths at hidden 16 and a batch of 520: 33 lane groups of
# its backward's 16 lanes, fewer than half the SMs.
SMALL_BATCH = (520, 40, 16, 3, 128, "rk4", 1, "all")


def time_k1(cs, device, coeffs, labels):
    """K1's forward and backward ms at the flagship's operands at hidden 8,
    16 and 32, float32 and bfloat16, with the launch plans where the
    checkout reports them, the flagship's train step at each, and K1 at
    each odd case of chip_smoke and at SMALL_BATCH (float32, random
    operands)."""
    from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1

    timing = {}
    for mode, (name, config) in enumerate((("k1", cs.FLAGSHIP), ("k1_bf16", cs.BF16_FLAGSHIP))):
        for hidden in (8, 16, 32):
            model = cs.make_model(device, config=dict(config, hidden_channels=hidden))
            with torch.no_grad():
                p = cs.packed_operands(model, coeffs)
            ops = (p.ct, p.z0t, p.w1t, p.b1, p.w2t, p.b2)
            plan = k1._Plan("rk4", 1, 1.0, (p.ct.shape[0],))
            key = name if hidden == 8 else f"{name}_H{hidden}"
            timing.update(time_k1_launches(k1, cs, ops, plan, mode, device, key))
            flagship = "flagship" if mode == 0 else "flagship_bf16"
            if hidden != 8:
                flagship += f"_H{hidden}"
            timing[f"{flagship}_train_step_ms"] = step_ms(cs, model, coeffs, labels)
    for seed, (B, n, H, C, W, method, m, which) in enumerate(cs.ODD_CASES + [SMALL_BATCH],
                                                             start=1):
        ops = cs.random_operands(B, n, H, C, W, seed, device)
        plan = k1._Plan(method, m, 1.0 / m, cs.knot_set(which, n))
        timing.update(time_k1_launches(k1, cs, ops, plan, 0, device,
                                       f"k1_B{B}_n{n}_H{H}_C{C}_W{W}_{method}_m{m}", (3, 3)))
    return timing


def recorded_k5_operands(grad_of, x):
    """The operands of the last K5 launch (the transpose solve) of one
    masked gradient of x, as phase 11 records them."""
    from torchcde_tpu_torch.ops import masked_tridiagonal_kernel as k5

    launch, recorded = k5.launch, []

    def record(*args):
        recorded.append(args)
        return launch(*args)

    with mock.patch.object(k5, "launch", record):
        grad_of(x)
    return recorded[-1]


def time_fit(cs, device):
    """K6/K7's, K4's and K5's ms at config 3 (one launch each, K6/K7 version
    1, K4 on the dense fit's shared system and K5 on the operands of one
    masked gradient's last launch, as phase 13 times them), config 3's
    NaN-masked fit forward and gradient and its dense fit's forward and
    gradient through ``natural_cubic_coeffs`` (CUDA events), and the
    kernels' plans where the checkout has them."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.ops import masked_cubic_kernel as mk
    from torchcde_tpu_torch.ops import masked_tridiagonal_kernel as k5
    from torchcde_tpu_torch.ops import tridiagonal_kernel as k4

    masked, dense = cs.config3_data()
    x = torch.from_numpy(masked).to(device)
    x2 = x[..., 0].contiguous()
    n, k = x2.shape
    t = torch.arange(k, dtype=torch.float32, device=device)
    hr = 1.0 / (t[1:] - t[:-1])
    zero = hr.new_zeros(1)
    diag = 2 * (torch.cat([zero, hr]) + torch.cat([hr, zero]))
    rhs = torch.randn((n, k), generator=torch.Generator(device=device).manual_seed(4),
                      device=device)
    # K4 takes ~0.17 ms a launch: 100 launches a mean, so that the launch
    # gaps' jitter stays under the 3 % that a redesign is held to.
    timing = {"k6_ms": cs._event_ms(lambda: mk.launch(t, x2, 1), 50),
              "k4_ms": cs._event_ms(lambda: k4.launch(rhs, hr, diag, hr), 100)}
    xd = torch.from_numpy(dense).to(device)
    w = torch.ones((n, k - 1, 4), device=device)

    def grad_of(values):
        xg = values.clone().requires_grad_()
        return torch.autograd.grad((tt.natural_cubic_coeffs(xg) * w).sum(), xg)

    solve_args = recorded_k5_operands(grad_of, x)
    timing["k5_ms"] = cs._event_ms(lambda: k5.launch(*solve_args), 50)
    with torch.no_grad():
        timing["masked_fit_ms"] = cs._event_ms(lambda: tt.natural_cubic_coeffs(x), 5)
        timing["dense_fit_ms"] = cs._event_ms(lambda: tt.natural_cubic_coeffs(xd), 5)
    timing["masked_fit_grad_ms"] = cs._event_ms(lambda: grad_of(x), 3)
    timing["dense_fit_grad_ms"] = cs._event_ms(lambda: grad_of(xd), 3)
    if hasattr(mk, "fit_plan"):
        timing["k6_plan"] = mk.fit_plan(k)._asdict()
    if hasattr(k4, "solve_plan"):
        timing["k4_plan"] = k4.solve_plan(k, True)._asdict()
    if hasattr(k5, "solve_plan"):
        timing["k5_plan"] = k5.solve_plan(k)._asdict()
    return timing


# The long rows' shapes: (key, kernel, rows, length); K4's bands per row
# ("rows": diagonally dominant, as chip_smoke.py's phase 10 draws them) or
# shared ("shared": the dense fit's system on unit times), K6/K7 on values
# with 20 % NaN, K5 on the operands of the masked gradient of such values.
# Lengths past 32 768 are past the clusters' reach.
LONG_SHAPES = (("k4_rows_8192x4096", "rows", 8192, 4096), ("k4_rows_2048x8192", "rows", 2048, 8192),
               ("k4_shared_2048x8192", "shared", 2048, 8192), ("k6_2048x8192", "k6", 2048, 8192),
               ("k6_2048x16384", "k6", 2048, 16384), ("k4_rows_2048x65536", "rows", 2048, 65536),
               ("k6_2048x65536", "k6", 2048, 65536), ("k6_2048x32769", "k6", 2048, 32769),
               ("k4_rows_2048x32769", "rows", 2048, 32769),
               ("k5_2048x8192", "k5", 2048, 8192), ("k5_2048x16384", "k5", 2048, 16384),
               ("k5_2048x65536", "k5", 2048, 65536), ("k4_shared_2048x65536", "shared", 2048, 65536))
# The masked fit's gradient through natural_cubic_coeffs, end to end (rows,
# length), timed where its K5 case is.
MASKED_GRAD_SHAPES = ((2048, 8192),)


def masked_values(n, k, device):
    """Values (n, k) with 20 % NaN, drawn on the card from a seed."""
    gen = torch.Generator(device=device).manual_seed(k)
    x = torch.randn((n, k), generator=gen, device=device)
    x[torch.rand((n, k), generator=gen, device=device) < 0.2] = float("nan")
    return x


def masked_grad(x):
    """The gradient of the masked fit's coefficients of x (n, k) (summed)
    through natural_cubic_coeffs: a call that runs it once."""
    import torchcde_tpu_torch as tt

    def grad_of(values):
        xg = values.clone().requires_grad_()
        return torch.autograd.grad(tt.natural_cubic_coeffs(xg).sum(), xg)

    return lambda: grad_of(x[..., None])


def long_operands(kind, n, k, device):
    """The operands of a LONG_SHAPES case, drawn on the card from a seed."""
    gen = torch.Generator(device=device).manual_seed(k)
    if kind == "k6":
        return (torch.arange(k, dtype=torch.float32, device=device), masked_values(n, k, device))
    if kind == "k5":
        return recorded_k5_operands(lambda x: masked_grad(x)(), masked_values(n, k, device))
    b = torch.randn((n, k), generator=gen, device=device)
    if kind == "shared":
        hr = torch.ones(k - 1, device=device)
        zero = hr.new_zeros(1)
        return b, hr, 2 * (torch.cat([zero, hr]) + torch.cat([hr, zero])), hr
    u = torch.randn((n, k - 1), generator=gen, device=device)
    l = torch.randn((n, k - 1), generator=gen, device=device)
    pad = u.new_zeros((n, 1))
    return b, u, 1.0 + torch.cat([u.abs(), pad], -1) + torch.cat([pad, l.abs()], -1), l


def peak_gb(fn):
    """The most device memory allocated while fn runs once (operands
    included), in GB: torch.cuda.max_memory_allocated after a reset."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def time_long_rows(cs, device):
    """K4's, K5's and K6/K7's ms at each of LONG_SHAPES (one launch each,
    K6/K7 version 1) with the route the checkout takes and the peak memory
    of one launch (peak_gb), K4's shared bands past 4096 by the per-row
    cluster route beside the shared one, and the masked gradient at
    MASKED_GRAD_SHAPES with the share of it that its two K5 launches
    take."""
    from torchcde_tpu_torch.ops import masked_cubic_kernel as mk
    from torchcde_tpu_torch.ops import masked_tridiagonal_kernel as k5
    from torchcde_tpu_torch.ops import tridiagonal_kernel as k4

    timing = {}
    for key, kind, n, k in LONG_SHAPES:
        ops = long_operands(kind, n, k, device)
        repeats = 3 if k > 32768 else 10
        if kind == "k6":
            run = lambda: mk.launch(*ops, 1)
            timing[f"{key}_ms"] = cs._event_ms(run, repeats)
            timing[f"{key}_plan"] = mk.fit_plan(k)._asdict()
        elif kind == "k5":
            run = lambda: k5.launch(*ops)
            timing[f"{key}_ms"] = cs._event_ms(run, repeats)
            timing[f"{key}_plan"] = k5.solve_plan(k)._asdict()
            if (n, k) in MASKED_GRAD_SHAPES:
                grad_ms = cs._event_ms(masked_grad(masked_values(n, k, device)), 3)
                timing[f"masked_fit_grad_{n}x{k}_ms"] = grad_ms
                timing[f"k5_share_of_masked_fit_grad_{n}x{k}"] = 2 * timing[f"{key}_ms"] / grad_ms
        else:
            run = lambda: k4.launch(*ops)
            timing[f"{key}_ms"] = cs._event_ms(run, repeats)
            timing[f"{key}_plan"] = k4.solve_plan(k, kind == "shared")._asdict()
        timing[f"{key}_peak_gb"] = peak_gb(run)
        if kind == "shared" and hasattr(k4, "pivot_positions") and k <= 32768:
            b, u, d, l = ops
            plan = k4.solve_plan(k, shared=False)
            x = torch.empty_like(b)
            operands = (b, u.reshape(1, -1), d.reshape(1, -1), l.reshape(1, -1))
            timing[f"{key}_per_row_cluster_ms"] = cs._event_ms(
                lambda: k4._kernel(plan, operands, x, (None, None), (n, k, k, 0, 0, 0)), repeats)
        del ops
        torch.cuda.empty_cache()
    return timing


PARTS = ("k2", "k9", "k8", "k1", "fit")


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--parts")]
    parts = PARTS
    for a in sys.argv[1:]:
        if a.startswith("--parts="):
            parts = tuple(a.split("=", 1)[1].split(","))
    root = os.path.abspath(args[0] if args else os.path.dirname(__file__))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from torchcde_tpu_torch import _build

    if not _build.__file__.startswith(root):
        raise SystemExit(f"time_kernels: imported the port from {_build.__file__}, not from {root}")
    smi, device = cs.phase_device()
    _path, seconds, log = _build.build()
    timing = {}
    if "k2" in parts:
        for batch in (4096, 256):
            timing.update(time_k2_default(cs, device, batch))
            timing[f"default_B{batch}_train_step_ms"] = step_ms(
                cs, *cs.default_model(device, batch))
        timing.update(time_k2_linear(cs, device))
        timing.update(time_k2_caps(cs, device))
    if "k9" in parts and hasattr(cs, "per_sample_problem"):
        timing.update(time_k9(cs, device))
    if "k8" in parts:
        timing.update(time_k8(cs, device))
    if "k1" in parts:
        _model, coeffs, labels = cs.default_model(device, 4096)
        timing.update(time_k1(cs, device, coeffs, labels))
    if "fit" in parts:
        timing.update(time_fit(cs, device))
        timing.update(time_long_rows(cs, device))
    print(json.dumps({"root": root, "card": smi, "build_s": seconds, "parts": list(parts),
                      **timing, "ptxas": ptxas_report(log)}), flush=True)


if __name__ == "__main__":
    main()
