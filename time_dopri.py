"""Times the adaptive kernels K2 and K9 and the default configuration's
train step in one checkout.

    python3 time_dopri.py [ROOT]

imports the port and its ``chip_smoke.py`` from the checkout at ROOT (by
default this script's directory), builds its kernels, and prints one JSON
line: the card's name and power limit, K2's forward and backward ms at the
default configuration (batch 4096, the specialised forward, as
``chip_smoke.py``'s phase 8 times them), the train step's median ms at
batch 4096 (CUDA events, 20 steps), K2's linear mode at config 4 (as phase
17 times it), K2 at phase 6's caps case (B 300, W 512, H 16, C 5), K9's
forward and backward ms per launch at the per-sample slice (as phase 24
times them; where the checkout has K9), the accepted steps of each timed
mesh (a backward's time follows them), and ptxas's report for each kernel
of the two (registers, stack frame).  To compare two commits on one card,
unpack both and run this for each on the same card, in turns: parent,
change, change, parent.  Needs one CUDA card.
"""

import json
import os
import re
import sys

import torch


def ptxas_report(log, pattern=r"(dopri|ps)_(fwd|bwd)(_team)?_kernel"):
    """{entry function: [ptxas lines]} for the entries matching pattern."""
    report, entry = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1) if re.search(pattern, found.group(1)) else None
        elif entry and ("stack frame" in line or "registers" in line):
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


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(__file__))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from torchcde_tpu_torch import _build

    if not _build.__file__.startswith(root):
        raise SystemExit(f"time_dopri: imported the port from {_build.__file__}, not from {root}")
    smi, device = cs.phase_device()
    _path, seconds, log = _build.build()
    k2 = cs.time_k2(device)
    model, coeffs, labels = cs.default_model(device, 4096)
    medians, samples = cs.time_train_steps(model, coeffs, labels,
                                           cs.plain_k2_loss(coeffs, labels), counts=(10, 1))
    k2_linear = time_k2_linear(cs, device)
    k2_caps = time_k2_caps(cs, device)
    k9 = time_k9(cs, device) if hasattr(cs, "per_sample_problem") else {}
    print(json.dumps({"root": root, "card": smi, "build_s": seconds,
                      "k2_fwd_ms": k2["k2_fwd_ms"], "k2_bwd_ms": k2["k2_bwd_ms"],
                      "k2_steps_accepted": k2["k2_steps_accepted"],
                      "default_B4096_train_step_ms": medians["kernel"],
                      "default_B4096_train_step_samples_ms": samples["kernel"], **k2_linear,
                      **k2_caps, **k9, "ptxas": ptxas_report(log)}), flush=True)


if __name__ == "__main__":
    main()
