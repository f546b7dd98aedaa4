"""dopri5's work: the model's FLOPs and K2's least times.

``K2`` is ``k2_bounds`` of ``chip_smoke.py:3828-3837``: per group of rows,
6 new stage evaluations per attempted step and one to start forward, 3
times the 7 stages of every accepted step backward; bytes are the control's
three coefficient rows, the accepted states and the state read and written.
The counts are those of the plain reference's own solve of the batch
(``reference/dopri5.py``), never the program's, so that a program that takes
more steps cannot read nearer its bound.  Model FLOPs count 6 evaluations
per accepted step.  ``names``: K2's kernels as the port's CUDA sources name
them (``csrc/fused_dopri.cu``).
"""

from cdebench.peaks import bound
from cdebench.work.rk4 import field_flops


def work(model, batch, length, counts):
    n, H, C = length - 1, model["hidden_channels"], model["input_channels"]
    f = field_flops(model)
    fwd_bytes = fwd_flops = bwd_bytes = bwd_flops = model_flops = 0
    for group in counts:
        rows, acc, att = group["rows"], group["accepted"], group["attempted"]
        ct_bytes = 4 * n * 3 * C * rows
        state = 4 * H * rows
        fwd_bytes += ct_bytes + state + 4 * acc * H * rows
        fwd_flops += (6 * att + 1) * rows * f
        bwd_bytes += 2 * ct_bytes + 4 * acc * H * rows + 2 * state
        bwd_flops += 3 * 7 * acc * rows * f
        model_flops += 6 * acc * rows * f
    if sum(group["rows"] for group in counts) != batch:
        raise ValueError("the counts do not cover the batch")
    fwd, fwd_by = bound(fwd_bytes, fwd_flops)
    bwd, bwd_by = bound(bwd_bytes, bwd_flops)
    return {"model_flops_fwd": model_flops,
            "kernels": {"K2": {"fwd_s": fwd, "fwd_by": fwd_by, "bwd_s": bwd, "bwd_by": bwd_by,
                               "names": ["dopri_fwd_team_kernel", "dopri_bwd_team_kernel"]}}}
