"""rk4's work: the model's FLOPs and K1's least times.

``k1`` is ``k1_bounds`` of ``chip_smoke.py:3811-3825`` (its docstring's
counts, ``fused_bounds``: the control's coefficient rows, the stored states
and the state read and written; 4 stage evaluations per substep forward, 3
times those backward), taken from chip_smoke's module constants to the
cell's batch, length and widths.  ``names``: K1's kernels as the port's
CUDA sources name them (``csrc/fused_fixed*.cu``).
"""

from cdebench.peaks import bound


def field_flops(model):
    """FLOPs of one field evaluation for one row: 2 W H (1 + C)."""
    return 2 * model["width"] * model["hidden_channels"] * (1 + model["input_channels"])


def work(model, batch, length, counts=None):
    n, H, C = length - 1, model["hidden_channels"], model["input_channels"]
    m = round(1.0 / float(model["step_size"]))  # substeps per unit interval
    f = field_flops(model)
    evaluations = 4 * m * n
    ct_bytes = 4 * n * 3 * C * batch
    state = 4 * H * batch
    states = 4 * n * H * batch
    fwd, fwd_by = bound(ct_bytes + state + states, evaluations * batch * f)
    bwd, bwd_by = bound(2 * ct_bytes + 2 * states + 2 * state, 3 * evaluations * batch * f)
    return {"model_flops_fwd": evaluations * batch * f,
            "kernels": {"K1": {"fwd_s": fwd, "fwd_by": fwd_by, "bwd_s": bwd, "bwd_by": bwd_by,
                               "names": ["fwd_slice_kernel", "bwd_slice_kernel"]}}}
