"""The host side of the team backward kernels (``csrc/cde_dopri.cuh``, "The
backward in teams"), shared by K2 (``fused_dopri_kernel.py``) and K9
(``fused_dopri_persample_kernel.py``): the launch plan, and the padded
weights and per-team weight-gradient partials that the plan sizes.

A wrapper asks for the plan once per launch (``team_plan``), sizes its
tensors from it and passes the plan's slots and row length to the kernel's
entry, which checks them against its own plan before it launches.
"""

import ctypes
import functools

import torch

from .. import _build

PLAN_KEYS = ("teams_per_block", "blocks", "slots", "outputs_per_thread", "shared_weights",
             "shared_bytes", "row")


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_team_declared", False):
        i = ctypes.c_int
        lib.fd_team_plan.argtypes = [i] * 4 + [ctypes.POINTER(ctypes.c_long)]
        lib.fd_team_plan.restype = i
        lib.fd_error_string.argtypes = [i]
        lib.fd_error_string.restype = ctypes.c_char_p
        lib._team_declared = True
    return lib


def team_plan(B, H, C, W):
    """The team backward's launch for these shapes, as a dict (``PLAN_KEYS``):
    teams per block, blocks, slots of the partials, outputs a thread carries
    at once, weights and accumulators in shared memory, the bytes of shared
    memory a block takes, and the padded row length of the weights and
    partials."""
    lib = _library()
    out = (ctypes.c_long * len(PLAN_KEYS))()
    rc = lib.fd_team_plan(B, H, C, W, out)
    if rc != 0:
        raise RuntimeError(f"no team backward for B {B}, H {H}, C {C}, W {W}: "
                           f"{lib.fd_error_string(rc).decode()} (code {rc})")
    return dict(zip(PLAN_KEYS, out))


def _round4(n):
    return (n + 3) // 4 * 4


def team_weights(w1t, b1, w2t, b2, row):
    """The weights padded as the team backward reads them: w1 (H4, row) with
    w1[h, w] = w1t[w, h], b1 (row,), w2 (CH4, row), b2 (CH4,), zero outside
    the field's (H4, CH4: H and C*H rounded up to a multiple of 4)."""
    (W, H), CH = w1t.shape, w2t.shape[0]
    w1 = w1t.new_zeros((_round4(H), row))
    w1[:H, :W] = w1t.t()
    w2 = w2t.new_zeros((_round4(CH), row))
    w2[:CH, :W] = w2t
    b1p, b2p = b1.new_zeros(row), b2.new_zeros(_round4(CH))
    b1p[:W], b2p[:CH] = b1, b2
    return w1, b1p, w2, b2p


def team_partials(slots, H, C, row, dtype, device):
    """The zeroed weight-gradient partials of a team backward launch, one
    slot per team: dw1 (slots, H, row), db1 (slots, row), dw2 (slots, C*H,
    row), db2 (slots, C*H rounded up to a multiple of 4)."""
    zeros = functools.partial(torch.zeros, dtype=dtype, device=device)
    return (zeros((slots, H, row)), zeros((slots, row)), zeros((slots, C * H, row)),
            zeros((slots, _round4(C * H))))


def sum_team_partials(dw1p, db1p, dw2p, db2p, W):
    """(dw1t (W, H), db1, dw2t (C*H, W), db2): the partials summed over their
    slots, in order, and cut to the field's widths."""
    return (dw1p.sum(0)[:, :W].t(), db1p.sum(0)[:W], dw2p.sum(0)[:, :W],
            db2p.sum(0)[:dw2p.shape[1]])
