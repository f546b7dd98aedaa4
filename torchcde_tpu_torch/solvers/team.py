"""The host side of the team kernels (``csrc/cde_dopri.cuh``, "The forward
in teams" and "The backward in teams"), shared by K2
(``fused_dopri_kernel.py``) and K9 (``fused_dopri_persample_kernel.py``):
the launch plans, the padded weights that both directions read, and the
backward's per-team weight-gradient partials.

A solve pads its weights once (``team_weights``) and hands them to every
forward and backward launch of its chunks and groups.  A wrapper asks for
its plan once per launch (``team_forward_plan``, ``team_plan``), sizes its
tensors from it and passes the plan's blocks or slots and the row length to
the kernel's entry, which checks them against its own plan before it
launches.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

PLAN_KEYS = ("teams_per_block", "blocks", "slots", "outputs_per_thread", "shared_weights",
             "shared_bytes", "row")
FORWARD_PLAN_KEYS = ("teams_per_block", "blocks", "lanes_per_team", "outputs_per_thread",
                     "shared_weights", "shared_bytes", "row", "scratch_floats", "row_per_thread")


def _library():
    lib = _build.load_library()
    if not getattr(lib, "_team_declared", False):
        i, out = ctypes.c_int, ctypes.POINTER(ctypes.c_long)
        for entry in (lib.fd_team_plan, lib.fd_forward_plan, lib.ps_forward_plan):
            entry.argtypes = [i] * 4 + [out]
            entry.restype = i
        lib.fd_error_string.argtypes = [i]
        lib.fd_error_string.restype = ctypes.c_char_p
        lib._team_declared = True
    return lib


def _plan(entry, keys, what, B, H, C, W):
    lib = _library()
    out = (ctypes.c_long * len(keys))()
    rc = getattr(lib, entry)(B, H, C, W, out)
    if rc != 0:
        raise RuntimeError(f"no team {what} for B {B}, H {H}, C {C}, W {W}: "
                           f"{lib.fd_error_string(rc).decode()} (code {rc})")
    return dict(zip(keys, out))


def team_plan(B, H, C, W):
    """The team backward's launch for these shapes, as a dict (``PLAN_KEYS``):
    teams per block, blocks, slots of the partials, outputs a thread carries
    at once, weights and accumulators in shared memory, the bytes of shared
    memory a block takes, and the padded row length of the weights and
    partials."""
    return _plan("fd_team_plan", PLAN_KEYS, "backward", B, H, C, W)


def team_forward_plan(B, H, C, W, cooperative):
    """The team forward's launch for these shapes, as a dict
    (``FORWARD_PLAN_KEYS``): teams per block, blocks, lanes each team walks,
    outputs a thread carries at once, weights in shared memory, the bytes of
    shared memory a block takes, the padded row length of the weights, the
    floats of the zeroed scratch, and whether the first layer takes one row
    per thread (W <= 32) rather than quads.  ``cooperative``: K2's launch, every
    block resident at once for the group norm (each team then walks as many
    lanes as residency needs); else K9's, a team per lane."""
    entry = "fd_forward_plan" if cooperative else "ps_forward_plan"
    return _plan(entry, FORWARD_PLAN_KEYS, "forward", B, H, C, W)


def _round4(n):
    return (n + 3) // 4 * 4


def team_row(W):
    """The padded row length of the weights and partials: W rounded up to an
    odd multiple of 4 (``cde_dopri.cuh``'s ``team_row``, which the kernels'
    entries check)."""
    r = _round4(W)
    return r if (r // 4) % 2 else r + 4


class TeamWeights(NamedTuple):
    """The field's weights padded as the team kernels read them, and its
    width."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    width: int


@torch.no_grad()
def team_weights(w1t, b1, w2t, b2):
    """The weights padded as the team kernels read them: w1 (H4, S) with
    w1[h, w] = w1t[w, h], b1 (S,), w2 (CH4, S), b2 (CH4,), zero outside the
    field's (H4, CH4: H and C*H rounded up to a multiple of 4; S =
    ``team_row(W)``), outside autograd."""
    (W, H), CH = w1t.shape, w2t.shape[0]
    row = team_row(W)
    w1 = w1t.new_zeros((_round4(H), row))
    w1[:H, :W] = w1t.t()
    w2 = w2t.new_zeros((_round4(CH), row))
    w2[:CH, :W] = w2t
    b1p, b2p = b1.new_zeros(row), b2.new_zeros(_round4(CH))
    b1p[:W], b2p[:CH] = b1, b2
    return TeamWeights(w1, b1p, w2, b2p, W)


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
