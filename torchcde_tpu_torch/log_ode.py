"""The log-ODE method: the windowed logsignature transform of long series.

Port of ``torchcde_tpu/log_ode.py``: compress a long series into
``length / window`` steps of ``logsignature_channels(c, depth)`` channels
each (``ops.logsignature``), ready for ``linear_interpolation_coeffs`` and a
Neural CDE over ``LinearInterpolation`` (a Neural RDE).

Offline preprocessing.  The time grid and the window plan are built on the
host; the values stay on x's device, where rows inserted at window
boundaries are blended (or, with missing values, filled by the NaN infill,
whose fills run as K3 on the card).
"""

import math

import numpy as np
import torch

from .interpolation.linear import linear_interpolation_coeffs
from .ops.logsignature import logsignature_channels, windowed_logsignatures
from .utils.misc import host_array, numpy_dtype, validate_input_path


def _merge_window_grid(t_np, window_length):
    """Builds the window-boundary grid and merges it into the data times.

    Mirrors log_ode.py:18-38: boundaries at t0 + k*window_length (the last
    one clamped to t[-1]); boundaries already (nearly) present in ``t`` are
    not duplicated.  Returns (merged_times, boundary_positions, new_t)."""
    t0, t_last = t_np[0], t_np[-1]
    num_pieces = int(math.ceil((t_last - t0) / window_length - 1e-12))
    end_t = t0 + num_pieces * window_length
    new_t = np.linspace(t0, end_t, num_pieces + 1)
    new_t = np.minimum(new_t, t_np.max())

    # Walking t for each boundary until new_t_elem <= t[i] or
    # allclose(new_t_elem, t[i]), vectorised: the stop index is the first t
    # at least new_t - allclose's tolerance.
    tol = 1e-8 + 1e-5 * np.abs(new_t)
    t_index = np.searchsorted(t_np, new_t - tol, side="left")
    t_index = np.minimum(t_index, len(t_np) - 1)
    close = np.isclose(new_t, t_np[t_index])
    inserts_before = np.concatenate([[0], np.cumsum(~close)[:-1]])
    boundary_positions = t_index + inserts_before
    insert_times = new_t[~close]

    if insert_times.size:
        merged = np.sort(np.concatenate([t_np, insert_times]))
    else:
        merged = t_np
    return merged, np.asarray(boundary_positions, dtype=np.int64), new_t


def _insert_rows(x, t_np, merged_t, blend):
    """x with rows at the merged grid's new times: blended linearly between
    their neighbours (``blend``), else NaN for the infill to fill.  Tensor
    ops on x's device; only the plan is made on the host."""
    insert_mask = ~np.isin(merged_t, t_np)
    ins_t = merged_t[insert_mask]
    length = x.shape[-2]
    if blend:
        j = np.clip(np.searchsorted(t_np, ins_t, side="right") - 1, 0, t_np.shape[0] - 2)
        frac = ((ins_t - t_np[j]) / (t_np[j + 1] - t_np[j])).astype(numpy_dtype(x.dtype))
        frac = torch.from_numpy(frac).to(x.device)[:, None]
        lo = torch.index_select(x, -2, torch.from_numpy(j).to(x.device))
        hi = torch.index_select(x, -2, torch.from_numpy(j + 1).to(x.device))
        inserted = (1 - frac) * lo + frac * hi
    else:
        inserted = x.new_full(x.shape[:-2] + (ins_t.shape[0], x.shape[-1]), math.nan)
    order = np.empty(merged_t.shape[0], dtype=np.int64)
    order[~insert_mask] = np.arange(length)
    order[insert_mask] = length + np.arange(ins_t.shape[0])
    rows = torch.cat([x, inserted], dim=-2)
    return torch.index_select(rows, -2, torch.from_numpy(order).to(x.device))


def _logsignature_windows(x, depth, window_length, t, _version):
    if not isinstance(depth, int) or depth < 1:
        raise ValueError(f"depth must be a positive integer, got {depth!r}")
    if not float(window_length) > 0:
        raise ValueError(f"window_length must be positive, got {window_length!r}")
    t = validate_input_path(x, t)
    # The JAX package refuses traced inputs here ("requires concrete
    # inputs"); PyTorch has no tracer, so every input is concrete.
    if isinstance(t, torch.Tensor):
        t = host_array(t)
    t_np = np.asarray(t, dtype=np.float64)
    merged_t, boundaries, new_t = _merge_window_grid(t_np, float(window_length))

    # Rows go in at the new times, filled linearly: that is what signatures
    # do between observations anyway (log_ode.py:47-49).  NaN-free data is
    # blended right away; data with missing values takes the NaN infill.
    needs_infill = bool(torch.isnan(x).any())  # one host sync: offline
    if merged_t.shape[0] != t_np.shape[0]:
        x = _insert_rows(x, t_np, merged_t, blend=not needs_infill)
    if needs_infill:
        x = linear_interpolation_coeffs(x, merged_t.astype(numpy_dtype(x.dtype)))

    channels = x.shape[-1]
    n_logsig = logsignature_channels(channels, depth)
    logsigs = windowed_logsignatures(x, depth, boundaries)
    if _version == 0:
        widths = torch.from_numpy(new_t[1:] - new_t[:-1]).to(dtype=x.dtype, device=x.device)
        logsigs = logsigs * widths[..., :, None]

    # The first "increment" carries the initial position X(t0), padded into
    # the logsignature channels (log_ode.py:53-55).
    pad = x.new_zeros(x.shape[:-2] + (1, n_logsig - channels))
    first = torch.cat([x[..., :1, :], pad], dim=-1)
    out = torch.cumsum(torch.cat([first, logsigs], dim=-2), dim=-2)
    if _version == 0:
        return out, torch.from_numpy(new_t).to(dtype=x.dtype, device=x.device)
    return out


def logsignature_windows(x, depth, window_length, t=None):
    """DEPRECATED: kept for API parity (reference log_ode.py:80-107).

    Returns (values, times); window logsignatures are rescaled by window
    width (_version=0)."""
    return _logsignature_windows(x, depth, window_length, t, _version=0)


def logsig_windows(x, depth, window_length, t=None):
    """Windowed logsignature transform (reference log_ode.py:110-133).

    x: (..., length, channels) with NaNs for missing values; depth: the
    signature truncation depth; window_length: the time span of a window;
    t: optional 1-D times.  Returns values (..., n_windows + 1,
    logsignature_channels) on x's device, on an implicit 0..n grid, ready
    for ``linear_interpolation_coeffs``."""
    return _logsignature_windows(x, depth, window_length, t, _version=1)
