"""Natural cubic splines and the cubic spline control path.

Port of ``torchcde_tpu/interpolation/cubic.py``.  ``natural_cubic_coeffs``
fits a natural cubic spline through each channel, NaN-masked where values
are missing: channels act as a batch dimension, the length axis is last.

* Without missing values (``_natural_cubic_coeffs_dense``) the knot
  derivatives solve one tridiagonal system per row (``ops.tridiagonal``: K4
  on the card).
* With missing values the fit runs over the observed knots of each row in
  place on the full grid: endpoint imputation (``_impute_endpoints``),
  next-/previous-observed fills (``ops.fill``: K3 on the card), the gappy
  Thomas solve (``_masked_solve``: K5 on the card), the spline algebra and
  the re-basing of each observed knot's polynomial onto every grid
  interval.  On the card the whole forward is one kernel, K6/K7
  (``ops/masked_cubic_kernel.py``); its gradient differentiates the plain
  pipeline (``_masked_coeffs_plain``), recomputed, as the JAX package does.

``CubicSpline`` evaluates any packed cubic coefficients, natural or Hermite.
"""

import numpy as np
import torch

from ..ops.fill import fill_dispatch, masked_fill
from ..ops.tridiagonal import tridiagonal_solve
from ..utils.misc import numpy_dtype, stack_endpoints, validate_input_path
from .base import InterpolationBase


def _take(x, index):
    """``jnp.take(x, index, axis=-2)``: index (any shape) along the knot axis."""
    picked = torch.index_select(x, -2, index.reshape(-1))
    return picked.reshape(x.shape[:-2] + index.shape + x.shape[-1:])


def _time_dtype(dtype):
    """The dtype a tensor time is located in: the coefficients', float32 for
    half-precision coefficients (whose dtype cannot tell knot 1023 from 1024),
    as the host integrator plans their solves in float32."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _knot(grid, index):
    """``grid[index]`` of the 1-D knot times, as an index_select: the
    per-sample adjoint differentiates it per lane (``torch.func.vjp`` under
    ``vmap``), which advanced indexing does not take."""
    return torch.index_select(grid, 0, index.reshape(-1)).reshape(index.shape)


def _spline_algebra(x, kd, hr, six_pd_hr):
    """Shared coefficient algebra (reference interpolation_cubic.py:44-51).

    x: knot values (..., k); kd: knot derivatives (..., k); hr: reciprocal
    knot spacings (..., k - 1); six_pd_hr is 6 * (x[i+1] - x[i]) * hr.
    Returns (a, b, two_c, three_d), each (..., k - 1)."""
    a = x[..., :-1]
    b = kd[..., :-1]
    two_c = (six_pd_hr - 4 * kd[..., :-1] - 2 * kd[..., 1:]) * hr
    three_d = (-six_pd_hr + 3 * (kd[..., :-1] + kd[..., 1:])) * hr * hr
    return a, b, two_c, three_d


def _natural_cubic_coeffs_dense(t, x):
    """No-missing-values natural spline on (..., length), length last; t is
    a tensor of x's dtype.  The length-2 case needs no branch: the system
    degenerates to the straight line."""
    h = t[1:] - t[:-1]
    hr = 1.0 / h
    six_pd = 6 * (x[..., 1:] - x[..., :-1])
    six_pd_hr = six_pd * hr
    pds = 0.5 * six_pd_hr * hr  # = 3 * path_diffs * hr^2

    zeros_off = torch.zeros(hr.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    diag = 2 * (torch.cat([zeros_off, hr], dim=-1) + torch.cat([hr, zeros_off], dim=-1))
    z = torch.zeros(pds.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    rhs = torch.cat([pds, z], dim=-1) + torch.cat([z, pds], dim=-1)

    kd = tridiagonal_solve(rhs, hr, diag, hr)
    return _spline_algebra(x, kd, hr, six_pd_hr)


def _masked_thomas_observed(diag, rhs, hr, hr_prev, observed):
    """The plain version of K5: Thomas solve of the 'gappy' tridiagonal
    system living at the observed positions of the full grid.

    The reduced natural-spline system couples consecutive observed knots;
    the forward sweep and the back substitution walk the full grid and pass
    the carry through missing rows.  All arrays (..., length); the coupling
    between an observed knot and its next observed neighbour is hr (at the
    earlier knot); hr_prev is hr carried from the previous observed
    position.  Returns x, zero at missing positions."""
    length = diag.shape[-1]
    one, zero = torch.ones_like(diag[..., 0]), torch.zeros_like(diag[..., 0])
    prev_d, prev_b = one, zero
    nds, nbs = [], []
    for i in range(length):
        o_i, hp_i = observed[..., i], hr_prev[..., i]
        w = hp_i / prev_d
        prev_d = torch.where(o_i, diag[..., i] - w * hp_i, prev_d)
        prev_b = torch.where(o_i, rhs[..., i] - w * prev_b, prev_b)
        nds.append(torch.where(o_i, prev_d, one))
        nbs.append(torch.where(o_i, prev_b, zero))
    x_next, xs = zero, []
    for i in range(length - 1, -1, -1):
        o_i = observed[..., i]
        x_i = (nbs[i] - hr[..., i] * x_next) / nds[i]
        x_next = torch.where(o_i, x_i, x_next)
        xs.append(torch.where(o_i, x_i, zero))
    return torch.stack(xs[::-1], dim=-1)


class _MaskedSolve(torch.autograd.Function):
    """The gappy solve with the JAX package's custom VJP (cubic.py:134-173).
    Both solves go through ``masked_thomas_kernel``: K5 for CUDA
    float32/bfloat16 operands, the plain ``_masked_thomas_observed``
    otherwise (``ops/dispatch.py``'s rule).

    The reduced system is symmetric (A_ij = A_ji = hr at the earlier observed
    knot), so the transpose solve reuses the same bands:
        y = A^{-1} g;  d_bar = -y x;  hr_bar_i = -y_i x_nextobs;
        hr_prev_bar_i = -y_i x_prevobs.
    Callers pass hr_prev = the previous-observed fill of hr, as the fit
    does; the split of the coupling gradient between hr and hr_prev then
    differs from differentiating the scan, but their total through the fill
    is the same."""

    @staticmethod
    def forward(ctx, diag, rhs, hr, hr_prev, observed):
        from ..ops.masked_tridiagonal_kernel import masked_thomas_kernel

        x = masked_thomas_kernel(diag, rhs, hr, hr_prev, observed)
        ctx.save_for_backward(diag, hr, hr_prev, observed, x)
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        from ..ops.masked_tridiagonal_kernel import masked_thomas_kernel

        diag, hr, hr_prev, observed, x = ctx.saved_tensors
        y = masked_thomas_kernel(diag, g.contiguous(), hr, hr_prev, observed)
        (xf,) = fill_dispatch((x,), observed, -1, False)
        (xb,) = fill_dispatch((x,), observed, -1, True)
        zero = torch.zeros_like(x[..., :1])
        x_prev = torch.cat([zero, xf[..., :-1]], dim=-1)
        x_next = torch.cat([xb[..., 1:], zero], dim=-1)
        obs_f = observed.to(x.dtype)
        return (-y * x * obs_f, y * obs_f, -y * x_next * obs_f, -y * x_prev * obs_f, None)


def _impute_endpoints(x, version):
    """Endpoint imputation (interpolation_cubic.py:101-131): version 0
    replaces only a missing first/last entry with the nearest observation;
    version 1 fills forward/backward from the first/last observation.
    Interior NaNs stay missing either way."""
    length = x.shape[-1]
    observed = ~torch.isnan(x)
    pos = torch.arange(length, device=x.device)
    obs_int = observed.to(torch.uint8)
    first_idx = torch.argmax(obs_int, dim=-1, keepdim=True)
    last_idx = (length - 1) - torch.argmax(torch.flip(obs_int, [-1]), dim=-1, keepdim=True)
    v_first = torch.gather(x, -1, first_idx)
    v_last = torch.gather(x, -1, last_idx)
    if version == 0:
        x = torch.where((pos == 0) & ~observed, v_first, x)
        x = torch.where((pos == length - 1) & ~observed, v_last, x)
    else:
        x = torch.where(pos < first_idx, v_first, x)
        x = torch.where(pos > last_idx, v_last, x)
    return x


def _masked_coeffs_plain(t, x):
    """The post-imputation masked fit as tensor ops (fills, gappy solve,
    re-basing): the plain pipeline, and the path the fused fit's gradient
    differentiates.  t (length,) of x's dtype; x (..., length) with NaNs.
    Returns (a, b, two_c, three_d), each (..., length - 1)."""
    observed = ~torch.isnan(x)
    x_safe = torch.where(observed, x, torch.zeros_like(x))
    t_b = t.expand(x.shape)

    # Next observed (value, time) strictly after each position.
    xn_inc, tn_inc = masked_fill((x_safe, t_b), observed, axis=-1, reverse=True)
    pad_t = tn_inc[..., -1:] + 1  # sentinel: no later observation
    xn = torch.cat([xn_inc[..., 1:], xn_inc[..., -1:]], dim=-1)
    tn = torch.cat([tn_inc[..., 1:], pad_t], dim=-1)

    # An interval starts at an observed position that has a later observation.
    later_obs = torch.flip(torch.cumsum(torch.flip(observed.to(torch.int32), [-1]), -1), [-1])
    has_next = observed & (later_obs > 1)

    h = tn - t_b
    hr = torch.where(has_next, 1.0 / torch.where(has_next, h, torch.ones_like(h)), 0.0)
    six_pd_hr = 6 * (xn - x_safe) * hr
    pds = 0.5 * six_pd_hr * hr

    # Previous-observed-interval quantities, forward-filled exclusively.
    hr_f, pds_f = masked_fill((hr, pds), observed, axis=-1)
    zero_col = torch.zeros_like(hr[..., :1])
    hr_prev = torch.cat([zero_col, hr_f[..., :-1]], dim=-1)
    pds_prev = torch.cat([zero_col, pds_f[..., :-1]], dim=-1)

    diag = 2 * (hr_prev + hr)
    diag = torch.where(observed & (diag > 0), diag, torch.ones_like(diag))
    rhs = pds_prev + pds

    kd = _MaskedSolve.apply(diag, rhs, hr, hr_prev, observed)

    # kd at the next observed knot (strictly after).
    kdn_inc = masked_fill(kd, observed, axis=-1, reverse=True)
    kdn = torch.cat([kdn_inc[..., 1:], kdn_inc[..., -1:]], dim=-1)

    two_c0 = (six_pd_hr - 4 * kd - 2 * kdn) * hr
    three_d0 = (-six_pd_hr + 3 * (kd + kdn)) * hr * hr

    # Re-base the polynomial of the last observed knot at or before each
    # grid interval onto that interval.
    a_k, b_k, two_c_k, three_d_k, t_obs = (
        v[..., :-1] for v in masked_fill((x_safe, kd, two_c0, three_d0, t_b), observed, axis=-1))
    offset = t_obs - t_b[..., :-1]

    a = a_k + ((0.5 * two_c_k - three_d_k * offset / 3) * offset - b_k) * offset
    b = b_k + (three_d_k * offset - two_c_k) * offset
    two_c = two_c_k - 2 * three_d_k * offset
    return a, b, two_c, three_d_k


def _masked_fit_plain(t, x, version):
    """The plain version of K6/K7: imputation, then the masked pipeline."""
    return _masked_coeffs_plain(t, _impute_endpoints(x, version))


class _MaskedFitFused(torch.autograd.Function):
    """The fused fit (K6/K7) on raw values, for the kernel's operands only
    (``masked_natural_cubic`` decides); its backward differentiates the
    plain pipeline, recomputed (cubic.py:308-332: the fit is offline
    preprocessing, so the forward's speed is what matters).  The pipeline's
    fills and solve run as K3 and K5 there."""

    @staticmethod
    def forward(ctx, version, t, x):
        from ..ops.masked_cubic_kernel import fit_on_card

        ctx.version = version
        ctx.save_for_backward(t, x)
        return fit_on_card(t, x, version)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        t, x = ctx.saved_tensors
        need_t, need_x = ctx.needs_input_grad[1:3]
        with torch.enable_grad():
            t_ = t.detach().requires_grad_(need_t)
            x_ = x.detach().requires_grad_(need_x)
            outs = _masked_coeffs_plain(t_, _impute_endpoints(x_, ctx.version))
            inputs = [v for v, need in ((t_, need_t), (x_, need_x)) if need]
            got = iter(torch.autograd.grad(outs, inputs, grads, allow_unused=True))
        return None, next(got) if need_t else None, next(got) if need_x else None


def _natural_cubic_coeffs_masked(t, x, version):
    """NaN-aware natural spline on (..., length), length last: K6/K7 for
    CUDA float32/bfloat16 values, the plain version otherwise.  Channels
    without any observation give the constant zero path
    (interpolation_cubic.py:85-92)."""
    from ..ops.masked_cubic_kernel import masked_natural_cubic

    any_obs = (~torch.isnan(x)).any(dim=-1, keepdim=True)
    a, b, two_c, three_d = masked_natural_cubic(t, x, version)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    return tuple(torch.where(any_obs, v, zero) for v in (a, b, two_c, three_d))


def _natural_cubic_spline_coeffs(x, t, version):
    t = validate_input_path(x, t)
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(t)
    t = t.to(dtype=x.dtype, device=x.device)

    # Channels act as a batch dimension for fitting (interpolation_cubic.py:177).
    xT = x.transpose(-1, -2)
    # One host sync; coefficient construction is offline preprocessing.
    if bool(torch.isnan(x).any()):
        coeffs = _natural_cubic_coeffs_masked(t, xT, version)
    else:
        coeffs = _natural_cubic_coeffs_dense(t, xT)

    # Pack as (..., length - 1, 4 * channels) in the reference's
    # cat([a, b, two_c, three_d], -1) channel layout.
    coeffs = torch.stack(coeffs, dim=-3)  # (..., 4, C, L - 1)
    coeffs = torch.movedim(coeffs, -1, -3)  # (..., L - 1, 4, C)
    return coeffs.reshape(coeffs.shape[:-2] + (coeffs.shape[-2] * coeffs.shape[-1],))


def natural_cubic_spline_coeffs(x, t=None):
    """DEPRECATED; kept for API parity (interpolation_cubic.py:193-230).

    Endpoint NaNs are imputed with the nearest observation (version 0).
    Returns coefficients (..., length - 1, 4 * channels) for ``CubicSpline``."""
    return _natural_cubic_spline_coeffs(x, t, version=0)


def natural_cubic_coeffs(x, t=None):
    """Natural cubic spline coefficients (interpolation_cubic.py:233-265).

    x: (..., length, channels), NaNs mark missing values; t: optional 1-D
    strictly increasing times (defaults to 0..length-1).  Returns a tensor
    (..., length - 1, 4 * channels) on x's device, to be passed to
    ``CubicSpline``.  On the card the fit runs as CUDA kernels (K4 without
    missing values, K6/K7 with them; K3 and K5 in the gradient)."""
    return _natural_cubic_spline_coeffs(x, t, version=1)


class CubicSpline(InterpolationBase):
    """Evaluates packed cubic coefficients (..., n_intervals, 4 * channels).

    The default grid is the host NumPy constant t = [0, 1, ..., n_intervals]:
    coefficients have one row per interval, so this is
    linspace(0, n, n + 1).
    """

    def __init__(self, coeffs, t=None):
        if t is None:
            t = np.linspace(
                0, coeffs.shape[-2], coeffs.shape[-2] + 1, dtype=numpy_dtype(coeffs.dtype)
            )
        elif not isinstance(t, np.ndarray):
            t = torch.as_tensor(t)

        channels = coeffs.shape[-1] // 4
        if channels * 4 != coeffs.shape[-1]:
            raise ValueError("Passed invalid coeffs.")
        self._t = t
        self._a = coeffs[..., :channels]
        self._b = coeffs[..., channels : 2 * channels]
        self._two_c = coeffs[..., 2 * channels : 3 * channels]
        self._three_d = coeffs[..., 3 * channels :]

    @property
    def grid_points(self):
        return self._t

    @property
    def interval(self):
        return stack_endpoints(self._t)

    def _interpret_t(self, t):
        """(fractional part, interval index) of t, broadcast against channels.

        A host scalar time on the host grid is located on the host: the
        fixed-step solvers and the model's initial value evaluate at such
        times, and a host-to-device copy there would stall the host on the
        device's queue."""
        maxlen = self._b.shape[-2] - 1
        if isinstance(self._t, np.ndarray) and not isinstance(t, torch.Tensor) and np.ndim(t) == 0:
            tv = self._t.dtype.type(t)
            index = int(np.clip(np.searchsorted(self._t, tv, side="left") - 1, 0, maxlen))
            return float(tv - self._t[index]), index
        work = _time_dtype(self._b.dtype)
        t = torch.as_tensor(t, dtype=work, device=self._b.device)
        grid = torch.as_tensor(self._t, dtype=work, device=self._b.device)
        index = torch.searchsorted(grid, t.detach(), side="left") - 1
        index = torch.clamp(index, 0, maxlen)
        fractional_part = (t - _knot(grid, index)).to(self._b.dtype)
        return fractional_part[..., None], index

    @staticmethod
    def _pick(x, index):
        return x[..., index, :] if isinstance(index, int) else _take(x, index)

    def evaluate(self, t):
        fractional_part, index = self._interpret_t(t)
        inner = 0.5 * self._pick(self._two_c, index) + self._pick(self._three_d, index) * fractional_part / 3
        inner = self._pick(self._b, index) + inner * fractional_part
        return self._pick(self._a, index) + inner * fractional_part

    def derivative(self, t):
        fractional_part, index = self._interpret_t(t)
        inner = self._pick(self._two_c, index) + self._pick(self._three_d, index) * fractional_part
        return self._pick(self._b, index) + inner * fractional_part


class NaturalCubicSpline(CubicSpline):
    """DEPRECATED alias (interpolation_cubic.py:339-346)."""
