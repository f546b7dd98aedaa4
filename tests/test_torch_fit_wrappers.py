"""The Python around the fit's kernels, driven on the CPU with stand-ins.

The CUDA kernels run only on the card.  Here each kernel's ``launch`` is
replaced by its plain version and the dispatch rule is made to ignore the
device, so the wrappers' own code runs: the autograd Functions (K4's
transpose-solve VJP with broadcast bands, the fused fit's recomputed
gradient), the layouts around the launches, the bfloat16 upcast, and the
launch counts the card check asserts.  Against the plain path in float64:
values rtol 1e-12, gradients 1e-10 (the same formulas; the VJPs sum in
another order).
"""

import numpy as np
import pytest
import torch

import torchcde_tpu_torch as tt
from torchcde_tpu_torch.interpolation import cubic
from torchcde_tpu_torch.ops import (
    dispatch,
    fill,
    fill_kernel,
    masked_cubic_kernel,
    masked_tridiagonal_kernel,
    tridiagonal,
    tridiagonal_kernel,
)

torch.set_num_threads(1)

MODULES = {"K3": fill_kernel, "K4": tridiagonal_kernel, "K5": masked_tridiagonal_kernel,
           "K6/K7": masked_cubic_kernel}


@pytest.fixture
def stand_ins(monkeypatch):
    """Every float tensor 'runs the kernel'; each launch runs the plain
    version (with the rule restored inside K6/K7's, whose plain version is
    a pipeline of fills and solves) and counts."""
    real_rule = dispatch.runs_kernel
    rule = lambda *ts: all(t.is_floating_point() for t in ts if t.dtype != torch.bool)
    plain = {
        "K3": lambda values, observed, reverse: list(
            fill.masked_fill_scan(tuple(values), observed, -1, reverse)),
        "K4": tridiagonal.tridiagonal_solve_thomas,
        "K5": cubic._masked_thomas_observed,
    }

    def fit(t, x, version):
        with monkeypatch.context() as m:
            m.setattr(dispatch, "runs_kernel", real_rule)
            return cubic._masked_fit_plain(t, x, version)

    plain["K6/K7"] = fit
    for name, module in MODULES.items():
        module.reset_launch_counts()

        def launch(*args, _module=module, _fn=plain[name]):
            _module.LAUNCHES += 1
            return _fn(*args)

        monkeypatch.setattr(module, "launch", launch)
    monkeypatch.setattr(dispatch, "runs_kernel", rule)
    yield lambda: {name: module.LAUNCHES for name, module in MODULES.items()}
    for module in MODULES.values():
        module.reset_launch_counts()


def _close(got, expected, tol):
    scale = max(1.0, float(expected.detach().abs().max()))
    np.testing.assert_allclose(got.detach().numpy(), expected.detach().numpy(), rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("band_batch", [(), (3,)])
def test_tridiagonal_kernel_function_and_its_vjp(stand_ins, band_batch):
    rng = np.random.default_rng(1)
    k = 9
    u, l = (torch.from_numpy(rng.standard_normal(band_batch + (k - 1,))) for _ in range(2))
    pad = torch.zeros(band_batch + (1,), dtype=torch.float64)
    d = 1.0 + torch.cat([u.abs(), pad], -1) + torch.cat([pad, l.abs()], -1)
    b = torch.from_numpy(rng.standard_normal((2, 3, k)))
    w = torch.from_numpy(rng.standard_normal((2, 3, k)))

    def solve(fn):
        leaves = [a.clone().requires_grad_() for a in (b, u, d, l)]
        x = fn(*leaves)
        return x, torch.autograd.grad((x * w).sum(), leaves)

    x, grads = solve(lambda *a: tridiagonal.tridiagonal_solve(*a))
    assert stand_ins()["K4"] == 2  # the solve and the transpose solve
    x_ref, grads_ref = solve(tridiagonal.tridiagonal_solve_thomas)
    _close(x, x_ref, 1e-12)
    for g, r in zip(grads, grads_ref):
        assert g.shape == r.shape
        _close(g, r, 1e-10)


@pytest.mark.parametrize("version", [0, 1])
def test_fused_fit_and_its_gradient(stand_ins, version):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 17, 2))
    x[rng.random(x.shape) < 0.3] = np.nan
    x[0, :, 0] = np.nan
    x[1, :4, 1] = np.nan
    t = np.cumsum(rng.uniform(0.3, 1.2, 17))
    w = torch.from_numpy(rng.standard_normal((3, 16, 8)))
    fit = {0: tt.natural_cubic_spline_coeffs, 1: tt.natural_cubic_coeffs}[version]

    def run():
        xt, tt_ = torch.from_numpy(x).requires_grad_(), torch.from_numpy(t).requires_grad_()
        coeffs = fit(xt, tt_)
        return coeffs, torch.autograd.grad((coeffs * w).sum(), (xt, tt_))

    coeffs, (gx, gt) = run()
    counts = stand_ins()
    assert counts == {"K3": 10, "K4": 0, "K5": 2, "K6/K7": 1}, counts
    with pytest.MonkeyPatch.context() as m:
        m.setattr(dispatch, "runs_kernel", lambda *ts: False)
        ref, (rx, rt) = run()
    _close(coeffs, ref, 1e-12)
    _close(gx, rx, 1e-10)
    _close(gt, rt, 1e-10)
    assert torch.all(gx[torch.isnan(torch.from_numpy(x))] == 0)


def test_dense_fit_counts_and_bfloat16_round_trip(stand_ins):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 12, 1)))
    xg = x.clone().requires_grad_()
    torch.autograd.grad(tt.natural_cubic_coeffs(xg).sum(), xg)
    assert stand_ins() == {"K3": 0, "K4": 2, "K5": 0, "K6/K7": 0}
    # bfloat16 enters the kernels as float32 and leaves as bfloat16.
    xb = x.clone()
    xb[1, 3, 0] = float("nan")
    for data in (x, xb):
        got = tt.natural_cubic_coeffs(data.bfloat16())
        ref = tt.natural_cubic_coeffs(data.bfloat16().double())
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=1e-2,
                                   atol=1e-2 * float(ref.abs().max()))


def test_fill_wrapper_moves_the_axis_and_fills_several_arrays(stand_ins):
    rng = np.random.default_rng(4)
    observed = torch.from_numpy(rng.random((5, 6, 3)) < 0.4)
    values = tuple(torch.from_numpy(rng.standard_normal((5, 6, 3))) for _ in range(3))
    for reverse in (False, True):
        got = fill.masked_fill(values, observed, axis=1, reverse=reverse)
        expected = fill.masked_fill_scan(values, observed, axis=1, reverse=reverse)
        for g, e in zip(got, expected):
            assert torch.equal(g, e)
    assert stand_ins()["K3"] == 2
