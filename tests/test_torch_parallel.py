"""The port's ``parallel`` package against the JAX package, on the CPU in float64.

The port of ``tests/test_parallel.py``: every case there (its three ``slow``
ones included) runs here on ranks joined by gloo over a file store
(``parallel.launch.run_ranks``), 4 ranks where JAX uses 8 virtual devices,
so every case still crosses shard boundaries.  The ranks run every case in
one spawn (``_rank_cases``); the JAX references are computed in this
process on one device from the same numpy inputs, made from a seed.  The
rank bodies import no JAX: the spawned children import this module, so JAX
is imported lazily, in the parent only.

Beyond the JAX file: an empty shard in the masked fit, ``DTensor`` operands
of the dense solve, the collectives' transposes, the fused route per rank
(taken on a data-parallel mesh, declined with a sharded field), per-sample
solves on a tensor-parallel field, and the error texts of ``make_mesh``,
``method=`` and the length's divisibility.
"""

import traceback

import numpy as np
import pytest
import torch

WORLD = 4
RTOL_LOSS, RTOL_PARAMS, ATOL_PARAMS = 1e-9, 1e-8, 1e-10
SMALL = dict(input_channels=3, hidden_channels=4, output_channels=1, width=16,
             interpolation="cubic", solver="rk4", adjoint=False, step_size=1.0)


# ---------------------------------------------------------------- inputs ----

def _inputs():
    """Every case's numpy inputs, from one seed."""
    rng = np.random.default_rng(13)
    inp = {}
    inp["train_x"] = rng.standard_normal((16, 12, 3))
    inp["train_y"] = (rng.random(16) > 0.5).astype(np.float64)
    x = rng.standard_normal((32, 20, 3))
    x[rng.random(x.shape) < 0.2] = np.nan
    inp["coeff_x"] = x
    for k in (48, 129, 1024):
        inp[f"tri{k}"] = _system(rng, 4, k)
    inp["tri_batch"] = _system(rng, 8, 256)
    inp["tri_dt"] = _system(rng, 4, 129)
    inp["custom_x"] = rng.standard_normal((16, 12, 3))
    inp["rev_x"] = rng.standard_normal((16, 12, 3))
    inp["rev_y"] = (rng.random(16) > 0.5).astype(np.float64)
    x = rng.standard_normal((16, 12, 3))
    x *= (10.0 ** np.linspace(-0.5, 0.5, 16))[:, None, None]
    inp["ps_rough_x"] = x
    inp["ps_z0"] = rng.standard_normal((16, 4))
    # Paths linear in time, their slopes spread over magnitudes.
    x = (rng.standard_normal((16, 1, 3))
         + rng.uniform(-1, 1, (16, 1, 3)) * np.arange(12)[None, :, None])
    inp["ps_smooth_x"] = x * (10.0 ** np.linspace(-0.5, 0.5, 16))[:, None, None]
    x = rng.standard_normal((4, 64, 3))
    x[rng.random(x.shape) < 0.35] = np.nan
    x[1, :, 2] = np.nan       # an all-NaN channel
    x[2, :10, 0] = np.nan     # a leading gap
    x[3, -12:, 1] = np.nan    # a trailing gap
    x[0, 8:40, 0] = np.nan    # a gap over several shards
    inp["masked_x"] = x
    inp["masked_t"] = np.sort(rng.random(64)) * 9 + 0.01 * np.arange(64)
    x = rng.standard_normal((4, 48, 2))
    x[rng.random(x.shape) < 0.25] = np.nan
    inp["one_shard_x"] = x
    x = rng.standard_normal((8, 32, 2))
    x[rng.random(x.shape) < 0.25] = np.nan
    inp["masked_batch_x"] = x
    x = rng.standard_normal((2, 64, 2))
    x[rng.random(x.shape) < 0.3] = np.nan
    inp["masked_grad_x"] = x
    x = rng.standard_normal((3, 64, 2))
    x[rng.random(x.shape) < 0.2] = np.nan
    x[0, 16:32, 0] = np.nan   # shard 1 of 4 holds no observation
    x[1, 16:48, 1] = np.nan   # shards 1 and 2
    x[2, :48, 0] = np.nan     # shards 0 to 2: every earlier shard is empty
    inp["empty_x"] = x
    inp["comm_x"] = rng.standard_normal((WORLD, 3, 5))
    inp["div_x"], inp["div_y"] = _spirals(16, 12)
    return inp


def _spirals(batch, length):
    """Spiral data (seed 0), smooth controls for the adaptive solves."""
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 4 * np.pi, length)
    phase = rng.uniform(0, 2 * np.pi, size=(batch, 1))
    y = (rng.random(batch) > 0.5).astype(np.float64)
    d = np.where(y > 0.5, 1.0, -1.0)[:, None]
    r = 0.5 + t / (4 * np.pi)
    x = np.stack([np.broadcast_to(t, (batch, length)), r * np.cos(d * t + phase),
                  r * np.sin(d * t + phase)], -1)
    return x, y


def _system(rng, batch, k):
    u = rng.standard_normal((batch, k - 1))
    lo = rng.standard_normal((batch, k - 1))
    b = rng.standard_normal((batch, k))
    pad = np.zeros((batch, 1))
    d = 1.0 + np.abs(np.concatenate([u, pad], -1)) + np.abs(np.concatenate([pad, lo], -1))
    return b, u, d, lo


# ------------------------------------------------------------- the ranks ----

class _Counted:
    """Counts the solves the fixed-step fused routes take (K1's and K8's,
    here their plain versions on the CPU), by wrapping
    ``fused_fixed.try_fused_mlp`` and ``cdeint.try_fused_reversible_heun``."""

    def __init__(self):
        import importlib

        from torchcde_tpu_torch.solvers import fused_fixed

        # The module, not the function that ``solvers`` exports by its name.
        cdeint = importlib.import_module("torchcde_tpu_torch.solvers.cdeint")
        self.count = 0
        self.patched = [(fused_fixed, "try_fused_mlp"), (cdeint, "try_fused_reversible_heun")]
        self.origs = [getattr(m, name) for m, name in self.patched]
        for (module, name), orig in zip(self.patched, self.origs):
            setattr(module, name, self._counting(orig))

    def _counting(self, orig):
        def counted(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.count += out is not None
            return out

        return counted

    def close(self):
        for (module, name), orig in zip(self.patched, self.origs):
            setattr(module, name, orig)


def _full(p):
    from torchcde_tpu_torch.parallel import comm

    return comm.whole(p)


def _train(inp, params, cfg_kw, mesh, x_key, y_key, tp=False):
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.interop import from_jax_params
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, make_train_step
    from torchcde_tpu_torch.parallel import place_params, shard_batch

    model = NeuralCDE(NeuralCDEConfig(**cfg_kw), device="cpu", dtype=torch.float64)
    model.load_state_dict(from_jax_params(params))
    if tp:
        place_params(mesh, model)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(inp[x_key]))
    coeffs, y = shard_batch(mesh, (coeffs, torch.from_numpy(inp[y_key])))
    # Adam's foreach route refuses a mix of plain tensors and DTensors.
    opt = torch.optim.Adam(model.parameters(), lr=1e-2, foreach=False)
    step = make_train_step(model, opt, mesh=mesh)
    counted = _Counted()
    try:
        for _ in range(2):
            loss = step(coeffs, y)
    finally:
        counted.close()
    state = {name: _full(p).detach() for name, p in model.named_parameters()}
    placements = {name: str(getattr(p, "placements", "plain"))
                  for name, p in model.named_parameters()}
    return dict(loss=loss, state=state, fused=counted.count, placements=placements)


class _CustomField(torch.nn.Module):
    """The JAX test's field: tanh(z @ lift + b) @ proj, reshaped to (4, 3)."""

    def __init__(self):
        super().__init__()
        self.lift = torch.nn.Linear(4, 32, dtype=torch.float64)
        self.proj = torch.nn.Linear(32, 12, bias=False, dtype=torch.float64)

    def forward(self, t, z):
        h = torch.tanh(self.lift(z))
        return self.proj(h).reshape(z.shape[:-1] + (4, 3))


def _case_custom(inp, refs_in, mesh):
    import torchcde_tpu_torch as tt
    from torch.distributed.tensor import Shard
    from torchcde_tpu_torch.parallel import (TensorParallelField, comm, param_sharding_rules,
                                             place_params, shard_batch)

    field = _CustomField()
    with torch.no_grad():
        field.lift.weight.copy_(torch.from_numpy(refs_in["lift_kernel"].T))
        field.lift.bias.copy_(torch.from_numpy(refs_in["lift_bias"]))
        field.proj.weight.copy_(torch.from_numpy(refs_in["proj_kernel"].T))
    rules = (("lift.weight", Shard(0)), ("lift.bias", Shard(0)), ("proj.weight", Shard(1)))
    hit = repr(param_sharding_rules(mesh, field, rules)["lift.weight"])
    place_params(mesh, field, rules)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(inp["custom_x"]))
    X = tt.CubicSpline(shard_batch(mesh, coeffs))
    z0 = torch.zeros(X._a.shape[0], 4, dtype=torch.float64)
    out = tt.cdeint(X, TensorParallelField(field), z0, X.interval, adjoint=False, method="rk4",
                    options=dict(step_size=1.0))
    torch.sum(out[:, -1] ** 2).backward()
    grads = {name: comm.psum(_full(p.grad), mesh, "data")
             for name, p in field.named_parameters()}
    return dict(hit=hit, grads=grads)


def _case_per_sample(inp, refs_in, mesh, key, single=False):
    """Per-sample dopri5 on each rank's lanes; ``single``: also the same
    solve of every lane on this rank alone."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.parallel import comm, shard_batch

    def solve(coeffs, z0):
        w = torch.from_numpy(refs_in["ps_w"]).requires_grad_()
        X = tt.CubicSpline(coeffs)

        def f(t, z):
            return torch.tanh(z @ w).reshape(z.shape[:-1] + (4, 3))

        out = tt.cdeint(X, f, z0, X.interval, adjoint=False, method="dopri5", rtol=1e-6,
                        atol=1e-8, options=dict(per_sample=True))
        loss = torch.sum(out[:, -1] ** 2)
        return loss.detach(), torch.autograd.grad(loss, w)[0]

    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(inp[key]))
    z0 = torch.from_numpy(inp["ps_z0"])
    loss, g = solve(*shard_batch(mesh, (coeffs, z0)))
    out = dict(loss=comm.psum(loss, mesh, "data"), grad=comm.psum(g, mesh, "data"))
    if single:
        out["single"] = solve(coeffs, z0)
    return out


# Per-sample solves on a tensor-parallel field (data 2 x model 2): the
# custom field under TensorParallelField with the JAX test's rules, the
# Neural CDE's MLP field placed by place_params, and the custom field under
# a layout the port's rules do not know (lift's input columns and proj's
# output rows split, lift's bias plain).
PS_TP_RULES = {
    "custom": (("lift.weight", 0), ("lift.bias", 0), ("proj.weight", 1)),
    "other layout": (("lift.weight", 1), ("proj.weight", 0)),
}
PS_TP_FIELDS = ("custom", "mlp", "other layout")
PS_TP_KW = dict(method="dopri5", rtol=1e-6, atol=1e-8, options=dict(per_sample=True))


def _case_per_sample_tp(inp, refs_in, mesh, kind, adjoint):
    """The per-sample dopri5 solve of every rank's lanes of ``ps_smooth_x``
    on a tensor-parallel field: the loss and the weights' gradients summed
    over ``data``, where each gradient lives (its type and placements beside
    the weight's), and the solves the fused per-lane route (K9's, here its
    plain version) took."""
    import importlib

    import torchcde_tpu_torch as tt
    from torch.distributed.tensor import Shard
    from torchcde_tpu_torch.interop import from_jax_params
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig
    from torchcde_tpu_torch.parallel import (TensorParallelField, comm, place_params,
                                             shard_batch)

    if kind == "mlp":
        model = NeuralCDE(NeuralCDEConfig(**SMALL), device="cpu", dtype=torch.float64)
        model.load_state_dict(from_jax_params(refs_in["params"]))
        place_params(mesh, model)
        module = field = model.func
    else:
        module = _CustomField()
        with torch.no_grad():
            module.lift.weight.copy_(torch.from_numpy(refs_in["lift_kernel"].T))
            module.lift.bias.copy_(torch.from_numpy(refs_in["lift_bias"]))
            module.proj.weight.copy_(torch.from_numpy(refs_in["proj_kernel"].T))
        place_params(mesh, module, [(name, Shard(d)) for name, d in PS_TP_RULES[kind]])
        field = TensorParallelField(module)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(inp["ps_smooth_x"]))
    c, z0 = shard_batch(mesh, (coeffs, torch.from_numpy(inp["ps_z0"])))
    cdeint = importlib.import_module("torchcde_tpu_torch.solvers.cdeint")
    route, taken = cdeint.try_fused_dopri5_per_sample, []

    def counted(*args, **kwargs):
        out = route(*args, **kwargs)
        taken.append(out is not None)
        return out

    cdeint.try_fused_dopri5_per_sample = counted
    try:
        X = tt.CubicSpline(c)
        out = tt.cdeint(X, field, z0, X.interval, adjoint=adjoint, **PS_TP_KW)
        loss = torch.sum(out[:, -1] ** 2)
        loss.backward()
    finally:
        cdeint.try_fused_dopri5_per_sample = route
    grads = {name: comm.psum(_full(p.grad), mesh, "data") for name, p in module.named_parameters()}
    where = {name: (type(p).__name__, str(getattr(p, "placements", "plain")),
                    type(p.grad).__name__, str(getattr(p.grad, "placements", "plain")))
             for name, p in module.named_parameters()}
    res = dict(loss=comm.psum(loss.detach(), mesh, "data"), grads=grads, where=where,
               fused=sum(taken), routes=len(taken))
    if kind == "mlp":
        # The same solve of every lane on this rank alone, the field's weights
        # plain, off the fused route.
        from torchcde_tpu_torch.solvers import disable_fused_dispatch

        plain = NeuralCDE(NeuralCDEConfig(**SMALL), device="cpu", dtype=torch.float64).func
        plain.load_state_dict({k[len("func."):]: v for k, v in
                               from_jax_params(refs_in["params"]).items() if k.startswith("func.")})
        X = tt.CubicSpline(coeffs)
        with disable_fused_dispatch():
            out = tt.cdeint(X, plain, torch.from_numpy(inp["ps_z0"]), X.interval,
                            adjoint=adjoint, **PS_TP_KW)
        one = torch.sum(out[:, -1] ** 2)
        one.backward()
        res["single"] = (one.detach(), {name: p.grad for name, p in plain.named_parameters()})
    return res


DIVERGENCE = {"rk4": 0.5, "dopri5": None}  # solver: step size


def _case_divergence(inp, refs_in, mesh, solver, adjoint):
    """One step's averaged gradients on a data-parallel mesh (ROADMAP.md
    section 3's entries on data-parallel adjoints and adaptive solves), and
    for dopri5 also the one-process gradient of the whole batch."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.interop import from_jax_params
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig
    from torchcde_tpu_torch.models.training import _average_over_data, loss_fn
    from torchcde_tpu_torch.parallel import shard_batch

    cfg = NeuralCDEConfig(**dict(SMALL, solver=solver, adjoint=adjoint,
                                 step_size=DIVERGENCE[solver]))
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(inp["div_x"]))
    labels = torch.from_numpy(inp["div_y"])

    def grads(c, y, mesh=None):
        model = NeuralCDE(cfg, device="cpu", dtype=torch.float64)
        model.load_state_dict(from_jax_params(refs_in["div_params"][solver]))
        loss = loss_fn(model, c, y)
        loss.backward()
        if mesh is not None:
            _average_over_data(model, loss.detach(), mesh)
        return {name: p.grad for name, p in model.named_parameters()}

    out = {"dp": grads(*shard_batch(mesh, (coeffs, labels)), mesh)}
    if solver == "dopri5" and not adjoint:
        out["one"] = grads(coeffs, labels)
    return out


def _case_comm(inp, mesh):
    """Each collective's values and its transpose, on the (1, 4) mesh."""
    from torch.distributed.tensor import DTensor
    from torchcde_tpu_torch.parallel import comm

    me = comm.axis_index(mesh, "model")
    x = torch.from_numpy(inp["comm_x"][me]).requires_grad_()
    w = torch.from_numpy(inp["comm_x"][(me + 1) % WORLD])
    out = {}
    # comm.whole of a DTensor split unevenly (3, 3, 3, 1 columns) and of a
    # summed one, and their gradients (each rank's part of the cotangent).
    from torch.distributed.tensor import Partial, Shard, distribute_tensor

    whole = torch.from_numpy(inp["comm_x"].reshape(6, 10)[:3])
    sharded = distribute_tensor(whole, mesh["model"], [Shard(1)]).requires_grad_()
    partial = torch.from_numpy(inp["comm_x"][me]).requires_grad_()
    summed = DTensor.from_local(partial, mesh["model"], [Partial()], run_check=False)
    y1, y2 = comm.whole(sharded), comm.whole(summed)
    (y1.sum() + (y2 * w.sum()).sum()).backward()
    out["whole"] = (y1.detach(), y2.detach(), sharded.grad.to_local(), partial.grad)
    for name, fn in (("gather", lambda v: comm.all_gather(v, mesh, "model")),
                     ("prev", lambda v: comm.shift_from_prev(v, mesh, "model")),
                     ("next2", lambda v: comm.shift_from_next(v, mesh, "model", 2)),
                     ("psum", lambda v: comm.psum(v, mesh, "model")),
                     ("relayout", lambda v: comm.relayout(v, mesh, "model", [0, 5, 10, 15, 20],
                                                          [0, 2, 9, 9, 20]))):
        y = fn(x)
        (g,) = torch.autograd.grad((y * torch.ones_like(y) * w.sum()).sum(), x)
        out[name] = (y.detach(), g)
    return out


def _guarded(results, name, fn, *args, **kwargs):
    try:
        results[name] = fn(*args, **kwargs)
    except Exception:  # recorded for the parent's test of this case
        results[name] = {"error": traceback.format_exc()}


def _rank_cases(rank, world, inp, refs_in):
    """Every case, on one rank of a 4-rank gloo group; runs no JAX."""
    import torchcde_tpu_torch as tt
    from torchcde_tpu_torch.parallel import (make_mesh, natural_cubic_coeffs_seq_sharded,
                                             shard_batch, tridiagonal_solve_seq_sharded)

    dp = make_mesh(data=4, model=1, device="cpu")
    tp = make_mesh(data=2, model=2, device="cpu")
    seq = make_mesh(data=1, model=4, device="cpu")
    res = {}
    rev = dict(SMALL, solver="reversible_heun")
    _guarded(res, "dp", _train, inp, refs_in["params"], SMALL, dp, "train_x", "train_y")
    _guarded(res, "tp", _train, inp, refs_in["params"], SMALL, tp, "train_x", "train_y", True)
    _guarded(res, "tp_adjoint", _train, inp, refs_in["params"], dict(SMALL, adjoint=True), tp,
             "train_x", "train_y", True)
    for adjoint in (False, True):
        _guarded(res, f"rev{adjoint}", _train, inp, refs_in["rev_params"],
                 dict(rev, adjoint=adjoint), dp, "rev_x", "rev_y")
    _guarded(res, "custom", _case_custom, inp, refs_in, tp)
    _guarded(res, "per_sample", _case_per_sample, inp, refs_in, dp, "ps_smooth_x")
    _guarded(res, "per_sample_rough", _case_per_sample, inp, refs_in, dp, "ps_rough_x", True)
    for kind in PS_TP_FIELDS:
        for adjoint in (False, True):
            _guarded(res, f"ps_tp_{kind}_{adjoint}", _case_per_sample_tp, inp, refs_in, tp, kind,
                     adjoint)
    _guarded(res, "coeffs", lambda: tt.natural_cubic_coeffs(
        shard_batch(dp, torch.from_numpy(inp["coeff_x"]))))

    def tri(key, mesh, **kw):
        b, u, d, lo = (torch.from_numpy(a) for a in inp[key])
        return tridiagonal_solve_seq_sharded(b, u, d, lo, mesh, **kw).full_tensor()

    for method in ("spike", "pcr"):
        for k in (48, 129, 1024):
            _guarded(res, f"tri_{method}_{k}", tri, f"tri{k}", seq, method=method)
    _guarded(res, "tri_batch", tri, "tri_batch", tp, axis="model", batch_axis="data")

    def tri_dtensor(method):
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor

        ops = [distribute_tensor(torch.from_numpy(a), seq, [Replicate(), Shard(1)])
               for a in inp["tri_dt"]]
        return tridiagonal_solve_seq_sharded(*ops, seq, method=method).full_tensor()

    for method in ("spike", "pcr"):
        _guarded(res, f"tri_dt_{method}", tri_dtensor, method)

    def masked(key, mesh, t=None, **kw):
        x = torch.from_numpy(inp[key])
        out = natural_cubic_coeffs_seq_sharded(x, t, mesh, **kw)
        return dict(full=out.full_tensor(), local=out.to_local().shape[-2])

    _guarded(res, "masked", masked, "masked_x", seq, torch.from_numpy(inp["masked_t"]))
    _guarded(res, "empty", masked, "empty_x", seq)
    _guarded(res, "masked_batch", masked, "masked_batch_x", tp, axis="model",
             batch_axis="data")

    def one_shard():
        from torchcde_tpu_torch.ops.tridiagonal import tridiagonal_solve

        x = torch.from_numpy(inp["one_shard_x"])
        got = natural_cubic_coeffs_seq_sharded(x, None, dp, axis="model").to_local()
        system = [torch.from_numpy(a) for a in inp["tri48"]]
        dense = tridiagonal_solve_seq_sharded(*system, dp, axis="model").to_local()
        return dict(got=got, same=bool(torch.equal(got, tt.natural_cubic_coeffs(x))),
                    dense_same=bool(torch.equal(dense, tridiagonal_solve(*system))))

    _guarded(res, "one_shard", one_shard)

    def masked_grad():
        x = torch.from_numpy(inp["masked_grad_x"]).requires_grad_()
        t = torch.arange(64, dtype=torch.float64)
        out = natural_cubic_coeffs_seq_sharded(x, t, seq, axis="model").full_tensor()
        return torch.autograd.grad(torch.sum(out ** 2), x)[0]

    _guarded(res, "masked_grad", masked_grad)
    _guarded(res, "comm", _case_comm, inp, seq)
    for solver in DIVERGENCE:
        for adjoint in (False, True):
            _guarded(res, f"div_{solver}_{adjoint}", _case_divergence, inp, refs_in, dp, solver,
                     adjoint)

    def errors():
        out = {}
        for name, call in (
                ("make_mesh", lambda: make_mesh(data=3, model=2, device="cpu")),
                ("method", lambda: tridiagonal_solve_seq_sharded(
                    *(torch.from_numpy(a) for a in inp["tri48"]), seq, method="bogus")),
                ("length", lambda: natural_cubic_coeffs_seq_sharded(
                    torch.zeros(2, 30, 1, dtype=torch.float64), None, seq))):
            try:
                call()
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
        return out

    _guarded(res, "errors", errors)
    return res


# ------------------------------------------------------ the parent's side ----

@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_refs(inputs):
    """JAX's single-device results (and the JAX-made parameters the ranks
    start from)."""
    import jax
    import jax.numpy as jnp
    import optax

    import torchcde_tpu as tc
    from torchcde_tpu.models.neural_cde import NeuralCDEConfig, init_neural_cde
    from torchcde_tpu.models.training import make_train_step

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    herm = lambda x: tc.hermite_cubic_coefficients_with_backward_differences(  # noqa: E731
        jnp.asarray(x))

    def run_steps(cfg, params, x, y):
        optimizer = optax.adam(1e-2)
        opt_state = optimizer.init(params)
        step = jax.jit(make_train_step(cfg, optimizer))
        coeffs = herm(x)
        for _ in range(2):
            params, opt_state, loss = step(params, opt_state, coeffs, jnp.asarray(y))
        return to_np(params), float(loss)

    refs, refs_in = {}, {}
    cfg = NeuralCDEConfig(**SMALL)
    params = init_neural_cde(jax.random.PRNGKey(0), cfg, dtype=jnp.float64)
    refs_in["params"] = to_np(params)
    refs["train"] = run_steps(cfg, params, inputs["train_x"], inputs["train_y"])
    refs["train_adjoint"] = run_steps(NeuralCDEConfig(**dict(SMALL, adjoint=True)), params,
                                      inputs["train_x"], inputs["train_y"])
    rev_params = {}
    for adjoint in (False, True):
        rcfg = NeuralCDEConfig(**dict(SMALL, solver="reversible_heun", adjoint=adjoint))
        rev_params = init_neural_cde(jax.random.PRNGKey(5), rcfg, dtype=jnp.float64)
        refs[f"rev{adjoint}"] = run_steps(rcfg, rev_params, inputs["rev_x"], inputs["rev_y"])
    refs_in["rev_params"] = to_np(rev_params)

    # The custom field's gradients.
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    cparams = {"lift": {"kernel": jax.random.normal(k1, (4, 32), dtype=jnp.float64),
                        "bias": jnp.zeros(32, jnp.float64)},
               "proj": {"kernel": jax.random.normal(k2, (32, 12), dtype=jnp.float64) / 32.0}}
    refs_in["lift_kernel"] = np.asarray(cparams["lift"]["kernel"])
    refs_in["lift_bias"] = np.asarray(cparams["lift"]["bias"])
    refs_in["proj_kernel"] = np.asarray(cparams["proj"]["kernel"])
    ccoeffs = herm(inputs["custom_x"])

    def closs(p):
        X = tc.CubicSpline(ccoeffs)

        def f(t, z):
            h = jnp.tanh(z @ p["lift"]["kernel"] + p["lift"]["bias"])
            return (h @ p["proj"]["kernel"]).reshape(z.shape[0], 4, 3)

        out = tc.cdeint(X, f, jnp.zeros((16, 4)), X.interval, adjoint=False, method="rk4",
                        options=dict(step_size=1.0))
        return jnp.sum(out[:, -1] ** 2)

    refs["custom"] = to_np(jax.jit(jax.grad(closs))(cparams))

    # Per-sample dopri5.
    from torchcde_tpu_torch.interop import from_jax_params

    w = jax.random.normal(jax.random.PRNGKey(7), (4, 12), dtype=jnp.float64) * 0.3
    refs_in["ps_w"] = np.asarray(w)
    pcoeffs = herm(inputs["ps_smooth_x"])

    def ploss(w_):
        X = tc.CubicSpline(pcoeffs)

        def f(t, z):
            return jnp.tanh(z @ w_).reshape(z.shape[:-1] + (4, 3))

        out = tc.cdeint(X, f, jnp.asarray(inputs["ps_z0"]), X.interval, adjoint=False,
                        method="dopri5", rtol=1e-6, atol=1e-8, options=dict(per_sample=True))
        return jnp.sum(out[:, -1] ** 2)

    lp, gp = jax.jit(jax.value_and_grad(ploss))(w)
    refs["per_sample"] = (float(lp), np.asarray(gp))

    # Per-sample dopri5 of the tensor-parallel cases' fields on one device,
    # in the port's weight names ((out, in) weights).
    state = {k: v.numpy() for k, v in from_jax_params(refs_in["params"]).items()}
    mlp = {name: state[f"func.{name}"] for name in ("linear1.weight", "linear1.bias",
                                                     "linear2.weight", "linear2.bias")}
    custom = {"lift.weight": refs_in["lift_kernel"].T, "lift.bias": refs_in["lift_bias"],
              "proj.weight": refs_in["proj_kernel"].T}

    def mlp_field(p):
        def f(t, z):
            h = jax.nn.relu(z @ p["linear1.weight"].T + p["linear1.bias"])
            return jnp.tanh(h @ p["linear2.weight"].T + p["linear2.bias"]).reshape(
                z.shape[:-1] + (4, 3))
        return f

    def custom_field(p):
        def f(t, z):
            h = jnp.tanh(z @ p["lift.weight"].T + p["lift.bias"])
            return (h @ p["proj.weight"].T).reshape(z.shape[:-1] + (4, 3))
        return f

    refs["ps_tp"] = {}
    for kind, make, weights in (("mlp", mlp_field, mlp), ("custom", custom_field, custom)):
        for adjoint in (False, True):
            def tp_loss(p, make=make, adjoint=adjoint):
                X = tc.CubicSpline(pcoeffs)
                out = tc.cdeint(X, make(p), jnp.asarray(inputs["ps_z0"]), X.interval,
                                adjoint=adjoint, **PS_TP_KW)
                return jnp.sum(out[:, -1] ** 2)

            value, grad = jax.jit(jax.value_and_grad(tp_loss))(
                {k: jnp.asarray(v) for k, v in weights.items()})
            refs["ps_tp"][kind, adjoint] = (float(value), to_np(grad))
    refs["ps_tp"]["other layout", False] = refs["ps_tp"]["custom", False]
    refs["ps_tp"]["other layout", True] = refs["ps_tp"]["custom", True]

    refs["coeffs"] = np.asarray(tc.natural_cubic_coeffs(jnp.asarray(inputs["coeff_x"])))
    from torchcde_tpu.ops.tridiagonal import tridiagonal_solve_thomas

    for key in ("tri48", "tri129", "tri1024", "tri_batch", "tri_dt"):
        b, u, d, lo = (jnp.asarray(a) for a in inputs[key])
        refs[key] = np.asarray(tridiagonal_solve_thomas(b, u, d, lo))
    refs["masked"] = np.asarray(tc.natural_cubic_coeffs(jnp.asarray(inputs["masked_x"]),
                                                        jnp.asarray(inputs["masked_t"])))
    for key in ("empty_x", "masked_batch_x", "one_shard_x"):
        refs[key] = np.asarray(tc.natural_cubic_coeffs(jnp.asarray(inputs[key])))
    tg = jnp.arange(64, dtype=jnp.float64)
    refs["masked_grad"] = np.asarray(jax.grad(
        lambda v: jnp.sum(tc.natural_cubic_coeffs(v, tg) ** 2))(
            jnp.asarray(inputs["masked_grad_x"])))

    # Gradients on JAX's data-parallel mesh (8 virtual devices).
    from torchcde_tpu.models.training import make_loss_fn
    from torchcde_tpu.parallel.mesh import batch_sharding
    from torchcde_tpu.parallel.mesh import make_mesh as jax_mesh
    from torchcde_tpu.parallel.mesh import shard_batch as jax_shard_batch

    dp_mesh = jax_mesh(data=8, model=1)
    dcoeffs = jax_shard_batch(dp_mesh, herm(inputs["div_x"]))
    dlabels = jax.device_put(jnp.asarray(inputs["div_y"]), batch_sharding(dp_mesh))
    refs_in["div_params"], refs["div"] = {}, {}
    for solver, step in DIVERGENCE.items():
        dparams = init_neural_cde(jax.random.PRNGKey(0), NeuralCDEConfig(
            **dict(SMALL, solver=solver, step_size=step)), dtype=jnp.float64)
        refs_in["div_params"][solver] = to_np(dparams)
        for adjoint in (False, True):
            dcfg = NeuralCDEConfig(**dict(SMALL, solver=solver, adjoint=adjoint, step_size=step))
            g = jax.jit(jax.grad(make_loss_fn(dcfg)))(dparams, dcoeffs, dlabels)
            refs["div"][solver, adjoint] = {k: v.numpy()
                                            for k, v in from_jax_params(to_np(g)).items()}

    # The JAX package's error texts.
    from torchcde_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from torchcde_tpu.parallel.seq_masked import natural_cubic_coeffs_seq_sharded
    from torchcde_tpu.parallel.seq_pcr import tridiagonal_solve_seq_sharded

    errors = {}
    with pytest.raises(ValueError) as e:
        jax_make_mesh(data=3, model=2)
    errors["make_mesh"] = str(e.value)
    mesh = jax_make_mesh(data=2, model=4)
    with pytest.raises(ValueError) as e:
        tridiagonal_solve_seq_sharded(*(jnp.asarray(a) for a in inputs["tri48"]), mesh,
                                      method="bogus")
    errors["method"] = str(e.value)
    with pytest.raises(ValueError) as e:
        natural_cubic_coeffs_seq_sharded(jnp.zeros((2, 30, 1)), None, mesh)
    errors["length"] = str(e.value)
    refs["errors"] = errors
    return refs, refs_in


@pytest.fixture(scope="module")
def ranks(inputs, jax_refs):
    from torchcde_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_rank_cases, WORLD, backend="gloo", args=(inputs, jax_refs[1]),
                     timeout=120)


def _case(ranks, name):
    out = [r[name] for r in ranks]
    for r in out:
        if isinstance(r, dict) and "error" in r:
            pytest.fail(r["error"])
    return out


def _check_training(got, ref_params, ref_loss):
    from torchcde_tpu_torch.interop import from_jax_params

    ref_state = from_jax_params(ref_params)
    for r in got:
        assert np.isclose(ref_loss, float(r["loss"]), rtol=RTOL_LOSS)
        for name, value in ref_state.items():
            np.testing.assert_allclose(r["state"][name], value.numpy(), rtol=RTOL_PARAMS,
                                       atol=ATOL_PARAMS, err_msg=name)


def test_data_parallel_matches_single_device(ranks, jax_refs):
    got = _case(ranks, "dp")
    _check_training(got, *jax_refs[0]["train"])
    # Each rank took its own fused route (K1's plain version here) on its
    # shard, once a step.
    assert [r["fused"] for r in got] == [2] * WORLD


def test_tensor_parallel_matches_single_device(ranks, jax_refs):
    got = _case(ranks, "tp")
    _check_training(got, *jax_refs[0]["train"])
    # The sharded field declines the fused route: the plain path, every step.
    assert [r["fused"] for r in got] == [0] * WORLD
    placements = got[0]["placements"]
    assert placements["func.linear1.weight"] == "(Shard(dim=0),)"
    assert placements["func.linear1.bias"] == "(Shard(dim=0),)"
    assert placements["func.linear2.weight"] == "(Shard(dim=1),)"
    assert placements["func.linear2.bias"] == "plain"
    assert placements["initial.weight"] == "plain"


def test_tensor_parallel_backsolve_adjoint_matches_single_device(ranks, jax_refs):
    """Not in the JAX file.  With ``adjoint=True`` the sharded field's
    solve backsolves, as JAX's does (its kernels decline off the TPU and on
    a mesh); the parameters' cotangents ride the augmented state whole."""
    got = _case(ranks, "tp_adjoint")
    _check_training(got, *jax_refs[0]["train_adjoint"])
    assert [r["fused"] for r in got] == [0] * WORLD


def test_sharded_coefficient_construction(ranks, jax_refs):
    got = np.concatenate(_case(ranks, "coeffs"), axis=0)
    np.testing.assert_allclose(got, jax_refs[0]["coeffs"], atol=1e-10)


@pytest.mark.parametrize("method", ["spike", "pcr"])
def test_seq_sharded_tridiagonal_matches_single_device(ranks, jax_refs, method):
    for k in (48, 129, 1024):
        for got in _case(ranks, f"tri_{method}_{k}"):
            np.testing.assert_allclose(got, jax_refs[0][f"tri{k}"], rtol=1e-9)


def test_seq_and_batch_sharded_tridiagonal(ranks, jax_refs):
    for got in _case(ranks, "tri_batch"):
        np.testing.assert_allclose(got, jax_refs[0]["tri_batch"], rtol=1e-9)


@pytest.mark.parametrize("method", ["spike", "pcr"])
def test_seq_sharded_tridiagonal_takes_length_sharded_dtensors(ranks, jax_refs, method):
    """Operands split over the length in ``torch.chunk``'s layout (129 rows:
    33, 33, 33, 30); pcr's power-of-two layout (64, 64, 1, 0) is reached by
    moving rows between the ranks."""
    for got in _case(ranks, f"tri_dt_{method}"):
        np.testing.assert_allclose(got, jax_refs[0]["tri_dt"], rtol=1e-9)


def test_tensor_parallel_custom_vector_field_rules(ranks, jax_refs):
    ref = jax_refs[0]["custom"]
    for r in _case(ranks, "custom"):
        assert r["hit"] == "Shard(dim=0)"  # the rule hit: lift.weight is sharded
        np.testing.assert_allclose(r["grads"]["lift.weight"], ref["lift"]["kernel"].T,
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(r["grads"]["lift.bias"], ref["lift"]["bias"],
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(r["grads"]["proj.weight"], ref["proj"]["kernel"].T,
                                   rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("adjoint", [False, True])
def test_data_parallel_reversible_heun_matches_single_device(ranks, jax_refs, adjoint):
    """Both adjoints take the fused reversible route (K8's plain version
    here) on each rank; its inverse-map adjoint is exact, so JAX's
    single-device backsolve-free step is the reference either way."""
    got = _case(ranks, f"rev{adjoint}")
    _check_training(got, *jax_refs[0][f"rev{adjoint}"])
    # Each rank took the fused reversible route (K8's) on its shard, once a step.
    assert [r["fused"] for r in got] == [2] * WORLD


def test_data_parallel_per_sample_solve_matches_single_device(ranks, jax_refs):
    """On paths linear in time, where the two packages' adaptive meshes
    agree (ROADMAP.md section 3, "Adaptive meshes drift on rough
    controls"), against JAX's single-device per-sample solve."""
    l_ref, g_ref = jax_refs[0]["per_sample"]
    for r in _case(ranks, "per_sample"):
        assert np.isclose(l_ref, float(r["loss"]), rtol=1e-9)
        np.testing.assert_allclose(r["grad"], g_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("kind", PS_TP_FIELDS)
def test_tensor_parallel_per_sample_solve_matches_single_device(ranks, jax_refs, kind, adjoint):
    """Not in the JAX file, whose mesh GSPMD partitions.  A per-sample solve
    of a tensor-parallel field computes on its weights whole (gathered once
    per solve); its values and the weights' gradients, both adjoints, are
    JAX's single-device per-sample solve's on paths linear in time, at the
    data-parallel test's tolerance (the MLP's: see below).  The gradients
    sit on the weights' DTensor shards, and the fused per-lane route
    declines the field."""
    l_ref, g_ref = jax_refs[0]["ps_tp"][kind, adjoint]
    for r in _case(ranks, f"ps_tp_{kind}_{adjoint}"):
        if kind == "mlp":
            # The MLP's ReLU switches along these paths, where the error
            # estimate magnifies rounding and two float64 meshes part (ROADMAP.md
            # section 3): JAX's own per-sample loss here is 5273.664795819061
            # directly and 5273.668944189296 with adjoint=True.  Held, as the
            # rough-control test above, against the port's one-process solve
            # of every lane with the weights plain.
            l_ref, g_ref = r["single"]
            rtol, atol = 1e-12, 1e-14
        else:
            rtol, atol = 1e-8, 1e-10
        assert np.isclose(l_ref, float(r["loss"]), rtol=min(rtol, 1e-9))
        for name, ref in g_ref.items():
            np.testing.assert_allclose(r["grads"][name], ref, rtol=rtol, atol=atol, err_msg=name)
        sharded = {name: w for name, w in r["where"].items() if w[0] == "DTensor"}
        assert len(sharded) == (3 if kind != "other layout" else 2)
        for name, (_, placements, grad_type, grad_placements) in sharded.items():
            assert (grad_type, grad_placements) == ("DTensor", placements), name
        assert r["fused"] == 0 and r["routes"] == 1


def test_data_parallel_per_sample_solve_on_rough_controls(ranks):
    """The JAX test's own inputs (Hermite splines of random data, on which
    float64 adaptive meshes drift between the two packages: ROADMAP.md
    section 3) against the port's single-device per-sample solve: lanes
    are independent, so only the sums' order differs."""
    for r in _case(ranks, "per_sample_rough"):
        l_one, g_one = r["single"]
        assert np.isclose(float(l_one), float(r["loss"]), rtol=1e-12)
        np.testing.assert_allclose(r["grad"], g_one, rtol=1e-12, atol=1e-14)


def test_seq_sharded_masked_cubic_fit_matches_single_device(ranks, jax_refs):
    for rank, r in enumerate(_case(ranks, "masked")):
        assert r["full"].shape == jax_refs[0]["masked"].shape
        np.testing.assert_allclose(r["full"], jax_refs[0]["masked"], rtol=1e-8, atol=1e-8)
        # No rank holds the whole length: 63 rows as 16, 16, 16, 15.
        assert r["local"] == (15 if rank == WORLD - 1 else 16)


def test_seq_sharded_masked_cubic_fit_with_empty_shards(ranks, jax_refs):
    for r in _case(ranks, "empty"):
        np.testing.assert_allclose(r["full"], jax_refs[0]["empty_x"], rtol=1e-8, atol=1e-8)


def test_seq_sharded_masked_cubic_fit_one_shard_shortcut(ranks, jax_refs):
    # One length shard: the single-device masked fit (and dense solve), bit
    # for bit.
    for r in _case(ranks, "one_shard"):
        assert r["same"] and r["dense_same"]
        np.testing.assert_allclose(r["got"], jax_refs[0]["one_shard_x"], rtol=1e-12,
                                   atol=1e-12)


def test_seq_sharded_masked_cubic_fit_with_batch_sharding(ranks, jax_refs):
    for r in _case(ranks, "masked_batch"):
        np.testing.assert_allclose(r["full"], jax_refs[0]["masked_batch_x"], rtol=1e-8,
                                   atol=1e-8)


def test_seq_sharded_masked_cubic_fit_differentiable(ranks, jax_refs, inputs):
    mask = ~np.isnan(inputs["masked_grad_x"])
    for got in _case(ranks, "masked_grad"):
        np.testing.assert_allclose(got[mask], jax_refs[0]["masked_grad"][mask], rtol=1e-7,
                                   atol=1e-8)


def test_collectives_and_their_transposes(ranks, inputs):
    """all_gather <-> reduce-scatter, shift <-> the opposite shift, psum <->
    identity, relayout <-> the inverse relayout, whole <-> this rank's part:
    the cotangent of sum(y * c_r) on rank r is held against its closed
    form."""
    xs = inputs["comm_x"]
    c = [xs[(r + 1) % WORLD].sum() for r in range(WORLD)]
    got = _case(ranks, "comm")
    for r in range(WORLD):
        y, g = got[r]["gather"]
        np.testing.assert_array_equal(y, xs)
        np.testing.assert_allclose(g, np.full((3, 5), sum(c)), rtol=1e-14)
        y, g = got[r]["prev"]
        np.testing.assert_array_equal(y, xs[r - 1] if r else np.zeros((3, 5)))
        np.testing.assert_allclose(g, np.full((3, 5), c[r + 1] if r < WORLD - 1 else 0.0))
        y, g = got[r]["next2"]
        np.testing.assert_array_equal(y, xs[r + 2] if r + 2 < WORLD else np.zeros((3, 5)))
        np.testing.assert_allclose(g, np.full((3, 5), c[r - 2] if r >= 2 else 0.0))
        y, g = got[r]["psum"]
        np.testing.assert_allclose(y, xs.sum(0), rtol=1e-14)
        np.testing.assert_allclose(g, np.full((3, 5), c[r]))
    cols = [0, 3, 6, 9, 10]
    for r in range(WORLD):
        y1, y2, g1, g2 = got[r]["whole"]
        np.testing.assert_array_equal(y1, xs.reshape(6, 10)[:3])
        np.testing.assert_allclose(y2, xs.sum(0), rtol=1e-14)
        np.testing.assert_array_equal(g1, np.ones((3, cols[r + 1] - cols[r])))
        np.testing.assert_allclose(g2, np.full((3, 5), c[r]))
    # relayout: rows 0..19 split 5/5/5/5 go to 2/7/0/11.
    whole = np.concatenate([xs[r] for r in range(WORLD)], axis=-1)
    dst = [0, 2, 9, 9, 20]
    for r in range(WORLD):
        y, g = got[r]["relayout"]
        np.testing.assert_array_equal(y, whole[..., dst[r]:dst[r + 1]])
        owner = np.searchsorted(dst, np.arange(20), side="right") - 1
        expect = np.array([c[o] for o in owner])[r * 5:(r + 1) * 5]
        np.testing.assert_allclose(g, np.broadcast_to(expect, (3, 5)))


def _worst_rel(got, ref):
    return max(np.linalg.norm(got[k] - ref[k]) / np.linalg.norm(ref[k]) for k in ref)


def test_data_parallel_divergences_from_jax(ranks, jax_refs):
    """The sizes ROADMAP.md section 3 records (B 16 spirals, L 12, H 4, W
    16): a data-parallel rank's ``adjoint=True`` takes its fused route's
    direct gradients where JAX backsolves, and a data-parallel dopri5 solve
    steps each shard on its own where JAX's controller spans the batch."""
    refs = jax_refs[0]["div"]
    rk4 = _case(ranks, "div_rk4_True")[0]["dp"]
    dopri_direct = _case(ranks, "div_dopri5_False")[0]
    dopri_adjoint = _case(ranks, "div_dopri5_True")[0]["dp"]
    sizes = {
        "rk4 adjoint vs JAX direct": _worst_rel(rk4, refs["rk4", False]),
        "rk4 adjoint vs JAX adjoint": _worst_rel(rk4, refs["rk4", True]),
        "JAX rk4 adjoint vs direct": _worst_rel(refs["rk4", True], refs["rk4", False]),
        "dopri5 DP direct vs JAX direct": _worst_rel(dopri_direct["dp"], refs["dopri5", False]),
        "dopri5 one process vs JAX direct": _worst_rel(dopri_direct["one"],
                                                       refs["dopri5", False]),
        "dopri5 DP adjoint vs DP direct": _worst_rel(dopri_adjoint, dopri_direct["dp"]),
    }
    print(sizes)
    assert sizes["rk4 adjoint vs JAX direct"] < 1e-12
    assert sizes["rk4 adjoint vs JAX adjoint"] > 1e-3
    assert sizes["dopri5 one process vs JAX direct"] < 1e-5
    assert sizes["dopri5 DP direct vs JAX direct"] > 1e-3
    assert sizes["dopri5 DP adjoint vs DP direct"] < 1e-12


@pytest.mark.parametrize("name", ["make_mesh", "method", "length"])
def test_error_texts_match_jax(ranks, jax_refs, name):
    got = _case(ranks, "errors")[0][name]
    ref = jax_refs[0]["errors"][name]
    if name == "make_mesh":
        # JAX counts its 8 virtual devices; the port counts its 4 ranks.
        assert ref == "data*model = 3*2 != 8 devices"
        assert got == "data*model = 3*2 != 4 devices"
    else:
        assert got == ref

