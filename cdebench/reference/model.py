"""The spiral Neural CDE as plain PyTorch: the reference that decides ``correct``.

    control   X: the cubic Hermite spline of the knots with backward
              differences on the grid t = 0, 1, ..., n (one row per interval),
              evaluated as a + b f + c f^2 + d f^3 at the fraction f
    field     f(z) = tanh(W2 relu(W1 z + b1) + b2), reshaped (hidden, input)
    solve     dz/dt = f(z) dX/dt, z(0) = Wi X(0) + bi, by ``<method>.py``
    logits    Wr z(n) + br;  loss: mean binary cross entropy on the logits
    update    Adam (bias-corrected, eps outside the square root)

Written from these definitions; it shares no code with the port.  The
batch runs in blocks of rows that the solver says are independent, so that
the float64 graph of a large batch fits beside nothing else on the card.
"""

import importlib
import math

import torch

LEAVES = ("initial.weight", "initial.bias", "func.linear1.weight", "func.linear1.bias",
          "func.linear2.weight", "func.linear2.bias", "readout.weight", "readout.bias")


class Precision:
    """float64, or float32 ("float32"), or float32 whose matrix products
    round their operands to TF32 ("tf32": 10 bits of mantissa, the
    tensor cores' float32 input), summing in float32."""

    def __init__(self, name):
        if name not in ("float64", "float32", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def matmul(self, a, b):
        if self.name == "tf32":
            return _TF32Matmul.apply(a, b)
        return a @ b


class _TF32Matmul(torch.autograd.Function):
    """a @ b with the operands rounded to TF32, and so the two products of
    its backward, as the tensor cores compute all three."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).transpose(-1, -2), to_tf32(a).transpose(-1, -2) @ g


def to_tf32(x):
    """x (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + keep) & ~0x1FFF
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def leaf_shapes(model):
    H, C, W, O = (model["hidden_channels"], model["input_channels"], model["width"],
                  model["output_channels"])
    return {"initial.weight": (H, C), "initial.bias": (H,),
            "func.linear1.weight": (W, H), "func.linear1.bias": (W,),
            "func.linear2.weight": (H * C, W), "func.linear2.bias": (H * C,),
            "readout.weight": (O, H), "readout.bias": (O,)}


def fan_in(name, shape, model):
    """The input width of a leaf's layer: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return shape[1] if len(shape) == 2 else {
        "initial.bias": model["input_channels"], "func.linear1.bias": model["hidden_channels"],
        "func.linear2.bias": model["width"], "readout.bias": model["hidden_channels"]}[name]


def hermite(x):
    """x (B, L, C) -> (a, b, c, d), each (B, L - 1, C): on interval i the cubic
    that takes the knots' values with slope m_i at its left knot and m_{i+1} at
    its right, m_i the backward difference x_i - x_{i-1} (m_0 = x_1 - x_0)."""
    secant = x[:, 1:] - x[:, :-1]
    m_left = torch.cat([secant[:, :1], secant[:, :-1]], dim=1)
    m_right = secant
    a = x[:, :-1]
    b = m_left
    c = 3 * secant - 2 * m_left - m_right
    d = m_left + m_right - 2 * secant
    return a, b, c, d


class Control:
    """dX/dt of the Hermite spline at a host time t on the grid 0..n."""

    def __init__(self, x):
        self.a, self.b, self.c, self.d = hermite(x)
        self.n = self.a.shape[1]

    def derivative(self, t):
        j = min(max(math.floor(t), 0), self.n - 1)
        f = t - j
        return self.b[:, j] + (2 * self.c[:, j] + 3 * self.d[:, j] * f) * f


def make_rhs(params, control, model, prec):
    H, C = model["hidden_channels"], model["input_channels"]
    w1t, w2t = params["func.linear1.weight"].t(), params["func.linear2.weight"].t()
    b1, b2 = params["func.linear1.bias"], params["func.linear2.bias"]

    def rhs(t, z):
        h = torch.relu(prec.matmul(z, w1t) + b1)
        g = torch.tanh(prec.matmul(h, w2t) + b2).reshape(z.shape[0], H, C)
        return (g * control.derivative(t)[:, None, :]).sum(dim=-1)

    return rhs


def solver(name):
    """The solver module ``<name>.py`` beside this file."""
    return importlib.import_module(f"{__package__}.{name}")


def forward(params, x, model, solve_cfg, prec, plan=None):
    """Logits (B,) of the rows of x and the solver's counts; ``plan`` is the
    solver's whole-batch set-up (``plan_batch``), made here when None."""
    method = solver(model["solver"])
    control = Control(x.to(prec.dtype))
    rhs = make_rhs(params, control, model, prec)
    z0 = prec.matmul(control.a[:, 0], params["initial.weight"].t()) + params["initial.bias"]
    if plan is None:
        plan = method.plan_batch(rhs, z0, 0.0, float(control.n), model, solve_cfg)
    zT, counts = method.solve(rhs, z0, 0.0, float(control.n), model, solve_cfg, plan)
    logits = prec.matmul(zT, params["readout.weight"].t()) + params["readout.bias"]
    return logits[:, 0], counts


def plan_batch(params, x, model, solve_cfg, prec):
    """The solver's whole-batch set-up (e.g. dopri5's initial step), no graph."""
    method = solver(model["solver"])
    with torch.no_grad():
        control = Control(x.to(prec.dtype))
        rhs = make_rhs({k: v.detach() for k, v in params.items()}, control, model, prec)
        z0 = (prec.matmul(control.a[:, 0], params["initial.weight"].detach().t())
              + params["initial.bias"].detach())
        return method.plan_batch(rhs, z0, 0.0, float(control.n), model, solve_cfg)


def bce_sum(logits, labels):
    return torch.sum(torch.clamp(logits, min=0) - logits * labels
                     + torch.log1p(torch.exp(-torch.abs(logits))))


def logits_of(params, x, model, solve_cfg, prec):
    """Logits (B,) of a whole batch without a graph, block by block, and
    the solver's counts of each block."""
    method = solver(model["solver"])
    params = {k: v.detach().to(prec.dtype) for k, v in params.items()}
    plan = plan_batch(params, x, model, solve_cfg, prec)
    out, counts = [], []
    with torch.no_grad():
        for rows in method.blocks(x.shape[0], solve_cfg):
            logit, count = forward(params, x[rows], model, solve_cfg, prec, plan)
            out.append(logit)
            counts.append(count)
    return torch.cat(out), counts


class Adam:
    """torch.optim.Adam's update, written out."""

    def __init__(self, params, lr, betas, eps):
        self.lr, (self.b1, self.b2), self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def train_record(params0, batches, model, solve_cfg, opt, prec):
    """Runs one train step per (x, labels) of ``batches`` from ``params0``.

    Returns {"losses": [float], "grad1": {leaf: the first step's gradient},
    "change": {leaf: parameters after the steps minus params0}, "logits1":
    the first step's logits}, float64."""
    method = solver(model["solver"])
    params = {k: v.detach().to(prec.dtype).clone().requires_grad_(True)
              for k, v in params0.items()}
    adam = Adam(params, opt["lr"], tuple(opt["betas"]), opt["eps"])
    losses, grad1, logits1 = [], None, None
    for x, labels in batches:
        B = x.shape[0]
        labels = labels.to(prec.dtype)
        plan = plan_batch(params, x, model, solve_cfg, prec)
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        loss, logits = 0.0, []
        for rows in method.blocks(B, solve_cfg):
            logit, _ = forward(params, x[rows], model, solve_cfg, prec, plan)
            logits.append(logit.detach().to(torch.float64))
            part = bce_sum(logit, labels[rows]) / B
            for k, g in zip(params, torch.autograd.grad(part, list(params.values()))):
                grads[k] += g
            loss += float(part.detach())
        losses.append(loss)
        if grad1 is None:
            grad1 = {k: g.detach().to(torch.float64).clone() for k, g in grads.items()}
            logits1 = torch.cat(logits)
        adam.step(params, grads)
    change = {k: (params[k].detach().to(torch.float64) - params0[k].to(torch.float64))
              for k in params}
    return {"losses": losses, "grad1": grad1, "change": change, "logits1": logits1}
