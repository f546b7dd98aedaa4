"""Batched tridiagonal solvers (port of ``torchcde_tpu/ops/tridiagonal.py``).

Thomas (sequential over the length) and parallel cyclic reduction (log-depth
levels) as plain PyTorch, differentiable by autograd, and K4, the CUDA
kernel (``ops/tridiagonal_kernel.py``).  ``method="auto"`` takes the kernel
for CUDA float32/bfloat16 operands and Thomas otherwise
(``ops/dispatch.py``); the JAX package's TPU thresholds (batch >= 1024,
length >= 17, ``k > 256 -> pcr``) have no counterpart.
"""

import torch


def _broadcast_system(b, A_upper, A_diagonal, A_lower):
    shape = torch.broadcast_shapes(A_diagonal.shape, b.shape)
    off_shape = shape[:-1] + (shape[-1] - 1,)
    return (b.expand(shape), A_upper.expand(off_shape), A_diagonal.expand(shape),
            A_lower.expand(off_shape))


def tridiagonal_solve_thomas(b, A_upper, A_diagonal, A_lower):
    """Thomas algorithm: sequential over length, vectorized over batch.

        b:          (..., k) right-hand side.
        A_upper:    (..., k - 1) superdiagonal.
        A_diagonal: (..., k) main diagonal.
        A_lower:    (..., k - 1) subdiagonal.

    Returns x (..., k) solving Ax = b; batch dimensions broadcast mutually.
    The plain version of K4."""
    b, A_upper, A_diagonal, A_lower = _broadcast_system(b, A_upper, A_diagonal, A_lower)
    k = b.shape[-1]
    if k == 1:
        return b / A_diagonal
    new_d, new_b = [A_diagonal[..., 0]], [b[..., 0]]
    for i in range(1, k):
        w = A_lower[..., i - 1] / new_d[-1]
        new_d.append(A_diagonal[..., i] - w * A_upper[..., i - 1])
        new_b.append(b[..., i] - w * new_b[-1])
    xs = [new_b[-1] / new_d[-1]]
    for i in range(k - 2, -1, -1):
        xs.append((new_b[i] - A_upper[..., i] * xs[-1]) / new_d[i])
    return torch.stack(xs[::-1], dim=-1)


def tridiagonal_solve_pcr(b, A_upper, A_diagonal, A_lower):
    """Parallel cyclic reduction: O(log k) vectorized elimination levels.

    Same system convention as ``tridiagonal_solve_thomas``."""
    b, A_upper, A_diagonal, A_lower = _broadcast_system(b, A_upper, A_diagonal, A_lower)
    k = b.shape[-1]
    if k == 1:
        return b / A_diagonal
    # lower[i] couples row i to i - 1 (lower[0] = 0); upper[i] couples row i
    # to i + 1 (upper[k - 1] = 0).
    zeros = torch.zeros_like(b[..., :1])
    lower = torch.cat([zeros, A_lower], dim=-1)
    upper = torch.cat([A_upper, zeros], dim=-1)
    diag, rhs = A_diagonal, b

    def shift_down(x, s):  # value from row i - s; zero beyond the boundary
        return torch.cat([torch.zeros_like(x[..., :s]), x[..., :-s]], dim=-1)

    def shift_up(x, s):  # value from row i + s; zero beyond the boundary
        return torch.cat([x[..., s:], torch.zeros_like(x[..., :s])], dim=-1)

    idx = torch.arange(k, device=b.device)
    s = 1
    for _ in range(max(1, (k - 1).bit_length())):
        safe = torch.where(diag == 0, torch.ones_like(diag), diag)
        alpha = torch.where(idx >= s, -lower / shift_down(safe, s), 0.0)
        beta = torch.where(idx < k - s, -upper / shift_up(safe, s), 0.0)
        diag = diag + alpha * shift_down(upper, s) + beta * shift_up(lower, s)
        rhs = rhs + alpha * shift_down(rhs, s) + beta * shift_up(rhs, s)
        lower = alpha * shift_down(lower, s)
        upper = beta * shift_up(upper, s)
        s *= 2
    return rhs / diag


def tridiagonal_solve(b, A_upper, A_diagonal, A_lower, *, method="auto"):
    """Solves the tridiagonal system Ax = b (reference: misc.py:13-67).

    method: "thomas" (sequential, minimal flops), "pcr" (log-depth), or
    "kernel" / "auto" (K4 on CUDA float32/bfloat16 operands, Thomas
    elsewhere: ``ops/dispatch.py``'s rule)."""
    if method == "thomas":
        return tridiagonal_solve_thomas(b, A_upper, A_diagonal, A_lower)
    if method == "pcr":
        return tridiagonal_solve_pcr(b, A_upper, A_diagonal, A_lower)
    if method in ("auto", "kernel"):
        from .tridiagonal_kernel import tridiagonal_solve_kernel

        return tridiagonal_solve_kernel(b, A_upper, A_diagonal, A_lower)
    raise ValueError(f"Unknown tridiagonal method {method!r}")
