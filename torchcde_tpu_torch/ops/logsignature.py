"""Logsignatures of piecewise-linear paths (port of
``torchcde_tpu/ops/logsignature.py``).

Work in the truncated tensor algebra T^{<=d}(R^c): a group element is its
levels, flattened tensors (..., c^k) for k = 1..d.

* the signature of one linear segment with increment v is exp(v) =
  (v, v^{(2)}/2!, ..., v^{(d)}/d!);
* segment signatures combine by Chen's identity, an associative but not
  commutative product, so the prefix signatures of a path are one
  log-depth inclusive scan (``prefix_signatures``);
* the signature of a window [a, b] is P_a^{-1} x P_b with the truncated
  group inverse, or a pairwise tree reduction of its segments;
* log is the truncated series log(1 + s) = sum (-1)^{m+1} s^m / m;
* coordinates are the tensor-log coefficients at the Lyndon words
  (signatory's default ``mode="words"``): 3 channels give 3/6/14 at depth
  1/2/3.

The JAX package computes none of this in a Pallas kernel, so it is plain
PyTorch on the card too.  The host-side Lyndon tables are this module's own
copy.
"""

import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Lyndon words (host-side, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def lyndon_words(channels: int, depth: int):
    """All Lyndon words over {0..channels-1} of length 1..depth, by (length,
    lexicographic) order: Duval's generation algorithm."""
    words = []
    w = [-1]
    while w:
        w[-1] += 1
        m = len(w)
        if w[-1] < channels:
            words.append(tuple(w))
            while len(w) < depth:
                w.append(w[-m])
        else:
            w.pop()
            continue
        while w and w[-1] == channels - 1:
            w.pop()
    words.sort(key=lambda word: (len(word), word))
    return tuple(words)


@functools.lru_cache(maxsize=None)
def logsignature_channels(channels: int, depth: int) -> int:
    """Dimension of the depth-d logsignature (the number of Lyndon words);
    ``signatory.logsignature_channels``'s equivalent."""
    return len(lyndon_words(channels, depth))


@functools.lru_cache(maxsize=None)
def _lyndon_indices(channels: int, depth: int):
    """Flat tensor-algebra index of each Lyndon word, grouped by length."""
    by_len = {k: [] for k in range(1, depth + 1)}
    for word in lyndon_words(channels, depth):
        idx = 0
        for letter in word:
            idx = idx * channels + letter
        by_len[len(word)].append(idx)
    return {k: np.asarray(v, dtype=np.int64) for k, v in by_len.items()}


# ---------------------------------------------------------------------------
# Truncated tensor algebra (levels are flattened tensors (..., c^k))
# ---------------------------------------------------------------------------


def _outer(a, b, c_a, c_b):
    return (a[..., :, None] * b[..., None, :]).reshape(a.shape[:-1] + (c_a * c_b,))


def tensor_exp(v, depth):
    """exp of a level-1 element: the signature of one linear segment."""
    c = v.shape[-1]
    levels = [v]
    power = v
    fact = 1.0
    for k in range(2, depth + 1):
        power = _outer(power, v, c ** (k - 1), c)
        fact *= k
        levels.append(power / fact)
    return tuple(levels)


def chen_product(A, B):
    """Chen's identity: the group product in T^{<=d} (implicit unit level 0)."""
    depth = len(A)
    c = A[0].shape[-1]
    out = []
    for k in range(1, depth + 1):
        term = A[k - 1] + B[k - 1]
        for i in range(1, k):
            term = term + _outer(A[i - 1], B[k - i - 1], c**i, c ** (k - i))
        out.append(term)
    return tuple(out)


def _mul_no_unit(s, t):
    """(s * t)_k for non-unital elements (level-0 coefficient zero)."""
    depth = len(s)
    c = s[0].shape[-1]
    out = []
    for k in range(1, depth + 1):
        term = None
        for i in range(1, k):
            prod = _outer(s[i - 1], t[k - i - 1], c**i, c ** (k - i))
            term = prod if term is None else term + prod
        if term is None:
            term = torch.zeros_like(s[k - 1])
        out.append(term)
    return tuple(out)


def group_inverse(A):
    """(1 + s)^{-1} = 1 - s + s^2 - ... truncated at depth."""
    depth = len(A)
    acc = tuple(-a for a in A)
    power = A
    sign = 1.0
    for _m in range(2, depth + 1):
        power = _mul_no_unit(power, A)
        acc = tuple(x + sign * p for x, p in zip(acc, power))
        sign = -sign
    return acc


def tensor_log(A):
    """log(1 + s) = s - s^2/2 + s^3/3 - ... truncated at depth."""
    depth = len(A)
    acc = tuple(A)
    power = A
    for m in range(2, depth + 1):
        power = _mul_no_unit(power, A)
        coef = ((-1.0) ** (m + 1)) / m
        acc = tuple(x + coef * p for x, p in zip(acc, power))
    return acc


def lyndon_coordinates(log_levels):
    """The tensor-log coefficients at the Lyndon-word indices (signatory's
    default ``mode="words"`` basis), concatenated by word length."""
    depth = len(log_levels)
    c = log_levels[0].shape[-1]
    idx = _lyndon_indices(c, depth)
    parts = []
    for k in range(1, depth + 1):
        if idx[k].size:
            index = torch.from_numpy(idx[k]).to(log_levels[k - 1].device)
            parts.append(torch.index_select(log_levels[k - 1], -1, index))
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# Path signatures
# ---------------------------------------------------------------------------


def prefix_signatures(increments, depth):
    """Prefix signatures P_i = exp(dx_1) x ... x exp(dx_i) along axis -2.

    increments: (..., n, c).  Returns levels (..., n, c^k).  The JAX
    package's ``lax.associative_scan`` becomes a Hillis-Steele scan: at
    distance s = 1, 2, 4, ..., each prefix i >= s takes P_{i-s} x P_i, the
    earlier prefix always on the left (Chen's product does not commute)."""
    levels = tensor_exp(increments, depth)
    n = increments.shape[-2]
    shift = 1
    while shift < n:
        earlier = tuple(lvl[..., : n - shift, :] for lvl in levels)
        later = tuple(lvl[..., shift:, :] for lvl in levels)
        combined = chen_product(earlier, later)
        levels = tuple(torch.cat([lvl[..., :shift, :], comb], dim=-2)
                       for lvl, comb in zip(levels, combined))
        shift *= 2
    return levels


def chen_reduce(levels):
    """Ordered Chen product along axis -2 by pairwise tree reduction.

    Unlike ``prefix_signatures`` this computes only the total product,
    halving the data each pass.  The all-zero element is the group unit, so
    padded (zero-increment) segments are no-ops.  An odd count carries its
    last element to the next pass."""
    m = levels[0].shape[-2]
    while m > 1:
        half = m // 2
        evens = tuple(lvl[..., 0 : 2 * half : 2, :] for lvl in levels)
        odds = tuple(lvl[..., 1 : 2 * half : 2, :] for lvl in levels)
        combined = chen_product(evens, odds)
        if m % 2:
            combined = tuple(torch.cat([comb, lvl[..., -1:, :]], dim=-2)
                             for comb, lvl in zip(combined, levels))
        levels = combined
        m = half + (m % 2)
    return tuple(lvl[..., 0, :] for lvl in levels)


def path_signature(path, depth):
    """Signature of a piecewise-linear path (..., length, c) over its whole
    span: the batched equivalent of signatory.Signature."""
    increments = path[..., 1:, :] - path[..., :-1, :]
    prefixes = prefix_signatures(increments, depth)
    return tuple(level[..., -1, :] for level in prefixes)


def path_logsignature(path, depth, mode="words"):
    """Logsignature of a piecewise-linear path (..., length, c): the batched
    equivalent of signatory.Logsignature(depth)."""
    sig = path_signature(path, depth)
    log_levels = tensor_log(sig)
    if mode == "tensor":
        return log_levels
    elif mode == "words":
        return lyndon_coordinates(log_levels)
    raise ValueError(f"Unknown logsignature mode {mode!r}")


def windowed_logsignatures(path, depth, boundaries):
    """Logsignatures of the windows [boundaries[i], boundaries[i+1]] of a
    piecewise-linear path, all at once.

    path: (..., length, c); boundaries: indices (n_windows + 1,) into the
    length axis.  Returns (..., n_windows, logsig_channels).

    Host boundaries (a sequence or a NumPy array, the offline case) gather
    each window's segments into a (n_windows, max_window) block, padded
    with zero increments (the group unit), reduced by ``chen_reduce``;
    uniform contiguous windows are a reshape.  Boundaries given as a tensor,
    or windows so skewed that the padding would pass four times the path
    (``max_window * n_windows > 4 * n``), take one prefix scan and two
    gathers: window signature = P_a^{-1} x P_b."""
    increments = path[..., 1:, :] - path[..., :-1, :]
    n = increments.shape[-2]
    c = path.shape[-1]

    b_np = None
    if not isinstance(boundaries, torch.Tensor):
        b_np = np.asarray(boundaries).astype(np.int64)
        lens = b_np[1:] - b_np[:-1]
        nw = len(lens)
        maxw = int(lens.max()) if nw else 0
        if nw == 0 or maxw * nw > 4 * n:
            b_np = None

    if b_np is not None:
        batch_shape = increments.shape[:-2]
        uniform = maxw * nw == n and int(lens.min()) == maxw and b_np[0] == 0
        if uniform:
            blocks = increments.reshape(batch_shape + (nw, maxw, c))
        else:
            idx = b_np[:-1, None] + np.arange(maxw)[None, :]
            valid = idx < b_np[1:, None]
            index = torch.from_numpy(np.clip(idx, 0, n - 1).reshape(-1)).to(path.device)
            blocks = torch.index_select(increments, -2, index).reshape(batch_shape + (nw, maxw, c))
            blocks = blocks * torch.from_numpy(valid).to(dtype=path.dtype, device=path.device)[..., None]
        window_sigs = chen_reduce(tensor_exp(blocks, depth))
        return lyndon_coordinates(tensor_log(window_sigs))

    if isinstance(boundaries, torch.Tensor):
        boundaries = boundaries.to(device=path.device, dtype=torch.long)
    else:
        boundaries = torch.as_tensor(np.asarray(boundaries, dtype=np.int64), device=path.device)
    prefixes = prefix_signatures(increments, depth)
    # P_0 = identity (zero levels); prefix index i covers segments 1..i,
    # i.e. grid position i.
    padded = tuple(torch.cat([torch.zeros_like(lvl[..., :1, :]), lvl], dim=-2)
                   for lvl in prefixes)
    starts = tuple(torch.index_select(lvl, -2, boundaries[:-1]) for lvl in padded)
    ends = tuple(torch.index_select(lvl, -2, boundaries[1:]) for lvl in padded)
    window_sigs = chen_product(group_inverse(starts), ends)
    return lyndon_coordinates(tensor_log(window_sigs))
