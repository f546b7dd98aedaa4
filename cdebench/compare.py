"""The numbers that decide ``correct``, each between two records.

Training: each of the first three steps' losses (and the first alone), the
first gradient's norm and the norm of the parameters' change after the
three, each leaf's norm against the reference's, the worst leaf counting,
and the first step's logits.  Inference: the logits of sampled calls.  For
logits, the widest gap (``logit_gap``) and the rows' own rounding
(``lane_noise``), which an adaptive solve's mesh does not move.  A cell's ``workloads/<cell>.json``
names the numbers that it compares and their limits; see ``PERF.md``.
"""

import statistics

import torch


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in tree.items()}


def worst_leaf_gap(program, reference, leaves=None):
    """max over leaves of |norm(program) - norm(reference)| over the larger of
    the reference leaf's norm and the median leaf's norm."""
    p, r = _norms(program), _norms(reference)
    leaves = list(r) if leaves is None else leaves
    median = statistics.median(r[k] for k in leaves)
    if any(p[k] != p[k] or p[k] == float("inf") for k in leaves):  # not finite
        return float("inf")
    return max(abs(p[k] - r[k]) / max(r[k], median, 1e-300) for k in leaves)


def moving_leaves(grad1):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = _norms(grad1)
    median = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= 1e-3 * median]


def loss_consistency(loss, logits, labels):
    """|the program's loss - the mean binary cross entropy of the program's
    own logits|, relative: the loss layer judged on the forward's output,
    which no solver mesh moves."""
    expected = float(bce_mean(logits.to(torch.float64), labels.to(torch.float64)))
    if loss != loss:
        return float("inf")
    return abs(loss - expected) / abs(expected)


def bce_mean(logits, labels):
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def train_readings(program, reference, x, labels, blocks):
    """program, reference: {"losses", "grad1", "change", "logits1"} (see
    reference.model); x, labels: the first step's raw spirals and labels;
    blocks: the solver's independent row blocks."""
    loss_gap = max(_loss_gap(p, r) for p, r in zip(program["losses"], reference["losses"]))
    return {
        "loss_gap": loss_gap,
        "loss1_gap": _loss_gap(program["losses"][0], reference["losses"][0]),
        "grad_norm_gap": worst_leaf_gap(program["grad1"], reference["grad1"]),
        "change_norm_gap": worst_leaf_gap(program["change"], reference["change"],
                                          moving_leaves(reference["grad1"])),
        "logit_gap": logit_gap(program["logits1"], reference["logits1"]),
        "lane_noise": lane_noise(program["logits1"], reference["logits1"], x, blocks),
        "loss_consistency": loss_consistency(program["losses"][0], program["logits1"], labels),
    }


def _loss_gap(program, reference):
    """|program - reference| / |reference|; a loss that is NaN reads infinite."""
    if program != program:
        return float("inf")
    return abs(program - reference) / abs(reference)


def logit_gap(program, reference):
    """The widest |program - reference| over the rows, over the larger of 1
    and the reference's largest magnitude; a row that is not finite reads
    infinite."""
    program, reference = program.to(torch.float64), reference.to(torch.float64)
    if not bool(torch.isfinite(program).all()):
        return float("inf")
    scale = max(1.0, float(reference.abs().max()))
    return float((program - reference).abs().max()) / scale


def verdict(readings, limits):
    """(correct, lines): each number that the cell's limits name against its
    limit; a number without a reading fails."""
    ok, lines = True, []
    for name, limit in limits.items():
        value = readings.get(name, float("inf"))
        ok = ok and limit is not None and value <= limit
        lines.append((name, value, limit))
    return ok, lines


def lane_noise(program, reference, x, blocks):
    """The root mean square, over the rows, of the gap between a row's error
    (program - reference) and the error that its two neighbours in phase
    predict for it, linearly in phase, over the larger of 1 and the
    reference's largest magnitude.

    Rows of one block (one mesh: a dopri5 group) and one chirality are
    sorted by their spiral's phase.  Where the program and the reference
    step on different meshes, each row's error holds a part that all rows of
    the block share, smooth in the phase; what the neighbours cannot
    predict is each row's own rounding.  ``x``: the raw spirals (B, L, 3)."""
    program, reference = program.to(torch.float64), reference.to(torch.float64)
    if not bool(torch.isfinite(program).all()):
        return float("inf")
    x = x.to(torch.float64)
    phase = torch.atan2(x[:, 0, 2], x[:, 0, 1])
    chirality = torch.sign(x[:, 1, 2] * x[:, 0, 1] - x[:, 1, 1] * x[:, 0, 2])
    err = program - reference
    total, count = 0.0, 0
    for rows in blocks:
        for side in (-1.0, 1.0):
            idx = torch.nonzero(chirality[rows] == side).flatten() + rows.start
            if idx.numel() < 3:
                continue
            order = idx[torch.argsort(phase[idx])]
            p, e = phase[order], err[order]
            span = p[2:] - p[:-2]
            ok = span > 0
            w = torch.where(ok, (p[2:] - p[1:-1]) / torch.where(ok, span, 1.0), 0.5)
            resid = e[1:-1] - (w * e[:-2] + (1 - w) * e[2:])
            total += float((resid * resid).sum())
            count += resid.numel()
    return (total / max(count, 1)) ** 0.5 / max(1.0, float(reference.abs().max()))
