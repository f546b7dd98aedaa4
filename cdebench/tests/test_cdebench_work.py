"""The work and bound arithmetic against counts made by hand for each
cell's shapes (H 8, C 3, W 128, length 100, so 99 intervals)."""

import json

import pytest

from cdebench import peaks
from cdebench.work import dopri5, rk4

F = 2 * 128 * 8 * 4  # one field evaluation of one row: 8192 FLOPs


def model(name, root):
    return json.loads((root / "cdebench" / "configs" / f"{name}.json").read_text())["model"]


@pytest.mark.parametrize("batch", [16384, 65536])
def test_rk4_work(root, batch):
    w = rk4.work(model("spiral-rk4-h8", root), batch, 100)
    assert rk4.field_flops(model("spiral-rk4-h8", root)) == F
    assert w["model_flops_fwd"] == 4 * 99 * batch * F
    k1 = w["kernels"]["K1"]
    assert k1["fwd_by"] == k1["bwd_by"] == "operations"
    assert k1["fwd_s"] == pytest.approx(4 * 99 * batch * F / 67e12)
    assert k1["bwd_s"] == pytest.approx(3 * 4 * 99 * batch * F / 67e12)


@pytest.mark.parametrize("batch", [4096, 16384])
def test_dopri5_work(root, batch):
    groups = [{"rows": 4096, "accepted": 81 + g, "attempted": 150 + 2 * g}
              for g in range(batch // 4096)]
    w = dopri5.work(model("spiral-dopri5-adjoint-h8", root), batch, 100, groups)
    acc = sum(g["accepted"] for g in groups)
    att = sum(g["attempted"] for g in groups)
    assert w["model_flops_fwd"] == 6 * acc * 4096 * F
    k2 = w["kernels"]["K2"]
    assert k2["fwd_s"] == pytest.approx((6 * att + len(groups)) * 4096 * F / 67e12)
    assert k2["bwd_s"] == pytest.approx(21 * acc * 4096 * F / 67e12)


def test_dopri5_counts_must_cover_the_batch(root):
    with pytest.raises(ValueError):
        dopri5.work(model("spiral-dopri5-adjoint-h8", root), 8192, 100,
                    [{"rows": 4096, "accepted": 1, "attempted": 1}])


def test_bound_takes_the_larger_side():
    assert peaks.bound(3.35e12, 1.0) == (1.0, "bytes")
    assert peaks.bound(1.0, 67e12) == (1.0, "operations")
