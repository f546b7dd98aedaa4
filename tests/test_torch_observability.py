"""The port's profiling and checkpoint utilities, on the CPU.

Checkpoints: a model's and Adam's ``state_dict`` round-trip so that a resumed
step equals the uninterrupted one bit for bit; npz files cross between the
JAX package and the port given a tree of the same structure; bfloat16 leaves
survive.  Tracing: ``trace``/``annotate`` write a Chrome trace that names the
annotation; the options PyTorch has no counterpart for raise.
"""

import collections
import glob
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchcde_tpu.utils import load_checkpoint as jax_load_checkpoint
from torchcde_tpu.utils import save_checkpoint as jax_save_checkpoint
from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, make_train_step
from torchcde_tpu_torch.utils import annotate, load_checkpoint, save_checkpoint, trace
from torchcde_tpu_torch.utils.observability import device_profile

torch.set_num_threads(1)
rng = np.random.default_rng(17)


def _flagship_model(seed=0):
    cfg = NeuralCDEConfig(3, 8, 1, width=16, interpolation="cubic", solver="rk4",
                          adjoint=False, step_size=1.0)
    return NeuralCDE(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")


def _batch(seed):
    import torchcde_tpu_torch as tt

    gen = np.random.default_rng(seed)
    x = torch.from_numpy(gen.standard_normal((6, 9, 3)).astype(np.float32))
    y = torch.from_numpy((gen.random(6) > 0.5).astype(np.float32))
    return tt.hermite_cubic_coefficients_with_backward_differences(x), y


def test_checkpoint_roundtrip(tmp_path):
    tree = {"coeffs": torch.from_numpy(rng.standard_normal((3, 9, 12))),
            "params": {"w": torch.from_numpy(rng.standard_normal((4, 4)))}}
    like = {"coeffs": torch.zeros(3, 9, 12, dtype=torch.float64),
            "params": {"w": torch.zeros(4, 4, dtype=torch.float64)}}
    path = str(tmp_path / "ckpt")
    assert save_checkpoint(path, tree) == "npz"
    assert os.path.exists(path + ".npz")
    restored = load_checkpoint(path, like)
    assert torch.equal(restored["coeffs"], tree["coeffs"])
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])


def test_resumed_training_is_bit_identical(tmp_path):
    model = _flagship_model()
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
    step = make_train_step(model, optimizer)
    batches = [_batch(s) for s in range(5)]
    for coeffs, labels in batches[:3]:
        step(coeffs, labels)
    path = tmp_path / "resume"
    assert save_checkpoint(path, {"model": model.state_dict(),
                                  "optimizer": optimizer.state_dict()}) == "npz"
    first = [float(step(*b)) for b in batches[3:]]
    like = {"model": model.state_dict(), "optimizer": optimizer.state_dict()}
    restored = load_checkpoint(path, like)
    model.load_state_dict(restored["model"])
    optimizer.load_state_dict(restored["optimizer"])
    again = [float(step(*b)) for b in batches[3:]]
    assert first == again
    assert first[0] != first[1]
    # the optimizer's non-tensor state keeps its Python types
    group = restored["optimizer"]["param_groups"][0]
    assert isinstance(group["betas"], tuple) and isinstance(group["lr"], float)
    assert group["params"] == optimizer.state_dict()["param_groups"][0]["params"]
    assert isinstance(restored["model"], collections.OrderedDict)


def test_resume_into_a_fresh_model_and_optimizer(tmp_path):
    model = _flagship_model()
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-2, eps=1e-8)
    step = make_train_step(model, optimizer)
    batches = [_batch(s) for s in range(4)]
    for b in batches[:2]:
        step(*b)
    save_checkpoint(tmp_path / "c.npz", {"model": model.state_dict(),
                                          "optimizer": optimizer.state_dict()})
    expected = [float(step(*b)) for b in batches[2:]]
    # A fresh pair, stepped once so that Adam has state of the same structure.
    fresh = _flagship_model(seed=1)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-2, eps=1e-8)
    make_train_step(fresh, fresh_opt)(*batches[0])
    restored = load_checkpoint(tmp_path / "c.npz", {"model": fresh.state_dict(),
                                                    "optimizer": fresh_opt.state_dict()})
    fresh.load_state_dict(restored["model"])
    fresh_opt.load_state_dict(restored["optimizer"])
    fresh_step = make_train_step(fresh, fresh_opt)
    assert [float(fresh_step(*b)) for b in batches[2:]] == expected


def test_bfloat16_leaf_survives(tmp_path):
    leaf = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).bfloat16()
    tree = {"bf16": leaf, "f32": leaf.float() * 3, "n": 4, "nothing": None}
    save_checkpoint(tmp_path / "b", tree)
    with np.load(tmp_path / "b.npz") as data:
        assert data["arr_0"].dtype == np.float32  # stored as its float32 upcast
        assert len(data.files) == 3  # None is an empty subtree
    like = {"bf16": torch.zeros(5, 7, dtype=torch.bfloat16), "f32": torch.zeros(5, 7),
            "n": 0, "nothing": None}
    restored = load_checkpoint(tmp_path / "b", like)
    assert restored["bf16"].dtype == torch.bfloat16
    assert torch.equal(restored["bf16"], leaf)
    assert torch.equal(restored["f32"], leaf.float() * 3)
    assert restored["n"] == 4 and isinstance(restored["n"], int)
    assert restored["nothing"] is None


def test_leaf_count_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path / "m", {"a": torch.zeros(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="holds 2 leaves and `like` has 1"):
        load_checkpoint(tmp_path / "m", {"a": torch.zeros(2)})


@pytest.fixture
def jax_npz_only(monkeypatch):
    """The JAX package's checkpoints take orbax when it imports; block it,
    so they take their npz path."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _cross_tree():
    gen = np.random.default_rng(4)
    return {
        "params": {"w": gen.standard_normal((4, 3)), "b": gen.standard_normal(3)},
        "coeffs": gen.standard_normal((2, 5, 12)).astype(np.float32),
        "layers": [gen.standard_normal(2), (gen.standard_normal(1), gen.integers(0, 9, 4))],
        "step": np.asarray(7, np.int32),
    }


def test_jax_checkpoint_loads_in_the_port(tmp_path, jax_npz_only):
    tree = _cross_tree()
    assert jax_save_checkpoint(str(tmp_path / "j"), jax.tree_util.tree_map(jnp.asarray, tree)) \
        == "npz"
    like = {
        "params": {"w": torch.zeros(4, 3, dtype=torch.float64),
                   "b": torch.zeros(3, dtype=torch.float64)},
        "coeffs": torch.zeros(2, 5, 12),
        "layers": [torch.zeros(2, dtype=torch.float64),
                   (np.zeros(1), torch.zeros(4, dtype=torch.int64))],
        "step": 0,
    }
    restored = load_checkpoint(str(tmp_path / "j"), like)
    assert torch.equal(restored["params"]["w"], torch.from_numpy(tree["params"]["w"]))
    assert torch.equal(restored["params"]["b"], torch.from_numpy(tree["params"]["b"]))
    assert torch.equal(restored["coeffs"], torch.from_numpy(tree["coeffs"]))
    assert torch.equal(restored["layers"][0], torch.from_numpy(tree["layers"][0]))
    assert isinstance(restored["layers"][1], tuple)
    np.testing.assert_array_equal(restored["layers"][1][0], tree["layers"][1][0])
    assert torch.equal(restored["layers"][1][1], torch.from_numpy(tree["layers"][1][1]))
    assert restored["step"] == 7


def test_port_checkpoint_loads_in_jax(tmp_path, jax_npz_only):
    tree = _cross_tree()
    ported = {
        "params": {"w": torch.from_numpy(tree["params"]["w"]),
                   "b": torch.from_numpy(tree["params"]["b"])},
        "coeffs": torch.from_numpy(tree["coeffs"]),
        "layers": [torch.from_numpy(tree["layers"][0]),
                   (tree["layers"][1][0], torch.from_numpy(tree["layers"][1][1]))],
        "step": 7,
    }
    save_checkpoint(str(tmp_path / "p"), ported)
    like = jax.tree_util.tree_map(jnp.zeros_like, jax.tree_util.tree_map(jnp.asarray, tree))
    restored = jax_load_checkpoint(str(tmp_path / "p"), like)
    for got, want in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(tree),
                         strict=True):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_trace_names_the_annotation(tmp_path):
    coeffs, labels = _batch(0)
    model = _flagship_model()
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    with trace(str(tmp_path / "prof")):
        with annotate("train_step"):
            step(coeffs, labels)
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train_step" in names
    assert any(str(n).startswith("aten::") for n in names)


def test_trace_writes_even_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with trace(str(tmp_path)):
            with annotate("failing"):
                raise KeyError("x")
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1


def test_perfetto_link_raises(tmp_path):
    with pytest.raises(ValueError, match="create_perfetto_link"):
        with trace(str(tmp_path), create_perfetto_link=True):
            pass


def test_device_profile_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        device_profile(lambda: torch.zeros(1))
