"""The port's public names against the JAX package's.

Every name that an ``__init__.py`` of the JAX package exports (its relative
imports and the functions and classes it defines) resolves on the port's
counterpart, under the same name, or under the name ``RENAMED`` gives it, or
is one of the ``JAX_ONLY`` names, each with the reason it has no port.  The
JAX package's files are read as source: nothing of JAX is imported here.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ("", "interpolation", "solvers", "ops", "utils", "models", "parallel", "native")

# (JAX module, name) -> the port's name for it.
RENAMED = {
    ("ops", "tridiagonal_solve_pallas"): "tridiagonal_solve_kernel",  # K4, a CUDA kernel
}

# (JAX module, name) -> why the port has no counterpart.
JAX_ONLY = {
    ("interpolation", "register_control"):
        "registers a control class as a JAX pytree; PyTorch has no pytree registry that "
        "cdeint reads",
    ("utils", "is_concrete"):
        "tells a concrete array from a JAX tracer; PyTorch runs eagerly and traces nothing",
    ("models", "init_neural_cde"):
        "the functional model's parameter pytree; the port's model is the NeuralCDE "
        "module, which interop.from_jax_params loads from those parameters",
    ("models", "neural_cde_apply"):
        "the functional model's forward over a parameter pytree; the port's is "
        "NeuralCDE.forward",
    ("models", "cde_func"):
        "the functional model's vector field over a parameter pytree; the port's is "
        "the MLPVectorField module",
    ("models.flax_interop", "CDEFunc"):
        "a Flax module; the port's modules are torch.nn modules (NeuralCDE, "
        "MLPVectorField)",
}


def _exports(sub):
    """The names ``torchcde_tpu/<sub>/__init__.py`` exports."""
    path = ROOT / "torchcde_tpu" / sub / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level >= 1:
            names += [alias.asname or alias.name for alias in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
    return names


def _port(sub):
    return importlib.import_module("torchcde_tpu_torch" + ("." + sub if sub else ""))


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top level")
def test_every_jax_export_resolves_on_the_port(sub):
    names = _exports(sub)
    assert names, f"no exports read from torchcde_tpu/{sub}/__init__.py"
    port = _port(sub)
    missing = [name for name in names
               if (sub, name) not in JAX_ONLY
               and not hasattr(port, RENAMED.get((sub, name), name))]
    assert not missing, f"torchcde_tpu_torch.{sub} lacks {missing}"


@pytest.mark.parametrize("sub", [s for s in SUBPACKAGES if s != "native"],
                         ids=lambda s: s or "top level")
def test_the_port_lists_its_exports(sub):
    """Each of the port's subpackages names its exports in ``__all__``, and
    each resolves."""
    port = _port(sub)
    assert all(hasattr(port, name) for name in port.__all__)
    wanted = {RENAMED.get((sub, name), name) for name in _exports(sub)
              if (sub, name) not in JAX_ONLY}
    assert wanted <= set(port.__all__) | {"__version__"}, wanted - set(port.__all__)


@pytest.mark.parametrize("where", sorted(JAX_ONLY), ids=lambda w: ".".join(w))
def test_the_jax_only_names_exist_only_in_jax(where):
    """The list stays honest: each name is the JAX package's and not the
    port's, and has its reason."""
    module, name = where
    assert JAX_ONLY[where]
    if "." in module:  # a module the JAX __init__ does not import
        path = ROOT / "torchcde_tpu" / (module.replace(".", "/") + ".py")
        tree = ast.parse(path.read_text())
        assert name in {n.name for n in tree.body if isinstance(n, ast.ClassDef)}
        port = ROOT / "torchcde_tpu_torch" / (module.replace(".", "/") + ".py")
        assert not port.exists()
        return
    assert name in _exports(module)
    assert not hasattr(_port(module), name)


def test_renamed_names_are_the_jax_exports():
    for (sub, name), port_name in RENAMED.items():
        assert name in _exports(sub)
        assert callable(getattr(_port(sub), port_name))
