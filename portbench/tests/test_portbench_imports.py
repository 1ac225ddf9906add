"""What the benchmark loads: never JAX or the JAX package, and for the
reference and the work counts nothing of the system either. Top-level
module names are compared whole: the system's package, robosat_tpu_torch,
begins with the JAX package's name."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.harness import main as harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
JAX = {"jax", "jaxlib", "flax", "robosat_tpu"}


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported(path) & JAX


@pytest.mark.parametrize("sub", ["reference", "work"])
def test_the_yardstick_imports_nothing_of_the_system(sub):
    for path in _sources(sub):
        assert "robosat_tpu_torch" not in _imported(path), path


def _loaded_by(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys; print(' '.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return {m.split(".")[0] for m in out.stdout.split()}


def test_the_reference_loads_nothing_of_the_system_or_jax():
    loaded = _loaded_by("import portbench.reference.unet, portbench.reference.deeplabv3plus, "
                        "portbench.reference.train, portbench.work.unet, portbench.work.deeplabv3plus")
    assert not loaded & (JAX | {"robosat_tpu_torch"})


def test_a_run_loads_the_system_and_no_jax():
    loaded = _loaded_by("import portbench.harness.main, portbench.drivers.predict, portbench.drivers.train\n"
                        "import robosat_tpu_torch.parallel.steps, robosat_tpu_torch.tools.predict, "
                        "robosat_tpu_torch.optim")
    assert "robosat_tpu_torch" in loaded
    assert not loaded & JAX


def test_the_run_refuses_jax_by_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "robosat_tpu_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "robosat_tpu.models", sys)
    assert harness.forbidden_modules() == ["robosat_tpu"]
