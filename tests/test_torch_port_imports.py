"""robosat_tpu_torch and chip_smoke.py import nothing of `robosat_tpu` and no JAX.

The port keeps its own copies of the host modules it needs; an import of
the JAX package (even of a module of it that is free of JAX) would let a
change there move both sides of every parity test at once. An AST scan of
every source file pins the static imports; a fresh interpreter that loads
the port's entry points pins what they pull in at run time.
"""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = sorted(glob.glob(os.path.join(ROOT, "robosat_tpu_torch", "**", "*.py"), recursive=True)) + [
    os.path.join(ROOT, "chip_smoke.py")
]


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("robosat_tpu", "jax", "jaxlib")


@pytest.mark.parametrize("path", _SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax_package(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
            bad.append(node.module)
    assert not bad, "{} imports {}".format(os.path.relpath(path, ROOT), bad)


def test_entry_points_load_no_jax_package():
    code = (
        "import sys\n"
        "import robosat_tpu_torch.tools.predict, robosat_tpu_torch.tools.train, robosat_tpu_torch.checkpoint\n"
        "import robosat_tpu_torch.ops.int8_mm, robosat_tpu_torch.ops.head_rungs\n"
        "import robosat_tpu_torch.models.fastnet, robosat_tpu_torch.models.qconv, robosat_tpu_torch.models.deeplab\n"
        "import robosat_tpu_torch.models.segformer\n"
        "import robosat_tpu_torch.tools.features, robosat_tpu_torch.tools.merge, robosat_tpu_torch.tools.dedupe\n"
        "import robosat_tpu_torch.tools.__main__\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('robosat_tpu', 'jax', 'jaxlib'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
