"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, and no file of the port (nor `chip_smoke.py` and the port's
profiling tool) imports them, nor OpenCV (`cv2`), PyYAML, matplotlib,
TensorBoard or Pillow, which the machine that runs the port does not have."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "yolopoint_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "profile_torch_serve.py"]
FORBIDDEN = ("jax", "yolopoint_tpu", "flax", "optax", "orbax", "cv2", "yaml", "matplotlib",
             "tensorboard", "PIL")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports_in_source(path):
    bad = [m for m in _imported_modules(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import pkgutil, sys, yolopoint_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'yolopoint_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('yolopoint_tpu_torch')]))\n"
    ) % (FORBIDDEN,)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15  # every module of the port was imported
