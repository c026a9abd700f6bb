"""The port's tools, and the test files that run on a card's machine
without JAX, stand alone as the rest of the port does: they import neither
JAX nor the JAX package, nor OpenCV (the same static scan as
`tests/test_torch_nojax.py`)."""

from pathlib import Path

import pytest

from tests.test_torch_nojax import FORBIDDEN, _imported_modules

REPO = Path(__file__).resolve().parents[1]


def test_train_profiler_imports_no_jax():
    path = REPO / "tools" / "profile_torch_train.py"
    bad = [m for m in _imported_modules(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", ["tools/bench_torch_nms.py", "tools/bench_torch_warp.py",
                                  "tools/bench_torch_box_nms.py",
                                  "tests/test_torch_box_nms_blocks.py",
                                  "tests/test_torch_nms_tiles.py",
                                  "tests/test_torch_warp_tiles.py"])
def test_card_side_files_import_no_jax(name):
    path = REPO / name
    bad = [m for m in _imported_modules(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path.name} imports {bad}"
