"""The port's training profiler stands alone as the rest of the port does:
it imports neither JAX nor the JAX package (the same static scan as
`tests/test_torch_nojax.py`)."""

from pathlib import Path

from tests.test_torch_nojax import FORBIDDEN, _imported_modules

REPO = Path(__file__).resolve().parents[1]


def test_train_profiler_imports_no_jax():
    path = REPO / "tools" / "profile_torch_train.py"
    bad = [m for m in _imported_modules(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path.name} imports {bad}"
