"""`tools/profile_torch_train.py` sets up its import path so that the
standard `profile` module, not the JAX package's `tools/profile.py`, backs
`cProfile`, which `torch._dynamo` imports when the agent's optimizer is
built. The script is loaded as Python runs it (its directory first on the
path) without running `main`, and `torch._dynamo` is imported after it."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

CHECK = """
import runpy, sys
sys.path.insert(0, {tools!r})  # as Python does for a script
runpy.run_path({script!r}, run_name="profile_torch_train")
import cProfile, profile, sysconfig
from pathlib import Path
stdlib = Path(sysconfig.get_paths()["stdlib"]).resolve()
assert Path(profile.__file__).resolve().parent == stdlib, profile.__file__
assert cProfile.run.__module__ == "cProfile" and callable(profile.run)
import torch._dynamo  # noqa: F401  (imports cProfile; failed with the shadowing module)
print("ok")
"""


def run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_profile_tool_loads_the_standard_profile():
    tools = str(REPO / "tools")
    proc = run(CHECK.format(tools=tools, script=str(REPO / "tools" / "profile_torch_train.py")))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]


def test_the_tools_directory_shadows_profile_without_the_setup():
    tools = str(REPO / "tools")
    proc = run(f"import sys; sys.path.insert(0, {tools!r}); import cProfile")
    assert proc.returncode != 0 and "profile" in proc.stderr
