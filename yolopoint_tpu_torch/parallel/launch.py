"""Start the ranks of a process group as worker processes of one host.

`run_ranks(n, argv, timeout)` picks a free localhost port for the group's
TCP store, starts `n` processes (`argv(rank, addr)` each, `LOCAL_RANK` set)
and waits for all of them under one deadline. A worker that fails, or the
deadline, stops every worker still running, so a collective left waiting
for a dead peer cannot hang the caller. The dry run
(`parallel.dryrun`), `chip_smoke.py` and the tests' gloo workers start
their ranks through it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Callable, Optional, Sequence

POLL_S = 0.05


def free_port() -> int:
    """A localhost TCP port that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def run_ranks(n: int, argv: Callable[[int, str], Sequence[str]], timeout: float,
              env: Optional[dict] = None, cwd=None, capture: bool = True) -> list:
    """Run ranks 0..n-1 as processes `argv(rank, "127.0.0.1:<port>")`, each
    with `LOCAL_RANK=<rank>` over `env` (default: this environment).
    Returns `(returncode, output)` a rank, in rank order (`output` the
    merged stdout and stderr, or None where `capture` is false and they go
    to this process's). A worker that exits nonzero stops the others; the
    deadline, `timeout` seconds away, stops them all and raises
    `TimeoutError`."""
    addr = f"127.0.0.1:{free_port()}"
    base = dict(os.environ if env is None else env)
    late = False
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") if capture else None
                for r in range(n)]
        procs = []
        try:
            for r in range(n):
                procs.append(subprocess.Popen(
                    list(argv(r, addr)), cwd=cwd, env={**base, "LOCAL_RANK": str(r)},
                    stdout=logs[r], stderr=subprocess.STDOUT if capture else None,
                    text=True))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs if p.returncode is not None):
                    break  # a failed rank: its peers would wait on it
                if time.monotonic() > deadline:
                    late = True
                    break
                time.sleep(POLL_S)
        finally:
            _stop(procs)
            outputs = []
            for f in logs:
                if f is not None:
                    f.seek(0)
                    outputs.append(f.read())
                    f.close()
                else:
                    outputs.append(None)
    if late:
        tails = "".join(f"\n--- rank {r}:\n{(out or '')[-3000:]}" for r, out in enumerate(outputs))
        raise TimeoutError(f"a rank of {n} took more than {timeout:.0f} s{tails}")
    return [(p.returncode, out) for p, out in zip(procs, outputs)]
