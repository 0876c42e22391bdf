"""A local launcher of one process group (what ``torchrun`` does on one
host), with a join timeout: the rehearsal of several ranks on one card,
the CPU tests' gloo groups and the multichip dry run start their ranks
through it.

Each rank is ``python <argv>`` with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
``OMP_NUM_THREADS`` 1 (the ranks share the host's cores); ``one_device``
gives every rank ``LOCAL_RANK`` 0 (all ranks on one card, over gloo). A
rank that exits non-zero, or a group that overruns ``timeout``, kills
every rank and raises with the tails of their output.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

THREADS = 1  # OMP_NUM_THREADS of each rank


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: list[str], world: int, timeout: float = 180.0, one_device: bool = False,
           cwd: str | None = None) -> list[str]:
    """Run ``world`` ranks of ``python <argv>`` to the end; returns each
    rank's standard output. Raises RuntimeError when a rank fails or the
    group overruns ``timeout`` seconds (every rank is killed first)."""
    port = free_port()
    logs = tempfile.mkdtemp(prefix="uasr_ranks_")
    procs, files = [], []
    for r in range(world):
        e = dict(os.environ)
        e.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0" if one_device else str(r),
                 LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                 OMP_NUM_THREADS=str(THREADS))
        out = open(os.path.join(logs, f"rank{r}.out"), "w+")
        err = open(os.path.join(logs, f"rank{r}.err"), "w+")
        files.append((out, err))
        procs.append(subprocess.Popen([sys.executable, *argv], stdout=out, stderr=err, env=e,
                                      cwd=cwd))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the group overran its {timeout:.0f} s join timeout"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    tails = []
    for r, (out, err) in enumerate(files):
        out.seek(0)
        err.seek(0)
        o, e = out.read(), err.read()
        out.close()
        err.close()
        outs.append(o)
        tails.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n{o[-1500:]}\n{e[-3000:]}")
    shutil.rmtree(logs, ignore_errors=True)
    if failed is not None:
        raise RuntimeError(f"{failed}\n" + "\n".join(tails))
    return outs
