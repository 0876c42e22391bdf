"""The control: the reference in the precision below the configuration's,
put in the program's place, reads far above the program on one of the
cell's numbers. On the CPU at a small size; on the card at the cells' own
size (``cuda``), where it must fail the cells' own limits."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark.core import files
from benchmark.tests import tiny

CONTROL = {"train": "float8", "decode": "float8", "stream": "bfloat16"}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


def _calibrate(root, cell: str, control: str, seeds: str, device: str, seconds: float):
    p = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", cell, "--seeds",
                        seeds, "--seconds", str(seconds), "--control", control,
                        "--control-seeds", seeds, "--device", device], cwd=root,
                       capture_output=True, text=True, timeout=3000,
                       env=dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{tiny.REPO}"))
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_control_reads_far_above_the_program(copy, cell):
    loop = json.loads((copy / "benchmark" / "workloads" / f"{cell}.json").read_text())["loop"]
    # a window long enough to reach the requests and ticks the check samples
    # (the small cells' first 6), also on a loaded CPU
    rows = _calibrate(copy, cell, CONTROL[loop], "11", "cpu", 2.0)
    prog = next(r for r in rows if r["what"] == "program")
    ctl = next(r for r in rows if r["what"].startswith("control"))
    limits = tiny.LIMITS[loop]
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert any(ctl[k] > limits[k] for k in limits), ctl


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cells' own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in files.spec()["workloads"]])
def test_control_fails_the_cell_limits_on_the_card(card, cell):
    work = files.workload(cell)
    rows = _calibrate(tiny.REPO, cell, CONTROL[work["loop"]], "2147483600,2147483601,2147483602",
                      "cuda", 3.0)
    for r in rows:
        if r["what"].startswith("control"):
            assert any(r[k] > work["limits"][k] for k in work["limits"]), r
