"""The harness: generators deterministic by seed, cells and metrics added
as files, no CPU fallback, no JAX, and the cells on the card."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.core import files
from benchmark.tests import tiny


def _traffic(kind: str, cell: str, **small):
    p = dict(files.workload(cell)["traffic"], **small)
    return files.module("traffic", kind), p


def test_bucketed_traffic_is_a_function_of_the_seed():
    gen, p = _traffic("bucketed", "librispeech_ctc_bigru.decode_64", batch=4, batches=6)
    a, b, c = gen.generate(p, 7), gen.generate(p, 7), gen.generate(p, 2 ** 31 + 5)
    assert all(np.array_equal(x, y) for ba, bb in zip(a, b) for x, y in zip(ba, bb))
    assert not np.array_equal(a[0][0], c[0][0])
    # every seed gets the same lengths and the same bucket sequence
    assert sorted(n for bt in a for n in bt[1].tolist()) == sorted(n for bt in c for n in bt[1].tolist())
    assert [bt[0].shape for bt in a] == [bt[0].shape for bt in c]


def test_slot_backlog_is_a_function_of_the_seed():
    gen, p = _traffic("slots", "aishell_streaming.stream_256", utterances=64)
    a, b, c = gen.generate(p, 3), gen.generate(p, 3), gen.generate(p, 4)
    assert np.array_equal(a.samples, b.samples) and np.array_equal(a.audio(5), b.audio(5))
    assert sorted(a.samples) == sorted(c.samples) and not np.array_equal(a.samples, c.samples)
    out = np.ones(10240, np.float32)
    n = int(a.samples[0])
    a.chunk_into(out, 0, n // 10240)
    assert not out[n % 10240:].any()


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_added_as_files_run(tmp_path):
    """A copy with one more workload file and one more metric file (and
    their entries) lists and runs them; no file already there changes."""
    copy = tiny.make_copy(tmp_path)
    before = _digest(copy / "benchmark")
    (copy / "benchmark" / "metrics" / "calls_traced.extra.py").write_text(
        "def read(ctx):\n    return float(len(ctx.calls))\n")
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "calls_traced.extra", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "run loop",
                              "moves": "serve_audio_s_per_s",
                              "workloads": ["tiny_libri.decode_64"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    out = tiny.result(tiny.run(copy, tiny.rehearse("tiny_libri.decode_64", trace=1)))
    assert out["correct"] and out["metrics"]["calls_traced.extra"]["value"] == 3.0
    after = _digest(copy / "benchmark")
    assert all(after[k] == v for k, v in before.items())


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(tiny.REPO / "benchmark" / "run.py"), "--workload",
                        "librispeech_ctc_bigru.decode_64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tiny.REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    import shutil

    shutil.copytree(tiny.REPO / "benchmark", tmp_path / "benchmark")
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "librispeech_ctc_bigru.decode_64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax(tmp_path):
    copy = tiny.make_copy(tmp_path)
    code = tiny.rehearse("tiny_ais.stream_256", trace=1) + (
        "import sys\nfrom benchmark.run import forbidden_modules\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        "assert not forbidden_modules(), forbidden_modules()\n")
    p = tiny.run(copy, "import json\n" + code)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "uasr"} and "uasr_torch" in loaded


def test_reference_imports_nothing_of_the_program():
    ref = tiny.REPO / "benchmark" / "reference"
    for path in ref.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("uasr_torch", "uasr", "jax", "jaxlib", "flax"), (
                    f"{path.name} imports {n}")
    code = ("import sys, importlib, pkgutil, benchmark.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('benchmark.reference.' + m.name)\n"
            "bad = {m.split('.')[0] for m in sys.modules} & {'uasr_torch', 'uasr', 'jax', 'flax'}\n"
            "assert not bad, bad\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in files.spec()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        "2147483690", "--seconds", "2", "--trace", "0"], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
