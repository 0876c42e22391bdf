"""A copy of the benchmark with small cells, for rehearsing it on the CPU.

``make_copy(dest)`` copies ``benchmark/`` and ``BENCHMARK.json`` into
``dest`` and adds, as new files and entries only, two small configurations
(``tiny_libri``, ``tiny_ais``: the recipes at small widths) and a small cell
for each loop, which report the same metrics as the cells they shrink.
``run(dest, code)`` runs Python ``code`` in a fresh process whose
``benchmark`` package is the copy's (the program under test comes from the
repository).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CELLS = {
    "tiny_libri.train_bucketed": "librispeech_ctc_bigru.train_bucketed",
    "tiny_libri.decode_64": "librispeech_ctc_bigru.decode_64",
    "tiny_ais.stream_256": "aishell_streaming.stream_256",
}
# limits for the small cells on the CPU, a few times the readings of a
# sound CPU run (the cells' own limits hold at their sizes on the card)
LIMITS = {
    "train": {"features": 1e-3, "logits": 0.1, "grad": 0.05, "change": 0.1,
              "warm_features": 1e-3, "warm_logits": 0.1, "warm_loss": 0.015, "warm_change": 0.1},
    "decode": {"features": 1e-3, "logits": 0.05, "transcript": 2.0, "transcript_mean": 0.5},
    "stream": {"features": 1e-3, "logits": 1e-3, "transcript_mean": 0.1},
}


def make_copy(dest: Path) -> Path:
    dest = Path(dest)
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    cfgs = dest / "benchmark" / "configs"
    lib = json.loads((cfgs / "librispeech_ctc_bigru.json").read_text())
    lib["name"] = "tiny_libri"
    lib["recipe"]["model"].update(hidden_size=32, num_gru_layers=2, conv_channels=8)
    lib["recipe"]["data"]["max_label_len"] = 16
    (cfgs / "tiny_libri.json").write_text(json.dumps(lib))
    ais = json.loads((cfgs / "aishell_streaming.json").read_text())
    ais["name"], ais["vocab_size"] = "tiny_ais", 50
    ais["recipe"]["model"]["hidden_size"] = 32
    ais["recipe"]["data"]["max_label_len"] = 48
    (cfgs / "tiny_ais.json").write_text(json.dumps(ais))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    short = {"mean_s": 1.2, "sd_s": 0.5, "min_s": 0.5, "max_s": 2.0}
    for tiny, base in CELLS.items():
        w = json.loads((dest / "benchmark" / "workloads" / f"{base}.json").read_text())
        w["name"], w["config"] = tiny, tiny.split(".")[0]
        t = w["traffic"]
        if t["kind"] == "bucketed":
            t.update(batch=4, buckets=[1.0, 2.0], batches=4, chars_per_s=5, max_label=16,
                     lengths=short)
            if "check" in w:
                w["check"].update(within=6, requests=2)
        else:
            t.update(slots=4, utterances=16, lengths=short)
            w["warm_ticks"] = 3
            w["check"].update(within=6, ticks=3, slots=2, utterances=4)
        w["traced_calls"] = 3
        w["limits"] = LIMITS[w["loop"]]
        (dest / "benchmark" / "workloads" / f"{tiny}.json").write_text(json.dumps(w))
        spec["workloads"].append({"name": tiny, "config": w["config"],
                                  "traffic": tiny.split(".")[1], "chips": 1, "why": "small"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if base in m.get("workloads", []):
                m["workloads"].append(tiny)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


def run(dest: Path, code: str, timeout: float = 600) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=f"{dest}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], cwd=dest, env=env, capture_output=True,
                          text=True, timeout=timeout)


def rehearse(cell: str, seed: int = 20250101, trace: int = 0, patch: str = "") -> str:
    """Code that applies ``patch`` to the program, runs ``cell`` on the
    CPU for a second and prints the result line."""
    return (f"import time, torch\ntorch.set_num_threads(2)\n{patch}\n"
            "from benchmark.run import run_cell, emit\n"
            f"emit(run_cell({cell!r}, {seed}, 1.0, bool({trace}), device='cpu', "
            "t_start=time.perf_counter()))\n")


def result(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
