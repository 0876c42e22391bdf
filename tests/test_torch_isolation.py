"""The port stands alone: importing every uasr_torch module, chip_smoke.py
and the rank-side module of the tests' process groups
(tests/_torch_dist_worker.py) pulls in no jax, flax, optax or uasr module,
and no source file of the port imports one, even inside a function."""

import ast
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "uasr")
# the unsupervised slice's modules, which must be among those checked
UNSUP = ("uasr_torch/ops/wgan.py", "uasr_torch/ops/eodm.py", "uasr_torch/ops/segment.py",
         "uasr_torch/ops/lm.py", "uasr_torch/tools/prepare.py", "uasr_torch/train.py",
         "uasr_torch/models/models.py", "uasr_torch/data/dataset.py")
# the data-at-scale slice's: the streaming loader and the native host runtime's binding
DATA = ("uasr_torch/data/loader.py", "uasr_torch/native/__init__.py")
# the LM and HMM decode slice's: Viterbi and forced alignment, the align tool
LM = ("uasr_torch/ops/viterbi.py", "uasr_torch/tools/align.py")
# the frame-CE and self-training slice's
SELFTRAIN = ("uasr_torch/ops/frame_ce.py", "uasr_torch/data/kaldi.py", "uasr_torch/selftrain.py",
             "uasr_torch/tools/selftrain.py", "uasr_torch/tools/sweep.py")
# the SSL and feature-cache slice's
SSL = ("uasr_torch/ops/infonce.py", "uasr_torch/models/ssl.py", "uasr_torch/pretrain.py",
       "uasr_torch/data/cache.py", "uasr_torch/data/transforms.py",
       "uasr_torch/tools/featurize.py")
# the pipeline, quantization and serving-export slice's
EXPORT = ("uasr_torch/ops/library.py", "uasr_torch/ops/quantize.py",
          "uasr_torch/tools/export.py", "uasr_torch/tools/pipeline.py")
# the distribution and scale slice's, and the profiling aux
PARALLEL = ("uasr_torch/parallel/__init__.py", "uasr_torch/parallel/mesh.py",
            "uasr_torch/parallel/distributed.py", "uasr_torch/parallel/collectives.py",
            "uasr_torch/parallel/launch.py", "uasr_torch/profiling.py",
            "uasr_torch/tools/dryrun_multichip.py", "tests/_torch_dist_worker.py")


def _port_files():
    return sorted((REPO / "uasr_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                          REPO / "tests" / "_torch_dist_worker.py"]


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(REPO).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def test_imports_pull_in_no_jax_flax_or_uasr():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    assert set(UNSUP) <= files and set(DATA) <= files and set(LM) <= files
    assert set(SELFTRAIN) <= files and set(SSL) <= files and set(EXPORT) <= files
    assert set(PARALLEL) <= files
    mods = [_module_name(p) for p in _port_files()]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sources_import_nothing_of_jax_flax_or_uasr():
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"
