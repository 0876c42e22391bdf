"""The port stands alone: importing every uasr_torch module and
chip_smoke.py pulls in no jax, flax, optax or uasr module, and no source
file of the port imports one, even inside a function."""

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


def _port_files():
    return sorted((REPO / "uasr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _module_name(path: pathlib.Path) -> str:
    rel = path.relative_to(REPO).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def test_imports_pull_in_no_jax_flax_or_uasr():
    files = {str(p.relative_to(REPO)) for p in _port_files()}
    assert set(UNSUP) <= files
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
