"""Build the port's CUDA sources at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, which the kernel's
wrapper loads with ``ctypes``. Sources that include no PyTorch header
build in seconds; ``torch.utils.cpp_extension.load`` would compile
PyTorch's headers for minutes on every fresh machine.

Libraries go into ``uasr_torch/_kernels_build/`` (listed in
``.gitignore``), named by a hash of the source, its headers and the
flags, so an edited source is rebuilt. ``build`` starts one ``nvcc`` per
missing library, all at once, and waits for every one. A failed build
raises with the compiler's messages; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernels_build"
SOURCES = ("log_mel", "bigru_fwd", "ctc_beam")
NVCC_FLAGS = (
    "-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc of the toolkit PyTorch finds (CUDA_HOME or CUDA_PATH, then
    nvcc on PATH, then /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build the CUDA kernels")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load the named kernel libraries."""
    with _LOCK:
        missing = [n for n in names if n not in _LIBS]
        procs = {}
        for n in missing:
            so = library_path(n)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, so)
        errors = []
        for n, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{out}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        for n in missing:
            _LIBS[n] = ctypes.CDLL(str(library_path(n)))
        return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    return build((name,))[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code:
        lib.uasr_cuda_error_string.restype = ctypes.c_char_p
        lib.uasr_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.uasr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
