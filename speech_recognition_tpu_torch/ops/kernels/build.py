"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` straight into ``speech_recognition_tpu_torch/_build/``
(not tracked by git); its wrapper loads it with ``ctypes``. The library's file name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. No PyTorch header is
included: a build takes seconds where ``torch.utils.cpp_extension``
takes minutes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# code generation, then what makes a shared library of it
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3")
NVCC_FLAGS = COMPILE_FLAGS + ("-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return nvcc


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives for its current source."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, nvcc: str | None = None) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this source exists.

    The library is written under a temporary name and renamed into
    place, so a concurrent or interrupted build never leaves a partial
    file behind.
    """
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def ptxas_report(name: str, nvcc: str | None = None) -> list[str]:
    """``ptxas -v``'s account of ``csrc/<name>.cu``, one line per kernel:
    its name, then registers, shared memory, stack and spills. Compiles
    the source once more, to a cubin that is thrown away, with the
    library's target and optimisation flags."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [nvcc or find_nvcc(), *COMPILE_FLAGS, "-cubin", "-Xptxas",
               "-v", "-o", os.path.join(tmp, f"{name}.cubin"),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    names, lines = [], {}
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            names.append(line.split("'")[1])
            lines[names[-1]] = []
        elif names and ("spill" in line or "Used" in line):
            lines[names[-1]].append(line.split(":", 1)[-1].strip())
    demangled = _demangle(names)
    return [f"{d}: " + "; ".join(lines[n]) for n, d in zip(names, demangled)]


def _demangle(names: list[str]) -> list[str]:
    """C++ names through ``c++filt`` where there is one, else as they are."""
    cxxfilt = shutil.which("c++filt")
    if cxxfilt is None or not names:
        return names
    out = subprocess.run([cxxfilt], input="\n".join(names),
                         capture_output=True, text=True).stdout.splitlines()
    return out if len(out) == len(names) else names
