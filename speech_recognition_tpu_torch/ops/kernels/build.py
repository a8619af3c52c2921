"""Build the port's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cc`` (host C++,
the batch WAV decoder) has a plain C interface and is compiled on first
use, by ``nvcc`` or by the host compiler (``g++``),
straight into ``speech_recognition_tpu_torch/_build/`` (not tracked by
git); its wrapper loads it with ``ctypes``. The library's file name
carries a hash of the source, of the shared headers ``csrc/*.cuh`` (for
a ``.cu``) and of the flags, so an edited source or header is rebuilt and
a stale library is never loaded. No PyTorch header is included: a build
takes seconds where ``torch.utils.cpp_extension`` takes minutes.
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
HOST_CXX = "g++"
HOST_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")


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


def source(name: str) -> Path:
    """``csrc/<name>.cu`` if there is one, else ``csrc/<name>.cc``."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cc"


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` (or ``.cc``) lives for its
    current source, its flags and, for a ``.cu``, the current
    ``csrc/*.cuh`` headers (any of which it may include)."""
    src = source(name)
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, compiler: str | None = None) -> Path:
    """Compile ``csrc/<name>.cu`` with ``nvcc``, or ``csrc/<name>.cc``
    with the host compiler, unless a build of this source exists.
    ``compiler`` overrides the one found. A failed build raises, with the
    compiler's output.

    The library is written under a temporary name and renamed into
    place, so a concurrent or interrupted build never leaves a partial
    file behind.
    """
    lib = library_path(name)
    if lib.exists():
        return lib
    src = source(name)
    if src.suffix == ".cu":
        compiler, flags = compiler or find_nvcc(), NVCC_FLAGS
    else:
        compiler, flags = compiler or HOST_CXX, HOST_FLAGS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [compiler, *flags, "-o", tmp, str(src)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run {compiler!r} to build "
                               f"{src.name}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed ({proc.returncode}): "
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
