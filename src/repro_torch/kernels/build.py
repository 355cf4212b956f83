"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``*.cu`` file under a ``csrc/`` directory of the package is one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds); ``*.cuh`` headers beside it are shared by the sources of
that directory.  Libraries go to ``build/kernels/`` at the repository
root, named by a hash of the source, its directory's headers and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  The build happens at first use,
never at import: the CPU tests import every module on hosts with no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
ptxas_info: dict = {}   # source name -> register/shared-memory/spill report


def sources() -> dict:
    """Kernel name (the source's stem) -> path, for every csrc/*.cu."""
    return {p.stem: p for p in sorted(PACKAGE_DIR.glob("**/csrc/*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "on a host with the CUDA toolkit")
    return str(path)


def _target(src: Path) -> Path:
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def is_built() -> bool:
    return all(_target(p).exists() for p in sources().values())


def build_all() -> dict:
    """Compile every stale source, one ``nvcc`` per source, all started
    together.  Returns name -> library path; raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: (src, _target(src)) for name, src in sources().items()
            if not _target(src).exists()}
    procs = {}
    for name, (src, out) in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_info[name] = "\n".join(l for l in log.splitlines()
                                     if "ptxas" in l or "spill" in l)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _target(src) for name, src in sources().items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, building it first if
    it is stale."""
    with _lock:
        if name not in _libs:
            if name not in sources():
                raise KeyError(f"no kernel source named {name!r}")
            path = build_all()[name]
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]
