"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled on first use into a shared library under the checkout's
git-ignored ``build/`` directory::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source builds anew and an unchanged one is loaded as it is.  Nothing but
the repository's own sources goes into a build, and no library is linked
beyond the CUDA runtime: a source that needs a libcuda function (the TMA
tensor maps of ``flash_attention_wgmma.cu``) looks it up at run time with
``cudaGetDriverEntryPoint``.  A missing ``nvcc`` or a failed compile
raises: there is no fallback to a plain version.  ``build`` and ``load``
hold one lock, so threads of one process (the pipelined engine's worker
beside the main thread) never compile the same source twice or write the
same temporary file.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# every csrc/<name>.cu of the port, each loaded by one kernel module
SOURCES = ("tbe_gather_pool", "onesided_a2a", "flash_attention",
           "flash_attention_wgmma")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildRecord:
    """How one library came to be loaded."""

    name: str
    path: Path
    seconds: float          # nvcc wall-clock; 0.0 when the cached build served
    log: str                # nvcc's output (ptxas register/spill report)


_LIBS: Dict[str, ctypes.CDLL] = {}
RECORDS: Dict[str, BuildRecord] = {}
_LOCK = threading.Lock()      # guards _LIBS, RECORDS and build/ (see build)


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is absent."""
    found = shutil.which("nvcc")
    if found is None:
        from torch.utils.cpp_extension import CUDA_HOME

        candidate = os.path.join(CUDA_HOME or "", "bin", "nvcc")
        found = candidate if CUDA_HOME and os.path.exists(candidate) else None
    if found is None:
        raise RuntimeError(
            "nvcc not found (not on PATH, no CUDA_HOME): the port's CUDA "
            "kernels are built from source at first use")
    return found


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives, keyed by its content."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, BuildRecord]:
    """Compile every named source that has no current build, all ``nvcc``
    processes started together, and wait for them.  Raises on the first
    failed compile, with its output."""
    with _LOCK:
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, BuildRecord]:
    todo = {n: library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name, path in todo.items():
            # the process and thread in the name: other processes may build
            # into the same directory
            tmp = path.with_name(
                f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu (exit "
                    f"{proc.returncode}):\n{log}")
            os.replace(tmp, todo[name])
            RECORDS[name] = BuildRecord(name, todo[name],
                                        time.perf_counter() - t0, log)
    for name in names:
        RECORDS.setdefault(name, BuildRecord(name, library_path(name), 0.0,
                                             "(cached build)"))
    return {n: RECORDS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
