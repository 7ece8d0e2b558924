"""Build and load the port's CUDA kernels.

Every ``csrc/<name>.cu`` compiles with ``nvcc`` into
``_build/lib<name>.so``, a shared library with a plain C interface that
the kernel's wrapper loads with ``ctypes``. The build runs on first use
from the sources in the package alone, one ``nvcc`` process per source,
all started together. A library is rebuilt when its source is newer.
Nothing here runs at import, so the CPU-only tests can import every
module.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import threading

SRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "--split-compile=0",
)

_BUILD_LOCK = threading.Lock()


def sources() -> dict[str, str]:
    """{kernel name: source path} of every CUDA source in the package."""
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    }


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels of ribca_tpu_torch build only where the CUDA "
            "toolkit is installed"
        )
    return found


def build_all(force: bool = False) -> dict:
    """Compile every stale (or, with ``force``, every) kernel library in
    parallel. Returns {name: compiler output}, which holds ptxas's
    registers, shared memory and spills of each kernel; raises with the
    compiler's output when a build fails."""
    with _BUILD_LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        todo = {
            name: src for name, src in sources().items()
            if force or not os.path.exists(library_path(name))
            or os.path.getmtime(library_path(name)) < os.path.getmtime(src)
        }
        if not todo:
            return {}
        nvcc = nvcc_path()
        procs = {}
        for name, src in todo.items():
            # write to a private name, then rename: a concurrent process
            # never loads a half-written library
            tmp = f"{library_path(name)}.{os.getpid()}.tmp"
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        logs, failed = {}, []
        for name, (tmp, proc) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, library_path(name))
            else:
                failed.append(name)
                if os.path.exists(tmp):
                    os.remove(tmp)
        if failed:
            raise RuntimeError(
                "nvcc failed for "
                + ", ".join(f"{n}:\n{logs[n]}" for n in failed)
            )
        return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in sources():
        raise KeyError(f"no CUDA source csrc/{name}.cu")
    build_all()
    return ctypes.CDLL(library_path(name))
