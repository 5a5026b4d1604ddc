"""Build the port's CUDA sources with nvcc and load them through ctypes.

Every kernel of `repro_torch` is CUDA C++ with a plain C interface under
``src/repro_torch/csrc/``. At first use it is compiled for Hopper
(``sm_90a``) into ``build/repro_torch/`` at the repository root and loaded
with `ctypes`; nothing is downloaded and no package of finished kernels is
used. The library's file name carries a hash of its source and flags, so an
edited source is rebuilt and a stale build is never loaded. The compiler's
register and spill report (``-Xptxas -v``) is kept beside the library as
``<name>.log``.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``. A module lock serialises builds, so two
threads of one process that reach a kernel at first use (the serving
layer's trainer and its caller) never compile into the same file.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "library_path",
           "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# one build at a time in a process: the temporary outputs are named by pid
_BUILD_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: repro_torch builds its CUDA kernels from "
        f"{CSRC} at first use and needs the CUDA toolkit (set CUDA_HOME)")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(*sources: str) -> list[Path]:
    """Compile the given ``csrc/`` sources that are not built yet, one
    ``nvcc`` per source, all started together; returns the library paths."""
    with _BUILD_LOCK:
        return _build(sources)


def _build(sources) -> list[Path]:
    outs = [library_path(s) for s in sources]
    todo = [(s, o) for s, o in zip(sources, outs) if not o.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = []
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode:
                failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("building the CUDA kernels failed: "
                               + "\n".join(failed))
    return outs


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    return ctypes.CDLL(str(build(source)[0]))
