"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``kernels/*/csrc/*.cu`` compiles into a shared library of its own
with a plain C interface, under ``build/kernels/`` at the repository
root.  The library's name carries a hash of its source and the compiler
flags, so an edited source builds anew and an unchanged one loads from
disk.  The build runs at the first CUDA use of any kernel: every missing
library compiles at once, one ``nvcc`` process per source, all started
together.  A failed build raises with the compiler's output.  One lock
serialises building and loading within a process, so threads that touch
a kernel for the first time at once (the service's batch worker and its
retrainer) run ``nvcc`` once and share one loaded library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

# sm_90a (not sm_90): the Hopper-only instructions need the "a" target.
# -Xptxas -v writes registers, shared memory and spills into the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
# re-entrant: library() holds it while it calls build_all()
_lock = threading.RLock()


def sources() -> dict[str, Path]:
    """Kernel name (the source's stem) -> CUDA source."""
    return {p.stem: p for p in sorted(_KERNELS.glob("*/csrc/*.cu"))}


def target(src: Path) -> Path:
    """The shared library ``src`` builds into."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def build_all() -> dict[str, float]:
    """Compile every kernel whose library is missing, in parallel.

    Returns kernel name -> seconds its build took (0.0 when it was
    already built).  Raises RuntimeError naming each failed source."""
    with _lock:
        return _build_missing()


def _build_missing() -> dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: src for name, src in sources().items()
            if not target(src).exists()}
    seconds = {name: 0.0 for name in sources()}
    if not todo:
        return seconds
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, src in todo.items():
        out = target(src)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT), log, tmp, out)
    failed = []
    for name, (proc, log, tmp, out) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{todo[name]} (nvcc exit {rc}):\n"
                          + out.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """What ``nvcc`` printed for kernel ``name`` (ptxas register, shared
    memory and spill counts)."""
    return target(sources()[name]).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                import torch
                cap = torch.cuda.get_device_capability()
                if cap != (9, 0):
                    raise RuntimeError(
                        f"kernels are built for sm_90a (Hopper); this card "
                        f"is sm_{cap[0]}{cap[1]}")
                build_all()
                lib = _loaded[name] = ctypes.CDLL(
                    str(target(sources()[name])))
    return lib
