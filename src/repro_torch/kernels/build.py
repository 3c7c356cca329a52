"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/torch_kernels/`` at the root of the
checkout, named by a hash of the source (with the sources it includes)
and the flags, so an edited source is never served a stale library.
``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``PATH``, then the
toolkit's default install prefix ``/usr/local/cuda``; a missing compiler
or a failed build raises.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# libraries loaded by :func:`load` in this process, by source name
_LOADS: "collections.Counter[str]" = collections.Counter()


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _lib_path(src: Path) -> Path:
    """The library's path, named by a hash of the source, the sources it
    includes from ``csrc/`` (``#include "name.cu"``) and the flags."""
    text = src.read_bytes()
    deps = re.findall(rb'^#include "([^"]+)"', text, flags=re.M)
    h = hashlib.sha256(text + b"".join((CSRC / d.decode()).read_bytes()
                                       for d in deps)
                       + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def compile_source(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns ``{"path", "seconds", "cached", "log"}``: ``log`` is nvcc's
    ptxas report of registers, spills and shared memory per kernel, kept
    beside the library (``.ptxas.txt``) and read back when it was built
    before; ``seconds`` is 0 then."""
    src = CSRC / f"{name}.cu"
    out = _lib_path(src)
    log_path = out.with_suffix(".ptxas.txt")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "cached": True, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log = (proc.stdout + proc.stderr).strip()
    # the report first, so that a built library always has its report
    log_tmp = log_path.with_suffix(f".{os.getpid()}.tmp")
    log_tmp.write_text(log)
    os.replace(log_tmp, log_path)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial
    return {"path": str(out), "seconds": secs, "cached": False, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed and loaded.
    Callers keep the handle (one per process)."""
    lib = ctypes.CDLL(compile_source(name)["path"])
    _LOADS[name] += 1
    return lib


def load_counts() -> dict:
    """How many times :func:`load` loaded each source's library in this
    process (``repro_torch.obs.profile.engine_compile_log`` reads it)."""
    return dict(_LOADS)
