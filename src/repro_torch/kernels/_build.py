"""Build the CUDA sources under ``csrc/`` into plain-C shared libraries.

Each source is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` at the repo root (listed in ``.gitignore``), named by
a hash of its source so that an edited kernel is rebuilt.  ``build``
starts one ``nvcc`` per missing library, all at once, and waits for all
of them.  Libraries are loaded with ``ctypes``; nothing here includes
PyTorch's headers, so a build takes seconds.  The flash-attention
library encodes its TMA tensor maps with the driver API's
``cuTensorMapEncodeTiled``, reached at run time through the runtime's
``cudaGetDriverEntryPoint``: nothing links against ``libcuda``, and no
source includes CUTLASS.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"flash_attention": "flash_attention.cu",
           "mlstm_chunk": "mlstm_chunk.cu", "slstm_step": "slstm_step.cu",
           "rglru_scan": "rglru_scan.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named library that is not built yet, in parallel.
    Returns {name: {"seconds", "cached", "log"}}; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, path)
        out[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                     "log": log}
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
