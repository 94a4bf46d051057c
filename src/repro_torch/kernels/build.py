"""Builds and loads the port's CUDA kernels (plain C interface + ctypes).

``library()`` compiles ``csrc/ota_kernels.cu`` with ``nvcc`` for
``sm_90a`` into ``build/repro_torch/`` at the root of the checkout, at
first use, and loads it with ``ctypes``.  The shared object is named after
a hash of the source (and the flags), so an edit rebuilds it.  Nothing is
built or loaded when the module is imported: the CPU tests import every
module on a machine without ``nvcc``.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "ota_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_ROUND_STEP_ARGS = [_P] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P]
_AGGREGATE_ARGS = [_P] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P]
ENTRIES = {
    "ota_round_step_f32": _ROUND_STEP_ARGS,
    "ota_round_step_bf16": _ROUND_STEP_ARGS,
    "ota_round_step_int8": _ROUND_STEP_ARGS,
    "ota_aggregate_f32": _AGGREGATE_ARGS,
    "ota_aggregate_bf16": _AGGREGATE_ARGS,
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built on the machine with the card")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"ota_kernels_{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this source's library exists; returns its
    path.  ``verbose`` adds ``-Xptxas -v`` (registers, spills) and prints
    the compiler's output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)        # atomic: concurrent builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use; argtypes declared for
    every entry (pointers as c_void_p, or ctypes would cut them to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
