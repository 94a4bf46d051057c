"""Builds and loads the port's CUDA kernels (plain C interface + ctypes).

Each source under ``csrc/`` is one shared library: ``library(name)``
compiles ``csrc/<name>.cu`` with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` at the root of the checkout, at first use, and
loads it with ``ctypes``.  A library is named after a hash of its source
(and the flags), so an edit rebuilds it.  ``build()`` starts one ``nvcc``
per source that is not built yet, all at once, and waits for them.
Nothing is built or loaded when the module is imported: the CPU tests
import every module on a machine without ``nvcc``.  A failed build raises.
``build_variants`` builds and loads other copies of a source (a parent
checkout's, a variant under trial) beside this one, for the profilers'
comparisons in one process.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_ROUND_STEP_ARGS = [_P] * 8 + [_I, _I, ctypes.c_longlong, _P]
_AGGREGATE_ARGS = [_P] * 5 + [_I, _I, ctypes.c_longlong, _P]
# q, k, v, o; b, sq, sk, h, kh, dh, dv, causal, window; stream
_ATTENTION_ARGS = [_P] * 4 + [_I] * 9 + [_P]
# x, dt, a_neg, b, c, state0 (may be null), y, state; batch, seq, h, g, p, n;
# stream
_SSD_ARGS = [_P] * 8 + [_I] * 6 + [_P]
ENTRIES = {
    "ota_kernels": {
        "ota_round_step_f32": _ROUND_STEP_ARGS,
        "ota_round_step_bf16": _ROUND_STEP_ARGS,
        "ota_round_step_int8": _ROUND_STEP_ARGS,
        "ota_aggregate_f32": _AGGREGATE_ARGS,
        "ota_aggregate_bf16": _AGGREGATE_ARGS,
    },
    "flash_attention": {
        "flash_attention_f32": _ATTENTION_ARGS,
        "flash_attention_bf16": _ATTENTION_ARGS,
    },
    "ssd_scan": {
        "ssd_scan_f32": _SSD_ARGS,
        "ssd_scan_bf16": _SSD_ARGS,
    },
}
SOURCES = {name: CSRC / f"{name}.cu" for name in ENTRIES}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built on the machine with the card")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build(*names: str, verbose: bool = False) -> dict:
    """Compile the named sources (all when none is named) whose libraries
    do not exist yet, one ``nvcc`` each, in parallel; returns
    ``{name: path}``.  ``verbose`` adds ``-Xptxas -v`` (registers, spills)
    and prints the compiler's output; ``log(name)`` reads it back."""
    names = names or tuple(SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, str(SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, cmd, tmp, out)
        for name, (proc, cmd, tmp, out) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
            if verbose:
                print(log, flush=True)
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)    # atomic: concurrent builders agree
    finally:
        for proc, _, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return {name: library_path(name) for name in names}


def log(name: str) -> str:
    """The compiler's output of the build of ``csrc/<name>.cu`` ("" if this
    checkout has not built it)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load_variant(path: Path, name: str) -> ctypes.CDLL:
    """A built library of ``csrc/<name>.cu`` or of a copy of it, with the
    argtypes of its entries declared (pointers as c_void_p, or ctypes would
    cut them to 32 bits)."""
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return load_variant(build(name)[name], name)


def build_variants(name: str, sources: dict, *kernels: str) -> dict:
    """Builds copies of ``csrc/<name>.cu`` that export the same entries
    (``{label: path}``) with nvcc and ``-Xptxas -v``, one process each, all
    at once; prints ptxas's register and spill lines for the kernels whose
    symbol holds one of ``kernels``; returns ``{label: loaded library}``."""
    jobs = {}
    for label, source in sources.items():
        digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
        out = BUILD_DIR / "variants" / f"{name}_{label}_{digest}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
               str(source)]
        jobs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for label, (proc, out) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        for line in ptxas_report(log, *kernels):
            print(f"[ptxas] {label}: {line}", flush=True)
        libs[label] = load_variant(out, name)
    return libs


def ptxas_report(log: str, *kernels: str) -> list:
    """ptxas's register and spill lines for the kernels whose symbol holds
    one of ``kernels``, each prefixed by its symbol."""
    keep, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif fn and any(k in fn for k in kernels) \
                and ("registers" in line or "spill" in line):
            keep.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return keep


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
