"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

One ``nvcc`` call compiles every ``.cu`` file for Hopper (``sm_90a``) into a
single shared library with a plain C interface, which is loaded with
``ctypes``.  Tensor pointers and the CUDA stream are passed as
``c_void_p``.  The library lives in ``build/`` beside this file (listed in
``.gitignore``), named by a hash of the sources, so an edit rebuilds and an
unchanged tree reuses it.  Nothing is built at import time: the first kernel
launch builds.
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

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNEL_SOURCES = ("field.cu", "curve.cu", "msm.cu")
HEADERS = ("bn254.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the build log
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# C entry point -> argument types (all return int: a cudaError_t code)
SIGNATURES = {
    "svtpu_mont_mul": [_P, _P, _P, _I64, _P, _INT, _P],
    "svtpu_g1_add": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _INT, _P],
    "svtpu_g1_double": [_P, _P, _P, _P, _P, _P, _I64, _P, _INT, _P],
    "svtpu_msm_scan": [_P, _P, _P, _P, _P, _I64, _INT, _INT, _P, _INT, _P],
}


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + KERNEL_SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libsvtpu_kernels_{source_hash()}.so"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {cuda_home}/bin or on PATH")
    return found


def nvcc_command(out: Path, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(CSRC_DIR / s) for s in KERNEL_SOURCES)]


def build() -> tuple[Path, float]:
    """Compile the kernels if the library for the current sources is missing.
    Returns (library path, seconds spent compiling; 0.0 when it existed)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = nvcc_command(tmp, nvcc_path())
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}); see {log}\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.svtpu_error_string.argtypes = [ctypes.c_int]
    lib.svtpu_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, kernel: str) -> None:
    """Raise if a launch returned a non-zero cudaGetLastError() code."""
    if code != 0:
        msg = library().svtpu_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: cuda error {code} ({msg})")
