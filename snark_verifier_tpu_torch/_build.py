"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

One ``nvcc`` process per ``.cu`` file, all started together, compiles the
sources for Hopper (``sm_90a``); one more links the objects into a single
shared library with a plain C interface, which is loaded with ``ctypes``.  Tensor pointers and the CUDA stream are passed as
``c_void_p``.  The library lives in ``build/`` beside this file (listed in
``.gitignore``), named by a hash of the sources, so an edit rebuilds and an
unchanged tree reuses it.  Nothing is built at import time: the first kernel
launch builds.

Every kernel wrapper launches through ``launch``, after shaping its operands
with ``check_limbs``, ``aligned`` and ``field_arg``.
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

import torch

from snark_verifier_tpu_torch.ops.limbs import NLIMB

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNEL_SOURCES = ("field.cu", "curve.cu", "msm.cu", "tower.cu", "poseidon.cu", "keccak.cu")
HEADERS = ("bn254.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the build log
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# C entry point -> argument types (all return int: a cudaError_t code)
SIGNATURES = {
    "svtpu_mont_mul": [_P, _P, _P, _I64, _P, _INT, _P],
    "svtpu_mont_pow": [_P, _P, _P, _I64, _P, _P, _INT, _INT, _P],
    "svtpu_g1_double": [_P, _P, _P, _P, _P, _P, _I64, _P, _INT, _P],
    "svtpu_msm_scan": [_P, _P, _P, _P, _P, _I64, _INT, _INT, _INT, _P, _P],
    "svtpu_g1_add_lanes": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _P, _INT, _P],
    "svtpu_horner_combine": [_P, _P, _P, _P, _P, _P, _I64, _INT, _INT, _P, _P],
    "svtpu_fq12_mul": [_P, _P, _P, _I64, _P, _P],
    "svtpu_miller_loop": [_P, _P, _P, _P, _P, _P, _I64, _I64, _INT, _P, _P],
    "svtpu_final_exp": [_P, _P, _P, _P, _P, _P, _I64, ctypes.c_uint64, _P, _P],
    "svtpu_msm_window": [_P, _P, _P, _P, _P, _I64, _INT, _P, _INT, _P],
    "svtpu_msm_horner": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _INT, _P],
    "svtpu_poseidon_perm": [_P, _P, _INT, _P, _I64, _P, _I64, _INT, _INT, _INT, _P, _P],
    "svtpu_keccak256": [_P, _I64, _P, _I64, _P],
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


def compile_command(source: str, obj: Path, nvcc: str = "nvcc") -> list[str]:
    """nvcc compiling one kernel source to an object file."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / source)]


def link_command(out: Path, objs, nvcc: str = "nvcc") -> list[str]:
    """nvcc linking the objects into the shared library."""
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(out), *map(str, objs)]


def build() -> tuple[Path, float]:
    """Compile the kernels if the library for the current sources is missing:
    one nvcc per source, all at once, then one link.  Returns (library path,
    seconds spent building; 0.0 when it existed)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in KERNEL_SOURCES]
    cmds = [compile_command(s, o, nvcc) for s, o in zip(KERNEL_SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    logs = [" ".join(c) + "\n" + p.communicate()[0] for c, p in zip(cmds, procs)]
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    tmp = out.with_name(f"{tag}.so")
    if not failed:
        link = link_command(tmp, objs, nvcc)
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(link)
    seconds = time.perf_counter() - t0
    log = out.with_suffix(".log")
    log.write_text("".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}; see {log}\n{''.join(logs)[-4000:]}")
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


@functools.cache
def field_arg(spec):
    """A ``field.FieldSpec``'s modulus words and n0 as a ctypes array (the
    kernels' Field)."""
    return (ctypes.c_uint32 * len(spec.kernel_words))(*map(int, spec.kernel_words))


def check_limbs(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is int64 with a trailing limb axis of 16."""
    for t in tensors:
        if t.dtype != torch.int64 or t.dim() == 0 or t.shape[-1] != NLIMB:
            raise ValueError(f"{name}: expected int64 (..., {NLIMB}) limbs, got {t.dtype} {tuple(t.shape)}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels load limb pairs as longlong2)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(entry: str, like: torch.Tensor, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and, last, the current
    stream of ``like``'s device, inside that device; raise if it failed."""
    with torch.cuda.device(like.device):
        code = getattr(library(), entry)(*args, stream_of(like))
    check(code, entry)
