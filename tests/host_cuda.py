"""Compile a CUDA kernel source's body for the host, so that a CPU test can
run the kernel's own code: the source up to its first C entry point, built as
host C++ beside a driver that runs one call a thread, through a small
``cuda_runtime.h`` shim.  Keep a body that a test compiles free of
CUDA-only intrinsics, or extend the shim."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

# Enough of cuda_runtime.h for a kernel body to compile as host C++: a
# thread is a call with blockIdx/threadIdx set.
HOST_SHIM = """#pragma once
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __global__
#define __constant__
#define __launch_bounds__(n)
#define __restrict__
struct svtpu_dim { unsigned x; };
static svtpu_dim threadIdx, blockIdx, blockDim;
struct longlong2 { long long x, y; };
"""


def compile_body(source: Path, driver: str, tmp_path: Path) -> ctypes.CDLL:
    """``source`` up to its first ``extern "C"``, then ``driver``, built as a
    host shared library in ``tmp_path`` and loaded; skips the test where the
    host has no C++ compiler."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip(f"no host C++ compiler to build {source.name}'s kernel body for the CPU")
    text = source.read_text()
    (tmp_path / "cuda_runtime.h").write_text(HOST_SHIM)
    body = tmp_path / f"{source.stem}_host.cpp"
    body.write_text(text[: text.index('extern "C"')] + driver)
    lib = tmp_path / f"lib{source.stem}_host.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{tmp_path}",
                    "-o", str(lib), str(body)], check=True, capture_output=True, timeout=240)
    return ctypes.CDLL(str(lib))
