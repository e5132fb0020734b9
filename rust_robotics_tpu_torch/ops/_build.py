"""Build the port's CUDA sources (`csrc/*.cu`) with nvcc at first use.

Each source becomes a shared library with a plain C interface, loaded with
ctypes; no source includes PyTorch's headers, so a build takes seconds. The
libraries go to `rust_robotics_tpu_torch/_build/`, named by a hash of the
sources and flags, so an unchanged source is not rebuilt. `build` starts one
nvcc per source, all at once. `build_host` builds a C++ host source (the
native runtime, `native/host_runtime.cpp`) with g++ the same way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and shared memory, into the .log
)

# The shared memory one block may use on sm_90 (227 KB, after
# cudaFuncSetAttribute), the build's one target: what a kernel may hold there.
SHARED_BYTES_PER_BLOCK = 232448

# g++ flags of the host runtime (the JAX package's native/__init__.py:52-55).
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the kernels")


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lives for the current sources."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (with ptxas's resource report) from the last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names) -> dict[str, float]:
    """Build every named source that is not built yet, one nvcc process
    each, all started together. Returns the seconds each build took (0.0
    for a library that was already there); raises with nvcc's output if a
    build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    seconds = {name: 0.0 for name in names}
    running = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            with open(out.with_suffix(".log"), "w") as log:
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT,
                )
            running[name] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, start) in running.items():
            rc = proc.wait()
            seconds[name] = time.perf_counter() - start
            if rc != 0:
                failed.append(f"{name}.cu (nvcc exit {rc}):\n{build_log(name)}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    finally:
        for proc, tmp, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built if needed, with `argtypes` and
    `restype` set from `signatures` ({function: (argtypes, restype)})."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded[name] = lib
    return lib


def build_host(source: Path) -> Path:
    """The shared library of the C++ host source `source`, built by g++
    into `_build/` unless a library of the same source and flags is there.
    Raises with the compiler's output if the build fails."""
    source = Path(source)
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    digest.update(source.read_bytes())
    out = BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; cannot build the host runtime")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *HOST_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"host build of {source.name} failed (exit "
                               f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
