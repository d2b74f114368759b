"""Build and load the port's CUDA kernels.

Each kernel is one file `jpeg_tpu_torch/csrc/<name>.cu` with a plain C entry
point. On first use it is compiled with nvcc for sm_90a into
`jpeg_tpu_torch/build/lib<name>.so` (gitignored) and loaded with ctypes; the
library is rebuilt when the source is newer. Nothing is built when a module
is imported. A missing nvcc or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_name_locks: dict = {}
_libs: dict = {}
# name -> (build seconds, nvcc/ptxas output) for kernels built by this process.
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or (
        "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _included(src: pathlib.Path) -> list:
    """The .cu files beside `src` that it includes."""
    names = re.findall(r'^#include "([^"]+\.cu)"', src.read_text(), re.M)
    return [src.parent / n for n in names if (src.parent / n).exists()]


def _build(name: str, src: pathlib.Path, lib_path: pathlib.Path,
           flags=()) -> None:
    with open(_BUILD_DIR / f"{name}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        # A source includes the headers beside it (csrc/*.cuh next to the
        # package's kernels) and may include other kernels' sources: an
        # edit to any of them rebuilds it too.
        newest = max(p.stat().st_mtime
                     for p in (src, *src.parent.glob("*.cuh"),
                               *_included(src)))
        if lib_path.exists() and lib_path.stat().st_mtime >= newest:
            return
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, lib_path)
        BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr + proc.stdout)


def load(name: str, source=None, flags=()) -> ctypes.CDLL:
    """The ctypes library of kernel `name`, built on first use. Threads
    loading different kernels build them in parallel.

    `source` (a path, default csrc/<name>.cu) and extra nvcc `flags` let a
    measurement build another version of a kernel under another `name`,
    beside the package's own."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = pathlib.Path(source) if source else _CSRC / f"{name}.cu"
        if not src.exists():
            raise RuntimeError(f"kernel source missing: {src}")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = _BUILD_DIR / f"lib{name}.so"
        _build(name, src, lib_path, flags)
        lib = ctypes.CDLL(str(lib_path))
        _libs[name] = lib
        return lib


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def settled(tensor):
    """`tensor`, once the stream that is filling it has finished. A tensor
    that is uploaded once and then kept (a table, a transform matrix) may be
    read next from another thread on another stream, which nothing orders
    after the upload: so whoever caches it waits for the upload here, once."""
    if tensor.device.type == "cuda":
        import torch

        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def check(name: str, err: int) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C entry."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
