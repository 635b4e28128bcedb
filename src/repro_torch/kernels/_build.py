"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use by ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels``
at the repository root, then loaded with ``ctypes``. The library name
carries a hash of the sources it was built from, so a changed source is
rebuilt and an unchanged one is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("topk_gate", "buddy_substitute", "expert_ffn", "grouped_ffn",
           "quant_ffn", "wkv_chunk", "route")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (nvcc on PATH or "
                       "under $CUDA_HOME/bin)")


def _sources(name: str) -> list:
    """The kernel's .cu file plus every shared header in csrc."""
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _sources(name):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start one nvcc process; returns (process, tmp output, final path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one nvcc; move its library into place; return its log."""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} (exit "
                           f"{proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all(names=KERNELS) -> dict:
    """Build every kernel library not yet built, all nvcc processes at
    once. Returns {name: {"seconds": s, "log": ptxas output or ''}}."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    info = {}
    for n, st in started.items():
        log = "" if st is None else _finish(n, st)
        info[n] = {"seconds": time.perf_counter() - t0, "log": log}
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        st = _start(name)
        if st is not None:
            _finish(name, st)
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def nbytes(*tensors) -> int:
    """Bytes of the tensors (None skipped), from their shapes and dtypes
    only: what a kernel's cost function charges for moving each once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
