"""Build and load the port's CUDA kernels (``csrc/*.cu``).

There is no JAX counterpart: this replaces Pallas lowering. Each
kernel source is compiled by ``nvcc`` on its own into a shared library
with a plain C interface and loaded with ``ctypes``; a build takes
seconds because no source includes PyTorch's headers. All sources are
compiled in parallel (one ``nvcc`` each, started together) at the
first CUDA call — importing the package builds nothing, so it imports
on a machine without a card or a compiler.

Libraries land in ``mxnet_tpu_torch/_build/``, named by a hash of the
sources, the shared header and the flags: a changed source rebuilds, an
unchanged one loads. A missing ``nvcc`` or a failed build raises with
the compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["library", "function", "launch_on", "check", "build_all",
           "KERNEL_SOURCES", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: kernel name -> source file under csrc/
KERNEL_SOURCES = {
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "decode_attention": "decode_attention.cu",
    "paged_decode_attention": "paged_decode_attention.cu",
    "dequant_matmul": "dequant_matmul.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}
#: name -> {"seconds": build wall time or 0.0 when cached,
#: "ptxas": the compiler's resource and spill lines}
build_info: dict = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda): "
        "the port's CUDA kernels are built from csrc/ at first use")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in (src, *sorted(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _ptxas_lines(log: str):
    """The compiler's resource and spill lines, and its performance
    warnings (``wgmma`` serialized: C7520)."""
    return [ln.strip() for ln in log.splitlines()
            if "Used" in ln or "Compiling entry" in ln or "spill" in ln
            or "Performance Loss" in ln]


def build_all() -> dict:
    """Build (or load from ``_build/``) every kernel library; returns
    ``{name: ctypes.CDLL}``. Thread-safe and idempotent."""
    with _lock:
        missing = [n for n in KERNEL_SOURCES if n not in _libs]
        if not missing:
            return dict(_libs)
        BUILD_DIR.mkdir(exist_ok=True)
        jobs = {}
        for name in missing:
            src = CSRC / KERNEL_SOURCES[name]
            lib = BUILD_DIR / f"lib{name}-{_digest(src)}.so"
            if lib.exists():
                build_info[name] = {"seconds": 0.0, "ptxas": [],
                                    "cached": True}
                continue
            # write to a private name, then rename: a concurrent process
            # never loads a half-written library
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(src)]
            jobs[name] = (lib, tmp, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failures = []
        for name, (lib, tmp, t0, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"--- {name} (exit {proc.returncode}) ---\n"
                                f"{log}")
                continue
            os.replace(tmp, lib)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "ptxas": _ptxas_lines(log),
                                "cached": False}
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failures))
        for name in missing:
            src = CSRC / KERNEL_SOURCES[name]
            _libs[name] = ctypes.CDLL(
                str(BUILD_DIR / f"lib{name}-{_digest(src)}.so"))
            _libs[name].mxtt_error_string.restype = ctypes.c_char_p
            _libs[name].mxtt_error_string.argtypes = [ctypes.c_int]
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (builds all on first use)."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def function(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of kernel library ``name``, with
    its ``argtypes`` declared (pointers and the stream as
    ``c_void_p``) and a ``cudaError_t`` (``c_int``) result."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _fns[key] = fn
    return fn


def launch_on(tensor, fn, args):
    """Call the C entry point ``fn(*args, stream)`` on the current
    stream of ``tensor``'s card and return its ``cudaError_t``. The card
    is made current around the call only when it is not already (a
    device context costs microseconds per launch)."""
    idx = tensor.get_device()
    if torch._C._cuda_getDevice() == idx:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def check(name: str, code: int, what: str):
    """Raise when a launch returned a non-zero ``cudaError_t``."""
    if code != 0:
        msg = library(name).mxtt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
