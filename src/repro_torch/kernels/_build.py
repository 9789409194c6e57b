"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into an object,
all of them at once, and the objects are linked into one shared library
with a plain C interface, loaded with ctypes.  No PyTorch header is
compiled, so a build takes seconds.  The library lands in
`build/repro_torch/` at the root of the checkout, named by a hash of the
sources and flags, and is built at first use.

The flags pin what the bits depend on, in one place for every kernel:
`-fmad=false` (no multiply-add contraction: the JAX reference is held with
FMA off), `-ftz=true` (fp32 denormals flush, as on XLA-CPU) and
`-prec-div=true`; never `--use_fast_math`.

A failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-fmad=false", "-ftz=true",
                     "-prec-div=true", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C entry point -> argument types; every one returns cudaGetLastError().
SIGNATURES = {
    "repro_izhikevich_update": [_P] * 10 + [_I64, _F, _F, _F, ctypes.c_int,
                                            _P],
    "repro_stdp_arrival": [_P] * 8 + [_I64] + [_F] * 6 + [_P],
    "repro_stdp_ltp": [_P] * 6 + [_I64] + [_F] * 6 + [_P],
    "repro_segment_sum_ordered": [_P] * 3 + [_I64] * 3 + [_P],
    "repro_rg_lru_scan": [_P] * 4 + [_I64] * 3 + [_P],
    "repro_flash_attention": [_P] * 4 + [_I64] * 4 + [ctypes.c_int] * 2
    + [_I64, _F, _F, _P],
}

_lib = None


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every `csrc/*.cu` in parallel and link them; returns the
    library's path (kept if it is already there)."""
    out = library_path()
    if out.exists():
        return out
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        procs = [subprocess.Popen(
            [exe, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s.name, log) for s, p, log in zip(srcs, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {name}\n{log}" for name, log in failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [exe, *ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def require(name: str, dtype, shape, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of `dtype` and
    `shape` on one device (what the kernels take)."""
    devices = set()
    for arg, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {x.device}, not CUDA")
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} is {x.dtype}{tuple(x.shape)}, "
                             f"expected {dtype}{tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
        devices.add(x.device)
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
