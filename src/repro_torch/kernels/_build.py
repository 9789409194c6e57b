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
`-prec-div=true`; never `--use_fast_math`.  A source may set flags of its
own (`SOURCE_FLAGS`, each replacing the base flag of the same name): the
tensor-core attention kernels, held to a tolerance and not to bit
equality, contract multiply-adds.  Their TMA descriptors are encoded with
the driver's `cuTensorMapEncodeTiled`, reached through the runtime's
driver entry point, so the library links no `-lcuda`.

A failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-fmad=false", "-ftz=true",
                     "-prec-div=true", "-Xcompiler", "-fPIC"]
#: Flags of one source (by file name); each replaces the NVCC_FLAGS entry
#: of the same option name (nvcc refuses an option given twice).
SOURCE_FLAGS = {"flash_attention_sm90.cu": ["-fmad=true"],
                "flash_decode.cu": ["-fmad=true"]}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C entry point -> argument types; every one returns cudaGetLastError().
SIGNATURES = {
    "repro_arborize": [_P] * 8 + [_I64] * 5 + [_P, _P, _P],
    "repro_arborize_elements": [_P] * 5 + [_I64] * 5 + [_P, _P, _P],
    "repro_arborize_chunk": [_P] * 5 + [_I64] * 7 + [_P, _P],
    # (pointers [16], int64 [20], uint64 [4], stream): csrc/stream.cu
    "repro_chunk_tables": [_P] * 4,
    # (pointers [15], int64 [6], float [5], stream): csrc/event.cu
    "repro_event_arrival": [_P] * 4,
    # (pointers [11], int64 [9], stream): csrc/event.cu
    "repro_event_emit": [_P] * 3,
    # (pointers [8], int64 [6], float [5], stream): csrc/event_phase_a.cu
    "repro_event_ltp": [_P] * 4,
    # (pointers [16], int64 [9], float [11], stream): csrc/event_phase_a.cu
    "repro_event_neurons": [_P] * 4,
    "repro_event_ltp_rows": [_P] * 10 + [_I64] * 5 + [_F] * 5 + [_P],
    "repro_izhikevich_update": [_P] * 10 + [_I64, _F, _F, _F, ctypes.c_int,
                                            _P],
    "repro_stdp_arrival": [_P] * 10 + [_I64] * 5 + [_F] * 6 + [_P],
    "repro_stdp_ltp": [_P] * 6 + [_I64] * 3 + [_F] * 6 + [_P],
    "repro_stdp_ltp_chunk": [_P] * 6 + [_I64] * 7 + [_F] * 6 + [_P],
    "repro_stdp_arrival_current": [_P] * 9 + [_I64] * 5 + [_F] * 6 + [_P],
    # (pointers [18], int64 [9], float [19], stream): csrc/stdp.cu
    "repro_stdp_phase_a": [_P] * 4,
    # (pointers [17], int64 [13], float [19], stream): csrc/stdp.cu
    "repro_stdp_phase_a_chunk": [_P] * 4,
    "repro_segment_sum_ordered": [_P] * 3 + [_I64] * 3 + [_P],
    "repro_rg_lru_scan": [_P] * 4 + [_I64] * 3 + [_P],
    "repro_rg_lru_scan_bwd": [_P] * 7 + [_I64] * 3 + [_P],
    "repro_flash_attention": [_P] * 4 + [_I64] * 4 + [ctypes.c_int] * 2
    + [_I64, _F, _F, _P],
    "repro_flash_attention_sm90": [_P] * 4 + [_I64] * 4 + [ctypes.c_int]
    + [_I64, _F, _F, _P],
    "repro_flash_decode": [_P] * 6 + [_I64] * 5 + [ctypes.c_int] * 2
    + [_I64, _F, _F, _P],
}

_lib = None

#: Launches of each kernel since the last reset, by name: the one registry
#: that every wrapper adds to (`counted`) where it launches its kernel,
#: and that `ops.launch_counts` reads.
launches = collections.Counter()
#: Launches recorded into a CUDA graph under capture since the last reset.
#: A capture launches nothing, and a replay launches what its capture
#: recorded without passing through any wrapper, so neither is counted in
#: `launches` (`core.engine.CapturedRun` keeps its replays).
recorded = collections.Counter()


def capturing() -> bool:
    """True while the current CUDA stream is being captured into a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def counted(name: str) -> None:
    """One launch of kernel `name`, or one recorded under capture."""
    (recorded if capturing() else launches)[name] += 1


class Scratch:
    """The kernels' zeroed integer scratch on one device, by name: fill
    counts, totals and tickets that every launch leaves zero again, and
    lists that a launch writes before it reads them.

    A captured CUDA graph replays the addresses it recorded, so a graph
    owns its Scratch for as long as the graph lives
    (`core.engine.CapturedRun` holds one and enters it with
    `own_scratch`), and no buffer is replaced under capture.  Launches
    outside such a scope share one Scratch a device, in stream order:
    they are the eager calls, all on the current stream."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.buffers = {}

    def get(self, name: str, n: int, dtype) -> torch.Tensor:
        buf = self.buffers.get(name)
        if buf is None or buf.numel() < n or buf.dtype != dtype:
            if capturing():
                raise RuntimeError(
                    f"scratch {name!r} of {n} elements first asked for under "
                    f"capture: run the captured steps once before capturing "
                    f"them")
            buf = torch.zeros(max(n, 1), dtype=dtype, device=self.device)
            self.buffers[name] = buf
        return buf


_owned = []         # the Scratch scopes entered, innermost last
_shared = {}        # device -> the Scratch of launches outside any scope


@contextlib.contextmanager
def own_scratch(scratch: Scratch):
    """Launches on scratch's device inside the block use `scratch`."""
    _owned.append(scratch)
    try:
        yield scratch
    finally:
        _owned.pop()


def scratch(device: torch.device, name: str, n: int,
            dtype=torch.int32) -> torch.Tensor:
    """A zeroed buffer of at least n elements for a launch on `device`:
    from the innermost `own_scratch` scope on that device, else the shared
    one.  A capture outside such a scope raises: its graph would keep
    buffers that any later launch may replace."""
    device = torch.device(device)
    for s in reversed(_owned):
        if s.device == device:
            return s.get(name, n, dtype)
    if capturing():
        raise RuntimeError(f"scratch {name!r} asked for under capture "
                           f"outside `own_scratch`: a captured graph must "
                           f"own its scratch")
    return _shared.setdefault(device, Scratch(device)).get(name, n, dtype)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def flags(source: Path) -> list:
    """nvcc's flags for one source."""
    own = SOURCE_FLAGS.get(source.name, [])
    names = {f.split("=")[0] for f in own}
    return [f for f in NVCC_FLAGS if f.split("=")[0] not in names] + own


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(" ".join(flags(p)).encode())
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
            [exe, *flags(s), "-c", str(s), "-o", str(o)],
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


def inspect(name: str) -> dict:
    """What ptxas and the disassembler say of one source: its `-Xptxas -v`
    lines (registers, shared memory, spills per kernel) and, where
    `cuobjdump` is found, how many SASS instructions are wgmma (HGMMA) and
    TMA loads (UTMALDG) (None without a disassembler)."""
    src = CSRC / name
    exe = nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / (src.stem + ".cubin")
        run = subprocess.run(
            [exe, *[f for f in flags(src) if f not in ("-Xcompiler",
                                                        "-fPIC")],
             "-Xptxas", "-v", "-cubin", str(src), "-o", str(cubin)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc -cubin failed:\n{run.stdout}")
        # "Used N registers, ...", "N bytes stack frame, N bytes spill ..."
        ptxas = [ln.strip() for ln in run.stdout.splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln or "arning" in ln]
        dis = shutil.which("cuobjdump") or str(Path(exe).with_name(
            "cuobjdump"))
        counts = None
        if os.path.exists(dis):
            sass = subprocess.run([dis, "-sass", str(cubin)],
                                  stdout=subprocess.PIPE, text=True).stdout
            # "/*0050*/  @P0 HGMMA.64x64x16.F32.BF16 R24, ... ;  /* 0x.. */"
            ops = []
            for ln in sass.splitlines():
                words = ln.split("*/", 1)[-1].split()
                if ln.strip().startswith("/*") and words:
                    ops.append(words[1] if words[0].startswith("@")
                               and len(words) > 1 else words[0])
            counts = {op: sum(o.startswith(op) for o in ops)
                      for op in ("HGMMA", "UTMALDG")}
    return {"source": name, "ptxas": ptxas, "disassembler": dis
            if counts is not None else None, "sass_counts": counts}


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


def require_aligned(name: str, nbytes: int, **tensors) -> None:
    """Raise unless every tensor's first element lies on an `nbytes`
    boundary: a kernel that reads or writes it `nbytes` at a time faults
    on the card with a misaligned address otherwise (a contiguous view at
    an odd storage offset passes `require`)."""
    for arg, x in tensors.items():
        if x.data_ptr() % nbytes:
            raise ValueError(f"{name}: {arg} starts at an address that is "
                             f"not a multiple of {nbytes} bytes (the kernel "
                             f"accesses it {nbytes} bytes at a time)")


def one_device(name: str, *tensors) -> None:
    """Raise unless every tensor lies on one device (a kernel's arguments
    checked by several `require` calls)."""
    devices = {x.device for x in tensors}
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")


def step_counter(name: str, t, device: torch.device):
    """(pointer, int) of a kernel's step argument: a device step counter
    (int64 [2] on `device`: t, and the row of the stimulus window; what a
    captured CUDA graph advances) gives its address and 0, a number gives
    None and int(t)."""
    if isinstance(t, torch.Tensor):
        if (t.device != device or t.dtype != torch.int64
                or tuple(t.shape) != (2,) or not t.is_contiguous()):
            raise ValueError(f"{name}: the step counter must be a contiguous "
                             f"int64 [2] tensor on {device}, got "
                             f"{t.dtype}{tuple(t.shape)} on {t.device}")
        return t.data_ptr(), 0
    return None, int(t)


def step_base(name: str, t_base, H: int, device: torch.device):
    """The pointer of a kernel's per-shard step offsets: None for None, else
    the address of t_base, which must be a contiguous int64 [H] tensor on
    `device` (shard h then steps at t + t_base[h]: a batch of simulations
    folded onto the shard axis, each at its own step)."""
    if t_base is None:
        return None
    if (not isinstance(t_base, torch.Tensor) or t_base.device != device
            or t_base.dtype != torch.int64 or tuple(t_base.shape) != (H,)
            or not t_base.is_contiguous()):
        got = (f"{t_base.dtype}{tuple(t_base.shape)} on {t_base.device}"
               if isinstance(t_base, torch.Tensor) else type(t_base).__name__)
        raise ValueError(f"{name}: t_base must be a contiguous int64 [{H}] "
                         f"tensor on {device}, got {got}")
    return t_base.data_ptr()
