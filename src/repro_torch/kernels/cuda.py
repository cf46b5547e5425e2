"""Build, load and call the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Builds happen at first
use, from the sources in the package only, into ``build/repro_torch_kernels``
at the root of the checkout (listed in ``.gitignore``).  A library's file
name carries a hash of its sources and flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is.  ``build()`` starts one
``nvcc`` per missing source, all at once.

Nothing here runs at import time: this module imports on machines with no
``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable, Sequence

import torch

SOURCES = ("lease_probe", "tier_pass", "rmsnorm", "rmsnorm_bwd",
           "flash_attention", "flash_attention_wgmma",
           "flash_attention_bwd", "flash_attention_bwd_wgmma",
           "decode_attention", "ssd_chunk", "ssd_chunk_wgmma",
           "ssd_chunk_bwd", "ssd_chunk_bwd_wgmma")
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> pathlib.Path:
    """Where ``name``'s library lives: keyed by a hash of its source, the
    shared headers and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library in ``names`` with one ``nvcc`` each,
    all started together.  Returns seconds per library built (0.0 for one
    already present), each from its own start to its own end; raises
    with the compiler's output on failure.  The ptxas report (registers,
    spills) lands beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, float] = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            out[name] = 0.0
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = so.with_suffix(f".{os.getpid()}.log")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as fh:
            procs[name] = (subprocess.Popen(cmd, stdout=fh,
                                            stderr=subprocess.STDOUT),
                           tmp, log, so, time.perf_counter())
    while procs:
        for name, (proc, tmp, log, so, t0) in list(procs.items()):
            if proc.poll() is None:
                continue
            del procs[name]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                                   f"{log.read_text()}")
            os.replace(log, so.with_suffix(".log"))
            os.replace(tmp, so)        # atomic: concurrent builders agree
            out[name] = time.perf_counter() - t0
        time.sleep(0.05)
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


P = ctypes.c_void_p
LD = ctypes.c_longlong
I = ctypes.c_int
F = ctypes.c_float

# storage type codes of the float kernels (csrc/float_io.cuh)
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def function(lib_name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared (pointers and the
    stream as ``c_void_p`` so no pointer is cut to 32 bits)."""
    fn = getattr(library(lib_name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


# ----------------------------------------------------------- argument checks
def _check_cuda_i32(name: str, t: torch.Tensor, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, other inputs on {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")


def check_rows(name: str, t: torch.Tensor, n: int, device) -> int:
    """Validate an ``[n, W]`` int32 row matrix on ``device`` whose ways are
    contiguous; returns its row stride (rows may be strided views, e.g. a
    gathered set row with its trash way sliced off)."""
    _check_cuda_i32(name, t, device)
    if t.dim() != 2 or t.shape[0] != n or t.shape[1] < 1:
        raise ValueError(f"{name}: expected shape [{n}, W>=1], got "
                         f"{tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: ways must be contiguous (stride 1), got "
                         f"strides {t.stride()}")
    return t.stride(0)


def check_table(tables, row, n: int, device):
    """Validate named ``[K, C]`` int32 tables on ``device`` that share K
    and C, each with contiguous ways and any row stride, and ``row``, the
    contiguous ``[n]`` int32 vector naming each lane's table row (None:
    lane i reads row i, so K == n).  Returns ``(K, C, row strides)``.
    Does not read ``row``'s values: the kernel traps on one outside
    ``[0, K)``."""
    (name, first), *_ = tables
    _check_cuda_i32(name, first, device)
    if first.dim() != 2:
        raise ValueError(f"{name}: expected a [K, C] table, got shape "
                         f"{tuple(first.shape)}")
    K, C = first.shape
    if row is None and K != n:
        raise ValueError(f"{name}: shape {tuple(first.shape)} has {K} rows "
                         f"for {n} lanes; without `row` lane i reads row i")
    if row is not None:
        check_vec("row", row, n, device)
        if n and K < 1:
            raise ValueError(f"{name}: no rows for {n} lanes to name")
    lds = [check_rows(nm, t, K, device) for nm, t in tables]
    for nm, t in tables:
        if t.shape[1] != C:
            raise ValueError(f"{nm}: expected {C} ways, got {t.shape[1]}")
    return K, C, lds


def check_vec(name: str, t: torch.Tensor, n: int, device) -> None:
    """Validate a contiguous ``[n]`` int32 vector on ``device``."""
    _check_cuda_i32(name, t, device)
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: expected shape [{n}], got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous vector")


def check_flags(name: str, t: torch.Tensor, n: int, device) -> None:
    """Validate a contiguous ``[n]`` bool vector on ``device``."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.bool:
        raise TypeError(f"{name}: expected a bool tensor")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor on "
                         f"{device}, got one on {t.device}")
    if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous vector of shape "
                         f"[{n}], got {tuple(t.shape)}")


def int32_value(name: str, v) -> int:
    """``v`` as a Python int that an int32 holds; raises otherwise."""
    if isinstance(v, bool) or not isinstance(v, int) \
            or not -2 ** 31 <= v < 2 ** 31:
        raise TypeError(f"{name}: expected an int32 value or tensor, got "
                        f"{v!r}")
    return v


def check_lane_or_one(name: str, t: torch.Tensor, n: int, device) -> int:
    """Validate a contiguous int32 vector of ``n`` lanes, or of one value
    that every lane reads; returns its step (1 or 0)."""
    _check_cuda_i32(name, t, device)
    if t.dim() != 1 or t.shape[0] not in (n, 1):
        raise ValueError(f"{name}: expected shape [{n}] or [1], got "
                         f"{tuple(t.shape)}")
    if t.shape[0] > 1 and t.stride(0) != 1:
        raise ValueError(f"{name}: expected a contiguous vector")
    return int(t.shape[0] == n)


def launch(fn, args, device) -> None:
    """Call a C launcher on ``device``'s current stream; raise on a launch
    error (``cudaGetLastError``).  Never synchronises."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch failed with cudaError {rc}")


def check_rows_16b(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` starts on a 16-byte boundary and each stride of
    a dim longer than 1, over all but the last dim, is a whole number of
    16 bytes: what 16-byte copies (``cp.async``, TMA) of its rows need."""
    el = t.element_size()
    if t.data_ptr() % 16 or any(
            n > 1 and s * el % 16
            for n, s in zip(t.shape[:-1], t.stride()[:-1])):
        raise ValueError(f"{name} must start on a 16-byte boundary with "
                         "strides of whole 16 bytes, got strides "
                         f"{t.stride()}")


def check_float(name: str, t: torch.Tensor, device, dtype=None) -> int:
    """Validate a float tensor for the float kernels: a CUDA tensor on
    ``device`` (if given) in f32 or bf16 (``dtype`` if given) whose last
    dim is contiguous.  Returns the kernel's storage type code."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, other inputs on {device}")
    if t.dtype not in FLOAT_CODES or (dtype is not None and t.dtype != dtype):
        want = dtype if dtype is not None else "float32 or bfloat16"
        raise TypeError(f"{name}: expected {want}, got {t.dtype}")
    if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must be contiguous, got "
                         f"strides {t.stride()}")
    return FLOAT_CODES[t.dtype]
