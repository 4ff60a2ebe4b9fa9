"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

Each kernel source is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds.  Libraries are built at first use into
``build/repro_torch_kernels/`` at the repository root, named by a hash of
their sources and flags, so an edited source is rebuilt and an unchanged
one is reused.  ``build_all()`` starts one ``nvcc`` per source at once
and waits for all of them.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: kernel name -> its source file in ``csrc``.
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "paged_prefill": "paged_prefill.cu",
    "dense_decode": "dense_decode.cu",
    "sclad_matmul": "sclad_matmul.cu",
    "ssd_scan": "ssd_scan.cu",
    "flash_attention": "flash_attention.cu",
}
_P, _I = ctypes.c_void_p, ctypes.c_int
#: kernel name -> (C entry point, argument types).  Every pointer and the
#: stream are c_void_p: a bare Python int would be cut to 32 bits.
ENTRY_POINTS = {
    "paged_decode": ("repro_paged_decode", [_P] * 8 + [_I] * 8 + [_P]),
    "paged_prefill": ("repro_paged_prefill", [_P] * 11 + [_I] * 10 + [_P]),
    "dense_decode": ("repro_dense_decode", [_P] * 5 + [_I] * 6 + [_P]),
    "sclad_matmul": ("repro_sclad_matmul", [_P] * 5 + [_I] * 8 + [_P]),
    "ssd_scan": ("repro_ssd_scan", [_P] * 6 + [_I] * 6 + [_P]),
    "flash_attention": ("repro_flash_attention", [_P] * 4 + [_I] * 8 + [_P]),
}
#: Pool payload dtype -> the ``kv_kind`` code of the paged entry points.
KV_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
HEADERS = ("paged_attention.cuh", "mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's usual install location; raises if none exists."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is (or will be) built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every missing library among ``names`` (default: all), one
    ``nvcc`` process per source, all started together.  Returns kernel name
    -> build seconds (0.0 for a library already built).  Raises with the
    compiler's output if any build fails.  The compiler's own report
    (registers, spills, shared memory) is kept beside each library as
    ``<library>.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        pending[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT),
                         tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in pending.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n"
                            f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` with its entry point typed,
    built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        entry, argtypes = ENTRY_POINTS[name]
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = _I
        lib.repro_cuda_error_string.argtypes = [_I]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def kv_kind(what: str, k_pool, kv_scales) -> int:
    """The ``kv_kind`` code of a pool for the paged entry points; raises
    unless the pool is bf16 without scales, or int8 / float8_e4m3fn with
    contiguous fp32 (N, bs, Hk) scales on the pool's device."""
    kind = KV_KINDS.get(k_pool.dtype)
    if kind is None:
        raise TypeError(f"{what}: pool dtype {k_pool.dtype} not bf16, int8 "
                        f"or float8_e4m3fn")
    if (kind != 0) != (kv_scales is not None):
        raise TypeError(f"{what}: an int8/fp8 pool needs kv_scales, a bf16 "
                        f"pool takes none")
    for s in kv_scales or ():
        if s.dtype != torch.float32 or s.shape != k_pool.shape[:3] \
                or s.device != k_pool.device or not s.is_contiguous():
            raise ValueError(f"{what}: scales must be contiguous fp32 "
                             f"{tuple(k_pool.shape[:3])} on the pool's "
                             f"device")
    return kind


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
