"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``.  Builds happen at
first use (never at import: the CPU tests import every module), all
sources in parallel, into ``build/kernels/`` at the repository root; a
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source never loads a stale
build.

Each kernel wrapper counts its launches in :data:`LAUNCHES`, keyed by
kernel name (:data:`KERNELS` names each kernel's source).
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
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                                REPO_ROOT / "build" / "kernels"))
SOURCES = ("fused_qgemm", "conv_implicit", "attn_flash", "attn_paged",
           "quantpack", "bitgemm", "int8_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> its source; launches through its wrapper (never the
# plain version)
KERNELS = {"fused_qgemm": "fused_qgemm", "conv_implicit": "conv_implicit",
           "attn_flash": "attn_flash", "attn_paged": "attn_paged",
           "quantize_pack": "quantpack", "bitgemm_packed": "bitgemm",
           "int8_matmul": "int8_matmul"}
LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}   # name -> nvcc/ptxas output of the build
BUILD_SECONDS: dict[str, float] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the CUDA "
                       "kernels are built from source on the machine with "
                       "the card")


def _lib_path(name: str) -> Path:
    # the source, the headers it may include and the flags
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: _lib_path(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def launcher(kernel: str, argtypes: list, suffix: str = "launch",
             restype=ctypes.c_int):
    """The C function ``<kernel>_<suffix>`` of the kernel's library (built
    on first use), with its ctypes signature set."""
    fn = getattr(library(KERNELS[kernel]), f"{kernel}_{suffix}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if the C launcher reported a nonzero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def count_device_ops(fn, calls: int = 4, windows: int = 3) -> int:
    """Operations one ``fn()`` puts on the device (kernels, memsets,
    copies), counted with ``torch.profiler`` over ``calls`` calls and
    rounded up (the tracer may drop a record at the start of a window).
    A window that delivers no device record at all (seen on an H100 after
    a dozen or more profiler sessions in one process) is taken again, at
    most ``windows`` times; a nonzero count is returned as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        if n:
            break
    return -(-n // calls)
