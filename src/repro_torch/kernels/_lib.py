"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``.  Builds happen at
first use (never at import: the CPU tests import every module), all
sources in parallel, into ``build/kernels/`` at the repository root; a
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source never loads a stale
build.  Each build is a ``kernels.build`` record of
``launch.trace.TRACER`` (its identifier the source's index in
:data:`SOURCES`) and counts in its ``kernels.builds`` counter; each first
load of a library is a ``kernels.load`` span.

Each kernel wrapper counts its launches in :data:`LAUNCHES`, keyed by
kernel name (:data:`KERNELS` names each kernel's source), and runs its
plain version on the tensors of :data:`PLAIN_DEVICES` (the CPU, and the
meta device of the dry run's abstract steps).  :func:`counted` makes a
wrapper report its call's work to an active step counter
(``launch.hlo_analysis.StepCounter``).  :func:`split_steps` is the split-K
rule the kernels' plans share.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.launch.trace import TRACER

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                                REPO_ROOT / "build" / "kernels"))
SOURCES = ("fused_qgemm", "conv_implicit", "attn_flash", "attn_paged",
           "quantpack", "bitgemm", "int8_matmul", "norm_act", "dwconv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> its source; launches through its wrapper (never the
# plain version)
KERNELS = {"fused_qgemm": "fused_qgemm", "conv_implicit": "conv_implicit",
           "attn_flash": "attn_flash", "attn_paged": "attn_paged",
           "quantize_pack": "quantpack", "bitgemm_packed": "bitgemm",
           "int8_matmul": "int8_matmul", "norm_act": "norm_act",
           "dwconv": "dwconv"}
LAUNCHES = {name: 0 for name in KERNELS}
# devices whose tensors a wrapper runs its plain version on
PLAIN_DEVICES = ("cpu", "meta")
# the active step counter (launch.hlo_analysis.StepCounter), or None
COUNTER: list = [None]


def counted(name: str, flops):
    """Decorator of kernel ``name``'s wrapper: under an active step
    counter, the call counts ``flops(*args, **kwargs)`` (the work of the
    kernel's plain version, from the arguments' shapes) and the bytes of
    its tensor arguments and outputs, and the counter counts none of the
    operations inside (the plain version's, or the kernel's ``empty``),
    so a step counts the same on the card as on the CPU or meta.  Without
    a counter the wrapper runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            counter = COUNTER[0]
            if counter is None:
                return fn(*args, **kwargs)
            with counter.kernel(name, flops(*args, **kwargs), args):
                out = fn(*args, **kwargs)
            counter.kernel_output(out)
            return out
        return call
    return wrap


def gemm_flops(a, b, *args, **kwargs) -> float:
    """2·M·N·K of an (M, K) x (K, N) product (the GEMM wrappers' work)."""
    (m, k), n = local_shape(a), local_shape(b)[1]
    return 2.0 * m * n * k


def local_shape(t) -> tuple:
    """The shape of this rank's part of ``t`` (a DTensor's local shard),
    which a step counter counts."""
    return tuple(getattr(t, "_local_tensor", t).shape)

# csrc/u8_mma.cuh's split-K constants: K is split until the grid holds
# about BLOCKS_PER_SM blocks on each of SMS SMs, at most MAX_SPLIT ways
# (the portable cluster size)
SMS, BLOCKS_PER_SM, MAX_SPLIT = 132, 4, 8

_LIBS: dict[str, ctypes.CDLL] = {}


def split_steps(tiles: int, nsteps: int, skinny: bool,
                split_wide: bool = True) -> int:
    """K steps a split (``csrc/u8_mma.cuh`` ``split_steps``, which every
    kernel's ``plan_for`` uses): 16-row (``skinny``) tiles split until the
    grid holds about BLOCKS_PER_SM blocks a SM, at least two steps a
    split; larger tiles, where ``split_wide``, only while they do not fill
    the SMs once, at least four steps a split; at most MAX_SPLIT splits."""
    if skinny:
        split = -(-SMS * BLOCKS_PER_SM // tiles)
    else:
        split = -(-SMS // tiles) if split_wide and tiles < SMS else 1
    split = max(1, min(split, MAX_SPLIT, nsteps // (2 if skinny else 4)))
    return -(-nsteps // split)


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


def _build(name: str, out: Path) -> tuple:
    """One ``nvcc`` run -> (its process, its start and end)."""
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    t1 = time.perf_counter()
    if proc.returncode == 0:
        os.replace(tmp, out)
    return proc, t0, t1


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all run
    together.  Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in names if not _lib_path(n).exists()}
    failed = []
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            runs = dict(zip(todo, pool.map(_build, todo, todo.values())))
        for name, (proc, t0, t1) in runs.items():
            TRACER.add("kernels.build", t0, t1, SOURCES.index(name))
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                              f"{proc.stdout}")
        TRACER.count("kernels.builds", len(todo) - len(failed))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: _lib_path(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        with TRACER.span("kernels.load", SOURCES.index(name)):
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


def count_device_ops(fn) -> int:
    """Operations one ``fn()`` puts on the device (kernels, memsets,
    copies): the nodes of a CUDA graph captured from one call, after a
    warm-up call on a side stream (builds, lazy module loads).  Exact,
    where counting ``torch.profiler`` records was not: on an H100, deep
    into a long process, three profiler windows in a row delivered no
    device record at all."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value
