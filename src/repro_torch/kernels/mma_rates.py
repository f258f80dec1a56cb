"""Issue rates of the integer tensor-core ``mma.sync`` shapes on the card.

Builds ``csrc/probe/mma_rates.cu`` with the kernels' own ``nvcc`` flags
into ``build/kernels/probe/`` and times, with CUDA events, a grid that
keeps every SM busy with register-only ``mma`` loops:

* ``b1``: ``m16n8k256 .b1 .and.popc`` (``csrc/bitgemm.cu``), 16 x 8 x 256
  AND + popcount bit products an instruction;
* ``u8`` and ``s8``: ``m16n8k32`` (``fused_qgemm.cu``, ``conv_implicit.cu``,
  ``int8_matmul.cu``), 16 x 8 x 32 products an instruction.

Run on the card from the repository root::

    PYTHONPATH=src python -m repro_torch.kernels.mma_rates

It prints the card's name and power limit, then one JSON line per shape
(instructions a second, products a second, their share of the published
1,979 int8 TOP/s counted as 2 operations a product) and the ratio of b1
bit products to u8 products a second.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

from . import _lib

KINDS = {"b1": (0, 16 * 8 * 256), "u8": (1, 16 * 8 * 32),
         "s8": (2, 16 * 8 * 32)}
PEAK_INT8_OPS = 1.979e15   # H100 SXM, dense (NVIDIA data sheet)
# the grid: BLOCKS_PER_SM blocks of THREADS on every SM, each warp issuing
# ITERS x the source's CHAINS mma; the best of REPS timed launches
BLOCKS_PER_SM, THREADS, ITERS, REPS = 4, 128, 2048, 5


def build() -> ctypes.CDLL:
    out_dir = _lib.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libmma_rates.so"
    src = _lib.CSRC / "probe" / "mma_rates.cu"
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True)
    return ctypes.CDLL(str(lib))


def measure() -> dict:
    import torch

    lib = build()
    fn = lib.mma_rate_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    chains = lib.mma_rate_chains()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, (kind, per_mma) in KINDS.items():
        def run():
            _lib.check_launch("mma_rates", fn(kind, blocks, THREADS, ITERS,
                                              out.data_ptr(), stream))
        run()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(REPS):
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            run()
            e.record()
            torch.cuda.synchronize()
            best = min(best, s.elapsed_time(e) / 1e3)
        n_mma = blocks * (THREADS // 32) * ITERS * chains
        res[name] = dict(seconds=best, mma=n_mma,
                         mma_per_s=n_mma / best,
                         mma_per_sm_per_s=n_mma / best / sms,
                         products_per_s=n_mma * per_mma / best,
                         share_of_int8_peak=2 * n_mma * per_mma / best
                         / PEAK_INT8_OPS)
    res["b1_bit_products_over_u8_products"] = (
        res["b1"]["products_per_s"] / res["u8"]["products_per_s"])
    res["grid"] = dict(blocks=blocks, threads=THREADS, iters=ITERS,
                       chains=chains)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rates: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("CARD", card)
    res = measure()
    for name in KINDS:
        print("MMA_RATE", json.dumps(dict(shape=name, **res[name])))
    print("MMA_RATES", json.dumps(dict(
        card=card, grid=res["grid"],
        b1_bit_products_over_u8_products=res[
            "b1_bit_products_over_u8_products"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
