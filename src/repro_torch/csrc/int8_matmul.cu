// Signed 8-bit matmul with a 32-bit accumulator, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bitgemm_mxu.py, int8_matmul_pallas (_kernel).
//
//   out[m, n] = sum_k A[m, k] * B[k, n]      (s8 x s8 -> s32)
//
// A is (M, K) and B (K, N), row-major signed 8-bit; out is (M, N) int32,
// exact while 128 * 128 * K < 2^31 (the wrapper checks it): the tensor
// cores sum s8 products into s32 exactly, in any order.  Any M, K and N,
// K = 0 included (the output is then zero).  The serve path calls it with
// the nibble groups of the int8 engine's levels (ops.bitgemm_mxu) and with
// single bit planes (int8_planewise).
//
// What bounds it on an H100: bytes, at every main-path shape.  svhn conv1
// at batch 8 (M=12800, K=576, N=64) reads 7.4 MB of A and writes a
// 3.3 MB int32 output (~3.2 us at 3.35 TB/s) for 0.9 G int8 operations
// (~0.5 us at 1,979 TOP/s); AlexNet fc5 (M=8, K=9216, N=4096) reads
// 37.7 MB of B (~11 us).  The first kernel (signed __dp4a on 64x64 tiles,
// synchronous staging, no split-K) ran fc5 as 64 blocks in 0.2469 ms,
// 153 GB/s (NVIDIA H100 80GB HBM3, 700.00 W).
//
// Design: csrc/fused_qgemm.cu's on signed operands, without the quantize,
// rowsum and epilogue.
//  * Tensor cores on s8: mma.sync m16n8k32 .s8.s8.s32.
//  * B stays (K, N) in device memory and is never copied: ldmatrix.x4.trans
//    plus __byte_perm (u8_mma.cuh) transpose it in registers.  That moves
//    bytes only, so it holds for s8 as for u8.  A lane owns 4 consecutive
//    output columns: int4 stores.
//  * cp.async staging (16 bytes a thread) in a ring of NST = 4 stages,
//    XOR-swizzled so every ldmatrix phase hits 8 distinct bank groups.
//  * Rows that cp.async cannot take 16 bytes at a time (K or N not a
//    multiple of 16, or a base pointer that is not 16-byte aligned, such as
//    a view one byte into a tensor) take a masked path inside the kernel:
//    the thread loads the chunk byte by byte (zero past the edge) and
//    stores it into the same ring.  The wrapper refuses nothing for
//    alignment and copies nothing.
//  * Split-K over a thread-block cluster (plan_for, exported as
//    int8_matmul_plan, with u8_mma.cuh split_steps): at M <= 32 (16-row
//    tiles) K is split until the grid holds about four blocks a SM, at
//    most 8 ways (the portable cluster size) and at least two K steps a
//    split; with 64-row tiles only when the tiles do not fill the SMs
//    once, and at least four K steps a split.
//    Each split keeps its int32 partial tile in its own shared memory, and
//    the cluster sums the partials through distributed shared memory
//    (u8_mma.cuh cluster_sum_store).  One launch, no workspace, no memset,
//    deterministic.  fc5 runs as 64 column tiles x 8 splits.
//
// Later work: wgmma with a TMA producer warp at M >= 64.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "u8_mma.cuh"

namespace {

using namespace u8mma;

constexpr int BN = W_ROW;          // output columns per block
constexpr int THREADS = 128;       // four warps
constexpr int NST = 4;             // stages of the cp.async ring

// One call's launch plan: the row tile, the K step, the K splits (one
// cluster), the K steps a split and the dynamic shared memory.
struct Plan {
  int bm, bk, nsplit, steps, smem;
};

Plan plan_for(int M, int N, int K) {
  Plan p;
  p.bm = M <= 32 ? 16 : 64;
  p.bk = p.bm == 16 ? 128 : 64;
  const int tiles =
      std::max(1, ((M + p.bm - 1) / p.bm) * ((N + BN - 1) / BN));
  const int nsteps = std::max(1, (K + p.bk - 1) / p.bk);
  p.steps = split_steps(tiles, nsteps, p.bm == 16);
  p.nsplit = (nsteps + p.steps - 1) / p.steps;
  // the ring; a split-K partial tile reuses it
  p.smem = NST * (p.bm * p.bk + p.bk * BN);
  return p;
}

// 16 bytes of row `row` (len bytes) from byte col on, zero past len, byte
// by byte: the masked path for rows cp.async cannot take
__device__ __forceinline__ uint4 load16_masked(const int8_t* row, int col,
                                               int len) {
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int q = 0; q < 16; ++q)
    if (col + q < len)
      v[q >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(row[col + q]))
                   << (8 * (q & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// a_async / b_async: A / B by 16-byte cp.async (row length a multiple of
// 16 and the base 16-byte aligned), else by the masked path.
template <int BM, int BK>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   int* __restrict__ out, int M, int N, int K, int steps,
                   int a_async, int b_async) {
  constexpr int WARPS_M = BM == 16 ? 1 : 2, WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, FM = WM / 16;
  constexpr int WN = BN / WARPS_N, FN = WN / 16;
  constexpr int A_BYTES = BM * BK, STAGE = A_BYTES + BK * BN;
  constexpr int ACH = BK / 16;
  static_assert(NST * STAGE >= BM * RED_PITCH * 4, "reduction room");
  extern __shared__ __align__(128) uint8_t smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * steps;
  const int nk = K > 0 ? min(steps, (K + BK - 1) / BK - kt0) : 0;

  auto load = [&](int st, int kt) {
    uint8_t* as = smem + st * STAGE;
    uint8_t* bs = as + A_BYTES;
    const int k0 = kt * BK;
    for (int c = tid; c < BM * ACH; c += THREADS) {
      const int r = c / ACH, ch = c % ACH;
      const int gm = m0 + r, gk = k0 + ch * 16;
      uint8_t* dst = as + a_off<BK>(r, ch);
      const bool ok = gm < M && gk < K;
      if (a_async) {
        cp_async16(dst, ok ? a + static_cast<size_t>(gm) * K + gk : a, ok);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            ok ? load16_masked(a + static_cast<size_t>(gm) * K, gk, K)
               : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int c = tid; c < BK * 4; c += THREADS) {
      const int r = c >> 2, ch = c & 3;
      const int gk = k0 + r, gn = n0 + ch * 16;
      uint8_t* dst = bs + w_off(r, ch);
      const bool ok = gk < K && gn < N;
      if (b_async) {
        cp_async16(dst, ok ? b + static_cast<size_t>(gk) * N + gn : b, ok);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            ok ? load16_masked(b + static_cast<size_t>(gk) * N, gn, N)
               : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  int acc[FM][FN][2][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][0][e] = acc[i][j][1][e] = 0;

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, achunk = lane >> 4;
  const int bkrow = b_krow(lane);

#pragma unroll
  for (int st = 0; st < NST - 1; ++st) {
    if (st < nk) load(st, kt0 + st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // step `it` has landed; stage (it-1) % NST is free
    if (it + NST - 1 < nk) load((it + NST - 1) % NST, kt0 + it + NST - 1);
    cp_async_commit();
    const uint8_t* as = smem + (it % NST) * STAGE;
    const uint8_t* bs = as + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      unsigned afr[FM][4];
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
        ldsm_x4(afr[fm], as + a_off<BK>(wm * WM + fm * 16 + arow,
                                        kk * 2 + achunk));
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) {
        unsigned ev[2], od[2];
        b_frags(bs, kk * 32 + bkrow, (wn * WN) / 16 + fn, ev, od);
#pragma unroll
        for (int fm = 0; fm < FM; ++fm) {
          mma_s8(acc[fm][fn][0], afr[fm], ev[0], ev[1]);
          mma_s8(acc[fm][fn][1], afr[fm], od[0], od[1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (gridDim.z == 1) {
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + fm * 16 + h * 8 + g;
        if (row >= M) continue;
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) {
          const int v[4] = {acc[fm][fn][0][2 * h], acc[fm][fn][1][2 * h],
                            acc[fm][fn][0][2 * h + 1],
                            acc[fm][fn][1][2 * h + 1]};
          store4(out + static_cast<size_t>(row) * N,
                 n0 + wn * WN + fn * 16 + 4 * tg, N, v);
        }
      }
    return;
  }

  // split-K: this split's partial tile into its own shared memory (the
  // drained ring), then the cluster sums the partials
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm * WM + fm * 16 + h * 8 + g;
#pragma unroll
      for (int fn = 0; fn < FN; ++fn)
        *reinterpret_cast<int4*>(red + lr * RED_PITCH + wn * WN + fn * 16
                                 + 4 * tg) =
            make_int4(acc[fm][fn][0][2 * h], acc[fm][fn][1][2 * h],
                      acc[fm][fn][0][2 * h + 1], acc[fm][fn][1][2 * h + 1]);
    }
  cluster_sum_store<BM, THREADS>(red, out, m0, n0, M, N);
}

template <int BM, int BK>
cudaError_t launch(const Plan& p, const int8_t* a, const int8_t* b, int* out,
                   int M, int N, int K, int a_async, int b_async,
                   cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, p.nsplit);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.nsplit;
  cfg.attrs = attr;
  cfg.numAttrs = p.nsplit > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, int8_matmul_kernel<BM, BK>, a, b, out, M,
                            N, K, p.steps, a_async, b_async);
}

}  // namespace

// The launch plan int8_matmul_launch uses for (M, N, K): fills plan with
// (row tile, K step, K splits, K steps a split, dynamic shared memory).
extern "C" int int8_matmul_plan(int M, int N, int K, int* plan) {
  const Plan p = plan_for(M, N, K);
  plan[0] = p.bm;
  plan[1] = p.bk;
  plan[2] = p.nsplit;
  plan[3] = p.steps;
  plan[4] = p.smem;
  return 0;
}

// Launch on `stream`; returns the launch's error (0 on success).
extern "C" int int8_matmul_launch(const void* a, const void* b, void* out,
                                  int M, int N, int K, void* stream) {
  const Plan p = plan_for(M, N, K);
  const int a_async =
      (K & 15) == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const int b_async =
      (N & 15) == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int8_t* b8 = static_cast<const int8_t*>(b);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      p.bm == 16
          ? launch<16, 128>(p, a8, b8, o, M, N, K, a_async, b_async, st)
          : launch<64, 64>(p, a8, b8, o, M, N, K, a_async, b_async, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
