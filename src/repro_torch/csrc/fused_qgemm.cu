// Fused quantize -> level GEMM -> rowsum -> dequant, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/fused_qgemm.py, fused_qgemm_pallas (_kernel).
//
//   out[m, n] = s * f32(sum_k A[m,k] W[k,n]) - t * f32(sum_k A[m,k])
//
// A is (M, K) unsigned 8-bit activation levels, or float32 activations that
// the kernel quantizes on load (clip to [0,1], rintf(x * (2^a - 1)) — round
// half to even, as jnp.round and torch.round); W is (K, N) unsigned 8-bit
// weight levels; out is (M, N) float32.  s and t come from the host.
//
// What bounds it on an H100: bytes, at every main-path shape.  The serve
// path calls it at svhn conv6 (batch 8: M=800, K=256, N=512; its largest
// stream is the 1.6 MB float32 output) and at AlexNet fc5/fc6 (M=8,
// K=9216 and 4096, N=4096), which stream 37.7 and 16.8 MB of weight
// levels: 11.3 and 5.0 us at 3.35 TB/s, against under a microsecond of
// int8 tensor-core work.  The first kernel (__dp4a on the CUDA cores, one
// 64x64 tile a block over all of K, synchronous staging) ran fc5 as 64
// blocks at about 150 GB/s.
//
// Design.
//  * Tensor cores on u8: mma.sync m16n8k32 .u8.u8.s32.  Levels are 0..255,
//    so no nibble split is needed (the MXU took s8), and the int32 sum is
//    exact in any order: the output equals the plain version bit for bit.
//  * W stays (K, N) in device memory (no transposed copy, not even at plan
//    compile).  The mma wants B K-contiguous, so W is transposed in
//    registers: ldmatrix.x4.trans reads 2x2 byte blocks (a k pair x an n
//    pair) of the staged (k, n) tile, the lane row addresses chosen so a
//    lane's two k pairs are one k quad, and two __byte_perm per register
//    pair give the column-major fragments of two 8-column mma tiles, one
//    for the even and one for the odd columns of a 16-column chunk.  A
//    lane then owns 4 consecutive output columns: float4 stores.
//  * cp.async staging (16 bytes a thread) in a ring of NST = 4 stages, so
//    three K steps are in flight while the tensor cores work on one; the
//    stages are XOR-swizzled so every ldmatrix phase hits 8 distinct bank
//    groups.  Rows that are not 16-byte aligned (K or N not a multiple of
//    16) and float32 activations (quantized on load) are staged through
//    registers into the same ring.
//  * Split-K for skinny M (M <= 32, the 16-row tile), planned by plan_for
//    below (exported as fused_qgemm_plan): K is split until the grid
//    holds about four blocks a SM, at most 8 ways (the portable cluster
//    size) and at least two K steps a split.  The splits of a tile form
//    one thread-block cluster; each writes its int32 partial tile and
//    partial rowsums to its own shared memory, and after a cluster
//    barrier block r sums rows r, r + S, ... of all S partials through
//    distributed shared memory, applies the epilogue and stores.  One
//    launch, no workspace, no counters, deterministic.  fc5 runs as 64
//    column tiles x 8 splits.
//  * The rowsum is summed from the A fragments (__dp4a against ones) by
//    the warps of the block's first column group, once per row and K
//    split, and combined with the partial tiles.
//  * The epilogue uses __fmul_rn/__fsub_rn (no FMA contraction).
//
// Later work: wgmma with a TMA producer warp at M >= 64; u4 mma
// (m16n8k64) at W1A4; a persistent grid over the column tiles.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "u8_mma.cuh"

namespace cg = cooperative_groups;

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
  // only the skinny 16-row tile splits: at M = 800 (svhn conv6) the
  // cluster combine costs more than the extra blocks gain
  p.steps = split_steps(tiles, nsteps, p.bm == 16, /*split_wide=*/false);
  p.nsplit = (nsteps + p.steps - 1) / p.steps;
  // the ring; the split-K partial tile and rowsums reuse it
  p.smem = NST * (p.bm * p.bk + p.bk * BN);
  return p;
}

__device__ __forceinline__ uint8_t quantize_level(float v, float n) {
  float x = fminf(fmaxf(v, 0.0f), 1.0f);
  float r = rintf(__fmul_rn(x, n));
  r = fminf(fmaxf(r, 0.0f), n);
  return static_cast<uint8_t>(__float2uint_rn(r));
}

// a_mode: 0 u8 levels by cp.async (K % 16 == 0, 16-byte aligned), 1 u8
// levels through registers, 2 float32 quantized on load.  w_async: W by
// cp.async (N % 16 == 0, 16-byte aligned), else through registers.
template <int BM, int BK>
__global__ void __launch_bounds__(THREADS)
fused_qgemm_kernel(const void* __restrict__ a_ptr,
                   const uint8_t* __restrict__ w, float* __restrict__ out,
                   int M, int N, int K, int steps, int a_mode, int w_async,
                   float n_levels, float s, float t) {
  constexpr int WARPS_M = BM == 16 ? 1 : 2, WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, FM = WM / 16;
  constexpr int WN = BN / WARPS_N, FN = WN / 16;
  constexpr int A_BYTES = BM * BK, STAGE = A_BYTES + BK * BN;
  constexpr int ACH = BK / 16;
  static_assert(NST * STAGE >= (BM * RED_PITCH + BM) * 4, "reduction room");
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ unsigned rs_s[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * steps;
  const int nk = min(steps, max(1, (K + BK - 1) / BK) - kt0);
  const uint8_t* a8 = static_cast<const uint8_t*>(a_ptr);
  const float* af32 = static_cast<const float*>(a_ptr);

  auto load = [&](int st, int kt) {
    uint8_t* as = smem + st * STAGE;
    uint8_t* ws = as + A_BYTES;
    const int k0 = kt * BK;
    for (int c = tid; c < BM * ACH; c += THREADS) {
      const int r = c / ACH, ch = c % ACH;
      const int gm = m0 + r, gk = k0 + ch * 16;
      uint8_t* dst = as + a_off<BK>(r, ch);
      if (a_mode == 0) {
        const bool ok = gm < M && gk < K;
        cp_async16(dst, ok ? a8 + static_cast<size_t>(gm) * K + gk : a8, ok);
      } else {
        unsigned v[4] = {0u, 0u, 0u, 0u};
        if (gm < M) {
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            if (gk + q < K) {
              const size_t i = static_cast<size_t>(gm) * K + gk + q;
              const unsigned lv =
                  a_mode == 1 ? a8[i] : quantize_level(af32[i], n_levels);
              v[q >> 2] |= lv << (8 * (q & 3));
            }
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    for (int c = tid; c < BK * 4; c += THREADS) {
      const int r = c >> 2, ch = c & 3;
      const int gk = k0 + r, gn = n0 + ch * 16;
      uint8_t* dst = ws + w_off(r, ch);
      if (w_async) {
        const bool ok = gk < K && gn < N;
        cp_async16(dst, ok ? w + static_cast<size_t>(gk) * N + gn : w, ok);
      } else {
        unsigned v[4] = {0u, 0u, 0u, 0u};
        if (gk < K) {
#pragma unroll
          for (int q = 0; q < 16; ++q)
            if (gn + q < N)
              v[q >> 2] |= static_cast<unsigned>(
                               w[static_cast<size_t>(gk) * N + gn + q])
                           << (8 * (q & 3));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
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
  unsigned rs[FM][2];
#pragma unroll
  for (int i = 0; i < FM; ++i) rs[i][0] = rs[i][1] = 0u;

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
    const uint8_t* ws = as + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      unsigned afr[FM][4];
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
        ldsm_x4(afr[fm], as + a_off<BK>(wm * WM + fm * 16 + arow,
                                        kk * 2 + achunk));
      if (wn == 0) {
#pragma unroll
        for (int fm = 0; fm < FM; ++fm) {
          rs[fm][0] = __dp4a(afr[fm][0], 0x01010101u, rs[fm][0]);
          rs[fm][0] = __dp4a(afr[fm][2], 0x01010101u, rs[fm][0]);
          rs[fm][1] = __dp4a(afr[fm][1], 0x01010101u, rs[fm][1]);
          rs[fm][1] = __dp4a(afr[fm][3], 0x01010101u, rs[fm][1]);
        }
      }
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) {
        unsigned ev[2], od[2];
        b_frags(ws, kk * 32 + bkrow, (wn * WN) / 16 + fn, ev, od);
#pragma unroll
        for (int fm = 0; fm < FM; ++fm) {
          mma_u8(acc[fm][fn][0], afr[fm], ev[0], ev[1]);
          mma_u8(acc[fm][fn][1], afr[fm], od[0], od[1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // rowsums of the block's rows: a quad of lanes holds one row's parts
  if (wn == 0) {
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned v = rs[fm][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tg == 0) rs_s[wm * WM + fm * 16 + h * 8 + g] = v;
      }
  }
  __syncthreads();

  if (gridDim.z == 1) {
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = wm * WM + fm * 16 + h * 8 + g, row = m0 + lr;
        if (row >= M) continue;
        const float corr = __fmul_rn(t, __uint2float_rn(rs_s[lr]));
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) {
          const float v[4] = {dequant(s, acc[fm][fn][0][2 * h], corr),
                              dequant(s, acc[fm][fn][1][2 * h], corr),
                              dequant(s, acc[fm][fn][0][2 * h + 1], corr),
                              dequant(s, acc[fm][fn][1][2 * h + 1], corr)};
          store4(out + static_cast<size_t>(row) * N,
                 n0 + wn * WN + fn * 16 + 4 * tg, N, v);
        }
      }
    return;
  }

  // split-K: this split's partial tile and rowsums into its own shared
  // memory (the drained ring), then the cluster sums them
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
  if (tid < BM) red[BM * RED_PITCH + tid] = static_cast<int>(rs_s[tid]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int nsplit = static_cast<int>(gridDim.z);
  const int rank = static_cast<int>(cluster.block_rank());
  const int mine = (BM - rank + nsplit - 1) / nsplit;  // rows rank + i*nsplit
  for (int e = tid; e < mine * (BN / 4); e += THREADS) {
    const int lr = rank + (e / (BN / 4)) * nsplit, lc = (e % (BN / 4)) * 4;
    int sum[4] = {0, 0, 0, 0};
    int rsum = 0;
    for (int q = 0; q < nsplit; ++q) {
      const int* rem = cluster.map_shared_rank(red, q);
      const int4 v = *reinterpret_cast<const int4*>(rem + lr * RED_PITCH + lc);
      sum[0] += v.x;
      sum[1] += v.y;
      sum[2] += v.z;
      sum[3] += v.w;
      rsum += rem[BM * RED_PITCH + lr];
    }
    const int row = m0 + lr;
    if (row < M) {
      const float corr = __fmul_rn(t, __int2float_rn(rsum));
      const float v[4] = {dequant(s, sum[0], corr), dequant(s, sum[1], corr),
                          dequant(s, sum[2], corr), dequant(s, sum[3], corr)};
      store4(out + static_cast<size_t>(row) * N, n0 + lc, N, v);
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int BM, int BK>
cudaError_t launch(const Plan& p, const void* a, const uint8_t* w, float* out,
                   int M, int N, int K, int a_mode, int w_async,
                   float n_levels, float s, float t, cudaStream_t st) {
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
  return cudaLaunchKernelEx(&cfg, fused_qgemm_kernel<BM, BK>, a, w, out, M,
                            N, K, p.steps, a_mode, w_async, n_levels, s, t);
}

}  // namespace

// The launch plan fused_qgemm_launch uses for (M, N, K): fills plan with
// (row tile, K step, K splits, K steps a split, dynamic shared memory).
extern "C" int fused_qgemm_plan(int M, int N, int K, int* plan) {
  const Plan p = plan_for(M, N, K);
  plan[0] = p.bm;
  plan[1] = p.bk;
  plan[2] = p.nsplit;
  plan[3] = p.steps;
  plan[4] = p.smem;
  return 0;
}

// Launch on `stream`; returns the launch's error (0 on success).
extern "C" int fused_qgemm_launch(const void* a, const void* w, void* out,
                                  int M, int N, int K, int a_is_levels,
                                  int a_bits, float s, float t,
                                  void* stream) {
  const Plan p = plan_for(M, N, K);
  const float n_levels = static_cast<float>((1 << a_bits) - 1);
  const int a_mode =
      !a_is_levels ? 2
      : ((K & 15) == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0) ? 0
                                                                       : 1;
  const int w_async =
      (N & 15) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const uint8_t* w8 = static_cast<const uint8_t*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      p.bm == 16
          ? launch<16, 128>(p, a, w8, o, M, N, K, a_mode, w_async, n_levels,
                            s, t, st)
          : launch<64, 64>(p, a, w8, o, M, N, K, a_mode, w_async, n_levels,
                           s, t, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
