// Packed AND + popcount bit-GEMM (the paper's Eq. 1), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bitgemm.py, bitgemm_packed_pallas (_kernel).
//
//   out[m, n] = sum_p sum_q 2^(p+q) sum_w popc(A[p, m, w] & W[q, n, w])
//
// A is (a_bits, M, Kw) and W (w_bits, N, Kw) bit planes packed 32 per
// 32-bit word along K (W pre-transposed, as the reference's kernel takes
// it); out is the (M, N) int32 level-GEMM accumulator, exact while
// (2^a - 1)(2^w - 1) K < 2^31 (the wrapper checks it).  Kw = 0 gives zeros.
//
// What bounds it on an H100: bytes.  On the CUDA cores it was the popcount
// issue rate (16 POPC per SM per clock: ~28 us for svhn conv2 at W1A4,
// batch 8, as long as torch._int_mm takes for the whole level GEMM), so
// this kernel runs Eq. 1 on the binary tensor cores instead:
// mma.sync m16n8k256 .b1.b1.s32 .and.popc is sum_k popc(a & w) over 256
// bits of K for a 16x8 tile, one instruction.  That leaves the operands
// and the int32 output: svhn conv2 at W1A4 moves 3.7 MB of planes and
// writes 6.6 MB (~3 us at 3.35 TB/s).
//
// Why b1 and not u8: on an NVIDIA H100 80GB HBM3 at 700.00 W
// (kernels/mma_rates.py, register-only loops on every SM) m16n8k256 .b1
// issues 1.135e9 instructions a second per SM, as many as m16n8k32 .u8
// (1.141e9): 4.91e15 AND-popcounts a second against 6.17e14 u8 products,
// 7.96x.  Unpacking the planes to {0,1} bytes for the u8 mma would cost
// 8x the instructions for the same plane pairs.
//
// Design.
//  * The packed layout is the mma's fragment layout.  Lane (g, tg) of the
//    A fragment holds words tg and tg+4 of rows g and g+8 of one 8-word K
//    step, which is what ldmatrix.x4 (b16, 8 rows x 16 bytes a matrix)
//    gives from the staged (rows, words) tile; the B fragment holds words
//    tg and tg+4 of column g, which ldmatrix.x4 gives from W as stored,
//    (N, Kw), for two 8-column tiles at once.  Both operands use the same
//    bit order, so the popcounts do not depend on how a word orders K.
//  * W's 16-row groups are staged even rows first, so the even and the odd
//    columns of a 16-column chunk are two mma tiles and a lane owns 4
//    consecutive output columns: int4 stores, full 32-byte sectors.
//  * The plane-pair shift 2^(p+q): at the main path's widths (W1A1, W1A4)
//    one accumulator set per shift s = p + q, summed shifted once at the
//    end; at other widths (up to 8 x 8 = 15 shifts, too many registers)
//    each pair's mma runs from a zeroed tile over a stage and is
//    shift-added into the running tile.  Exact under the wrapper's
//    int32_exact.
//  * Staging: plane rows are Kw words, rarely a multiple of 4 on the main
//    path (svhn 18 ... 72, AlexNet 75, 108, 288), so rows are 4-byte, not
//    16-byte aligned.  cp.async copies 16, 8 or 4 bytes (the largest that
//    divides the row and both bases: no host copy), words past Kw are
//    zero-filled (a zero word ANDs to zero) and 8-word steps with no word
//    left are skipped.  A stage is 16 words of every plane row of the tile
//    (64 bytes a row, 16-byte chunks XOR-swizzled so every ldmatrix phase
//    hits 8 distinct bank groups), in a ring of up to 4 stages.
//  * Tiles: 64 columns; 16 rows at M <= 32, 64 rows for W1A1 where those
//    tiles fill the SMs twice over (svhn conv2, AlexNet conv1 at batch 8,
//    whose int32 outputs of 6.6 and 6.4 MB dominate), else 32 rows.  Four
//    warps; with 32 or 64 rows a warp computes (16 or 32) x 32.
//  * Split-K over a thread-block cluster where the tiles do not fill the
//    card, planned by plan_for below (exported as bitgemm_packed_plan)
//    with u8_mma.cuh split_steps: at M <= 32 (AlexNet fc5/fc6, M = 8) K
//    is split until the grid holds about four blocks a SM, at least two
//    stages a split; 32-row tiles fewer than the SMs (M = 33..64 at
//    N = 4096) split until they fill the SMs once, at least four stages a
//    split; at most 8 ways.  The cluster sums the int32 partials through
//    distributed shared memory in the same launch (u8_mma.cuh
//    cluster_sum_store).
//
// Later work: TMA staging; a persistent grid over the row tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "u8_mma.cuh"
#include "smem_optin.cuh"

namespace {

using namespace u8mma;

constexpr int BN = W_ROW;          // output columns (W plane rows) a block
constexpr int THREADS = 128;       // four warps
constexpr int KW_STEP = 16;        // words of K a stage: two 256-bit steps
constexpr int ROW = KW_STEP * 4;   // bytes of a staged plane row
constexpr int MAX_NST = 4;         // stages of the cp.async ring
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may use
constexpr int MAX_BITS = 8;

// One call's launch plan: the row tile, the stages of the ring, the K
// splits (one cluster), the stages a split and the dynamic shared memory.
struct Plan {
  int bm, nst, nsplit, steps, smem;
};

Plan plan_for(int M, int N, int Kw, int a_bits, int w_bits) {
  Plan p;
  // 64-row tiles only for one plane pair where they fill the SMs twice
  // over (svhn conv2, AlexNet conv1 at batch 8); 32-row tiles elsewhere:
  // twice the blocks, and half the accumulators at W1A4
  const int tiles64 = ((M + 63) / 64) * ((N + BN - 1) / BN);
  p.bm = M <= 32                                        ? 16
         : (a_bits * w_bits == 1 && tiles64 >= 2 * SMS) ? 64
                                                        : 32;
  const int stage = (a_bits * p.bm + w_bits * BN) * ROW;
  p.nst = std::min(MAX_NST, SMEM_MAX / stage);
  const int tiles =
      std::max(1, ((M + p.bm - 1) / p.bm) * ((N + BN - 1) / BN));
  const int nsteps = std::max(1, (Kw + KW_STEP - 1) / KW_STEP);
  p.steps = split_steps(tiles, nsteps, p.bm == 16);
  p.nsplit = (nsteps + p.steps - 1) / p.steps;
  p.smem = std::max(p.nst * stage, p.nsplit > 1 ? p.bm * RED_PITCH * 4 : 0);
  return p;
}

// cp.async of 16 (cp_async16), 8 or 4 bytes (.ca: .cg takes 16 only);
// fill false zero-fills the destination
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes, bool fill) {
  if (bytes == 16) {
    cp_async16(dst, src, fill);
    return;
  }
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill ? bytes : 0;
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void mma_b1(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c (words 4c..4c+3) of staged row R: the 8
// consecutive rows an ldmatrix phase reads land in 8 distinct bank groups.
__device__ __forceinline__ int s_off(int R, int c) {
  return R * ROW + ((c ^ ((R >> 1) & 3)) << 4);
}

// Staged row of W row n of a tile: each 16-row group even rows first
__device__ __forceinline__ int w_slot(int n) {
  return (n & ~15) | ((n & 1) << 3) | ((n >> 1) & 7);
}

// AB, WB: the widths as constants (one accumulator set per shift), or 0
// for widths given at run time (shift-add per plane pair and stage).
// vec: bytes a cp.async (16, 8 or 4).
template <int BM, int AB, int WB>
__global__ void __launch_bounds__(THREADS)
bitgemm_packed_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ w, int* __restrict__ out,
                      int M, int N, int Kw, int a_bits_rt, int w_bits_rt,
                      int steps, int nst, int vec) {
  constexpr int WARPS_M = BM == 16 ? 1 : 2, WARPS_N = 4 / WARPS_M;
  constexpr int WM = BM / WARPS_M, FM = WM / 16;
  constexpr int WN = BN / WARPS_N, FC = WN / 16;  // 16-column chunks
  constexpr bool SETS = AB > 0;
  constexpr int NS = SETS ? AB + WB - 1 : 1;
  extern __shared__ __align__(128) uint8_t smem[];

  const int a_bits = SETS ? AB : a_bits_rt;
  const int w_bits = SETS ? WB : w_bits_rt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * steps;
  const int nk =
      Kw > 0 ? min(steps, (Kw + KW_STEP - 1) / KW_STEP - kt0) : 0;
  const int a_rows = a_bits * BM;
  const int stage = (a_rows + w_bits * BN) * ROW;
  const int cl = vec == 16 ? 2 : (vec == 8 ? 3 : 4);  // log2 copies a row
  const int wpc = vec >> 2;                           // words a copy

  auto load = [&](int st, int kt) {
    uint8_t* s = smem + st * stage;
    const int k0 = kt * KW_STEP;
    const int total = (a_rows + w_bits * BN) << cl;
    for (int c = tid; c < total; c += THREADS) {
      const int R = c >> cl, wd = (c & ((1 << cl) - 1)) * wpc;
      const int gk = k0 + wd;
      const uint32_t* src;
      bool ok;
      int Rs;
      if (R < a_rows) {
        const int p = R / BM, gm = m0 + R % BM;
        ok = gm < M && gk < Kw;
        src = a + (static_cast<size_t>(p) * M + gm) * Kw + gk;
        Rs = R;
      } else {
        const int q = (R - a_rows) / BN, n = (R - a_rows) % BN;
        const int gn = n0 + n;
        ok = gn < N && gk < Kw;
        src = w + (static_cast<size_t>(q) * N + gn) * Kw + gk;
        Rs = a_rows + q * BN + w_slot(n);
      }
      cp_async_n(s + s_off(Rs, wd >> 2) + (wd & 3) * 4, ok ? src : a, vec,
                 ok);
    }
  };

  int acc[NS][FM][FC][2][4];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][i][j][0][e] = acc[s][i][j][1][e] = 0;

  // ldmatrix lane addresses.  A: matrices (rows 0-7, words 0-3), (rows
  // 8-15, 0-3), (0-7, 4-7), (8-15, 4-7) = a0..a3.  B: (even columns, words
  // 0-3), (even, 4-7), (odd, 0-3), (odd, 4-7) = b0, b1 of the even tile
  // and b0, b1 of the odd tile.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, achunk = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 4) << 3), bchunk = (lane >> 3) & 1;

  auto a_frag = [&](unsigned (&f)[4], const uint8_t* s, int p, int fm,
                    int kk) {
    ldsm_x4(f, s + s_off(p * BM + wm * WM + fm * 16 + arow, kk * 2 + achunk));
  };
  auto b_frag = [&](unsigned (&f)[4], const uint8_t* s, int q, int fc,
                    int kk) {
    ldsm_x4(f, s + s_off(a_rows + q * BN + wn * WN + fc * 16 + brow,
                         kk * 2 + bchunk));
  };

  for (int st = 0; st < MAX_NST - 1; ++st) {
    if (st < nst - 1) {
      if (st < nk) load(st, kt0 + st);
      cp_async_commit();
    }
  }
  for (int it = 0; it < nk; ++it) {
    // step `it` has landed once at most nst - 2 younger groups are pending
    if (nst == 4)
      cp_async_wait<2>();
    else if (nst == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // and stage (it-1) % nst is free
    if (it + nst - 1 < nk) load((it + nst - 1) % nst, kt0 + it + nst - 1);
    cp_async_commit();
    const uint8_t* s = smem + (it % nst) * stage;
    const int nks = min(2, (Kw - (kt0 + it) * KW_STEP + 7) >> 3);
    if constexpr (SETS) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk >= nks) break;
#pragma unroll
        for (int q = 0; q < WB; ++q) {
          unsigned bfr[FC][4];
#pragma unroll
          for (int fc = 0; fc < FC; ++fc) b_frag(bfr[fc], s, q, fc, kk);
#pragma unroll
          for (int p = 0; p < AB; ++p) {
            unsigned afr[FM][4];
#pragma unroll
            for (int fm = 0; fm < FM; ++fm) a_frag(afr[fm], s, p, fm, kk);
#pragma unroll
            for (int fm = 0; fm < FM; ++fm)
#pragma unroll
              for (int fc = 0; fc < FC; ++fc) {
                mma_b1(acc[p + q][fm][fc][0], afr[fm], bfr[fc][0],
                       bfr[fc][1]);
                mma_b1(acc[p + q][fm][fc][1], afr[fm], bfr[fc][2],
                       bfr[fc][3]);
              }
          }
        }
      }
    } else {
      for (int q = 0; q < w_bits; ++q)
        for (int p = 0; p < a_bits; ++p) {
          int tmp[FM][FC][2][4];
#pragma unroll
          for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FC; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) tmp[i][j][0][e] = tmp[i][j][1][e] = 0;
          for (int kk = 0; kk < nks; ++kk) {
            unsigned bfr[FC][4], afr[FM][4];
#pragma unroll
            for (int fc = 0; fc < FC; ++fc) b_frag(bfr[fc], s, q, fc, kk);
#pragma unroll
            for (int fm = 0; fm < FM; ++fm) a_frag(afr[fm], s, p, fm, kk);
#pragma unroll
            for (int fm = 0; fm < FM; ++fm)
#pragma unroll
              for (int fc = 0; fc < FC; ++fc) {
                mma_b1(tmp[fm][fc][0], afr[fm], bfr[fc][0], bfr[fc][1]);
                mma_b1(tmp[fm][fc][1], afr[fm], bfr[fc][2], bfr[fc][3]);
              }
          }
#pragma unroll
          for (int i = 0; i < FM; ++i)
#pragma unroll
            for (int j = 0; j < FC; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[0][i][j][0][e] += tmp[i][j][0][e] << (p + q);
                acc[0][i][j][1][e] += tmp[i][j][1][e] << (p + q);
              }
        }
    }
  }
  cp_async_wait<0>();

  // the shift sets summed, 2^s each
  int res[FM][FC][2][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int ev = 0, od = 0;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          ev += acc[s][i][j][0][e] << s;
          od += acc[s][i][j][1][e] << s;
        }
        res[i][j][0][e] = ev;
        res[i][j][1][e] = od;
      }

  if (gridDim.z == 1) {
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + fm * 16 + h * 8 + g;
        if (row >= M) continue;
#pragma unroll
        for (int fc = 0; fc < FC; ++fc) {
          const int v[4] = {res[fm][fc][0][2 * h], res[fm][fc][1][2 * h],
                            res[fm][fc][0][2 * h + 1],
                            res[fm][fc][1][2 * h + 1]};
          store4(out + static_cast<size_t>(row) * N,
                 n0 + wn * WN + fc * 16 + 4 * tg, N, v);
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
      for (int fc = 0; fc < FC; ++fc)
        *reinterpret_cast<int4*>(red + lr * RED_PITCH + wn * WN + fc * 16
                                 + 4 * tg) =
            make_int4(res[fm][fc][0][2 * h], res[fm][fc][1][2 * h],
                      res[fm][fc][0][2 * h + 1], res[fm][fc][1][2 * h + 1]);
    }
  cluster_sum_store<BM, THREADS>(red, out, m0, n0, M, N);
}

template <int BM, int AB, int WB>
cudaError_t launch(const Plan& p, const uint32_t* a, const uint32_t* w,
                   int* out, int M, int N, int Kw, int a_bits, int w_bits,
                   int vec, cudaStream_t st) {
  static int attr_set[smem_optin::MAX_DEVICES] = {};  // above 48 KB
  cudaError_t e = smem_optin::ensure(bitgemm_packed_kernel<BM, AB, WB>,
                                     SMEM_MAX, attr_set);
  if (e != cudaSuccess) return e;
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
  return cudaLaunchKernelEx(&cfg, bitgemm_packed_kernel<BM, AB, WB>, a, w,
                            out, M, N, Kw, a_bits, w_bits, p.steps, p.nst,
                            vec);
}

template <int BM>
cudaError_t launch_bits(const Plan& p, const uint32_t* a, const uint32_t* w,
                        int* out, int M, int N, int Kw, int a_bits,
                        int w_bits, int vec, cudaStream_t st) {
  if (a_bits == 1 && w_bits == 1)
    return launch<BM, 1, 1>(p, a, w, out, M, N, Kw, a_bits, w_bits, vec, st);
  if (a_bits == 4 && w_bits == 1)
    return launch<BM, 4, 1>(p, a, w, out, M, N, Kw, a_bits, w_bits, vec, st);
  return launch<BM, 0, 0>(p, a, w, out, M, N, Kw, a_bits, w_bits, vec, st);
}

}  // namespace

// The launch plan bitgemm_packed_launch uses: fills plan with (row tile,
// ring stages, K splits, stages a split, dynamic shared memory).
extern "C" int bitgemm_packed_plan(int M, int N, int Kw, int a_bits,
                                   int w_bits, int* plan) {
  if (a_bits < 1 || a_bits > MAX_BITS || w_bits < 1 || w_bits > MAX_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(M, N, Kw, a_bits, w_bits);
  plan[0] = p.bm;
  plan[1] = p.nst;
  plan[2] = p.nsplit;
  plan[3] = p.steps;
  plan[4] = p.smem;
  return 0;
}

// Launch on `stream`; returns the launch's error (0 on success).
extern "C" int bitgemm_packed_launch(const void* a_planes,
                                     const void* w_planes, void* out, int M,
                                     int N, int Kw, int a_bits, int w_bits,
                                     void* stream) {
  if (a_bits < 1 || a_bits > MAX_BITS || w_bits < 1 || w_bits > MAX_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(M, N, Kw, a_bits, w_bits);
  // the widest cp.async that every plane row start is aligned to
  const uintptr_t al = reinterpret_cast<uintptr_t>(a_planes) |
                       reinterpret_cast<uintptr_t>(w_planes) |
                       static_cast<uintptr_t>(Kw) * 4;
  const int vec = (al & 15) == 0 ? 16 : ((al & 7) == 0 ? 8 : 4);
  const uint32_t* a = static_cast<const uint32_t*>(a_planes);
  const uint32_t* w = static_cast<const uint32_t*>(w_planes);
  int* o = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      p.bm == 16   ? launch_bits<16>(p, a, w, o, M, N, Kw, a_bits, w_bits,
                                     vec, st)
      : p.bm == 32 ? launch_bits<32>(p, a, w, o, M, N, Kw, a_bits, w_bits,
                                     vec, st)
                   : launch<64, 1, 1>(p, a, w, o, M, N, Kw, a_bits, w_bits,
                                      vec, st);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}
