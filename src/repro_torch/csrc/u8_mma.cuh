// Integer tensor-core building blocks shared by fused_qgemm.cu,
// conv_implicit.cu, int8_matmul.cu and bitgemm.cu: cp.async, ldmatrix,
// mma.sync m16n8k32 on u8 and s8 operands, the register transpose that
// feeds the mma's K-contiguous B operand from a (K, N) tile staged 64
// bytes (64 columns) a K row, and the int32 split-K combine over a
// thread-block cluster.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace u8mma {

constexpr int W_ROW = 64;  // bytes of a staged weight row (64 columns)

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill ? 16 : 0;  // 0: zero-fill the destination
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void mma_u8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row r in an A stage (BK bytes a row):
// the 8 rows an ldmatrix phase reads land in 8 distinct bank groups.
template <int BK>
__device__ __forceinline__ int a_off(int r, int c) {
  constexpr int CPR = BK / 16;  // 4 or 8 chunks a row
  return r * BK + ((c ^ ((r / (8 / CPR)) & (CPR - 1))) << 4);
}

// Byte offset of 16-byte chunk c of K row k in a weight stage (4 chunks a
// row): the rows {0,1,4,5,8,9,12,13} (+2) a transposing phase reads land
// in 8 distinct bank groups.
__device__ __forceinline__ int w_off(int k, int c) {
  return k * W_ROW + ((c ^ ((k >> 2) & 3)) << 4);
}

// The K row lane `lane` addresses for ldmatrix.x4.trans in a k32 step:
// matrices 0-1 cover k 0-15, 2-3 k 16-31; matrix parity picks the pair
// (0,1) or (2,3) of each k quad, so a lane (g, tg) gets k 4tg..4tg+3.
__device__ __forceinline__ int b_krow(int lane) {
  const int j = lane >> 3, i = lane & 7;
  return (j >> 1) * 16 + 4 * (i >> 1) + 2 * (j & 1) + (i & 1);
}

// B fragments of one k32 x 16-column chunk: `ev` for the mma tile of the
// chunk's even columns (logical column g = physical 2g), `od` for the odd.
// ldmatrix.trans gives a lane 2x2 byte blocks (a k pair x a column pair);
// two __byte_perm per register pair regroup them into k quads.
__device__ __forceinline__ void b_frags(const uint8_t* ws, int krow,
                                        int chunk, unsigned (&ev)[2],
                                        unsigned (&od)[2]) {
  unsigned r[4];
  ldsm_x4_trans(r, ws + w_off(krow, chunk));
  ev[0] = __byte_perm(r[0], r[1], 0x6420);
  ev[1] = __byte_perm(r[2], r[3], 0x6420);
  od[0] = __byte_perm(r[0], r[1], 0x7531);
  od[1] = __byte_perm(r[2], r[3], 0x7531);
}

// The shared epilogue, s * f32(acc) - corr with corr = t * f32(rowsum),
// rounded step by step (no FMA contraction), as the plain version.
__device__ __forceinline__ float dequant(float s, int acc, float corr) {
  return __fsub_rn(__fmul_rn(s, __int2float_rn(acc)), corr);
}

// Four consecutive outputs of one row (N columns) from column col on: a
// lane's share of the even and odd mma tiles of a 16-column chunk.
__device__ __forceinline__ void store4(float* row, int col, int N,
                                       const float (&v)[4]) {
  if ((N & 3) == 0 && col + 3 < N) {
    *reinterpret_cast<float4*>(row + col) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q < N) row[col + q] = v[q];
  }
}

__device__ __forceinline__ void store4(int* row, int col, int N,
                                       const int (&v)[4]) {
  if ((N & 3) == 0 && col + 3 < N) {
    *reinterpret_cast<int4*>(row + col) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q < N) row[col + q] = v[q];
  }
}

constexpr int SMS = 132;           // H100 SXM
constexpr int BLOCKS_PER_SM = 4;   // split-K at 16-row tiles fills to this
constexpr int MAX_SPLIT = 8;       // portable thread-block cluster size

// K steps a split for a launch of `tiles` output tiles over `nsteps` K
// steps, the split-K rule of every kernel here: 16-row (`skinny`) tiles
// split until the grid holds about BLOCKS_PER_SM blocks on each SM, at
// least two steps a split; larger tiles, where `split_wide`, only while
// they do not fill the SMs once, at least four steps a split; at most
// MAX_SPLIT splits.  The splits are ceil(nsteps / steps).  Mirrored on
// the CPU by kernels/_lib.py split_steps.
inline int split_steps(int tiles, int nsteps, bool skinny,
                       bool split_wide = true) {
  int split = skinny ? (SMS * BLOCKS_PER_SM + tiles - 1) / tiles
              : (split_wide && tiles < SMS) ? (SMS + tiles - 1) / tiles
                                            : 1;
  const int cap = nsteps / (skinny ? 2 : 4);
  split = split < MAX_SPLIT ? split : MAX_SPLIT;
  split = split < cap ? split : cap;
  split = split > 1 ? split : 1;
  return (nsteps + split - 1) / split;
}

constexpr int RED_PITCH = W_ROW + 4;  // int32 pitch of a split's partial

// Split-K over a thread-block cluster along z (one cluster a tile, one
// block a K split): each block has written its (BM, 64) int32 partial
// tile to `red` in its own shared memory (pitch RED_PITCH); block r sums
// rows r, r + S, ... of all S partials through distributed shared memory
// and stores them.  One launch, no workspace, deterministic.
template <int BM, int THREADS>
__device__ __forceinline__ void cluster_sum_store(int* red, int* out, int m0,
                                                  int n0, int M, int N) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int nsplit = static_cast<int>(gridDim.z);
  const int rank = static_cast<int>(cluster.block_rank());
  const int mine = (BM - rank + nsplit - 1) / nsplit;
  for (int e = threadIdx.x; e < mine * (W_ROW / 4); e += THREADS) {
    const int lr = rank + (e / (W_ROW / 4)) * nsplit;
    const int lc = (e % (W_ROW / 4)) * 4;
    int sum[4] = {0, 0, 0, 0};
    for (int q = 0; q < nsplit; ++q) {
      const int* rem = cluster.map_shared_rank(red, q);
      const int4 v = *reinterpret_cast<const int4*>(rem + lr * RED_PITCH + lc);
      sum[0] += v.x;
      sum[1] += v.y;
      sum[2] += v.z;
      sum[3] += v.w;
    }
    if (m0 + lr < M) store4(out + static_cast<size_t>(m0 + lr) * N, n0 + lc,
                            N, sum);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

}  // namespace u8mma
