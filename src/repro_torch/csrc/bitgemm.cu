// Packed AND + popcount bit-GEMM (the paper's Eq. 1), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bitgemm.py, bitgemm_packed_pallas (_kernel).
//
//   out[m, n] = sum_p sum_q 2^(p+q) sum_w popc(A[p, m, w] & W[q, n, w])
//
// A is (a_bits, M, Kw) and W (w_bits, N, Kw) bit planes packed 32 per
// 32-bit word along K (W pre-transposed, as the reference's kernel takes
// it); out is the (M, N) int32 level-GEMM accumulator, exact while
// (2^a - 1)(2^w - 1) K < 2^31 (the wrapper checks it).
//
// What bounds it on an H100: the CUDA cores' popcount issue rate, not
// bytes.  Each (m, n, word, plane pair) costs one AND, one POPC and one
// add; POPC issues at 16 per SM per clock on sm_90, so at svhn conv2 at
// batch 8 and W1A4 (M=12800, N=128, Kw=18, 4 plane pairs) the 118 M
// popcounts take at least ~28 us at 1.98 GHz, while the operands are
// 4.6 MB (~1.4 us at 3.35 TB/s).  The int8 tensor cores would do the same
// level GEMM in under a microsecond: the literal Eq. 1 dataflow is the
// paper's, not Hopper's, fastest form.
//
// Design: the TPU kernel built a (TM, TN, TKw) AND intermediate in VMEM
// per plane pair and carried the output tile over a sequential K grid
// axis.  Here each block owns a 64x64 output tile and loops over K
// itself, KT=8 words at a time: the word tiles of every plane of both
// operands are staged in shared memory (row pitch 9 words, so the column
// reads of one warp hit distinct banks), and each thread keeps its 4x4
// outputs in registers.  Per staged tile and plane pair a thread sums
// __popc(a & w) over the 8 words into a partial and adds it shifted by
// p+q — the reference's "<< (m+n)".  Later work: the binary tensor-core
// mma (.b1 with .and.popc) and TMA staging, and split-K for skinny M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // rows per block
constexpr int TN = 64;        // columns per block
constexpr int KT = 8;         // words of K per staged tile
constexpr int KP = KT + 1;    // shared row pitch in words
constexpr int MAX_BITS = 8;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bitgemm_packed_kernel(const uint32_t* __restrict__ a,
                      const uint32_t* __restrict__ w, int* __restrict__ out,
                      int M, int N, int Kw, int a_bits, int w_bits) {
  __shared__ uint32_t As[MAX_BITS * TM * KP];
  __shared__ uint32_t Ws[MAX_BITS * TN * KP];

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // columns tx + 16*j
  const int ty = tid / 16;          // rows ty*4 + i
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < Kw; k0 += KT) {
    for (int idx = tid; idx < a_bits * TM * KT; idx += THREADS) {
      const int p = idx / (TM * KT), r = (idx / KT) % TM, c = idx % KT;
      const int gm = m0 + r, gk = k0 + c;
      As[(p * TM + r) * KP + c] =
          (gm < M && gk < Kw) ? a[((size_t)p * M + gm) * Kw + gk] : 0u;
    }
    for (int idx = tid; idx < w_bits * TN * KT; idx += THREADS) {
      const int q = idx / (TN * KT), r = (idx / KT) % TN, c = idx % KT;
      const int gn = n0 + r, gk = k0 + c;
      Ws[(q * TN + r) * KP + c] =
          (gn < N && gk < Kw) ? w[((size_t)q * N + gn) * Kw + gk] : 0u;
    }
    __syncthreads();

    for (int p = 0; p < a_bits; ++p) {
      for (int q = 0; q < w_bits; ++q) {
        int part[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = 0;
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          uint32_t av[4], wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            av[i] = As[(p * TM + ty * 4 + i) * KP + c];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = Ws[(q * TN + tx + 16 * j) * KP + c];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) part[i][j] += __popc(av[i] & wv[j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j] << (p + q);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[(size_t)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int bitgemm_packed_launch(const void* a_planes,
                                     const void* w_planes, void* out, int M,
                                     int N, int Kw, int a_bits, int w_bits,
                                     void* stream) {
  if (a_bits < 1 || a_bits > MAX_BITS || w_bits < 1 || w_bits > MAX_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  bitgemm_packed_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a_planes),
      static_cast<const uint32_t*>(w_planes), static_cast<int*>(out), M, N,
      Kw, a_bits, w_bits);
  return static_cast<int>(cudaGetLastError());
}
