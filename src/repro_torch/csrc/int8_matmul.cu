// Tiled signed 8-bit matmul with a 32-bit accumulator, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bitgemm_mxu.py, int8_matmul_pallas (_kernel).
//
//   out[m, n] = sum_k A[m, k] * B[k, n]      (s8 x s8 -> s32)
//
// A is (M, K) and B (K, N), row-major signed 8-bit; out is (M, N) int32,
// exact while 128 * 128 * K < 2^31 (the wrapper checks it).  Any M, K and
// N: the kernel masks the ragged edges itself.  The serve path calls it
// with the levels of the int8 engine (nibble groups of at most 7 bits,
// ops.bitgemm_mxu) and with single bit planes (int8_planewise).
//
// What bounds it on an H100: bytes at the serve path's shapes.  The
// level GEMM of svhn conv6 at batch 8 (M=800, K=256, N=512) is 0.2 G
// int8 operations, ~0.1 us on the tensor cores, against 0.2 MB of
// operands and a 1.6 MB int32 output (~0.6 us); AlexNet fc5 (M=8,
// K=9216, N=4096) reads 37.7 MB of B, ~11 us.  This first kernel runs on
// the CUDA cores' __dp4a and stays far from both.
//
// Design: the TPU kernel carried the int32 output block over a sequential
// K grid axis on the MXU.  Here each block owns a 64x64 output tile and
// loops over K itself, 64 bytes at a time staged in shared memory with a
// 68-byte row pitch (17 words: conflict-free column reads); B is stored
// transposed, so four consecutive K values of one column form one word,
// and the signed __dp4a folds four K steps into each of a thread's 16
// accumulators.  It is csrc/fused_qgemm.cu's tiling on signed operands,
// without the quantize, rowsum and epilogue.  Later work: mma.sync or
// wgmma on s8 operands, cp.async or TMA pipelining, split-K for skinny M.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;       // rows per block
constexpr int TN = 64;       // columns per block
constexpr int KC = 64;       // K bytes per staged chunk
constexpr int KP = KC + 4;   // shared row pitch in bytes (17 words)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                   int* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[TM * KP];
  __shared__ __align__(16) int8_t Bs[TN * KP];

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

  // 16-byte vector loads only where every row start is 16-byte aligned
  const bool k_vec = (K % 16) == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool n_vec = (N % 16) == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    // A chunk: thread loads 16 bytes of one row
    {
      const int r = tid >> 2, c = (tid & 3) * 16;
      const int gm = m0 + r, gk = k0 + c;
      int8_t* dst = As + r * KP + c;
      if (k_vec && gm < M && gk + 16 <= K) {
        uint4 v = *reinterpret_cast<const uint4*>(a + (size_t)gm * K + gk);
        uint32_t* d = reinterpret_cast<uint32_t*>(dst);
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q)
          dst[q] = (gm < M && gk + q < K) ? a[(size_t)gm * K + gk + q] : 0;
      }
    }
    // B chunk, transposed: Bs[n][k]
    {
      const int kk = tid >> 2, nn = (tid & 3) * 16;
      const int gk = k0 + kk, gn = n0 + nn;
      if (n_vec && gk < K && gn + 16 <= N) {
        uint4 v = *reinterpret_cast<const uint4*>(b + (size_t)gk * N + gn);
        const int8_t* s = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int q = 0; q < 16; ++q) Bs[(nn + q) * KP + kk] = s[q];
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q)
          Bs[(nn + q) * KP + kk] =
              (gk < K && gn + q < N) ? b[(size_t)gk * N + gn + q] : 0;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < KC / 4; ++j) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const int*>(As + (ty * 4 + i) * KP + 4 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bv[i] = *reinterpret_cast<const int*>(Bs + (tx + 16 * i) * KP + 4 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = __dp4a(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + tx + 16 * jj;
      if (col < N) out[(size_t)row * N + col] = acc[i][jj];
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int int8_matmul_launch(const void* a, const void* b, void* out,
                                  int M, int N, int K, void* stream) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  int8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
