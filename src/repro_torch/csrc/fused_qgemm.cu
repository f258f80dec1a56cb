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
// path calls it at small M (svhn conv6 at batch 8: M=800, K=256, N=512;
// AlexNet fc5/fc6: M=8, K=9216 and 4096, N=4096).  fc5 reads 37.7 MB of
// weight levels, about 11 us at 3.35 TB/s, against under a microsecond of
// int8 tensor-core work; conv6's largest stream is its 1.6 MB float32
// output.  fc5 and fc6 run as only 64 blocks (one row tile) with no load
// pipelining, so this first kernel streams far below that rate.
//
// Design: the TPU kernel carried the accumulator and the rowsum in VMEM
// scratch across a sequential K grid axis; Hopper blocks run in no order,
// so here each block owns a 64x64 output tile and loops over K itself,
// with the 16 accumulators of each thread in registers.  Operands stay
// u8 (no nibble split: the MXU needed s8 operands, __dp4a's unsigned form
// takes u8 directly) and each __dp4a folds four K steps of all bit-plane
// pairs at once.  K chunks of 64 bytes are staged in shared memory with a
// 68-byte row pitch (17 words: conflict-free column reads); W is stored
// transposed so four consecutive K values of one column form one word.
// The rowsum of the block's rows is summed from the same staged chunk.
// The epilogue uses __fmul_rn/__fsub_rn so no FMA contraction changes
// its rounding: the result equals the plain PyTorch version bit for bit.
// Later work: mma.sync / wgmma on u8 operands, cp.async or TMA pipelining,
// split-K for the skinny-M FC layers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;       // rows per block
constexpr int TN = 64;       // columns per block
constexpr int KC = 64;       // K bytes per staged chunk
constexpr int KP = KC + 4;   // shared row pitch in bytes (17 words)
constexpr int THREADS = 256;

__device__ __forceinline__ uint8_t quantize_level(float v, float n) {
  float x = fminf(fmaxf(v, 0.0f), 1.0f);
  float r = rintf(__fmul_rn(x, n));
  r = fminf(fmaxf(r, 0.0f), n);
  return static_cast<uint8_t>(__float2uint_rn(r));
}

template <bool A_LEVELS>
__global__ void __launch_bounds__(THREADS)
fused_qgemm_kernel(const void* __restrict__ a_ptr,
                   const uint8_t* __restrict__ w,
                   float* __restrict__ out, int M, int N, int K,
                   float n_levels, float s, float t) {
  __shared__ __align__(16) uint8_t As[TM * KP];
  __shared__ __align__(16) uint8_t Bs[TN * KP];
  __shared__ unsigned rs_s[TM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // columns tx + 16*j
  const int ty = tid / 16;          // rows ty*4 + i
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;

  unsigned acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0u;
  unsigned rs = 0u;  // rowsum of row m0 + tid (threads tid < TM)

  // 16-byte vector loads only where every row start is 16-byte aligned
  const bool k_vec =
      (K % 16) == 0 && (reinterpret_cast<uintptr_t>(a_ptr) & 15) == 0;
  const bool n_vec =
      (N % 16) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  for (int k0 = 0; k0 < K; k0 += KC) {
    // A chunk: thread loads 16 bytes of one row
    {
      const int r = tid >> 2, c = (tid & 3) * 16;
      const int gm = m0 + r, gk = k0 + c;
      uint8_t* dst = As + r * KP + c;
      if (A_LEVELS) {
        const uint8_t* a = static_cast<const uint8_t*>(a_ptr);
        if (k_vec && gm < M && gk + 16 <= K) {
          uint4 v = *reinterpret_cast<const uint4*>(a + (size_t)gm * K + gk);
          uint32_t* d = reinterpret_cast<uint32_t*>(dst);
          d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 16; ++q)
            dst[q] = (gm < M && gk + q < K) ? a[(size_t)gm * K + gk + q] : 0;
        }
      } else {
        const float* a = static_cast<const float*>(a_ptr);
#pragma unroll
        for (int q = 0; q < 16; ++q)
          dst[q] = (gm < M && gk + q < K)
                       ? quantize_level(a[(size_t)gm * K + gk + q], n_levels)
                       : 0;
      }
    }
    // W chunk, transposed: Bs[n][k]
    {
      const int kk = tid >> 2, nn = (tid & 3) * 16;
      const int gk = k0 + kk, gn = n0 + nn;
      if (n_vec && gk < K && gn + 16 <= N) {
        uint4 v = *reinterpret_cast<const uint4*>(w + (size_t)gk * N + gn);
        const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
        for (int q = 0; q < 16; ++q) Bs[(nn + q) * KP + kk] = b[q];
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q)
          Bs[(nn + q) * KP + kk] =
              (gk < K && gn + q < N) ? w[(size_t)gk * N + gn + q] : 0;
      }
    }
    __syncthreads();

    if (tid < TM) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(As + tid * KP);
#pragma unroll
      for (int j = 0; j < KC / 4; ++j) rs = __dp4a(row[j], 0x01010101u, rs);
    }
#pragma unroll 4
    for (int j = 0; j < KC / 4; ++j) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const uint32_t*>(As + (ty * 4 + i) * KP + 4 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        bv[i] = *reinterpret_cast<const uint32_t*>(Bs + (tx + 16 * i) * KP + 4 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = __dp4a(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

  if (tid < TM) rs_s[tid] = rs;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
    const float corr = __fmul_rn(t, __uint2float_rn(rs_s[ty * 4 + i]));
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + tx + 16 * jj;
      if (col < N)
        out[(size_t)row * N + col] =
            __fsub_rn(__fmul_rn(s, __uint2float_rn(acc[i][jj])), corr);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fused_qgemm_launch(const void* a, const void* w, void* out,
                                  int M, int N, int K, int a_is_levels,
                                  int a_bits, float s, float t,
                                  void* stream) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  const float n_levels = static_cast<float>((1 << a_bits) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_is_levels)
    fused_qgemm_kernel<true><<<grid, THREADS, 0, st>>>(
        a, static_cast<const uint8_t*>(w), static_cast<float*>(out), M, N, K,
        n_levels, s, t);
  else
    fused_qgemm_kernel<false><<<grid, THREADS, 0, st>>>(
        a, static_cast<const uint8_t*>(w), static_cast<float*>(out), M, N, K,
        n_levels, s, t);
  return static_cast<int>(cudaGetLastError());
}
