// Fused DoReFa quantize + bit-plane pack, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/quantpack.py, quantize_pack_pallas (_kernel).
//
//   levels[m, k]        = clip(rintf(clip(a[m,k], 0, 1) * (2^bits - 1)), 0, 2^bits - 1)
//   planes[b, m, k/32]  bit (k % 32) = bit b of levels[m, k]
//
// a is (M, K) float32 and levels (M, K) unsigned 8-bit; or, in the
// levels-in form, a is already (M, K) unsigned 8-bit levels and only the
// planes are written (the faithful engine packs its activation levels
// this way).  planes is (bits, M, ceil(K/32)) 32-bit words, LSB first
// along K, the layout of the reference's pack_bits; the tail of the last
// word of a row is zero.
//
// What bounds it on an H100: bytes.  It reads every input element once
// and writes 1 byte of level plus bits/8 bytes of planes per element;
// there is no arithmetic to speak of.  At svhn conv2's patches at batch 8
// (M=12800, K=576) the float-in form reads 29.5 MB and writes 7.4 MB of
// levels, about 11 us at 3.35 TB/s; the levels-in form reads the 7.4 MB.
//
// Design: the TPU kernel packed a 256x512 VMEM tile with a multiply-and-
// sum over the 32 lanes of each word.  Here one warp owns one word: lane j
// quantizes (or reads) element 32*w + j, so a warp reads 128 contiguous
// bytes of float input, and __ballot_sync over bit b of the lanes' levels
// is the packed word of plane b directly (lane j sets bit j, LSB first).
// Lane b stores plane b's word.  rintf rounds half to even, as jnp.round
// and torch.round do; __fmul_rn keeps the product from fusing.  Later
// work: several words per warp and 16-byte stores of the planes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 8 warps: 8 packed words per block
constexpr int WARPS = THREADS / 32;

template <bool A_LEVELS>
__global__ void __launch_bounds__(THREADS)
quantize_pack_kernel(const void* __restrict__ a_ptr,
                     uint8_t* __restrict__ levels,
                     uint32_t* __restrict__ planes, int M, int K, int Kw,
                     int bits, float n_levels) {
  const int lane = threadIdx.x & 31;
  const long long word =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  // word is the same for the 32 lanes of a warp: a warp leaves whole,
  // before any __ballot_sync
  if (word >= (long long)M * Kw) return;
  const int m = static_cast<int>(word / Kw);
  const int kw = static_cast<int>(word % Kw);
  const int k = kw * 32 + lane;
  unsigned lv = 0u;
  if (k < K) {
    const size_t idx = (size_t)m * K + k;
    if (A_LEVELS) {
      lv = static_cast<const uint8_t*>(a_ptr)[idx];
    } else {
      const float v = static_cast<const float*>(a_ptr)[idx];
      const float x = fminf(fmaxf(v, 0.0f), 1.0f);
      float r = rintf(__fmul_rn(x, n_levels));
      r = fminf(fmaxf(r, 0.0f), n_levels);
      lv = __float2uint_rn(r);
      levels[idx] = static_cast<uint8_t>(lv);
    }
  }
  unsigned mine = 0u;
  for (int b = 0; b < bits; ++b) {
    const unsigned w = __ballot_sync(0xffffffffu, (lv >> b) & 1u);
    if (lane == b) mine = w;
  }
  if (lane < bits) planes[((size_t)lane * M + m) * Kw + kw] = mine;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// `levels` is written only when a_is_levels is 0.
extern "C" int quantize_pack_launch(const void* a, void* levels,
                                    void* planes, int M, int K,
                                    int a_is_levels, int bits,
                                    void* stream) {
  const int Kw = (K + 31) / 32;
  const long long words = (long long)M * Kw;
  const unsigned blocks = static_cast<unsigned>((words + WARPS - 1) / WARPS);
  const float n_levels = static_cast<float>((1 << bits) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_is_levels)
    quantize_pack_kernel<true><<<blocks, THREADS, 0, st>>>(
        a, nullptr, static_cast<uint32_t*>(planes), M, K, Kw, bits,
        n_levels);
  else
    quantize_pack_kernel<false><<<blocks, THREADS, 0, st>>>(
        a, static_cast<uint8_t*>(levels), static_cast<uint32_t*>(planes), M,
        K, Kw, bits, n_levels);
  return static_cast<int>(cudaGetLastError());
}
