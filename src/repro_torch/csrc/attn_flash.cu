// Quantized flash attention (contiguous prefill), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/attn_flash.py, attn_flash_pallas
// (_flash_kernel).
//
//   out[b,i,h,:] = sum_j softmax_j(scale * (qc[b,i,h,:] . kc[b,j,h,:]))
//                  * v[b,j,h,:]
//
// over the keys j that the causal and window masks leave to row i.
// qc, kc are centred int8 levels (lv - 2^(bits-1), in [-128, 127]): their
// dot product is the reference's rowsum-corrected integer, so no
// correction pass is needed.  v and out are float32 or bfloat16 (one type
// for both), all in the reference's (B, S, H, hd) layout with KV already
// expanded for GQA.  `scale` (s_q * s_k / sqrt(hd)) is read from device
// memory, so the host never waits on it.
//
// What bounds it on an H100: operations.  At the main path's prefill
// (B=2, S=2048, H=15, hd=64, causal) the score dots are ~2.1e6 per head
// and batch row, 2 * hd int8 operations each (~8 G in all), and P@V the
// same count of f32 multiply-adds, which run on the CUDA cores (67 TFLOP/s
// non-tensor fp32) while the int8 dots could run on tensor cores; the
// inputs are only ~12 MB (about 4 us at 3.35 TB/s).
//
// Design: the TPU kernel carried (m, l, acc) in VMEM scratch across a
// sequential kv grid axis; Hopper blocks run in no order, so each block
// owns TQ query rows of one (batch, head), one row per thread, and loops
// over the kv tiles itself (only up to the causal diagonal, and only from
// the window's trailing edge), with the row's levels, (m, l) and its hd
// accumulators in registers.  K and V tiles are staged in shared memory
// (V converted to f32 once per tile); every thread reads the same key row,
// so the reads broadcast.  Scores are signed __dp4a over four levels at a
// time, exact in int32, scaled in f32 (__fmul_rn, no contraction), then
// masked; the online softmax updates every KC keys.  A masked key's weight
// is 0 (the reference multiplies by the mask).  The epilogue divides by
// max(l, 1e-30) with IEEE division.  No -use_fast_math: expf is the
// accurate one.  Later work: mma.sync / wgmma on the int8 dots and on P@V,
// several rows per warp, cp.async or TMA staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;   // query rows per block, one per thread
constexpr int TK = 64;   // keys per staged tile
constexpr int KC = 16;   // keys per online-softmax update
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD, typename T>
__global__ void __launch_bounds__(TQ)
attn_flash_kernel(const int8_t* __restrict__ qc, const int8_t* __restrict__ kc,
                  const T* __restrict__ v, T* __restrict__ out,
                  const float* __restrict__ scale_ptr, int Sq, int Skv, int H,
                  int causal, int window) {
  __shared__ __align__(16) int8_t Ks[TK * HD];
  __shared__ __align__(16) float Vs[TK * HD];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * TQ;
  const int tid = threadIdx.x;
  const int iq = q0 + tid;
  const bool row_ok = iq < Sq;
  const float scale = *scale_ptr;

  int qw[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) qw[i] = 0;
  if (row_ok) {
    const int4* src = reinterpret_cast<const int4*>(
        qc + (((size_t)b * Sq + iq) * H + h) * HD);
#pragma unroll
    for (int i = 0; i < HD / 16; ++i) {
      const int4 t = src[i];
      qw[4 * i] = t.x; qw[4 * i + 1] = t.y;
      qw[4 * i + 2] = t.z; qw[4 * i + 3] = t.w;
    }
  }

  // keys any row of this block can see
  int kv_hi = Skv - 1;
  if (causal) kv_hi = min(kv_hi, q0 + TQ - 1);
  const int kv_lo = window > 0 ? max(0, q0 - (window - 1)) : 0;

  float m = NEG_INF, l = 0.f;
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  for (int k0 = kv_lo; k0 <= kv_hi; k0 += TK) {
    const int nk = min(TK, kv_hi + 1 - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < nk * (HD / 16); idx += TQ) {
      const int r = idx / (HD / 16), c = idx % (HD / 16);
      reinterpret_cast<int4*>(Ks + r * HD)[c] = reinterpret_cast<const int4*>(
          kc + (((size_t)b * Skv + k0 + r) * H + h) * HD)[c];
    }
    for (int idx = tid; idx < nk * HD; idx += TQ) {
      const int r = idx / HD, d = idx % HD;
      Vs[r * HD + d] = to_f32(v[(((size_t)b * Skv + k0 + r) * H + h) * HD + d]);
    }
    __syncthreads();
    if (!row_ok) continue;

    for (int c0 = 0; c0 < nk; c0 += KC) {
      float s[KC];
      unsigned ok_bits = 0u;
      float cmax = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int j = c0 + jj, jk = k0 + j;
        bool ok = j < nk;
        if (causal) ok = ok && jk <= iq;
        if (window > 0) ok = ok && jk > iq - window;
        float sv = NEG_INF;
        if (ok) {
          const int4* kr = reinterpret_cast<const int4*>(Ks + j * HD);
          int dot = 0;
#pragma unroll
          for (int w = 0; w < HD / 16; ++w) {
            const int4 kw = kr[w];
            dot = __dp4a(qw[4 * w], kw.x, dot);
            dot = __dp4a(qw[4 * w + 1], kw.y, dot);
            dot = __dp4a(qw[4 * w + 2], kw.z, dot);
            dot = __dp4a(qw[4 * w + 3], kw.w, dot);
          }
          sv = __fmul_rn(__int2float_rn(dot), scale);
          ok_bits |= 1u << jj;
        }
        s[jj] = sv;
        cmax = fmaxf(cmax, sv);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        if (!(ok_bits & (1u << jj))) continue;
        const float p = expf(s[jj] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(Vs + (c0 + jj) * HD);
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 vv = vr[d4];
          acc[4 * d4] += p * vv.x;
          acc[4 * d4 + 1] += p * vv.y;
          acc[4 * d4 + 2] += p * vv.z;
          acc[4 * d4 + 3] += p * vv.w;
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    T* o = out + (((size_t)b * Sq + iq) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) store(o + d, __fdiv_rn(acc[d], denom));
  }
}

template <int HD>
int launch_hd(const void* qc, const void* kc, const void* v, void* out,
              const void* scale, int B, int Sq, int Skv, int H, int causal,
              int window, int dtype, cudaStream_t st) {
  dim3 grid(B * H, (Sq + TQ - 1) / TQ);
  const int8_t* q = static_cast<const int8_t*>(qc);
  const int8_t* k = static_cast<const int8_t*>(kc);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    attn_flash_kernel<HD, float><<<grid, TQ, 0, st>>>(
        q, k, static_cast<const float*>(v), static_cast<float*>(out), sc, Sq,
        Skv, H, causal, window);
  else if (dtype == 1)
    attn_flash_kernel<HD, __nv_bfloat16><<<grid, TQ, 0, st>>>(
        q, k, static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), sc, Sq, Skv, H, causal, window);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// dtype: 0 float32, 1 bfloat16 (v and out).  window <= 0: no window.
extern "C" int attn_flash_launch(const void* qc, const void* kc,
                                 const void* v, void* out, const void* scale,
                                 int B, int Sq, int Skv, int H, int hd,
                                 int causal, int window, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_hd<32>(qc, kc, v, out, scale, B, Sq, Skv, H, causal,
                           window, dtype, st);
    case 64:
      return launch_hd<64>(qc, kc, v, out, scale, B, Sq, Skv, H, causal,
                           window, dtype, st);
    case 128:
      return launch_hd<128>(qc, kc, v, out, scale, B, Sq, Skv, H, causal,
                            window, dtype, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
