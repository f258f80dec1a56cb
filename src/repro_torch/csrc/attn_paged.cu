// Quantized paged attention (continuous-batching decode steps and prefill
// chunks), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/attn_flash.py, attn_paged_pallas
// (_paged_kernel).  Oracle: attn_paged_xla (its port attn_paged_plain).
//
// For slot b, query row (s, head j) and every key slot of the pages its
// table row names:
//
//   logit = scal[b] * (qc[b,s,j,:] . kc[page,t,kvh(j),:])   (masked by ppos)
//   out[b,s,j,:] = sum softmax(logit) * v[page,t,kvh(j),:]
//
// qc: centred int8 q levels (per-slot s_q, computed before the launch);
// pool_k / pool_v: (NP+1, ps, Hkv, hd) float32 or bfloat16; ppos:
// (NP+1, ps) int32, -1 = never written; table: (B, P) int32; q_pos: (B, S)
// int32, -1 = padding row; s_k, scal: (B,) float32 device arrays (per-slot
// K scale and s_q * s_k / sqrt(hd)).  kvh(j) = min(j / g, Hkv - 1),
// g = max(n_q / Hkv, 1).
//
// What bounds it on an H100: bytes.  A decode step reads each slot's K and
// V pages once (at the chip smoke's 8 slots x 18 pages x 16 x 5 x 64 bf16,
// ~2.9 MB for K and V, ~1 us at 3.35 TB/s) against ~1.5 M multiply-adds;
// but at these sizes the launch itself and the per-page block barriers
// dominate.
//
// Design: the TPU kernel was a (slot, page) grid with the page selected
// through a scalar-prefetched table and (m, l, acc) carried in VMEM across
// the page axis.  Here one block serves one (slot, KV head): it walks the
// slot's table row itself, reading table[b, p], so the g query heads of a
// GQA group read each K/V page once.  K is quantized on load with the
// slot's s_k (IEEE division __fdiv_rn and rintf, round half to even, as
// the reference's jnp.round): per slot the levels equal the reference's
// pool-wide levels pass, since each live page has one owner and the null
// page stays masked.  Per page: stage K levels, V (as f32) and positions
// in shared memory; all (row, key) scores by signed __dp4a; per row the
// online-softmax update of (m, l); then every (row, d) accumulator.  The
// weights are not multiplied by the mask: a masked key's weight
// exp(NEG_INF - m) is 0 once its row has a valid key, and a row with none
// (q_pos = -1) averages V over all gathered slots, which is what
// attn_paged_xla's softmax gives such a row (the Pallas body gives 0).
// Later work: several slots per block at decode, tensor-core dots, a
// split over pages for long tables.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
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
__global__ void __launch_bounds__(THREADS)
attn_paged_kernel(const int8_t* __restrict__ qc, const T* __restrict__ pool_k,
                  const T* __restrict__ pool_v, const int* __restrict__ ppos,
                  const int* __restrict__ table,
                  const int* __restrict__ q_pos,
                  const float* __restrict__ s_k_arr,
                  const float* __restrict__ scal_arr, T* __restrict__ out,
                  int S, int Hp, int Hkv, int ps, int P, int n_q, int causal,
                  int window, int bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = max(n_q / Hkv, 1);
  const int h_lo = kvh * g;
  const int h_hi = (kvh == Hkv - 1) ? Hp : min(Hp, (kvh + 1) * g);
  const int nh = h_hi - h_lo;
  if (nh <= 0) return;  // uniform over the block
  const int R = nh * S;  // rows: r = hh * S + s, query head h_lo + hh

  // layout: must match paged_smem_bytes() in kernels/attn_flash.py
  int8_t* qs = reinterpret_cast<int8_t*>(smem);      // R x HD
  int8_t* ks = qs + R * HD;                          // ps x HD
  float* vs = reinterpret_cast<float*>(ks + ps * HD);  // ps x HD
  int* pp = reinterpret_cast<int*>(vs + ps * HD);    // ps
  float* sc = reinterpret_cast<float*>(pp + ps);     // R x ps
  float* acc = sc + R * ps;                          // R x HD
  float* mrow = acc + R * HD;                        // R
  float* lrow = mrow + R;                            // R
  float* crow = lrow + R;                            // R

  const int tid = threadIdx.x;
  const float sk = s_k_arr[b];
  const float scale = scal_arr[b];
  const int zi = 1 << (bits - 1);
  const float zf = static_cast<float>(zi);
  const float nf = static_cast<float>((1 << bits) - 1);

  for (int idx = tid; idx < R * (HD / 16); idx += THREADS) {
    const int r = idx / (HD / 16), c = idx % (HD / 16);
    const int hh = r / S, s = r % S;
    reinterpret_cast<int4*>(qs + r * HD)[c] = reinterpret_cast<const int4*>(
        qc + (((size_t)b * S + s) * Hp + h_lo + hh) * HD)[c];
  }
  for (int idx = tid; idx < R * HD; idx += THREADS) acc[idx] = 0.f;
  for (int r = tid; r < R; r += THREADS) {
    mrow[r] = NEG_INF;
    lrow[r] = 0.f;
  }

  for (int p = 0; p < P; ++p) {
    const size_t page = static_cast<size_t>(table[b * P + p]);
    __syncthreads();  // previous page fully consumed
    for (int t = tid; t < ps; t += THREADS) pp[t] = ppos[page * ps + t];
    for (int idx = tid; idx < ps * HD; idx += THREADS) {
      const int t = idx / HD, d = idx % HD;
      const size_t gi = ((page * ps + t) * Hkv + kvh) * HD + d;
      float lv = rintf(__fdiv_rn(to_f32(pool_k[gi]), sk)) + zf;
      lv = fminf(fmaxf(lv, 0.f), nf);
      ks[idx] = static_cast<int8_t>(static_cast<int>(lv) - zi);
      vs[idx] = to_f32(pool_v[gi]);
    }
    __syncthreads();
    for (int idx = tid; idx < R * ps; idx += THREADS) {
      const int r = idx / ps, t = idx % ps;
      const int iq = q_pos[b * S + r % S];
      const int pos = pp[t];
      bool ok = pos >= 0;
      if (causal) ok = ok && pos <= iq;
      if (window > 0) ok = ok && pos > iq - window;
      float val = NEG_INF;
      if (ok) {
        const int4* qr = reinterpret_cast<const int4*>(qs + r * HD);
        const int4* kr = reinterpret_cast<const int4*>(ks + t * HD);
        int dot = 0;
#pragma unroll
        for (int w = 0; w < HD / 16; ++w) {
          const int4 a = qr[w], k = kr[w];
          dot = __dp4a(a.x, k.x, dot);
          dot = __dp4a(a.y, k.y, dot);
          dot = __dp4a(a.z, k.z, dot);
          dot = __dp4a(a.w, k.w, dot);
        }
        val = __fmul_rn(__int2float_rn(dot), scale);
      }
      sc[idx] = val;
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      float mx = NEG_INF;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[r * ps + t]);
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      float psum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float w = expf(sc[r * ps + t] - m_new);
        sc[r * ps + t] = w;
        psum += w;
      }
      lrow[r] = lrow[r] * corr + psum;
      mrow[r] = m_new;
      crow[r] = corr;
    }
    __syncthreads();
    for (int idx = tid; idx < R * HD; idx += THREADS) {
      const int r = idx / HD, d = idx % HD;
      float a = acc[idx] * crow[r];
      for (int t = 0; t < ps; ++t) a += sc[r * ps + t] * vs[t * HD + d];
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD;
    const int hh = r / S, s = r % S;
    store(out + (((size_t)b * S + s) * Hp + h_lo + hh) * HD + d,
          __fdiv_rn(acc[idx], fmaxf(lrow[r], 1e-30f)));
  }
}

template <int HD, typename T>
int launch_typed(const void* qc, const void* pk, const void* pv,
                 const void* ppos, const void* table, const void* q_pos,
                 const void* s_k, const void* scal, void* out, int B, int S,
                 int Hp, int Hkv, int ps, int P, int n_q, int causal,
                 int window, int bits, int smem, cudaStream_t st) {
  auto kern = attn_paged_kernel<HD, T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(B, Hkv), THREADS, smem, st>>>(
      static_cast<const int8_t*>(qc), static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int*>(ppos),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<const float*>(s_k), static_cast<const float*>(scal),
      static_cast<T*>(out), S, Hp, Hkv, ps, P, n_q, causal, window, bits);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int dtype, const void* qc, const void* pk, const void* pv,
              const void* ppos, const void* table, const void* q_pos,
              const void* s_k, const void* scal, void* out, int B, int S,
              int Hp, int Hkv, int ps, int P, int n_q, int causal, int window,
              int bits, int smem, cudaStream_t st) {
  if (dtype == 0)
    return launch_typed<HD, float>(qc, pk, pv, ppos, table, q_pos, s_k, scal,
                                   out, B, S, Hp, Hkv, ps, P, n_q, causal,
                                   window, bits, smem, st);
  if (dtype == 1)
    return launch_typed<HD, __nv_bfloat16>(qc, pk, pv, ppos, table, q_pos,
                                           s_k, scal, out, B, S, Hp, Hkv, ps,
                                           P, n_q, causal, window, bits, smem,
                                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// dtype: 0 float32, 1 bfloat16 (pools, out).  window <= 0: no window.
// smem: the block's dynamic shared memory, paged_smem_bytes() in Python.
extern "C" int attn_paged_launch(const void* qc, const void* pk,
                                 const void* pv, const void* ppos,
                                 const void* table, const void* q_pos,
                                 const void* s_k, const void* scal, void* out,
                                 int B, int S, int Hp, int Hkv, int hd, int ps,
                                 int P, int n_q, int causal, int window,
                                 int bits, int smem, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_hd<32>(dtype, qc, pk, pv, ppos, table, q_pos, s_k, scal,
                           out, B, S, Hp, Hkv, ps, P, n_q, causal, window,
                           bits, smem, st);
    case 64:
      return launch_hd<64>(dtype, qc, pk, pv, ppos, table, q_pos, s_k, scal,
                           out, B, S, Hp, Hkv, ps, P, n_q, causal, window,
                           bits, smem, st);
    case 128:
      return launch_hd<128>(dtype, qc, pk, pv, ppos, table, q_pos, s_k, scal,
                            out, B, S, Hp, Hkv, ps, P, n_q, causal, window,
                            bits, smem, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
