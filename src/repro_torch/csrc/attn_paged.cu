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
// q: (B, S, Hp, hd); pool_k / pool_v: (NP+1, ps, Hkv, hd), one type (float32
// or bfloat16) for q, the pools and out; ppos: (NP+1, ps) int32, -1 = never
// written; table: (B, P) int32; q_pos: (B, S) int32, -1 = padding row.
// kvh(j) = min(j / g, Hkv - 1), g = max(n_q / Hkv, 1).  The per-slot scales
// are the plain version's: s_q[b] = max|q[b]| / z + 1e-12 over the slot's
// rows (padding rows included), s_k[b] the same over the slot's K at live
// positions (ppos >= 0) of every KV head, scal = s_q * s_k * (1/sqrt(hd)),
// each step rounded as PyTorch rounds it on the card.
//
// What bounds it on an H100: bytes.  A decode step reads each slot's K and
// V pages once (8 slots x 18 pages x 16 x 5 x 64 bf16 is ~2.9 MB, ~1 us at
// 3.35 TB/s) against ~1.5 M multiply-adds; at these sizes the two launches
// and the latency of the page walk dominate.
//
// Design (two launches, no other device operation):
// 1. attn_paged_scales_kernel, grid (P, B): block (p, b) takes max|k| over
//    the live slots of table page p of slot b (all KV heads) and writes it
//    to kmax[b, p]; block (0, b) also writes max|q[b]| and zeroes slot b's
//    row counters.  No gather of the whole table's K is materialised.
// 2. attn_paged_kernel, grid (split, KV head x head group, slot)
//    (flash-decoding): the table row is cut into splits of `pps` pages,
//    enough that the grid fills the card (plan_for below); a KV head's g
//    query heads share its pages in one block while their S rows are few
//    (decode), and go to blocks of `hpb` heads, about 16 rows each, when S
//    is larger (a prefill chunk).
//    A block reduces its slot's kmax row and qmax into the scales,
//    quantizes its rows' q (its query heads x S rows) into shared
//    memory, and walks its pages in tiles of KT key slots with
//    double-buffered cp.async (raw K, V and positions of the next tile load
//    while the current one computes).  K is quantized from shared memory
//    exactly as the plain version does (__fdiv_rn, rintf, clamp).  One warp
//    per row: each lane takes two keys of the tile (signed __dp4a over the
//    levels, exact int32, __fmul_rn by scal), the row's max and sum go by
//    shuffle, and each lane owns hd/32 accumulator columns for P @ V,
//    eight keys at a time in two chains (V zero-filled past the tile's
//    keys).
//    Each split writes (m, l, acc) per row to scratch; the last split to
//    finish a row (a counter per query row, after __threadfence) combines
//    that row, so the combines spread over the blocks: weights
//    exp(m_i - m), not special-cased, so a padding
//    row, whose every partial has m = NEG_INF, gets the mean of V over all
//    P * ps gathered slots, as attn_paged_xla's softmax gives it.
//    The weights are not multiplied by the mask: a masked key's weight
//    exp(NEG_INF - m) is exactly 0 once its row has a valid key.  Key
//    slots past the split's end (a ragged last tile) take -inf and weigh 0.
// Later work: mma.sync on a prefill chunk's rows, several slots per
// block at decode.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KT = 64;  // key slots per staged tile (two per lane)
constexpr int SCAN_THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// max |x| over the 16 bytes at p (16-byte aligned)
__device__ __forceinline__ float absmax16(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}
__device__ __forceinline__ float absmax16(const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(__bfloat162float(e[i])));
  return m;
}

// max over the block of nonnegative values; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red is free
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i)
    r = fmaxf(r, red[i]);
  return r;
}

// s = max|x| / z + 1e-12 as PyTorch computes it on the card (a division by
// a Python scalar is a multiply by its float reciprocal; 1/z is exact)
__device__ __forceinline__ float scale_of(float mx, float zf) {
  return __fadd_rn(__fmul_rn(mx, __fdiv_rn(1.f, zf)), 1e-12f);
}

// the centred level clip(rint(x / s) + z, 0, 2^bits - 1) - z
__device__ __forceinline__ int8_t level(float x, float s, float zf, float nf,
                                        int zi) {
  float lv = rintf(__fdiv_rn(x, s)) + zf;
  lv = fminf(fmaxf(lv, 0.f), nf);
  return static_cast<int8_t>(static_cast<int>(lv) - zi);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
// zero-fill 16 bytes of shared memory (src is not read)
__device__ __forceinline__ void cp_async16_zero(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, 0;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
attn_paged_scales_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                         const int* __restrict__ ppos,
                         const int* __restrict__ table, float* __restrict__ kmax,
                         float* __restrict__ qmax, int* __restrict__ counters,
                         int S, int Hp, int Hkv, int hd, int ps, int P) {
  __shared__ float red[SCAN_THREADS / 32];
  constexpr int VEC = 16 / sizeof(T);
  const int p = blockIdx.x, b = blockIdx.y;
  const int row = Hkv * hd;  // elements of one key slot, every KV head
  const size_t page = static_cast<size_t>(table[b * P + p]);
  const T* base = pool_k + page * ps * row;
  const int nvec = ps * row / VEC;
  float m = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nvec; i += SCAN_THREADS) {
    if (ppos[page * ps + (i * VEC) / row] >= 0)
      m = fmaxf(m, absmax16(base + static_cast<size_t>(i) * VEC));
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) kmax[b * P + p] = m;
  if (p != 0) return;
  const T* qb = q + static_cast<size_t>(b) * S * Hp * hd;
  const int nq = S * Hp * hd / VEC;
  float mq = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nq; i += SCAN_THREADS)
    mq = fmaxf(mq, absmax16(qb + static_cast<size_t>(i) * VEC));
  mq = block_max(mq, red);
  if (threadIdx.x == 0) qmax[b] = mq;
  for (int i = threadIdx.x; i < S * Hp; i += SCAN_THREADS)
    counters[b * S * Hp + i] = 0;
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
attn_paged_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                  const T* __restrict__ pool_v, const int* __restrict__ ppos,
                  const int* __restrict__ table,
                  const int* __restrict__ q_pos,
                  const float* __restrict__ kmax,
                  const float* __restrict__ qmax, int* __restrict__ counters,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  T* __restrict__ out, int S, int Hp, int Hkv, int ps, int P,
                  int n_q, int causal, int window, int bits, int pps,
                  int nsplit, int hpb, int ngroups, float inv_sqrt_hd) {
  constexpr int HDP = HD + 16;           // int8 row pitch: no bank conflicts
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;          // 16-byte chunks of a K or V row
  constexpr int DPL = HD / 32;           // accumulator columns per lane
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[WARPS];

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / ngroups, grp = blockIdx.y % ngroups;
  const int g = max(n_q / Hkv, 1);
  const int kv_hi = (kvh == Hkv - 1) ? Hp : min(Hp, (kvh + 1) * g);
  const int h_lo = kvh * g + grp * hpb;  // this block's query heads
  const int h_hi = min(kv_hi, h_lo + hpb);
  const int nh = h_hi - h_lo;
  if (nh <= 0) return;  // uniform over every split of this head group
  const int R = nh * S;  // rows: r = hh * S + s, query head h_lo + hh

  // layout: smem_bytes() below
  T* kraw = reinterpret_cast<T*>(smem);                   // 2 x KT x HD
  T* vraw = kraw + 2 * KT * HD;                           // 2 x KT x HD
  int* pos = reinterpret_cast<int*>(vraw + 2 * KT * HD);  // 2 x KT
  int8_t* ks = reinterpret_cast<int8_t*>(pos + 2 * KT);   // KT x HDP
  int8_t* qs = ks + KT * HDP;                             // R x HDP
  float* acc = reinterpret_cast<float*>(qs + R * HDP);    // R x HD
  float* mrow = acc + R * HD;                             // R
  float* lrow = mrow + R;                                 // R

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int zi = 1 << (bits - 1);
  const float zf = static_cast<float>(zi);
  const float nf = static_cast<float>((1 << bits) - 1);

  const int p0 = split * pps;
  const int nkeys = min(pps, P - p0) * ps;
  const int ntiles = (nkeys + KT - 1) / KT;
  const int* trow = table + b * P + p0;

  auto issue = [&](int tile, int buf) {
    const int j0 = tile * KT;
    const int nk = min(KT, nkeys - j0);
    T* kd = kraw + buf * KT * HD;
    T* vd = vraw + buf * KT * HD;
    int* pd = pos + buf * KT;
    const int nk8 = (nk + 7) & ~7;  // V rows past nk are zero-filled
    for (int c = tid; c < nk8 * CPR; c += THREADS) {
      const int t = c / CPR, cc = c % CPR, j = j0 + t;
      if (t < nk) {
        const size_t page = static_cast<size_t>(trow[j / ps]);
        const size_t off = ((page * ps + j % ps) * Hkv + kvh) * HD + cc * VEC;
        cp_async16(kd + t * HD + cc * VEC, pool_k + off);
        cp_async16(vd + t * HD + cc * VEC, pool_v + off);
      } else {
        cp_async16_zero(vd + t * HD + cc * VEC, pool_v);
      }
    }
    for (int t = tid; t < nk; t += THREADS) {
      const int j = j0 + t;
      cp_async4(pd + t, ppos + static_cast<size_t>(trow[j / ps]) * ps + j % ps);
    }
    cp_async_commit();
  };
  if (ntiles > 0) issue(0, 0);

  float mk = 0.f;
  for (int i = tid; i < P; i += THREADS) mk = fmaxf(mk, kmax[b * P + i]);
  mk = block_max(mk, red);
  const float s_k = scale_of(mk, zf);
  const float s_q = scale_of(qmax[b], zf);
  const float scale = __fmul_rn(__fmul_rn(s_q, s_k), inv_sqrt_hd);

#pragma unroll 4
  for (int c = tid; c < R * CPR; c += THREADS) {  // 16 bytes of q at a time
    const int r = c / CPR, cc = c % CPR;
    const int hh = r / S, s = r % S;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + ((static_cast<size_t>(b) * S + s) * Hp + h_lo + hh) * HD
        + cc * VEC);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      qs[r * HDP + cc * VEC + j] = level(to_f32(e[j]), s_q, zf, nf, zi);
  }
  for (int idx = tid; idx < R * HD; idx += THREADS) acc[idx] = 0.f;
  for (int r = tid; r < R; r += THREADS) {
    mrow[r] = NEG_INF;
    lrow[r] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) {
      issue(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` has landed for every thread
    const int nk = min(KT, nkeys - it * KT);
    const T* kd = kraw + buf * KT * HD;
    const T* vd = vraw + buf * KT * HD;
    const int* pd = pos + buf * KT;
    for (int idx = tid; idx < nk * HD; idx += THREADS)
      ks[(idx / HD) * HDP + idx % HD] = level(to_f32(kd[idx]), s_k, zf, nf, zi);
    __syncthreads();

    for (int r = warp; r < R; r += WARPS) {
      const int iq = q_pos[b * S + r % S];
      float sc[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = lane + 32 * u;
        float val = -INFINITY;  // past the split's end: weight 0
        if (t < nk) {
          const int kp = pd[t];
          bool ok = kp >= 0;
          if (causal) ok = ok && kp <= iq;
          if (window > 0) ok = ok && kp > iq - window;
          val = NEG_INF;
          if (ok) {
            const int4* qr = reinterpret_cast<const int4*>(qs + r * HDP);
            const int4* kr = reinterpret_cast<const int4*>(ks + t * HDP);
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
        }
        sc[u] = val;
      }
      float mx = fmaxf(sc[0], sc[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      const float w0 = expf(sc[0] - m_new), w1 = expf(sc[1] - m_new);
      float wsum = w0 + w1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
      // keys in groups of 8 (weight 0 and V zero past nk), two chains
      float a[DPL], a2[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        a[c] = acc[r * HD + lane + 32 * c] * corr;
        a2[c] = 0.f;
      }
      for (int t0 = 0; t0 < nk; t0 += 8) {
        const float wsrc = t0 < 32 ? w0 : w1;
#pragma unroll
        for (int u = 0; u < 8; u += 2) {
          const float wa = __shfl_sync(0xffffffffu, wsrc, (t0 + u) & 31);
          const float wb = __shfl_sync(0xffffffffu, wsrc, (t0 + u + 1) & 31);
          const T* va = vd + (t0 + u) * HD + lane;
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            a[c] = fmaf(wa, to_f32(va[32 * c]), a[c]);
            a2[c] = fmaf(wb, to_f32(va[HD + 32 * c]), a2[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r * HD + lane + 32 * c] = a[c] + a2[c];
      __syncwarp();
      if (lane == 0) {
        mrow[r] = m_new;
        lrow[r] = lrow[r] * corr + wsum;
      }
    }
    __syncthreads();  // ks and this buffer are free for the next tiles
  }

  if (nsplit == 1) {
    for (int r = warp; r < R; r += WARPS) {
      const int hh = r / S, s = r % S;
      const float den = fmaxf(lrow[r], 1e-30f);
      T* o = out + ((static_cast<size_t>(b) * S + s) * Hp + h_lo + hh) * HD;
#pragma unroll
      for (int c = 0; c < DPL; ++c)
        store(o + lane + 32 * c, __fdiv_rn(acc[r * HD + lane + 32 * c], den));
    }
    return;
  }

  // partials: (m, l) as (B, nsplit, S, Hp, 2), acc as (B, nsplit, S, Hp, HD)
  const size_t split_stride = static_cast<size_t>(S) * Hp;
  const size_t slot0 = static_cast<size_t>(b) * nsplit * split_stride;
  for (int r = warp; r < R; r += WARPS) {
    const size_t row = slot0 + split * split_stride + (r % S) * Hp + h_lo
                       + r / S;
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      part_acc[row * HD + lane + 32 * c] = acc[r * HD + lane + 32 * c];
    if (lane == 0) {
      part_ml[2 * row] = mrow[r];
      part_ml[2 * row + 1] = lrow[r];
    }
  }
  __threadfence();
  __syncwarp();
  // the last split to finish a row combines it (a counter per query row):
  // one warp a row, lanes load the splits' (m, l) side by side, and each
  // lane sums its accumulator columns over the splits with the loads of
  // several splits in flight
  for (int r = warp; r < R; r += WARPS) {
    const int hh = r / S, s = r % S;
    const size_t rid = (static_cast<size_t>(b) * S + s) * Hp + h_lo + hh;
    int last = 0;
    if (lane == 0) last = atomicAdd(counters + rid, 1) == nsplit - 1;
    if (!__shfl_sync(0xffffffffu, last, 0)) continue;
    __threadfence();
    const size_t row0 = slot0 + s * Hp + h_lo + hh;
    float m = -INFINITY;
    for (int i = lane; i < nsplit; i += 32)
      m = fmaxf(m, __ldcg(part_ml + 2 * (row0 + i * split_stride)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f, a[DPL];
#pragma unroll
    for (int c = 0; c < DPL; ++c) a[c] = 0.f;
    for (int base = 0; base < nsplit; base += 32) {
      float wl = 0.f;
      if (base + lane < nsplit) {
        const size_t row = row0 + (base + lane) * split_stride;
        wl = expf(__ldcg(part_ml + 2 * row) - m);
        l = fmaf(wl, __ldcg(part_ml + 2 * row + 1), l);
      }
      const int n = min(32, nsplit - base);
#pragma unroll 4
      for (int u = 0; u < n; ++u) {
        const float w = __shfl_sync(0xffffffffu, wl, u);
        const float* src =
            part_acc + (row0 + (base + u) * split_stride) * HD + lane;
#pragma unroll
        for (int c = 0; c < DPL; ++c) a[c] = fmaf(w, __ldcg(src + 32 * c), a[c]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    const float den = fmaxf(l, 1e-30f);
    T* o = out + rid * HD;
#pragma unroll
    for (int c = 0; c < DPL; ++c) store(o + lane + 32 * c, __fdiv_rn(a[c], den));
  }
}

// Rows one block holds at most: a KV head's query heads share a block
// while their S rows each fit BLOCK_ROWS; the page split aims at
// TARGET_BLOCKS blocks (four per SM of an H100).
constexpr int BLOCK_ROWS = 16;
constexpr int TARGET_BLOCKS = 4 * 132;

// One call's launch plan: hpb query heads a block (ngroups head groups a
// KV head), splits of pps pages (nsplit of them, the last possibly
// shorter, never empty), the attention block's dynamic shared memory and
// the scratch, both in bytes.
struct Plan {
  int hpb, ngroups, pps, nsplit, smem;
  size_t scratch;
};

// Dynamic shared memory of an attention block of `rows` query rows; the
// layout is attn_paged_kernel's (two staged tiles of raw K, V and
// positions, the tile's K levels, the rows' q levels, accumulators, m, l).
int smem_bytes(int rows, int hd, int itemsize) {
  const int pitch = hd + 16;
  return 4 * KT * hd * itemsize + 2 * KT * 4 + KT * pitch + rows * pitch +
         4 * rows * hd + 8 * rows;
}

Plan plan_for(int B, int S, int Hp, int Hkv, int hd, int P, int n_q,
              int itemsize) {
  Plan pl;
  const int g = std::max(n_q / Hkv, 1);
  // the most query heads a KV head serves (the last also takes padded ones)
  const int nh = std::max(std::min(g, Hp), Hp - (Hkv - 1) * g);
  pl.hpb = std::max(1, std::min(nh, BLOCK_ROWS / S));
  pl.ngroups = (nh + pl.hpb - 1) / pl.hpb;
  const long long blocks = static_cast<long long>(P) * B * Hkv * pl.ngroups;
  pl.pps = static_cast<int>(
      std::max(1LL, (blocks + TARGET_BLOCKS - 1) / TARGET_BLOCKS));
  pl.nsplit = (P + pl.pps - 1) / pl.pps;
  pl.smem = smem_bytes(pl.hpb * S, hd, itemsize);
  // float32 words: kmax (B*P), qmax (B), row counters (B*S*Hp), then, with
  // more than one split, partial (m, l) (2*B*nsplit*S*Hp) and acc
  // (B*nsplit*S*Hp*hd)
  const size_t rows = static_cast<size_t>(B) * S * Hp;
  size_t words = static_cast<size_t>(B) * P + B + rows;
  if (pl.nsplit > 1) words += rows * pl.nsplit * (2 + hd);
  pl.scratch = 4 * words;
  return pl;
}

template <int HD, typename T>
int launch_typed(const void* q, const void* pk, const void* pv,
                 const void* ppos, const void* table, const void* q_pos,
                 void* scratch, void* out, int B, int S, int Hp, int Hkv,
                 int ps, int P, int n_q, int causal, int window, int bits,
                 float inv_sqrt_hd, cudaStream_t st) {
  const Plan pl = plan_for(B, S, Hp, Hkv, HD, P, n_q, sizeof(T));
  const int nsplit = pl.nsplit;
  float* kmax = static_cast<float*>(scratch);
  float* qmax = kmax + static_cast<size_t>(B) * P;
  int* counters = reinterpret_cast<int*>(qmax + B);
  float* part_ml = reinterpret_cast<float*>(counters + B * S * Hp);
  float* part_acc = part_ml + 2 * static_cast<size_t>(B) * nsplit * S * Hp;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(pk);
  const int* tpos = static_cast<const int*>(ppos);
  const int* ttab = static_cast<const int*>(table);
  attn_paged_scales_kernel<T><<<dim3(P, B), SCAN_THREADS, 0, st>>>(
      tq, tk, tpos, ttab, kmax, qmax, counters, S, Hp, Hkv, HD, ps, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kern = attn_paged_kernel<HD, T>;
  static int smem_set = 48 * 1024;
  if (pl.smem > smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = pl.smem;
  }
  kern<<<dim3(nsplit, Hkv * pl.ngroups, B), THREADS, pl.smem, st>>>(
      tq, tk, static_cast<const T*>(pv), tpos, ttab,
      static_cast<const int*>(q_pos), kmax, qmax, counters, part_ml, part_acc,
      static_cast<T*>(out), S, Hp, Hkv, ps, P, n_q, causal, window, bits,
      pl.pps, nsplit, pl.hpb, pl.ngroups, inv_sqrt_hd);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int dtype, const void* q, const void* pk, const void* pv,
              const void* ppos, const void* table, const void* q_pos,
              void* scratch, void* out, int B, int S, int Hp, int Hkv, int ps,
              int P, int n_q, int causal, int window, int bits,
              float inv_sqrt_hd, cudaStream_t st) {
  if (dtype == 0)
    return launch_typed<HD, float>(q, pk, pv, ppos, table, q_pos, scratch, out,
                                   B, S, Hp, Hkv, ps, P, n_q, causal, window,
                                   bits, inv_sqrt_hd, st);
  if (dtype == 1)
    return launch_typed<HD, __nv_bfloat16>(
        q, pk, pv, ppos, table, q_pos, scratch, out, B, S, Hp, Hkv, ps, P, n_q,
        causal, window, bits, inv_sqrt_hd, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launch both kernels on `stream`; returns cudaGetLastError() (0 on
// success).  dtype: 0 float32, 1 bfloat16 (q, pools, out).  window <= 0: no
// window.  scratch: the bytes attn_paged_plan returns for the same shape.
extern "C" int attn_paged_launch(const void* q, const void* pk, const void* pv,
                                 const void* ppos, const void* table,
                                 const void* q_pos, void* scratch, void* out,
                                 int B, int S, int Hp, int Hkv, int hd, int ps,
                                 int P, int n_q, int causal, int window,
                                 int bits, float inv_sqrt_hd, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch_hd<32>(dtype, q, pk, pv, ppos, table, q_pos, scratch, out,
                           B, S, Hp, Hkv, ps, P, n_q, causal, window, bits,
                           inv_sqrt_hd, st);
    case 64:
      return launch_hd<64>(dtype, q, pk, pv, ppos, table, q_pos, scratch, out,
                           B, S, Hp, Hkv, ps, P, n_q, causal, window, bits,
                           inv_sqrt_hd, st);
    case 96:
      return launch_hd<96>(dtype, q, pk, pv, ppos, table, q_pos, scratch, out,
                           B, S, Hp, Hkv, ps, P, n_q, causal, window, bits,
                           inv_sqrt_hd, st);
    case 128:
      return launch_hd<128>(dtype, q, pk, pv, ppos, table, q_pos, scratch, out,
                            B, S, Hp, Hkv, ps, P, n_q, causal, window, bits,
                            inv_sqrt_hd, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch plan attn_paged_launch uses for this shape: fills plan with
// (query heads a block, head groups a KV head, pages a split, splits,
// dynamic shared memory bytes of an attention block) and returns the
// scratch bytes.  dtype as for attn_paged_launch.
extern "C" long long attn_paged_plan(int B, int S, int Hp, int Hkv, int hd,
                                     int P, int n_q, int dtype, int* plan) {
  const Plan pl = plan_for(B, S, Hp, Hkv, hd, P, n_q, dtype == 0 ? 4 : 2);
  plan[0] = pl.hpb;
  plan[1] = pl.ngroups;
  plan[2] = pl.pps;
  plan[3] = pl.nsplit;
  plan[4] = pl.smem;
  return static_cast<long long>(pl.scratch);
}
